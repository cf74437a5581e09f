"""The port's graph service against the JAX reference's.

  * the serving generators of ``repro_torch.data.synthetic`` yield the same
    streams as ``repro.data.synthetic`` for the same seed, and
    ``admission_batches`` keeps its edge cases;
  * ``repro_torch.serve.GraphService`` answers equal ``repro.serve``'s on
    the same graph and queries, both services carrying a
    ``RecommendScorer(pool_size=16, topk=4)`` with the reference's DIN
    weights carried across: BFS, SSSP and neighbors-of exactly; PPR's top-k
    vertices equal, scores within 2e-5; recommend-for's scores within rtol
    1e-5 and its top-k vertices equal wherever the score gaps exceed that,
    before and after a flush refreshes the pool;
  * the request loop: capacity rejection, deadline drain, full-batch
    coalescing over the default mix, a mid-stream flush against a fresh
    service, the auto-flush threshold;
  * the smoke's replay check also holds neighbors-of for every root;
  * ``python -m repro_torch.launch.serve`` exits 0 with ``--arch graph
    --smoke``, ``--arch din --mode pointwise`` and ``--mode retrieval``, and
    ``--arch smollm-135m --tokens 8``, all with ``--device cpu``.

Everything runs on the CPU (``device="cpu"``); inputs come from numpy seeds.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core.graph as RG
import repro.data.synthetic as RS
from repro import serve as rserve
from repro.core.partition import PartitionConfig as RConfig

import repro_torch.core.graph as TG
import repro_torch.data.synthetic as TS
from repro_torch import serve as tserve
from repro_torch.core.engine import EngineOptions
from repro_torch.core.partition import PartitionConfig
from repro_torch.models.recsys import din as tdin

LANES = 4
PPR_TOL = 2e-5  # the round's tolerance for sum problems against the reference
REC_RTOL = 1e-5  # DIN scores: the same float32 math in another association
POOL, TOPK = 16, 4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def graph():
    g0 = RG.symmetrize(RG.rmat(6, 4, seed=1))
    w = (np.random.default_rng(2).random(g0.num_edges) + 0.1).astype(np.float32)
    return RG.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)


def _port_graph(g):
    return TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=g.weights)


def _ref_scorer():
    return rserve.RecommendScorer(pool_size=POOL, topk=TOPK)


def _port_scorer(ref_scorer):
    """The port's scorer with the reference scorer's DIN weights."""
    params = tdin.params_from_reference(jax.tree.map(np.asarray, ref_scorer._params), "cpu")
    return tserve.RecommendScorer(pool_size=POOL, topk=TOPK, params=params, device="cpu")


def _service(g, **kw):
    return tserve.GraphService(_port_graph(g), PartitionConfig(p=2, l=2), lanes=LANES,
                               device="cpu", **kw)


@pytest.fixture(scope="module")
def services(graph):
    ref_scorer = _ref_scorer()
    ref = rserve.GraphService(graph, RConfig(p=2, l=2), lanes=LANES, scorer=ref_scorer)
    return ref, _service(graph, scorer=_port_scorer(ref_scorer))


def _assert_recommend_match(got, want):
    """Scores within REC_RTOL in rank order; the vertex at a rank equal
    wherever the reference's score there is apart from its neighbours'."""
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=REC_RTOL, atol=0)
    s = want["scores"].astype(np.float64)
    gap = np.abs(np.diff(s)) > 2 * REC_RTOL * np.abs(s).max()
    clear = np.ones(s.shape[0], bool)
    clear[:-1] &= gap
    clear[1:] &= gap
    assert clear.any()
    np.testing.assert_array_equal(got["vertices"][clear], want["vertices"][clear])
    np.testing.assert_array_equal(got["items"][clear], want["items"][clear])


# ---------------------------------------------------------------------------
# generators


@pytest.mark.parametrize("mix", [None, TS.DEFAULT_QUERY_MIX, {"bfs": 1.0}])
@pytest.mark.parametrize("seed", [0, 5])
def test_query_streams_match_reference(seed, mix):
    for n, v in ((64, 128), (7, 3)):
        assert TS.mixed_query_workload(n, v, mix=mix, seed=seed) == \
            RS.mixed_query_workload(n, v, mix=mix, seed=seed)
        np.testing.assert_array_equal(TS.query_workload(n, v, seed=seed, zipf_a=1.5),
                                      RS.query_workload(n, v, seed=seed, zipf_a=1.5))
    assert TS.QUERY_KINDS == RS.QUERY_KINDS and TS.DEFAULT_QUERY_MIX == RS.DEFAULT_QUERY_MIX
    wl = TS.mixed_query_workload(64, 128, mix=mix, seed=seed)
    if mix is not None and len(mix) > 1:  # the default mix carries recommend-for traffic
        assert {q["kind"] for q in wl} == set(mix) and "recommend" in mix


@pytest.mark.parametrize("weighted", [False, True])
def test_edge_insertion_stream_matches_reference(weighted):
    for n, v, b in ((30, 64, 4), (512, 1 << 12, 2), (0, 8, 1)):
        got = TS.edge_insertion_stream(n, v, num_batches=b, weighted=weighted, seed=6)
        want = RS.edge_insertion_stream(n, v, num_batches=b, weighted=weighted, seed=6)
        assert len(got) == len(want) == b
        for ga, wa in zip(got, want):
            for x, y in zip(ga, wa):
                if y is None:
                    assert x is None
                else:
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        TS.edge_insertion_stream(4, 8, num_batches=0)


def test_admission_batches_edge_cases():
    batches = TS.admission_batches(np.arange(10), 4)
    assert [s for _, s in batches] == [4, 4, 2]
    assert batches[-1][0].tolist() == [8, 9, 9, 9]  # padded with the LAST root
    assert TS.admission_batches(np.array([], dtype=np.int64), 4) == []
    with pytest.raises(ValueError):
        TS.admission_batches(np.arange(3), 0)
    assert [c.tolist() for c, _ in TS.admission_batches(np.array([5, 5, 7]), 1)] == \
        [[5], [5], [7]]
    (chunk, served), = TS.admission_batches(np.array([3, 3, 3, 3]), 4)
    assert chunk.tolist() == [3, 3, 3, 3] and served == 4
    for r in (np.arange(9), np.array([2, 2, 1])):
        got, want = TS.admission_batches(r, 4), RS.admission_batches(r, 4)
        assert [(c.tolist(), s) for c, s in got] == [(c.tolist(), s) for c, s in want]
    with pytest.raises(ValueError):
        TS.mixed_query_workload(4, 16, mix={"not-a-kind": 1.0})
    with pytest.raises(ValueError):
        TS.mixed_query_workload(4, 16, mix={"bfs": 0.0})


# ---------------------------------------------------------------------------
# router answers against the reference service


def _queries(kind, roots, target=5):
    return [tserve.Query(kind=kind, root=r, target=target, qid=i) for i, r in enumerate(roots)]


def _ref_queries(qs):
    return [rserve.Query(kind=q.kind, root=q.root, target=q.target, qid=q.qid) for q in qs]


@pytest.mark.parametrize("kind,roots", [("bfs", [0, 7, 19, 33]), ("bfs", [3, 3]),
                                        ("sssp", [2, 11]), ("sssp", [1, 5, 9, 60])])
def test_traversal_answers_match_reference(services, kind, roots):
    ref, port = services
    for target in (5, 40):
        qs = _queries(kind, roots, target)
        got, want = port.answer_batch(qs), ref.answer_batch(_ref_queries(qs))
        assert got.served == want.served and got.lanes == want.lanes == LANES
        assert got.iterations == want.iterations
        assert got.answers == want.answers


def test_ppr_answers_match_reference(services):
    ref, port = services
    qs = _queries("ppr", [3, 17, 3])
    got, want = port.answer_batch(qs), ref.answer_batch(_ref_queries(qs))
    assert got.iterations == want.iterations
    for a, b in zip(got.answers, want.answers):
        np.testing.assert_array_equal(a["vertices"], b["vertices"])
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=PPR_TOL)


def test_neighbors_answers_match_reference(graph, services):
    ref, port = services
    qs = _queries("neighbors", [0, 13, 40])
    got, want = port.answer_batch(qs), ref.answer_batch(_ref_queries(qs))
    assert got.iterations == 0 and not got.cold
    for a, b, q in zip(got.answers, want.answers, qs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.sort(a), np.sort(graph.src[graph.dst == q.root]).astype(a.dtype))


def test_batch_validation_and_recommend(graph, services):
    ref, port = services
    qs = _queries("recommend", [8, 8, 41])
    got, want = port.answer_batch(qs), ref.answer_batch(_ref_queries(qs))
    assert got.kind == "recommend" and got.served == 3 and got.lanes == 1
    assert got.iterations == 0 and got.cold == want.cold
    for a, b in zip(got.answers, want.answers):
        assert sorted(a) == sorted(b) == ["items", "scores", "vertices"]
        assert a["vertices"].dtype == np.int64 and a["scores"].shape == (TOPK,)
        _assert_recommend_match(a, b)
    for k in got.answers[0]:  # the same user twice: the same answer
        np.testing.assert_array_equal(got.answers[0][k], got.answers[1][k])
    with pytest.raises(ValueError):
        port.answer_batch([])
    with pytest.raises(ValueError):
        port.answer_batch([tserve.Query(kind="bfs", root=0), tserve.Query(kind="sssp", root=0)])
    with pytest.raises(ValueError):
        port.answer_batch([tserve.Query(kind="pagerank", root=0)])
    with pytest.raises(ValueError):
        port.answer_batch([tserve.Query(kind="bfs", root=0)] * (LANES + 1))
    with pytest.raises(ValueError, match="without a RecommendScorer"):
        _service(graph).answer_batch([tserve.Query(kind="recommend", root=8)])
    with pytest.raises(ValueError, match="lookup"):
        tserve.RecommendScorer(lookup="gspmd", device="cpu")
    with pytest.raises(RuntimeError, match="refresh_pool"):
        tserve.RecommendScorer(device="cpu").recommend_for(port.pg, 8)
    with pytest.raises(ValueError):
        _service(graph, opts=EngineOptions(lanes=8))


# ---------------------------------------------------------------------------
# request loop


def test_loop_capacity_rejection(graph):
    loop = tserve.RequestLoop(_service(graph), tserve.LoopConfig(queue_capacity=2,
                                                                 max_wait_ms=1e6))
    assert loop.submit(tserve.Query(kind="bfs", root=0, qid=0), now=0.0)
    assert loop.submit(tserve.Query(kind="bfs", root=1, qid=1), now=0.0)
    assert not loop.submit(tserve.Query(kind="bfs", root=2, qid=2), now=0.0)
    assert loop.queued == 2 and loop.metrics.rejected == 1


def test_loop_coalesces_full_batch_and_drains_at_deadline(graph):
    loop = tserve.RequestLoop(_service(graph), tserve.LoopConfig(max_wait_ms=20.0))
    for i in range(LANES):
        assert loop.submit(tserve.Query(kind="bfs", root=i, qid=i), now=0.0)
    done = loop.pump(now=0.0)  # a full batch drains with no deadline
    assert [c.qid for c in done] == list(range(LANES))
    assert loop.metrics.batches[-1].served == LANES
    assert loop.submit(tserve.Query(kind="sssp", root=1, qid=7), now=0.0)
    assert loop.pump(now=0.010) == []  # a young partial batch keeps waiting
    assert [c.qid for c in loop.pump(now=0.025)] == [7]  # past the 20 ms deadline
    assert loop.metrics.batches[-1].served == 1


def test_loop_run_replays_mixed_stream(graph):
    svc = _service(graph, scorer=tserve.RecommendScorer(pool_size=POOL, topk=TOPK,
                                                         device="cpu"))
    loop = tserve.RequestLoop(svc, tserve.LoopConfig(max_wait_ms=5.0, host_batch=LANES))
    wl = TS.mixed_query_workload(20, graph.num_vertices, seed=9)
    assert "recommend" in {q["kind"] for q in wl}
    done = loop.run([("query", tserve.Query(kind=q["kind"], root=q["root"],
                                            target=q["target"], qid=i))
                     for i, q in enumerate(wl)])
    assert sorted(c.qid for c in done) == list(range(20))
    s = loop.metrics.summary()
    assert s["queries"] == 20 and s["latency"]["n"] == 20 and s["qps"] > 0
    for kind in {q["kind"] for q in wl}:
        assert s["per_kind"][kind]["latency"]["n"] == sum(1 for q in wl if q["kind"] == kind)


def test_flush_mid_stream_matches_fresh_service(graph):
    svc = _service(graph)
    qs = _queries("bfs", range(4), target=21)
    assert svc.answer_batch(qs).cold and not svc.answer_batch(qs).cold
    old_pg = svc.pg
    assert old_pg.device_cache  # the batches uploaded the edge tensors
    src, dst, w = TS.edge_insertion_stream(24, graph.num_vertices, weighted=True, seed=3)[0]
    svc.ingest(src, dst, w)
    rec = svc.flush()
    assert rec.edges_added == 24 and svc.generation == 1
    assert svc.pg is not old_pg and old_pg.device_cache == {}  # swapped, old copies freed
    assert svc.g.num_edges == graph.num_edges + 24
    post = svc.answer_batch(qs)
    assert post.cold
    g2 = RG.COOGraph(src=np.concatenate([graph.src, src.astype(graph.src.dtype)]),
                     dst=np.concatenate([graph.dst, dst.astype(graph.dst.dtype)]),
                     num_vertices=graph.num_vertices,
                     weights=np.concatenate([graph.weights, w]))
    assert post.answers == _service(g2).answer_batch(qs).answers
    ref = rserve.GraphService(g2, RConfig(p=2, l=2), lanes=LANES)
    assert post.answers == ref.answer_batch(_ref_queries(qs)).answers


def test_auto_flush_threshold(graph):
    svc = _service(graph, auto_flush_edges=8)
    loop = tserve.RequestLoop(svc)
    loop.ingest([1, 2, 3], [4, 5, 6], [1.0, 1.0, 1.0])
    assert svc.delta.pending_edges == 3
    loop.ingest([7] * 5, [8] * 5, [1.0] * 5)
    assert svc.delta.pending_edges == 0 and svc.generation == 1
    assert len(loop.metrics.flushes) == 1 and svc.g.num_edges == graph.num_edges + 8


def test_recommend_follows_flush(graph):
    """A flush refreshes the pool from the new in-degrees on both sides, and
    the answers still match."""
    ref_scorer = _ref_scorer()
    ref = rserve.GraphService(graph, RConfig(p=2, l=2), lanes=LANES, scorer=ref_scorer)
    port = _service(graph, scorer=_port_scorer(ref_scorer))
    hub = np.full(40, 61, dtype=np.int64)  # 40 new in-edges make vertex 61 the top hub
    src = np.arange(40, dtype=np.int64) % graph.num_vertices
    w = np.ones(40, np.float32)
    for svc in (ref, port):
        svc.ingest(src, hub, w)
        svc.flush()
    np.testing.assert_array_equal(port.scorer._pool_vertices, ref.scorer._pool_vertices)
    assert port.scorer._pool_vertices[0] == 61
    qs = _queries("recommend", [61, 2])
    got, want = port.answer_batch(qs), ref.answer_batch(_ref_queries(qs))
    assert got.cold and want.cold
    for a, b in zip(got.answers, want.answers):
        _assert_recommend_match(a, b)


def test_replay_equivalence_compares_neighbors_of_for_every_root(graph):
    """The smoke's equivalence check answers neighbors-of for every distinct
    root of a stream that sends none, and catches partitions whose in-edges
    differ where BFS cannot see it (a self-loop on a root)."""
    from repro_torch.core.partition import partition_2d
    from repro_torch.launch.serve import check_replay_equivalence

    g = _port_graph(graph)
    cfg = PartitionConfig(p=2, l=2)
    workload = TS.mixed_query_workload(12, g.num_vertices, mix={"bfs": 1.0}, seed=0)
    roots = {int(q["root"]) for q in workload}
    counts = check_replay_equivalence(g, partition_2d(g, cfg), partition_2d(g, cfg), workload,
                                      LANES, "cpu", None)
    assert counts == {"bfs": 12, "neighbors": len(roots)}
    r = min(roots)
    looped = TG.COOGraph(src=np.append(g.src, r).astype(g.src.dtype),
                         dst=np.append(g.dst, r).astype(g.dst.dtype),
                         num_vertices=g.num_vertices,
                         weights=np.append(g.weights, 1.0).astype(np.float32))
    with pytest.raises(AssertionError, match="neighbors query"):
        check_replay_equivalence(g, partition_2d(g, cfg), partition_2d(looped, cfg), workload,
                                 LANES, "cpu", None)


@pytest.mark.parametrize("args,expect", [
    (["--arch", "graph", "--smoke"], "serve smoke OK"),
    (["--arch", "din", "--mode", "pointwise"], "pointwise on cpu: batch 512"),
    (["--arch", "din", "--mode", "retrieval"], "retrieval on cpu: 4096 candidates"),
    (["--arch", "smollm-135m", "--tokens", "8"], "decoded 8 tokens x batch 4 on cpu"),
])
def test_serve_cli_smoke_on_cpu(args, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args,
                          "--device", "cpu"], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert expect in out.stdout


def test_serving_modules_import_no_jax():
    """The serving path of the port pulls in neither jax nor the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch.serve, repro_torch.launch.serve, repro_torch.data.synthetic\n"
        "import repro_torch.core.partition, repro_torch.core.problems\n"
        "import repro_torch.models.recsys.din, repro_torch.dist.embedding\n"
        "import repro_torch.kernels.embedding_bag, repro_torch.configs.registry\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
