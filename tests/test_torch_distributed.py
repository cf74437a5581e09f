"""The port's multi-channel engine over ``torch.distributed`` against the
reference's, on the CPU: every rank is a spawned process of a gloo group
(``repro_torch.launch.mesh.spawn_ranks``), and each spawn carries its own
time limit, so a deadlock fails one test instead of the run.

  * ``core.distributed.run_distributed`` at p = 4 ranks on the cases of
    tests/test_distributed_equiv.py:54-140 (stride mapping, the hub-split
    star graph, dynamic and static schedules, forced push) and on lane
    batches: labels and iteration counts bit-equal to ``repro``'s
    ``run(..., EngineOptions(backend="pallas"))`` on the same graph and
    options (the reference's equivalence suite holds that equal to its
    ``run_distributed``); PageRank within rtol=2e-5, atol=1e-8 and equal
    iterations;
  * ``core.frontier.run_distributed_frontier`` at p = 8 ranks
    (tests/test_distributed.py:222): labels, iterations and the whole wire
    statistics dict equal to ``repro``'s at 8 host devices;
  * ``dist.gnn_parallel.make_graphscale_aggregate`` and
    ``dist.gat_parallel.make_gat_graphscale_loss`` (loss and parameter
    gradients, the reference's weights carried across, the attention
    vectors drawn non-zero) against ``repro``'s, within rtol=1e-5;
  * ``dist.embedding.make_crossbar_lookup`` over a 2 x 4 mesh of 8 ranks,
    the table sharded over the "model" axis and over both axes (the
    two-level crossbar: one all-to-all a level), against ``repro``'s under
    shard_map (tests/test_distributed.py:69-89, 283-315): rows, the table
    gradient, and at a small capacity the rows and dropped counts.

All the reference's multi-device runs share one subprocess with 8 forced
host devices (``ref_multi``), as tests/test_distributed.py runs them.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import repro.core.graph as RG
from repro.core import problems as RP
from repro.core.engine import EngineOptions as REngineOptions
from repro.core.engine import run as r_run
from repro.core.partition import PartitionConfig as RConfig
from repro.core.partition import partition_2d as r_partition
from repro.data.synthetic import skewed_graph as r_skewed

import _torch_ranks as ranks
from repro_torch.launch.mesh import make_graph_group, spawn_ranks

ROOT = Path(__file__).resolve().parents[1]
PR_TOL = dict(rtol=2e-5, atol=1e-8)
GNN_TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's own aggregate-vs-oracle tolerance (tests/test_distributed.py):
# sums of ~12 random rows cancel, so the absolute term carries near-zero rows
AGG_TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT = 60  # seconds a spawn of ranks may take (it needs a few)

_REF_MULTI = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
import repro.dist  # the jax>=0.6 shard_map/make_mesh/AxisType shims on 0.4.x
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.core.graph as G
from repro.core.frontier import run_distributed_frontier
from repro.core.partition import PartitionConfig, partition_2d
from repro.core.problems import bfs
from repro.dist.embedding import crossbar_lookup_local, make_crossbar_lookup
from repro.dist.gat_parallel import make_gat_graphscale_loss
from repro.dist.gnn_parallel import make_graphscale_aggregate, shard_features
from repro.launch.mesh import make_graph_mesh
from repro.models.gnn import archs as gnn

out = {}
mesh8, mesh4 = make_graph_mesh(8), make_graph_mesh(4)
for name, g, cfg, root in (
        ("grid", G.grid_2d(80, 60), dict(p=8, l=2, lane=8, stride=100), 3),
        ("rmat8", G.symmetrize(G.rmat(10, 8, seed=1)), dict(p=8, l=2, lane=8), 5)):
    res, stats = run_distributed_frontier(bfs(root), g, partition_2d(g, PartitionConfig(**cfg)),
                                          mesh8, budget=64)
    out[f"frontier/{name}/label"] = res.labels["label"]
    out[f"frontier/{name}/iterations"] = res.iterations
    for k, v in stats.items():
        out[f"frontier/{name}/stats/{k}"] = v

rng = np.random.default_rng(0)
g = G.symmetrize(G.rmat(9, 6, seed=1))
pg = partition_2d(g, PartitionConfig(p=4, l=3, lane=4, stride=50))
feat = rng.standard_normal((g.num_vertices, 8)).astype(np.float32)
out["agg/feat"] = feat
out["agg/out"] = np.asarray(jax.jit(make_graphscale_aggregate(pg, mesh4))(
    shard_features(feat, pg, mesh4)))

g = G.symmetrize(G.rmat(8, 6, seed=3))
pg = partition_2d(g, PartitionConfig(p=4, l=1, lane=4))
F, H, HD, OUT = 12, 4, 4, 5
cfg = gnn.GNNConfig(name="gat", n_layers=2, d_hidden=HD, n_heads=H)
params = dict(gnn.init(jax.random.key(0), cfg, F, OUT))
for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):  # non-zero attention
    params[k] = jnp.asarray(0.5 * rng.standard_normal(params[k].shape).astype(np.float32))
feat = rng.standard_normal((g.num_vertices, F)).astype(np.float32)
labels = rng.integers(0, OUT, g.num_vertices).astype(np.int32)
lab_pad = np.zeros(pg.padded_vertices, np.int32); lab_pad[: g.num_vertices] = labels
mask_pad = np.zeros(pg.padded_vertices, np.float32); mask_pad[: g.num_vertices] = 1.0
loss_fn = make_gat_graphscale_loss(mesh4, ("graph",), pg.vertices_per_core, H, HD)
args = (shard_features(feat, pg, mesh4), *map(jnp.asarray, (pg.src_gidx, pg.dst_lidx, pg.valid)),
        jax.device_put(lab_pad, NamedSharding(mesh4, P("graph"))),
        jax.device_put(mask_pad, NamedSharding(mesh4, P("graph"))))
loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
out["gat/feat"], out["gat/labels"], out["gat/loss"] = feat, labels, float(loss)
for path, leaf in jax.tree_util.tree_leaves_with_path(params):
    out["gat/param/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = \
        np.asarray(leaf)
for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
    out["gat/grad/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = \
        np.asarray(leaf)

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
for form, taxes, rows, d, n, cap in (("model", "model", 64, 8, 32, 2),
                                     ("full", ("data", "model"), 64, 6, 16, 1)):
    table = rng.random((rows, d), np.float32)
    ids = rng.integers(-1, rows, (n, 5)).astype(np.int32)
    ids[: n // 4, 0] = 0  # a hub row: some shard's queue overflows at capacity cap
    lookup = make_crossbar_lookup(mesh, table_axis=taxes, batch_axes=("data", "model"),
                                  capacity_factor=4.0)
    tbl = jax.device_put(table, NamedSharding(mesh, P(taxes, None)))
    idd = jax.device_put(ids, NamedSharding(mesh, P(("data", "model"), None)))
    rows_out = jax.jit(lookup)(tbl, idd)
    grad = jax.jit(jax.grad(lambda t: (lookup(t, idd) ** 2).sum()))(tbl)
    n_sh = 4 if form == "model" else 8

    def body(tb, il):
        got, dropped = crossbar_lookup_local(tb, il.reshape(-1), taxes, n_sh, cap)
        return got, dropped[None]

    small, dropped = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(taxes, None), P(("data", "model"), None)),
        out_specs=(P(("data", "model"), None), P(("data", "model"))), check_vma=False))(tbl, idd)
    for k, v in (("table", table), ("ids", ids), ("cap", cap), ("rows", rows_out),
                 ("grad", grad), ("small", small), ("dropped", dropped)):
        out[f"lookup/{form}/{k}"] = np.asarray(v)

# recommend-for at 4 table shards: the reference's own 4-device scorer cannot
# split a (1, L) history over 4 shards (shard_map raises), so its crossbar
# (make_crossbar_lookup over a 4-device "table" mesh) runs on the flat ids
# split as the port splits them: padded with -1 to a multiple of 4
import dataclasses
from repro.configs.registry import get as rget
from repro.data.synthetic import skewed_graph
from repro.models.recsys import din as rdin
from repro.serve.router import RecommendScorer as RScorer
sys.path.insert(0, sys.argv[2])
from _torch_ranks import REC_CASES, graph
rlookup = make_crossbar_lookup(make_graph_mesh(4, axis="table"), "table", "table")

def split_lookup(table, ids):
    flat = ids.reshape(-1)
    n = flat.shape[0]
    share = -(-n // 4)
    padded = jnp.full((share * 4,), -1, flat.dtype).at[:n].set(flat)
    return rlookup(table, padded)[:n].reshape(ids.shape + (table.shape[-1],))

for case, (gname, vocab, seq, roots) in REC_CASES.items():
    g = graph(gname, G, skewed_graph)
    pg = partition_2d(g, PartitionConfig(p=2, l=2))
    cfg = dataclasses.replace(rget("din").smoke(), item_vocab=vocab, seq_len=seq)
    for form in ("four", "one"):
        s = RScorer(cfg, pool_size=64, topk=8, lookup="take", seed=0)
        if form == "four" and vocab % 4 == 0:
            s._score = jax.jit(lambda p, b, c=cfg: rdin.score_candidates(
                p, b, c, lookup_fn=split_lookup))
        s.refresh_pool(g)
        for i, r in enumerate(roots):
            a = s.recommend_for(pg, r)
            for k in ("vertices", "scores"):
                out[f"rec/{case}/{form}/{i}/{k}"] = np.asarray(a[k])
    for path, leaf in jax.tree_util.tree_leaves_with_path(s._params):
        out[f"rec/{case}/param/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                            for k in path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def ref_multi(tmp_path_factory):
    """The reference's multi-device results, from one subprocess with 8
    forced host devices (jax locks the device count at first init)."""
    path = tmp_path_factory.mktemp("ref_multi") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_MULTI), str(path),
                          str(Path(__file__).parent)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    with np.load(path) as z:
        return dict(z)


def _tree(ref, prefix):
    """Rebuild a nested dict/list tree from ``prefix/<path>`` npz keys."""
    root = {}
    for key, v in ref.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


@pytest.fixture(scope="module")
def rank_results(ref_multi, tmp_path_factory):
    """One spawn of 4 gloo ranks for the engine cases and the GNN paths, one
    of 8 for the frontier engine and the lookups."""
    init_dir = tmp_path_factory.mktemp("rendezvous")
    four = spawn_ranks(
        ranks.engine_and_gnn, 4,
        (_tree(ref_multi, "gat/param/"), ref_multi["gat/feat"], ref_multi["gat/labels"],
         ref_multi["agg/feat"]),
        backend="gloo", timeout=SPAWN_TIMEOUT, init_dir=init_dir)
    lookups = {form: (ref_multi[f"lookup/{form}/table"], ref_multi[f"lookup/{form}/ids"],
                      int(ref_multi[f"lookup/{form}/cap"])) for form in ("model", "full")}
    eight = spawn_ranks(ranks.frontier_and_lookup, 8, (lookups,), backend="gloo",
                        timeout=SPAWN_TIMEOUT, init_dir=init_dir)
    return four, eight


_REF_PARTS = {}


def _ref_part(gname):
    if gname not in _REF_PARTS:
        g = ranks.graph(gname, RG, r_skewed)
        _REF_PARTS[gname] = (g, r_partition(g, RConfig(**ranks.GRAPH_CONFIGS[gname])))
    return _REF_PARTS[gname]


@pytest.mark.parametrize("case", ranks.ENGINE_CASES, ids=[c[0] for c in ranks.ENGINE_CASES])
def test_run_distributed_matches_reference(case, rank_results):
    name, gname, pname, args, pkw, okw = case
    g, pg = _ref_part(gname)
    want = r_run(getattr(RP, pname)(*args, **pkw), g, pg,
                 REngineOptions(backend="pallas", **okw))
    for rank, out in enumerate(rank_results[0]):
        labels, iters, converged = out["engine"][name]
        assert iters == want.iterations, (name, rank, iters, want.iterations)
        assert converged and want.converged
        assert set(labels) == set(want.labels)
        for k, v in want.labels.items():
            v = np.asarray(v)
            if pname == "pagerank":
                np.testing.assert_allclose(labels[k], v, **PR_TOL)
            else:
                assert labels[k].dtype == v.dtype and np.array_equal(labels[k], v), (name, k)


def test_distributed_streams_this_cores_packed_words_only(rank_results):
    """Each rank holds the packed stream only (no flat src/dst/valid), and the
    options' coverage and push stream."""
    keys = rank_results[0][0]["const_keys"]
    assert keys[:2] == ("word", "counts") and "coverage" in keys and "push_word" in keys
    assert not {"src", "dst", "valid"} & set(keys)


@pytest.mark.parametrize("gname", ["grid", "rmat8"])
def test_frontier_engine_matches_reference(gname, rank_results, ref_multi):
    want_stats = _tree(ref_multi, f"frontier/{gname}/stats/")
    for rank, out in enumerate(rank_results[1]):
        labels, iters, stats = out["frontier"][gname]
        assert np.array_equal(labels["label"], ref_multi[f"frontier/{gname}/label"]), rank
        assert iters == int(ref_multi[f"frontier/{gname}/iterations"])
        assert set(stats) == set(want_stats)
        for k, v in want_stats.items():
            assert stats[k] == v.item(), (gname, k, stats[k], v)
    assert rank_results[1][0]["frontier"]["grid"][2]["sparse_phases"] > 0


def test_graphscale_aggregate_matches_reference(rank_results, ref_multi):
    got = np.concatenate([out["aggregate"] for out in rank_results[0]])
    np.testing.assert_allclose(got, ref_multi["agg/out"], **AGG_TOL)


@pytest.mark.parametrize("wire", ["gat", "gat_bf16"])
def test_gat_graphscale_loss_and_grads_match_reference(wire, rank_results, ref_multi):
    """f32 wires within GNN_TOL of the reference; bf16 wires (f32 math)
    within bf16's precision of it."""
    tol = GNN_TOL if wire == "gat" else dict(rtol=2e-2, atol=2e-3)
    want = ranks._leaves(_tree(ref_multi, "gat/grad/"))
    for out in rank_results[0]:
        loss, grads = out[wire]
        np.testing.assert_allclose(loss, float(ref_multi["gat/loss"]), **tol)
        assert len(grads) == len(want)
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a, b, rtol=tol["rtol"], atol=tol["atol"] * max(
                1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("form", ["model", "full"])
def test_crossbar_lookup_over_ranks_matches_reference(form, rank_results, ref_multi):
    ids = ref_multi[f"lookup/{form}/ids"]
    per = ids.shape[0] // 8
    n_shards = 4 if form == "model" else 8
    table = ref_multi[f"lookup/{form}/table"]
    rows = table.shape[0] // n_shards
    grad = np.zeros_like(table)
    small_want = ref_multi[f"lookup/{form}/small"].reshape(8, -1, table.shape[1])
    dropped_want = ref_multi[f"lookup/{form}/dropped"]
    assert dropped_want.sum() > 0  # the small capacity does overflow
    for r, out in enumerate(rank_results[1]):
        got, g_shard, small, dropped = out[form]
        np.testing.assert_allclose(got, ref_multi[f"lookup/{form}/rows"][r * per:(r + 1) * per],
                                   rtol=1e-6)
        shard = r % 4 if form == "model" else r
        grad[shard * rows:(shard + 1) * rows] += g_shard  # "model": replicas over "data" add
        np.testing.assert_array_equal(small, small_want[r])
        assert dropped == int(dropped_want[r])
    np.testing.assert_allclose(grad, ref_multi[f"lookup/{form}/grad"], rtol=1e-5, atol=1e-6)


def test_spawn_ranks_ends_every_rank_when_one_fails(tmp_path):
    """Rank 1 raises while rank 0 waits on it in a collective: the spawn
    raises with the rank's traceback well inside its limit."""
    with pytest.raises(RuntimeError, match="rank one fails"):
        spawn_ranks(ranks.fail_on_rank_one, 2, backend="gloo", timeout=SPAWN_TIMEOUT,
                    init_dir=tmp_path)


def test_make_graph_group_needs_its_rendezvous():
    with pytest.raises(ValueError, match="not initialised"):
        make_graph_group(4)


# ---------------------------------------------------------------------------
# recommend-for through the router's table-sharded crossbar lookup


@pytest.fixture(scope="module")
def rec_results(ref_multi, tmp_path_factory):
    """recommend-for in 4 gloo ranks, each case's scorer carrying the
    reference scorer's weights."""
    params = {case: _tree(ref_multi, f"rec/{case}/param/") for case in ranks.REC_CASES}
    out = spawn_ranks(ranks.recommend_sharded, 4, (params,), backend="gloo",
                      timeout=SPAWN_TIMEOUT, init_dir=tmp_path_factory.mktemp("rec"))
    return out


def _rec_ref(ref_multi, case, form, i):
    return {k: ref_multi[f"rec/{case}/{form}/{i}/{k}"] for k in ("vertices", "scores")}


@pytest.mark.parametrize("case", list(ranks.REC_CASES))
def test_sharded_recommend_matches_reference(case, rec_results, ref_multi):
    """The port's 4-rank answers (every rank the same) against the
    reference's crossbar at 4 table shards (one shard where item_vocab % 4 !=
    0): vertices equal, scores within DIN_TOL (rtol 1e-5, atol 1e-6)."""
    _, vocab, _, roots = ranks.REC_CASES[case]
    answers0, drops0, shards = rec_results[0][case]
    assert shards == (4 if vocab % 4 == 0 else 1)
    for answers, drops, sh in (r[case] for r in rec_results[1:]):
        assert sh == shards and drops == drops0
        for a, b in zip(answers, answers0):
            np.testing.assert_array_equal(a["vertices"], b["vertices"])
            np.testing.assert_array_equal(a["scores"], b["scores"])
    for i in range(len(roots)):
        want = _rec_ref(ref_multi, case, "four", i)
        np.testing.assert_array_equal(answers0[i]["vertices"], want["vertices"])
        np.testing.assert_allclose(answers0[i]["scores"], want["scores"], rtol=1e-5, atol=1e-6)


def test_sharded_recommend_drops_as_the_one_shard_lookup_allows(rec_results, ref_multi):
    """Where no id overflowed a shard's queue the 4-shard answers are the
    one-shard answers (vertices equal, scores within DIN_TOL); the skewed
    pool overflows (zero rows, as the reference's), the spread one does not,
    and one shard never drops."""
    seen = {True: 0, False: 0}
    for case, (_, vocab, _, roots) in ranks.REC_CASES.items():
        answers, drops, shards = rec_results[0][case]
        if shards == 1:
            assert drops == [0] * len(roots)
        for i, d in enumerate(drops):
            seen[d == 0] += 1
            if d == 0:
                want = _rec_ref(ref_multi, case, "one", i)
                np.testing.assert_array_equal(answers[i]["vertices"], want["vertices"])
                np.testing.assert_allclose(answers[i]["scores"], want["scores"],
                                           rtol=1e-5, atol=1e-6)
    assert sum(rec_results[0]["skewed"][1]) > 0
    assert sum(rec_results[0]["spread"][1]) == 0
    assert seen[True] and seen[False]
