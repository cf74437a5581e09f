"""Multi-query lanes in the port against the JAX reference.

One compressed edge-stream pass answers K queries: the payload gains a
trailing lane axis (K vector lanes for SSSP/PPR batches, ceil(K/32) packed
reach words for multi-source BFS, reduced by word OR). Checked on the CPU,
where the port's kernel wrappers run their plain PyTorch versions:

  * each lane arm of both kernels against ``repro``'s Pallas kernels in
    interpret mode on the same packed arrays: 'or' at W=1 and W=2 words
    (K=16, K=40 with a partial word), vector min with the SSSP add, vector
    sum; counts and fetch-map arms; both push src-bit regimes. Min and OR
    exactly; sum within rtol=1e-6, atol=1e-9 (the reference's own
    Pallas-vs-XLA tolerance, tests/test_engine_fused.py);
  * ``bfs_multi``/``sssp_multi`` (async and sync) and ``ppr_multi`` through
    ``repro_torch.core.engine.run(device="cpu")`` against
    ``repro.core.engine.run``: labels and iterations bit-identical for BFS
    and SSSP, PPR within 2e-5 of the reference's K-lane result (its own
    K-lane vs K=1 bit-identity claim fails in the reference and is not
    asserted here);
  * the per-lane frozen lane, the ``EngineOptions.lanes`` admission check,
    and the lane frontier union with the 1/K-scaled direction thresholds
    against ``repro``'s ``run_frontier_trace``.

Every input comes from a numpy seed and goes to both packages as numpy.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.graph as RG
from repro.core import engine as RE
from repro.core import frontier_words as RF
from repro.core import problems as RP
from repro.core.partition import PartitionConfig as RConfig
from repro.core.partition import partition_2d as r_partition
from repro.data.synthetic import path_grid_graph, skewed_graph
from repro.kernels.csr_gather_reduce.kernel import (
    gather_reduce_cores_pallas,
    scatter_reduce_cores_pallas,
)
from repro.kernels.csr_gather_reduce.ops import combine_split_rows as r_combine

import repro_torch.core.graph as TG
from repro_torch.core import engine as TE
from repro_torch.core import frontier_words as TF
from repro_torch.core import problems as TP
from repro_torch.core import u32
from repro_torch.core.partition import PartitionConfig, partition_2d
from repro_torch.kernels.csr_gather_reduce import kernel as K
from repro_torch.kernels.csr_gather_reduce import scatter as S
from repro_torch.kernels.csr_gather_reduce.ops import combine_split_rows as t_combine

INF_F32 = float(np.finfo(np.float32).max)
SUM_TOL = dict(rtol=1e-6, atol=1e-9)  # one kernel launch, sum association only
PPR_TOL = 2e-5  # the round's tolerance for sum problems against the reference
ROOTS = [3, 7, 0, 100, 3]  # deliberate duplicate: two lanes, same source


def _weighted(g, seed):
    w = (np.random.default_rng(seed).random(g.num_edges) + 0.1).astype(np.float32)
    return RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


def _port_graph(g):
    return TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=g.weights)


# graph -> (make, partition config); the hub-split config of tests/test_multi_query.py
GRAPHS = {
    "rmat8_16bit": (lambda: _weighted(RG.symmetrize(RG.rmat(8, 6, seed=13)), 1),
                    dict(p=2, l=2, lane=4, tile_vb=16, push_block=64)),
    "rmat8_32bit": (lambda: _weighted(RG.symmetrize(RG.rmat(8, 6, seed=14)), 2),
                    dict(p=2, l=2, lane=4, tile_vb=16, pack_src_bits=32)),
    "hub_split": (lambda: _weighted(skewed_graph(256, kind="star", hub_in_degree=700,
                                                 avg_degree=2, seed=7), 3),
                  dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32)),
}

# lane variant -> (kind, edge_op, identity, lanes, payload kind)
LANE_VARIANTS = {
    "or_w1": ("or", "none", 0.0, 1, "words"),  # K = 16: one packed word
    "or_w2": ("or", "none", 0.0, 2, "words"),  # K = 40: a full and a partial word
    "min_f32_add": ("min", "add", INF_F32, 5, "dist"),
    "sum_f32": ("sum", "none", 0.0, 4, "rank"),
}
PUSH_VARIANTS = ("or_w1", "or_w2", "min_f32_add")


@pytest.fixture(scope="module")
def partitions():
    return {name: r_partition(make(), RConfig(**cfg)) for name, (make, cfg) in GRAPHS.items()}


def _payload(kind, n, lanes, rng):
    if kind == "words":
        k = 16 if lanes == 1 else 40
        bits = rng.random((n, 32 * lanes)) < 0.15
        bits[:, k:] = False  # a partial last word keeps its tail bits clear
        w = (bits.reshape(n, lanes, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64))
        return w.sum(axis=-1).astype(np.uint32)
    if kind == "dist":
        v = (rng.random((n, lanes)) * 50).astype(np.float32)
        v[rng.random((n, lanes)) < 0.2] = INF_F32
        return v
    return (rng.random((n, lanes)) / n).astype(np.float32)


def _to_port(a):
    if a is None:
        return None
    return u32.to_bits(a) if a.dtype == np.uint32 else torch.from_numpy(np.array(a))


def _from_port(t):
    return u32.from_bits(t) if t.dtype == torch.int32 else t.numpy()


def _fetch(counts, t_tiles, rng, share=0.3):
    real = np.arange(t_tiles)[None, None, :] < counts[..., None]
    active = real & (rng.random(real.shape) < share)
    return np.asarray(RF.active_fetch_map(jnp.asarray(active)))


def _assert_agree(got, want, kind):
    got = _from_port(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "sum":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got, want)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("arm", ["counts", "fetch"])
@pytest.mark.parametrize("variant", list(LANE_VARIANTS))
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_gather_lane_arm_matches_reference_kernel(partitions, graph, variant, arm):
    pg = partitions[graph]
    kind, edge_op, identity, lanes, pkind = LANE_VARIANTS[variant]
    rng = np.random.default_rng(21)
    kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
              kind=kind, edge_op=edge_op, identity=identity)
    for m in range(pg.l):
        word, counts = pg.tile_word[:, m], pg.tile_counts[:, m]
        hi = pg.tile_word_hi[:, m] if pg.tile_word_hi is not None else None
        w = pg.tile_weights[:, m] if edge_op == "add" else None
        fetch = _fetch(counts, word.shape[2], rng) if arm == "fetch" else None
        payload = _payload(pkind, pg.gathered_size, lanes, rng)
        want = np.asarray(gather_reduce_cores_pallas(
            jnp.asarray(payload), jnp.asarray(word), jnp.asarray(counts), _j(hi), _j(w),
            _j(fetch), interpret=True, **kw))
        assert want.shape == (pg.p, pg.packed_rows_per_core, lanes)
        got = K.gather_reduce_cores(*(_to_port(a) for a in (payload, word, counts, hi, w, fetch)),
                                    **kw)
        _assert_agree(got, want, kind)


@pytest.mark.parametrize("arm", ["counts", "fetch"])
@pytest.mark.parametrize("variant", PUSH_VARIANTS)
@pytest.mark.parametrize("graph", ["rmat8_16bit", "rmat8_32bit"])
def test_scatter_lane_arm_matches_reference_kernel(partitions, graph, variant, arm):
    pg = partitions[graph]
    assert pg.push_src_bits == (16 if graph == "rmat8_16bit" else 32)
    kind, edge_op, identity, lanes, pkind = LANE_VARIANTS[variant]
    rng = np.random.default_rng(22)
    kw = dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits, kind=kind,
              edge_op=edge_op, identity=identity)
    for m in range(pg.l):
        word, counts = pg.push_word[:, m], pg.push_counts[:, m]
        hi = pg.push_word_hi[:, m] if pg.push_word_hi is not None else None
        w = pg.push_weights[:, m] if edge_op == "add" else None
        fetch = _fetch(counts, word.shape[2], rng) if arm == "fetch" else None
        payload = _payload(pkind, pg.gathered_size, lanes, rng)
        want = np.asarray(scatter_reduce_cores_pallas(
            jnp.asarray(payload), jnp.asarray(word), jnp.asarray(counts), _j(hi), _j(w),
            _j(fetch), interpret=True, **kw))
        got = S.scatter_reduce_cores(*(_to_port(a) for a in (payload, word, counts, hi, w, fetch)),
                                     **kw)
        _assert_agree(got, want, kind)


@pytest.mark.parametrize("variant", list(LANE_VARIANTS))
def test_combine_split_rows_broadcasts_over_lanes(partitions, variant):
    """The level-2 fold of the hub-split layout (and the row_pos undo of an
    LPT-packed one, through the engine tests below) over a trailing lane
    axis, against the reference's fold."""
    pg = partitions["hub_split"]
    assert pg.tile_split_map is not None
    kind, _, identity, lanes, pkind = LANE_VARIANTS[variant]
    rng = np.random.default_rng(23)
    for m in range(pg.l):
        reduced = _payload(pkind, pg.p * pg.packed_rows_per_core, lanes, rng).reshape(
            pg.p, pg.packed_rows_per_core, lanes)
        smap = pg.tile_split_map[:, m]
        want = np.asarray(r_combine(jnp.asarray(reduced), jnp.asarray(smap), kind=kind,
                                    identity=identity))
        got = t_combine(_to_port(reduced), torch.from_numpy(smap.astype(np.int64)), kind=kind,
                        identity=identity)
        _assert_agree(got, want, kind)


def test_lane_wrappers_reject_what_the_kernels_do_not_take():
    word = torch.zeros((1, 1, 2, 4), dtype=torch.int32)
    counts = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="or"):  # 'or' needs packed words
        K.gather_reduce_cores(torch.zeros(4, dtype=torch.int32), word, counts, num_rows=4,
                              vb=4, kind="or")
    with pytest.raises(ValueError, match="or"):
        K.gather_reduce_cores(torch.zeros((4, 2)), word, counts, num_rows=4, vb=4, kind="or")
    with pytest.raises(ValueError, match="lanes"):
        K.gather_reduce_cores(torch.zeros((4, 2, 2)), word, counts, num_rows=4, vb=4)
    with pytest.raises(ValueError, match="min"):  # the push scatter takes min/or only
        S.scatter_reduce_cores(torch.zeros((4, 2)), word, counts, num_rows=8, kind="sum")


@pytest.mark.parametrize("variant", ["min_u32", "min_f32_add", "sum_f32"])
def test_laneless_payload_is_the_one_lane_case(partitions, variant):
    """Both kernels run a laneless (G,) payload as L = 1 (the same memory
    layout): the wrappers give the same values for (G,) and (G, 1), on both
    arms of both streams (sum on the pull stream only)."""
    pg = partitions["rmat8_16bit"]
    kind, edge_op, identity = {"min_u32": ("min", "none", float(0xFFFFFFFF)),
                               "min_f32_add": ("min", "add", INF_F32),
                               "sum_f32": ("sum", "none", 0.0)}[variant]
    rng = np.random.default_rng(24)
    payload = (_payload("words", pg.gathered_size, 1, rng)[:, 0] if variant == "min_u32"
               else _payload("dist" if edge_op == "add" else "rank", pg.gathered_size, 1, rng)[:, 0])
    one = _to_port(payload)
    streams = [(K.gather_reduce_cores, pg.tile_word, pg.tile_counts, pg.tile_weights,
                dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits))]
    if kind == "min":
        streams.append((S.scatter_reduce_cores, pg.push_word, pg.push_counts, pg.push_weights,
                        dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits)))
    for fn, word, counts, weights, kw in streams:
        for m in range(pg.l):
            w = _to_port(weights[:, m]) if edge_op == "add" else None
            fetch = _to_port(_fetch(counts[:, m], word.shape[3], rng))
            for f in (None, fetch):
                args = (_to_port(word[:, m]), _to_port(counts[:, m]), None, w, f)
                flat = fn(one, *args, kind=kind, edge_op=edge_op, identity=identity, **kw)
                lane = fn(one.view(-1, 1), *args, kind=kind, edge_op=edge_op, identity=identity,
                          **kw)
                assert lane.shape == flat.shape + (1,)
                assert torch.equal(lane[..., 0], flat)


# ---------------------------------------------------------------------------
# the engine: K-lane runs against the reference's K-lane runs
# ---------------------------------------------------------------------------


def _both(g, cfg):
    return r_partition(g, RConfig(**cfg)), partition_2d(_port_graph(g), PartitionConfig(**cfg))


def _bfs_graph():
    return RG.symmetrize(RG.rmat(8, 6, seed=13))


def _sssp_graph(seed=11):
    g0 = RG.rmat(8, 6, seed=seed)
    return _weighted(g0, seed)


# port options -> the reference's (the port's 'kernel'/'oracle' are 'pallas'/'xla')
def _ref_opts(**kw):
    if "backend" in kw:
        kw["backend"] = {"kernel": "pallas", "oracle": "xla"}[kw["backend"]]
    return RE.EngineOptions(**kw)


def _assert_runs_equal(got, want, exact=True):
    assert got.iterations == want.iterations and got.converged == want.converged
    assert set(got.labels) == set(want.labels)
    for k, b in want.labels.items():
        a = got.labels[k]
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=PPR_TOL, err_msg=k)


ENGINE_OPTS = {
    "default": {},
    "sync": dict(immediate_updates=False),
    "static": dict(dynamic_tile_skip=False),
    "push": dict(direction="push"),
    "oracle": dict(backend="oracle"),
}


@pytest.mark.parametrize("opts", list(ENGINE_OPTS))
def test_bfs_multi_matches_reference(opts):
    g = _bfs_graph()
    rpg, tpg = _both(g, dict(p=2, l=2, lane=4))
    kw = ENGINE_OPTS[opts]
    want = RE.run(RP.bfs_multi(ROOTS), g, rpg, _ref_opts(**kw))
    got = TE.run(TP.bfs_multi(ROOTS), _port_graph(g), tpg, TE.EngineOptions(**kw), device="cpu")
    _assert_runs_equal(got, want)
    assert got.labels["dist"].shape == (g.num_vertices, len(ROOTS))


def test_bfs_multi_partial_word_matches_single_runs():
    """K=40 spans a full and a partial packed word: every column is the
    port's single-query BFS, and the run is the reference's."""
    g = RG.symmetrize(RG.rmat(7, 4, seed=3))
    rpg, tpg = _both(g, dict(p=2, l=2, lane=4))
    roots = np.random.default_rng(0).integers(0, g.num_vertices, size=40).tolist()
    got = TE.run(TP.bfs_multi(roots), _port_graph(g), tpg, device="cpu")
    _assert_runs_equal(got, RE.run(RP.bfs_multi(roots), g, rpg))
    for j in (0, 31, 32, 39):
        single = TE.run(TP.bfs(roots[j]), _port_graph(g), tpg, device="cpu")
        np.testing.assert_array_equal(got.labels["dist"][:, j], single.labels["label"])


@pytest.mark.parametrize("opts", list(ENGINE_OPTS))
def test_sssp_multi_matches_reference(opts):
    g = _sssp_graph()
    rpg, tpg = _both(g, dict(p=2, l=2, lane=4))
    roots = [1, 50, 200]
    kw = ENGINE_OPTS[opts]
    want = RE.run(RP.sssp_multi(roots), g, rpg, _ref_opts(**kw))
    got = TE.run(TP.sssp_multi(roots), _port_graph(g), tpg, TE.EngineOptions(**kw),
                 device="cpu")
    _assert_runs_equal(got, want)


@pytest.mark.parametrize("mode", ["converged", "fixed_iters"])
@pytest.mark.parametrize("backend", ["kernel", "oracle"])
def test_ppr_multi_matches_reference(backend, mode):
    g = RG.rmat(8, 6, seed=12)
    rpg, tpg = _both(g, dict(p=2, l=2, lane=4))
    seeds = [2, 9, 77]
    kw = dict(backend=backend)
    tol = 1e-6
    if mode == "fixed_iters":
        kw["max_iters"], tol = 12, 0.0
    want = RE.run(RP.ppr_multi(seeds, tol=tol), g, rpg, _ref_opts(**kw))
    got = TE.run(TP.ppr_multi(seeds, tol=tol), _port_graph(g), tpg, TE.EngineOptions(**kw),
                 device="cpu")
    _assert_runs_equal(got, want, exact=False)


def test_multi_query_hub_split_graph():
    """Lanes through the two-level (hub-split) fold: bit-identical to the
    reference and, per column, to the port's single-query runs."""
    g = skewed_graph(n=256, kind="star", hub_in_degree=700, avg_degree=2, seed=7)
    rpg, tpg = _both(g, dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32))
    assert tpg.split_row_fraction > 0.0
    roots = [0, 5, 17, 0]
    tg = _port_graph(g)
    res_b = TE.run(TP.bfs_multi(roots), tg, tpg, device="cpu")
    res_s = TE.run(TP.sssp_multi(roots), tg, tpg, device="cpu")
    _assert_runs_equal(res_b, RE.run(RP.bfs_multi(roots), g, rpg))
    _assert_runs_equal(res_s, RE.run(RP.sssp_multi(roots), g, rpg))
    for j, r in enumerate(roots):
        np.testing.assert_array_equal(res_b.labels["dist"][:, j],
                                      TE.run(TP.bfs(r), tg, tpg, device="cpu").labels["label"])
        np.testing.assert_array_equal(res_s.labels["label"][:, j],
                                      TE.run(TP.sssp(r), tg, tpg, device="cpu").labels["label"])


def _two_chains():
    """A 4-vertex chain (lane 0 converges fast) and a 47-vertex chain."""
    short = np.arange(3, dtype=np.uint32)
    long = np.arange(4, 50, dtype=np.uint32)
    src = np.concatenate([short, long])
    dst = np.concatenate([short + 1, long + 1])
    return RG.symmetrize(RG.COOGraph(src=src, dst=dst, num_vertices=51))


def test_per_lane_convergence_frozen_lane():
    """The reference's frozen-lane case: the per-iteration live masks and
    dist columns of the port equal the reference's, lane 0 freezes while
    lane 1 advances."""
    g = _two_chains()
    cfg = dict(p=2, l=2, lane=4)
    rpg, tpg = _both(g, cfg)
    rprob, tprob = RP.bfs_multi([0, 4]), TP.bfs_multi([0, 4])
    r_it = RE.make_iteration(rprob, rpg, RE.EngineOptions(backend="xla"))
    t_it = TE.make_iteration(tprob, tpg, TE.EngineOptions(backend="oracle"), device="cpu")
    r_lab = RE.prepare_labels(rprob, g, rpg)
    t_lab = TE.prepare_labels(tprob, _port_graph(g), tpg, device="cpu")
    masks = []
    for _ in range(60):
        r_new, t_new = r_it(r_lab), t_it(t_lab)
        mask = tprob.not_converged_lanes(t_lab, t_new).numpy()
        np.testing.assert_array_equal(mask, np.asarray(rprob.not_converged_lanes(r_lab, r_new)))
        np.testing.assert_array_equal(u32.from_bits(t_new["dist"]), np.asarray(r_new["dist"]))
        masks.append(mask)
        if not bool(tprob.not_converged(t_lab, t_new)):
            break
        r_lab, t_lab = r_new, t_new
    masks = np.stack(masks)
    assert masks[-1].tolist() == [False, False]
    lane0 = int(np.max(np.nonzero(masks[:, 0])[0]))
    assert masks[lane0 + 1].tolist() == [False, True]
    changed = TF.lane_popcounts(TP.lane_bits(t_lab["reach"], 2))
    assert changed.tolist() == [4, 47]  # every vertex of its chain reached


def test_engine_options_lanes_admission_check():
    g = _bfs_graph()
    _, tpg = _both(g, dict(p=2, l=2, lane=4))
    tg = _port_graph(g)
    prob = TP.bfs_multi([1, 2, 3])
    TE.run(prob, tg, tpg, TE.EngineOptions(lanes=3), device="cpu")  # matches: ok
    with pytest.raises(ValueError, match="lanes"):
        TE.run(prob, tg, tpg, TE.EngineOptions(lanes=8), device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        TE.run(TP.bfs(1), tg, tpg, TE.EngineOptions(lanes=3), device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        TE.EngineOptions(lanes=-1)


def test_lane_frontier_union_matches_reference():
    rng = np.random.default_rng(31)
    for shape, dt in (((2, 2 * 40, 3), np.float32), ((3, 2 * 37, 2), np.uint32)):
        old = rng.integers(0, 4, shape).astype(dt)
        new = old.copy()
        new[rng.random(shape) < 0.05] += 1
        want = np.asarray(RF.frontier_words_from_labels(
            jnp.asarray(old), jnp.asarray(new), 2, shape[1] // 2, lanes=True))
        got = TF.frontier_words_from_labels(_to_port(old), _to_port(new), 2, shape[1] // 2,
                                            lanes=True)
        np.testing.assert_array_equal(u32.from_bits(got), want)
        changed = old != new
        np.testing.assert_array_equal(TF.lane_popcounts(torch.from_numpy(changed)).numpy(),
                                      np.asarray(RF.lane_popcounts(jnp.asarray(changed))))


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("pname", ["bfs_multi", "sssp_multi"])
def test_lane_schedule_matches_reference_trace(pname, k):
    """The union frontier and the 1/K-scaled Beamer thresholds: the
    per-iteration directions, dense iterations and skipped fractions of the
    port's trace equal the reference's; push is taken. The thresholds are
    raised so that push stays reachable at K=8 on 256 vertices (0.02 / 8 of
    256 bits rounds to 0)."""
    g = path_grid_graph(256, 1, shuffle=True, seed=11)
    if pname == "sssp_multi":
        g = _weighted(g, 5)
    rpg, tpg = _both(g, dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32))
    roots = np.random.default_rng(k).integers(0, g.num_vertices, size=k).tolist()
    kw = dict(direction_alpha=0.5, direction_beta=0.9)
    want = RE.run_frontier_trace(getattr(RP, pname)(roots), g, rpg, RE.EngineOptions(**kw))
    got = TE.run_frontier_trace(getattr(TP, pname)(roots), _port_graph(g), tpg,
                                TE.EngineOptions(**kw), device="cpu")
    assert got["direction"] == want["direction"] and "push" in got["direction"]
    assert got["dense_iterations"] == want["dense_iterations"]
    assert got["dynamic_skipped_tile_fraction"] == want["dynamic_skipped_tile_fraction"]
    assert got["iterations"] == want["iterations"]
    for key, b in want["labels"].items():
        np.testing.assert_array_equal(got["labels"][key], np.asarray(b))
