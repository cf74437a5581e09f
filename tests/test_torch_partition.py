"""The port's host partition against the reference, byte for byte.

``repro_torch.core.partition.partition_2d`` is a numpy copy of
``repro.core.partition.partition_2d`` whose LPT row packer uses a heap in
place of a per-row ``argmin`` scan. Every array it builds must be
byte-identical to the reference's, across both packed-word regimes, both
row-map modes (``row_pos`` and the split maps of hub-row splitting),
weighted graphs, the stride permutation and with the push stream on or off.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.graph as RG
from repro.core.partition import PartitionConfig as RConfig
from repro.core.partition import partition_2d as r_partition
from repro.data.synthetic import skewed_graph
from repro.kernels.csr_gather_reduce import ops as r_ops

import repro_torch.core.graph as TG
from repro_torch.core.partition import PartitionConfig as TConfig
from repro_torch.core.partition import PartitionedGraph
from repro_torch.core.partition import partition_2d as t_partition
from repro_torch.kernels.csr_gather_reduce import ops as t_ops


def _port_graph(g):
    return TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=g.weights)


def _weighted(g, seed):
    w = np.random.default_rng(seed).random(g.num_edges).astype(np.float32)
    return RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


def _graph(name):
    if name == "rmat10":
        return RG.symmetrize(RG.rmat(10, 8, seed=1))
    if name == "rmat9_w":
        return _weighted(RG.rmat(9, 6, seed=4), seed=4)
    if name == "grid":
        return RG.grid_2d(13, 17)
    if name == "chain":
        return RG.chain(40)
    if name == "karate":
        return RG.karate_club()
    if name == "star":
        return RG.star(64)
    if name == "hub":  # one dominant in-degree hub: forces hub-row splitting
        return skewed_graph(512, kind="star", hub_in_degree=2000, avg_degree=2, seed=3)
    if name == "hub_w":
        return _weighted(skewed_graph(256, kind="powerlaw", hub_in_degree=500, seed=5), seed=5)
    raise KeyError(name)


def _assert_same_partition(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "config":
            assert dataclasses.asdict(x) == dataclasses.asdict(y)
        elif isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), f.name
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, (f.name, x, y)


CASES = [
    ("rmat10", dict(p=2, l=2, lane=4)),
    ("rmat10", dict(p=4, l=2, lane=8, tile_vb=16, stride=100)),
    ("rmat10", dict(p=2, l=2, lane=4, pack_src_bits=32)),
    ("rmat10", dict(p=2, l=2, lane=4, tile_vb=16, build_push=False)),
    ("rmat10", dict(p=2, l=2, lane=4, degree_aware_tiles=False)),
    ("rmat9_w", dict(p=2, l=2, lane=4, tile_vb=16)),
    ("rmat9_w", dict(p=2, l=2, lane=4, pack_src_bits=32, stride=100, build_push=False)),
    ("grid", dict(p=2, l=3, lane=4)),
    ("chain", dict(p=2, l=2, lane=4)),
    ("karate", dict(p=1, l=1, lane=4)),
    ("star", dict(p=2, l=2, lane=4, tile_vb=8, tile_eb=8)),
    ("hub", dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32)),
    ("hub", dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32, pack_src_bits=32, build_push=False)),
    ("hub", dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32, split_threshold=None)),
    ("hub_w", dict(p=2, l=2, lane=8, tile_vb=16, tile_eb=16, stride=100)),
]


@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_partition_byte_identical(name, cfg):
    g = _graph(name)
    ref = r_partition(g, RConfig(**cfg))
    got = t_partition(_port_graph(g), TConfig(**cfg))
    _assert_same_partition(ref, got)


def test_cases_cover_every_layout_mode():
    """The case list above exercises both regimes and both row-map modes."""
    seen = set()
    for name, cfg in CASES:
        pg = t_partition(_port_graph(_graph(name)), TConfig(**cfg))
        seen.add(("bits", pg.src_bits))
        seen.add(("map", "split" if pg.tile_split_map is not None
                  else "pos" if pg.tile_row_pos is not None else "identity"))
        seen.add(("weights", pg.tile_weights is not None))
        seen.add(("push", pg.push_word is not None))
        seen.add(("stride", pg.perm is not None))
    for want in [("bits", 16), ("bits", 32), ("map", "split"), ("map", "pos"),
                 ("map", "identity"), ("weights", True), ("push", True),
                 ("push", False), ("stride", True)]:
        assert want in seen, want


@pytest.mark.parametrize("seed", range(6))
def test_lpt_heap_matches_argmin_greedy(seed):
    """The heap packer makes the reference greedy's exact choices: least
    loaded non-full block, lowest index on ties, zero-count tail included."""
    rng = np.random.default_rng(seed)
    r_blocks = int(rng.integers(1, 9))
    vb = int(rng.integers(1, 17))
    n = int(rng.integers(1, r_blocks * vb + 1))
    counts = rng.integers(0, 6, n) * rng.integers(0, 2, n)  # many ties + zeros
    if seed % 2:
        counts[int(rng.integers(0, n))] = 1000  # one hub
    np.testing.assert_array_equal(
        t_ops._balance_row_blocks(counts, r_blocks, vb),
        r_ops._balance_row_blocks(counts, r_blocks, vb),
    )


def test_from_numpy_carries_reference_state():
    """``PartitionedGraph.from_numpy`` on a reference partition's fields
    reproduces the port's own build of the same graph."""
    g = _graph("hub")
    cfg = dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32)
    ref = r_partition(g, RConfig(**cfg))
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    carried = PartitionedGraph.from_numpy(fields)
    _assert_same_partition(carried, t_partition(_port_graph(g), TConfig(**cfg)))
    with pytest.raises(ValueError, match="unknown"):
        PartitionedGraph.from_numpy({**fields, "bogus": 1})


def test_memory_report_matches_reference():
    g = _graph("rmat9_w")
    cfg = dict(p=2, l=2, lane=4, tile_vb=16)
    assert (
        t_partition(_port_graph(g), TConfig(**cfg)).memory_report()
        == r_partition(g, RConfig(**cfg)).memory_report()
    )


@pytest.mark.parametrize("push_block", [None, 64, 1024])
def test_push_footprint_counts_the_built_stream(push_block):
    """``repro_torch.push_footprint`` sizes the push stream from the flat
    bucket arrays alone; it must predict what the partitioner stacks."""
    from repro_torch.push_footprint import push_footprint

    g = TG.symmetrize(TG.rmat(10, 8, seed=6))
    cfg = dict(p=4, l=2, tile_vb=64, tile_eb=32, push_block=push_block)
    built = t_partition(g, TConfig(**cfg))
    flat = t_partition(g, TConfig(**cfg, build_tiles=False))
    got = push_footprint(flat, push_block, 32)
    assert got["shape"] == list(built.push_word.shape)
    assert got["block_sources"] == built.push_block
    assert got["src_bits"] == built.push_src_bits
    words = built.push_word.nbytes + (built.push_word_hi.nbytes if built.push_word_hi is not None else 0)
    assert got["word_bytes"] == words
    assert got["coverage_bytes"] == built.push_coverage.nbytes
    assert got["real_tiles"] == int(built.push_counts.sum())


# -- the run property the Hopper kernels lean on ------------------------------
# The lane gather kernel and the segment-softmax kernel fold runs of equal
# rows in registers and write each run once: in every layout the port
# builds, each packed row's valid slots inside a row block form one run in
# slot order (no other slot between its first and its last).


def _rows_in_one_run(rows, valid):
    """(..., N) rows and validity per row block: True iff in every block
    each row's valid slots are one unbroken run of slots."""
    rows = np.asarray(rows).reshape(-1, np.shape(rows)[-1])
    valid = np.asarray(valid).reshape(rows.shape)
    for rr, vv in zip(rows, valid):
        at = np.nonzero(vv)[0]
        if at.size == 0:
            continue
        seq = rr[at]
        starts = np.r_[True, (seq[1:] != seq[:-1]) | (np.diff(at) != 1)]
        if np.unique(seq[starts]).size != int(starts.sum()):
            return False
    return True


def _pull_rows(pg):
    """Rows and validity of the pull stream's slots, (p, l, R, T * Eb)."""
    word = pg.tile_word
    flat = word.shape[:3] + (-1,)
    if pg.src_bits == 16:
        rows, valid = (word >> 16) & 0x7FFF, word < 0
    else:
        rows, valid = pg.tile_word_hi & 0x7FFFFFFF, pg.tile_word_hi < 0
    return rows.reshape(flat), valid.reshape(flat)


def test_run_checker_sees_a_broken_layout():
    rows = np.array([[1, 1, 2, 2, 0, 0], [3, 3, 3, 4, 3, 5]])
    valid = np.array([[True] * 4 + [False] * 2, [True] * 6])
    assert not _rows_in_one_run(rows, valid)  # row 3 comes back in block 1
    assert _rows_in_one_run(rows[:1], valid[:1])
    gap = np.array([[True, False, True, True, True, False]])  # padding inside row 1's slots
    assert not _rows_in_one_run(np.array([[1, 1, 1, 2, 0, 0]]), gap)


@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_cold_partition_keeps_each_row_in_one_run(name, cfg):
    """Every cold layout of the case list (row packing, split hub rows, the
    32-bit regime, the stride permutation)."""
    pg = t_partition(_port_graph(_graph(name)), TConfig(**cfg))
    assert _rows_in_one_run(*_pull_rows(pg))


@pytest.mark.parametrize("name,cfg", [CASES[1], CASES[2], CASES[11], CASES[14]],
                         ids=["pos-stride", "bits32", "split", "split-weighted"])
def test_delta_flush_keeps_each_row_in_one_run(name, cfg):
    """The same after apply_edge_deltas re-tiles the buckets a stream of
    insertions dirties (hub rows gaining edges included)."""
    from repro_torch.core.partition import apply_edge_deltas

    g = _port_graph(_graph(name))
    pg = t_partition(g, TConfig(**cfg))
    rng = np.random.default_rng(3)
    n = g.num_vertices
    for _ in range(2):
        k = 64
        src = rng.integers(0, n, k).astype(np.uint32)
        dst = np.where(rng.random(k) < 0.5, rng.integers(0, 4, k), rng.integers(0, n, k))
        w = rng.random(k).astype(np.float32) if g.weights is not None else None
        pg, _ = apply_edge_deltas(pg, src, dst.astype(np.uint32), w)
        assert _rows_in_one_run(*_pull_rows(pg))


@pytest.mark.parametrize("n,e,vb,hub", [(300, 4000, 64, 0), (4096, 16384, 512, 0),
                                        (2000, 30000, 128, 9000), (50, 700, 64, 500)])
def test_gat_layout_keeps_each_row_in_one_run(n, e, vb, hub):
    """GAT's softmax layout (build_edge_tiles) on shuffled edges, masked
    slots and one hub destination included."""
    from repro_torch.kernels.segment_softmax.ops import build_edge_tiles

    rng = np.random.default_rng(n + e)
    dst = rng.integers(0, n, e)
    dst[:hub] = 7
    dst = dst[rng.permutation(e)]
    valid = rng.random(e) < 0.9
    t = build_edge_tiles(dst, valid, n, vb=vb, eb=256).tiles
    assert _rows_in_one_run(t.dstb, t.valid)


# The one-bucket kernel (csrc/gather_reduce.cu) leans on the same property
# in the uncompressed (R, T, Eb) arrays prepare_tiles builds for one bucket.
BUCKET_SWEEP = {  # name -> (v, e, vb, eb, balance_rows, split_threshold, weighted, hub edges)
    "natural": (64, 300, 8, 16, False, None, False, 0),
    "natural_hub": (256, 4000, 64, 32, False, None, False, 1500),
    "row_pos": (128, 1000, 16, 32, True, None, False, 0),
    "row_pos_weighted": (128, 1000, 16, 32, True, None, True, 300),
    "split": (32, 800, 8, 8, True, 64, False, 600),
    "multiway_split": (16, 1050, 8, 8, True, 8, False, 1000),
    "split_weighted": (256, 6000, 64, 32, True, 32, True, 2000),
    "one_block": (64, 64, 64, 8, False, None, False, 0),
}


@pytest.mark.parametrize("case", list(BUCKET_SWEEP))
def test_bucket_layouts_keep_each_row_in_one_run(case):
    """prepare_tiles over a dst-sorted bucket: natural rows, row packing
    (row_pos), hub-row splits (row_orig), weighted buckets; padding slots
    (valid False) dropped."""
    v, e, vb, eb, balance, split, weighted, hub = BUCKET_SWEEP[case]
    rng = np.random.default_rng(v + e)
    dst = np.sort(np.concatenate([np.full(hub, 3), rng.integers(0, v, e - hub)]))
    w = rng.random(e).astype(np.float32) if weighted else None
    t = t_ops.prepare_tiles(rng.integers(0, 4 * v, e).astype(np.int32), dst.astype(np.int32),
                            rng.random(e) < 0.9, num_rows=v, vb=vb, eb=eb, weights=w,
                            balance_rows=balance, split_threshold=split)
    assert (t.row_orig is not None) == (split is not None and hub > split)
    assert (t.row_pos is not None) == (balance and split is None and v > vb)
    r_blocks = t.src.shape[0]
    assert _rows_in_one_run(t.dstb.reshape(r_blocks, -1), t.valid.reshape(r_blocks, -1))


@pytest.mark.parametrize("name,cfg", [CASES[0], CASES[6], CASES[11], CASES[14]],
                         ids=["rmat", "weighted-bits32", "split", "split-weighted"])
def test_partition_buckets_keep_each_row_in_one_run(name, cfg):
    """Every (core, phase) bucket of a partition, tiled as chip_smoke.py's
    bucket phase tiles it (the partition's row packing and split rule)."""
    from repro_torch.core.partition import _bucket_split_threshold

    pg = t_partition(_port_graph(_graph(name)), TConfig(**cfg))
    c = pg.config
    vpc, vb, eb = pg.vertices_per_core, pg.tile_vb, pg.tile_word.shape[4]
    split = 0
    for i in range(pg.p):
        for m in range(pg.l):
            t = t_ops.prepare_tiles(
                pg.src_gidx[i, m], pg.dst_lidx[i, m], pg.valid[i, m], num_rows=vpc, vb=vb,
                eb=eb, weights=pg.weights[i, m] if pg.weights is not None else None,
                balance_rows=c.degree_aware_tiles,
                split_threshold=_bucket_split_threshold(c, int(pg.valid[i, m].sum()), vpc // vb))
            split += t.row_orig is not None
            r_blocks = t.src.shape[0]
            assert _rows_in_one_run(t.dstb.reshape(r_blocks, -1), t.valid.reshape(r_blocks, -1))
    assert split > 0 or name != "hub"


def _push_blocks_sorted(pg):
    """True iff in every (core, phase, source block) of the push stream the
    valid slots come first and are sorted by (src, dst): the order the
    scatter kernel's source runs lean on."""
    flat = pg.push_word.shape[:3] + (-1,)
    word = pg.push_word.reshape(flat)
    if pg.push_src_bits == 16:
        src, dst, valid = word & 0xFFFF, (word >> 16) & 0x7FFF, word < 0
    else:
        hi = pg.push_word_hi.reshape(flat)
        src, dst, valid = word, hi & 0x7FFFFFFF, hi < 0
    key = (src.astype(np.int64) << 32) | dst.astype(np.int64)
    prefix = np.all(np.diff(valid.astype(np.int8), axis=-1) <= 0)
    return bool(prefix and np.all((np.diff(key, axis=-1) >= 0) | ~valid[..., 1:]))


_PUSH_CASES = [(i, c) for i, c in enumerate(CASES) if c[1].get("build_push", True)]


def test_push_order_checker_sees_a_broken_layout():
    pg = t_partition(_port_graph(_graph("rmat10")), TConfig(p=2, l=2, lane=4))
    assert _push_blocks_sorted(pg)
    word = pg.push_word.copy()
    flat = word.reshape(word.shape[:3] + (-1,))
    n = int((flat[0, 0, 0] < 0).sum())
    assert n > 2
    flat[0, 0, 0, [0, n - 1]] = flat[0, 0, 0, [n - 1, 0]]  # two slots swapped
    assert not _push_blocks_sorted(dataclasses.replace(pg, push_word=word))
    word = pg.push_word.copy()
    word.reshape(flat.shape)[0, 0, 0, 0] = 0  # a padding slot before valid ones
    assert not _push_blocks_sorted(dataclasses.replace(pg, push_word=word))


@pytest.mark.parametrize("name,cfg", [c for _, c in _PUSH_CASES],
                         ids=[f"{c[0]}-{i}" for i, c in _PUSH_CASES])
def test_cold_push_stream_is_sorted_by_source(name, cfg):
    """Every cold layout of the case list that builds the push stream (both
    regimes, split hub rows, the stride permutation, weighted graphs)."""
    pg = t_partition(_port_graph(_graph(name)), TConfig(**cfg))
    assert pg.push_word is not None and _push_blocks_sorted(pg)


@pytest.mark.parametrize("name,cfg", [CASES[1], CASES[2], CASES[11], CASES[14]],
                         ids=["pos-stride", "bits32", "split", "split-weighted"])
def test_delta_flush_keeps_the_push_stream_sorted_by_source(name, cfg):
    """The same after apply_edge_deltas re-tiles the buckets a stream of
    insertions dirties (hub rows gaining edges included)."""
    from repro_torch.core.partition import apply_edge_deltas

    g = _port_graph(_graph(name))
    pg = t_partition(g, TConfig(**cfg))
    rng = np.random.default_rng(5)
    n = g.num_vertices
    for _ in range(2):
        k = 64
        src = np.where(rng.random(k) < 0.5, rng.integers(0, 4, k), rng.integers(0, n, k))
        dst = rng.integers(0, n, k)
        w = rng.random(k).astype(np.float32) if g.weights is not None else None
        pg, _ = apply_edge_deltas(pg, src.astype(np.uint32), dst.astype(np.uint32), w)
        assert _push_blocks_sorted(pg)
