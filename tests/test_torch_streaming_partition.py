"""The port's out-of-core streaming build against the JAX reference.

``repro_torch.core.partition.partition_2d_streaming`` must return, on every
field of ``IDENTITY_FIELDS`` and byte for byte, what
``repro.core.partition.partition_2d_streaming`` returns for the same chunk
stream and config, and what the port's own ``partition_2d`` returns for the
materialized edge list, on the cases of tests/test_streaming_partition.py
(one test here for each of its 20): both row-map modes (LPT ``row_pos``,
hub-split ``row_orig``/``split_map``), both src-bit regimes with the exact
2^16 boundary, weighted, stride permutation, push; chunk-size invariance and
the chunk-protocol errors; ``RMATStream`` chunks byte-identical to the
reference's and replayed deterministically; a memmap-backed build, a port
engine BFS on it and ``apply_edge_deltas`` on it against a cold rebuild;
``memory_report``. ``plan_push_tiles`` and ``skewed_graph`` against the
reference's too.

Inputs come from numpy seeds.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.graph as RG
from repro.core import partition as RPart
from repro.core.engine import EngineOptions as REngineOptions
from repro.core.engine import run as r_run
from repro.core.problems import bfs as r_bfs
from repro.data import rmat as RR
from repro.data.synthetic import skewed_graph as r_skewed_graph
from repro.kernels.csr_gather_reduce import ops as RO

import repro_torch.core.graph as TG
from repro_torch.core import partition as TPart
from repro_torch.core.engine import run
from repro_torch.core.problems import bfs
from repro_torch.data import RMATStream, materialize, rmat_chunks
from repro_torch.data.synthetic import skewed_graph
from repro_torch.kernels.csr_gather_reduce import ops as TO
from repro_torch.serve import DeltaBuffer

# every array field whose bytes define streaming == in-memory (the
# reference test's list)
IDENTITY_FIELDS = (
    "src_gidx", "dst_lidx", "valid", "weights", "bucket_sizes",
    "tile_word", "tile_word_hi", "tile_counts", "tile_weights",
    "tile_coverage", "tile_row_pos", "tile_row_orig", "tile_split_map",
    "push_word", "push_word_hi", "push_counts", "push_weights",
    "push_coverage",
)
SCALARS = ("p", "l", "sub_size", "num_vertices", "num_edges", "src_bits", "split_rows",
           "push_block", "push_src_bits", "tile_vb", "t_max_unsplit")


def assert_identical(a, b):
    """Two partitions (port or reference) equal byte for byte on every
    identity field, dtype included, and on the scalars."""
    for name in IDENTITY_FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype and va.shape == vb.shape, name
            assert va.tobytes() == vb.tobytes(), name
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


def _cfgs(**kw):
    return RPart.PartitionConfig(**kw), TPart.PartitionConfig(**kw)


def _pair(g):
    """(reference graph, port graph) of the same arrays."""
    return (RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=g.weights),
            TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=g.weights))


def _stream_both(g, chunk, **kw):
    """(port streaming, reference streaming, port in-memory) of ``g``."""
    rg, tg = _pair(g)
    rcfg, tcfg = _cfgs(**kw)
    ts = TPart.partition_2d_streaming(TPart.coo_edge_chunks(tg, chunk), g.num_vertices, tcfg)
    rs = RPart.partition_2d_streaming(RPart.coo_edge_chunks(rg, chunk), g.num_vertices, rcfg)
    return ts, rs, TPart.partition_2d(tg, tcfg)


def _hub_graph():
    """Two dominant hubs on a small vertex set: hub-row splitting under a low
    threshold (the reference test's graph)."""
    return skewed_graph(96, kind="star", hub_in_degree=600, num_hubs=2, seed=5)


def _sparse_graph(num_vertices, num_edges, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges).astype(np.uint32)
    dst = rng.integers(0, num_vertices, num_edges).astype(np.uint32)
    w = rng.random(num_edges).astype(np.float32) if weighted else None
    return TG.COOGraph(src=src, dst=dst, num_vertices=num_vertices, weights=w)


@pytest.mark.parametrize("kind", ["star", "powerlaw"])
def test_skewed_graph_matches_reference(kind):
    a = skewed_graph(200, kind=kind, hub_in_degree=300, num_hubs=3, seed=4)
    b = r_skewed_graph(200, kind=kind, hub_in_degree=300, num_hubs=3, seed=4)
    assert a.num_vertices == b.num_vertices and a.weights is None and b.weights is None
    for f in ("src", "dst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    with pytest.raises(ValueError, match="kind"):
        skewed_graph(10, kind="ring")


@pytest.mark.parametrize("gathered,block,eb", [(1000, 32, 8), (1000, 1000, 128), (70, 64, 4),
                                               (5, 32, 2)])
def test_plan_push_tiles_matches_reference(gathered, block, eb):
    counts = np.random.default_rng(gathered + block).integers(0, 40, gathered)
    got = TO.plan_push_tiles(counts, gathered_size=gathered, block_sources=block, eb=eb)
    want = RO.plan_push_tiles(counts, gathered_size=gathered, block_sources=block, eb=eb)
    assert got == want


@pytest.mark.parametrize("push_block,stride", [(None, None), (64, None), (1024, 3)])
def test_stream_push_footprint_counts_the_streamed_build(push_block, stride):
    """``stream_push_footprint`` counts, from one pass over the chunk stream,
    what the streaming build stacks and what ``push_footprint`` counts from
    the in-memory build's flat arrays."""
    from repro_torch.push_footprint import push_footprint, stream_push_footprint

    g = TG.symmetrize(TG.rmat(10, 8, seed=6))
    cfg = TPart.PartitionConfig(p=4, l=2, tile_vb=64, tile_eb=32, push_block=push_block,
                                stride=stride)
    chunks = TPart.coo_edge_chunks(g, 1000)
    (got,) = stream_push_footprint(chunks, g.num_vertices, cfg, [push_block], 32)
    built = TPart.partition_2d_streaming(chunks, g.num_vertices, cfg)
    flat = TPart.partition_2d(g, dataclasses.replace(cfg, build_tiles=False))
    assert got == push_footprint(flat, push_block, 32)
    assert got["shape"] == list(built.push_word.shape)
    assert got["block_sources"] == built.push_block
    words = built.push_word.nbytes + (built.push_word_hi.nbytes
                                      if built.push_word_hi is not None else 0)
    assert got["word_bytes"] == words
    assert got["coverage_bytes"] == built.push_coverage.nbytes
    assert got["real_tiles"] == int(built.push_counts.sum())


class TestChooseSrcBits:
    def test_src_boundary_exact(self):
        assert TO.SRC16_LIMIT == RO.SRC16_LIMIT == 1 << 16
        for gathered in (TO.SRC16_LIMIT, TO.SRC16_LIMIT + 1):
            assert TO.choose_src_bits(gathered, 128) == RO.choose_src_bits(gathered, 128)
        assert TO.choose_src_bits(TO.SRC16_LIMIT, 128) == 16
        assert TO.choose_src_bits(TO.SRC16_LIMIT + 1, 128) == 32

    def test_vb_boundary_exact(self):
        assert TO.DSTB16_LIMIT == RO.DSTB16_LIMIT
        for vb in (TO.DSTB16_LIMIT, TO.DSTB16_LIMIT + 1):
            assert TO.choose_src_bits(1024, vb) == RO.choose_src_bits(1024, vb)
        assert TO.choose_src_bits(1024, TO.DSTB16_LIMIT) == 16
        assert TO.choose_src_bits(1024, TO.DSTB16_LIMIT + 1) == 32

    def test_end_to_end_boundary(self):
        # V = 2^17, l = 2: gathered exactly 2^16, the last 16-bit layout;
        # V = 2^18 crosses into the two-word regime
        for v_log2, bits in ((17, 16), (18, 32)):
            g = _sparse_graph(1 << v_log2, 400, seed=3)
            ts, rs, tm = _stream_both(g, 64, p=2, l=2, tile_vb=1024, build_push=False)
            assert ts.p * ts.sub_size == (1 << v_log2) // 2
            assert ts.src_bits == bits and (ts.tile_word_hi is not None) == (bits == 32)
            assert_identical(ts, rs)
            assert_identical(ts, tm)


class TestStreamingIdentity:
    def test_split_map_mode(self):
        ts, rs, tm = _stream_both(_hub_graph(), 97, p=2, l=2, tile_vb=16, tile_eb=16,
                                  split_threshold=16)
        assert ts.tile_row_orig is not None and ts.split_rows > 0
        assert_identical(ts, rs)
        assert_identical(ts, tm)

    def test_row_pos_mode(self):
        ts, rs, tm = _stream_both(_hub_graph(), 97, p=2, l=2, tile_vb=16, tile_eb=16,
                                  split_threshold=None)
        assert ts.tile_row_orig is None and ts.tile_row_pos is not None
        assert_identical(ts, rs)
        assert_identical(ts, tm)

    @pytest.mark.parametrize("split_threshold", [16, None])
    def test_engine_labels_agree(self, split_threshold):
        g = _hub_graph()
        ts, rs, _ = _stream_both(g, 97, p=2, l=2, tile_vb=16, tile_eb=16,
                                 split_threshold=split_threshold)
        rg, tg = _pair(g)
        want = r_run(r_bfs(3), rg, rs, REngineOptions(backend="xla"))
        got = run(bfs(3), tg, ts, device="cpu")
        assert got.iterations == want.iterations
        np.testing.assert_array_equal(got.labels["label"], np.asarray(want.labels["label"]))

    def test_chunk_size_invariance(self):
        g = _sparse_graph(256, 900, seed=7, weighted=True)
        ts, rs, tm = _stream_both(g, 1 << 20, p=2, l=2, tile_vb=32)
        assert ts.weights is not None and ts.push_weights is not None
        assert_identical(ts, rs)
        assert_identical(ts, tm)
        for chunk in (1, 7, 113):
            other = TPart.partition_2d_streaming(TPart.coo_edge_chunks(_pair(g)[1], chunk),
                                                 g.num_vertices, TPart.PartitionConfig(
                                                     p=2, l=2, tile_vb=32))
            assert_identical(other, ts)

    def test_stride_permutation(self):
        ts, rs, tm = _stream_both(_sparse_graph(300, 700, seed=9), 41, p=2, l=2, stride=10)
        assert ts.perm is not None and np.array_equal(ts.perm, rs.perm)
        assert_identical(ts, rs)
        assert_identical(ts, tm)


class TestChunkProtocol:
    def test_one_shot_generator_rejected(self):
        g = _sparse_graph(64, 100)
        for mod in (TPart, RPart):
            gen = ((g.src[i:i + 10], g.dst[i:i + 10]) for i in range(0, 100, 10))
            with pytest.raises(TypeError, match="replay"):
                mod.partition_2d_streaming(gen, 64, mod.PartitionConfig(p=2, l=2))

    def test_list_of_chunks_accepted(self):
        g = _sparse_graph(64, 100, seed=2)
        chunks = [(g.src[i:i + 33], g.dst[i:i + 33]) for i in range(0, 100, 33)]
        rcfg, tcfg = _cfgs(p=2, l=2)
        ts = TPart.partition_2d_streaming(chunks, 64, tcfg)
        assert_identical(ts, RPart.partition_2d_streaming(tuple(chunks), 64, rcfg))
        assert_identical(ts, TPart.partition_2d(g, tcfg))

    def test_empty_graph_one_empty_chunk(self):
        g = TG.COOGraph(src=np.zeros(0, np.uint32), dst=np.zeros(0, np.uint32), num_vertices=64)
        assert len(list(TPart.coo_edge_chunks(g)())) == 1
        ts, rs, tm = _stream_both(g, 1 << 18, p=2, l=2)
        assert ts.num_edges == 0
        assert_identical(ts, rs)
        assert_identical(ts, tm)
        with pytest.raises(ValueError, match="positive"):
            TPart.coo_edge_chunks(g, 0)

    def test_mixed_weighted_chunks_rejected(self):
        s = np.arange(8, dtype=np.int64)
        w = np.ones(8, np.float32)
        chunks = [(s, s, w), (s, s)]
        with pytest.raises(ValueError, match="weight"):
            TPart.partition_2d_streaming(chunks, 64, TPart.PartitionConfig(p=2, l=2))
        with pytest.raises(ValueError, match="weights shape"):
            TPart.partition_2d_streaming([(s, s, w[:3])], 64, TPart.PartitionConfig(p=2, l=2))
        with pytest.raises(TypeError, match="tuple"):
            TPart.partition_2d_streaming([s], 64, TPart.PartitionConfig(p=2, l=2))

    def test_out_of_range_vertex_rejected(self):
        s = np.array([0, 70], dtype=np.int64)
        for mod in (TPart, RPart):
            with pytest.raises(ValueError, match="out of range"):
                mod.partition_2d_streaming([(s, s)], 64, mod.PartitionConfig(p=2, l=2))


class TestRMATStream:
    def test_deterministic_and_replayable(self):
        st = rmat_chunks(8, 8, seed=11, chunk_edges=500)
        ref = RR.rmat_chunks(8, 8, seed=11, chunk_edges=500)
        a = [(s.copy(), d.copy()) for s, d in st()]
        b = list(st())
        assert len(a) == st.num_chunks == ref.num_chunks
        for (sa, da), (sb, db), (sr, dr) in zip(a, b, ref()):
            assert sa.tobytes() == sb.tobytes() == sr.tobytes()
            assert da.tobytes() == db.tobytes() == dr.tobytes()
            assert sa.dtype == sr.dtype
        other = rmat_chunks(8, 8, seed=12, chunk_edges=500)
        assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, other()))

    def test_counts_and_bounds(self):
        st = RMATStream(scale=7, edge_factor=4, seed=3, symmetric=True, weighted=True)
        g = materialize(st)
        rg = RR.materialize(RR.RMATStream(scale=7, edge_factor=4, seed=3, symmetric=True,
                                          weighted=True))
        assert st.num_vertices == 1 << 7
        assert g.num_edges == st.num_edges == 2 * 4 * (1 << 7)
        assert int(g.src.max()) < st.num_vertices and int(g.dst.max()) < st.num_vertices
        for f in ("src", "dst", "weights"):
            assert getattr(g, f).tobytes() == getattr(rg, f).tobytes(), f
        with pytest.raises(ValueError, match="quadrant"):
            RMATStream(scale=4, a=0.6, b=0.3, c=0.2)

    def test_stream_is_valid_chunks_argument(self):
        st = rmat_chunks(8, 6, seed=5, chunk_edges=300, weighted=True)
        rst = RR.rmat_chunks(8, 6, seed=5, chunk_edges=300, weighted=True)
        rcfg, tcfg = _cfgs(p=2, l=2, tile_vb=32)
        ts = TPart.partition_2d_streaming(st, st.num_vertices, tcfg)
        assert_identical(ts, RPart.partition_2d_streaming(rst, rst.num_vertices, rcfg))
        assert_identical(ts, TPart.partition_2d(materialize(st), tcfg))


class TestMemmapAndDelta:
    def test_memmap_identical_and_runs(self, tmp_path):
        st = rmat_chunks(8, 8, seed=1, chunk_edges=400)
        rst = RR.rmat_chunks(8, 8, seed=1, chunk_edges=400)
        rcfg, tcfg = _cfgs(p=2, l=2, tile_vb=32)
        g = materialize(st)
        pm = TPart.partition_2d_streaming(st, st.num_vertices, tcfg,
                                          memmap_dir=str(tmp_path / "port"))
        assert isinstance(pm.tile_word, np.memmap) and isinstance(pm.src_gidx, np.memmap)
        rs = RPart.partition_2d_streaming(rst, rst.num_vertices, rcfg,
                                          memmap_dir=str(tmp_path / "ref"))
        assert_identical(pm, rs)
        assert_identical(pm, TPart.partition_2d(g, tcfg))
        rg = RR.materialize(rst)
        want = r_run(r_bfs(3), rg, rs, REngineOptions(backend="xla"))
        for opts in ({}, {"dynamic_tile_skip": False}):
            from repro_torch.core.engine import EngineOptions

            got = run(bfs(3), g, pm, EngineOptions(**opts), device="cpu")
            assert got.iterations == want.iterations
            np.testing.assert_array_equal(got.labels["label"], np.asarray(want.labels["label"]))

    def test_delta_flush_against_memmap_partition(self, tmp_path):
        # a flush against a memmap-backed partition equals the reference's
        # flush and a cold rebuild of the grown edge list, and aliases none
        # of the files (serve/delta.py)
        from repro.serve.delta import DeltaBuffer as RDeltaBuffer

        st = rmat_chunks(8, 8, seed=4, chunk_edges=300)
        rst = RR.rmat_chunks(8, 8, seed=4, chunk_edges=300)
        rcfg, tcfg = _cfgs(p=2, l=2, tile_vb=32)
        pm = TPart.partition_2d_streaming(st, st.num_vertices, tcfg,
                                          memmap_dir=str(tmp_path / "port"))
        rm = RPart.partition_2d_streaming(rst, rst.num_vertices, rcfg,
                                          memmap_dir=str(tmp_path / "ref"))
        new_src = np.array([1, 33, 200, 7], dtype=np.int64)
        new_dst = np.array([250, 2, 9, 7], dtype=np.int64)
        buf, rbuf = DeltaBuffer(pm), RDeltaBuffer(rm)
        buf.stage(new_src, new_dst)
        rbuf.stage(new_src, new_dst)
        new_pg, report = buf.flush(pm)
        r_pg, r_report = rbuf.flush(rm)
        assert report.edges_added == r_report.edges_added == 4
        assert not any(isinstance(getattr(new_pg, f), np.memmap)
                       for f in IDENTITY_FIELDS if getattr(new_pg, f) is not None)
        assert_identical(new_pg, r_pg)
        g = materialize(st)
        grown = TG.COOGraph(
            src=np.concatenate([g.src.astype(np.int64), new_src]).astype(np.uint32),
            dst=np.concatenate([g.dst.astype(np.int64), new_dst]).astype(np.uint32),
            num_vertices=g.num_vertices,
        )
        assert_identical(new_pg, TPart.partition_2d(grown, tcfg))


class TestMemoryReport:
    def test_totals_and_fields(self):
        g = _sparse_graph(256, 800, seed=6)
        rg, tg = _pair(g)
        rcfg, tcfg = _cfgs(p=2, l=2, tile_vb=32)
        pg = TPart.partition_2d(tg, tcfg)
        rep = pg.memory_report()
        assert rep == RPart.partition_2d(rg, rcfg).memory_report()
        assert rep["device_total_bytes"] == sum(rep["device"].values())
        assert rep["host_flat_total_bytes"] == sum(rep["host_flat"].values())
        assert rep["total_bytes"] == rep["device_total_bytes"] + rep["host_flat_total_bytes"]
        assert rep["device"]["tile_word"] == pg.tile_word.nbytes
        assert rep["bytes_per_edge"] > rep["device_bytes_per_edge"] > 0
        assert "push_word" in rep["device"]

    def test_pull_only_drops_push_fields(self):
        g = _sparse_graph(256, 800, seed=6)
        rg, tg = _pair(g)
        rcfg, tcfg = _cfgs(p=2, l=2, tile_vb=32, build_push=False)
        ps = TPart.partition_2d_streaming(TPart.coo_edge_chunks(tg, 100), 256, tcfg)
        rep = ps.memory_report()
        assert rep == RPart.partition_2d(rg, rcfg).memory_report()
        assert not any(k.startswith("push") for k in rep["device"])


def test_streaming_fields_are_the_dataclass_fields():
    """IDENTITY_FIELDS and the scalars cover every partition field but the
    carried config, the permutations (compared in test_stride_permutation)
    and the device cache."""
    names = {f.name for f in dataclasses.fields(TPart.PartitionedGraph)}
    covered = set(IDENTITY_FIELDS) | set(SCALARS) | {"config", "perm", "inv_perm",
                                                      "device_cache"}
    assert names == covered
