"""Card-only checks of the port: the CUDA kernels against their plain versions.

The gather kernel on its static and fetch-map arms, the scatter kernel on
both push regimes and both arms (min bit-equal, sum within ``SUM_TOL``),
each lane arm of both (the word OR of packed reach words, vector min with
the SSSP add, vector sum, and the lane-chunk path at vb=1024), and the
engine with its default options (dynamic tile skip, 'auto' direction) and
with forced push, laneless and K-lane, on the card against the CPU run; the
embedding-bag kernel against its plain version (sum and mean, odd D, the
DIN width D = 18, B = 1, all-padding bags, a cold-table shape at a small N,
bit-stability) and DIN ``score`` / ``score_candidates`` on the card against
the CPU run; the segment-softmax kernel against its plain version (heads,
vb up to 8192, empty rows, all-invalid tiles, bit-stability) and GAT's
forward and backward on the card against the CPU run; the one-bucket
gather kernel against its plain version (every arm, plain, packed, split
and empty layouts, both sizes of source offset, T = 0).

Every test here needs an NVIDIA GPU (the kernel has no CPU mode) and skips
without one. The file imports neither jax nor ``repro``, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports the JAX reference.)
"""
import numpy as np
import pytest
import torch

import repro_torch.core.graph as G
from repro_torch.core import problems as P
from repro_torch.core import u32
from repro_torch.core import frontier_words as F
from repro_torch.core.engine import EngineOptions, run, run_frontier_trace
from repro_torch.core.partition import PartitionConfig, partition_2d
from repro_torch.kernels.csr_gather_reduce import kernel as K
from repro_torch.kernels.csr_gather_reduce import scatter as S
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_reference
from repro_torch.kernels.embedding_bag import kernel as EB

INF_U32 = 0xFFFFFFFF
INF_F32 = float(np.finfo(np.float32).max)
# the kernel sums warp-ordered, the plain version tile-ordered
SUM_TOL = dict(rtol=1e-5, atol=1e-9)

VARIANTS = {  # variant -> (kind, edge_op, identity)
    "min_u32": ("min", "none", float(INF_U32)),
    "min_f32_add": ("min", "add", INF_F32),
    "sum_f32": ("sum", "none", 0.0),
}


def _with_weights(g, seed):
    w = np.random.default_rng(seed).random(g.num_edges).astype(np.float32)
    return G.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


def _hub_graph(seed, weighted):
    """One dominant in-degree row over a uniform background: splits rows."""
    rng = np.random.default_rng(seed)
    n, hub_deg, bg = 512, 3000, 1000
    src = np.concatenate([rng.integers(0, n, hub_deg), rng.integers(0, n, bg)]).astype(np.uint32)
    dst = np.concatenate([np.full(hub_deg, 3), rng.integers(0, n, bg)]).astype(np.uint32)
    g = G.COOGraph(src=src, dst=dst, num_vertices=n)
    return _with_weights(g, seed) if weighted else g


GRAPHS = {
    "rmat10_16bit": (lambda: _with_weights(G.symmetrize(G.rmat(10, 8, seed=2)), 2),
                     dict(p=2, l=2, lane=8, tile_vb=64, build_push=False)),
    "rmat10_32bit": (lambda: G.symmetrize(G.rmat(10, 8, seed=3)),
                     dict(p=4, l=2, lane=8, tile_vb=16, pack_src_bits=32, build_push=False)),
    "hub_split": (lambda: _hub_graph(7, weighted=True),
                  dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32, build_push=False)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _payload(variant, n, rng):
    if variant == "min_u32":
        v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        v[rng.random(n) < 0.2] = INF_U32
        return u32.to_bits(v)
    if variant == "min_f32_add":
        v = (rng.random(n) * 50).astype(np.float32)
        v[rng.random(n) < 0.2] = INF_F32
        return torch.from_numpy(v)
    return torch.from_numpy((rng.random(n) / n).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_kernel_matches_plain(graph, variant, cuda_device):
    make, cfg = GRAPHS[graph]
    pg = partition_2d(make(), PartitionConfig(**cfg))
    kind, edge_op, identity = VARIANTS[variant]
    rng = np.random.default_rng(13)
    kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
              kind=kind, edge_op=edge_op, identity=identity)
    key = K.variant_name(torch.int32 if variant == "min_u32" else torch.float32, kind, edge_op)
    for m in range(pg.l):
        hi = pg.tile_word_hi[:, m] if pg.tile_word_hi is not None else None
        w = pg.tile_weights[:, m] if edge_op == "add" and pg.tile_weights is not None else None
        args = [_payload(variant, pg.gathered_size, rng), torch.from_numpy(pg.tile_word[:, m].copy()),
                torch.from_numpy(pg.tile_counts[:, m].copy()),
                None if hi is None else torch.from_numpy(hi.copy()),
                None if w is None else torch.from_numpy(w.copy())]
        want = K.gather_reduce_cores(*args, **kw)
        before = K.LAUNCHES.get(key, 0)
        got = K.gather_reduce_cores(
            *[a.to(cuda_device) if a is not None else None for a in args], **kw).cpu()
        assert K.LAUNCHES[key] == before + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        if kind == "sum":
            torch.testing.assert_close(got, want, **SUM_TOL)
        else:
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pname", ["bfs", "wcc", "sssp", "pagerank"])
def test_engine_on_card_matches_cpu(pname, cuda_device):
    problem = {"bfs": P.bfs(1), "wcc": P.wcc(), "sssp": P.sssp(1), "pagerank": P.pagerank()}[pname]
    g = _hub_graph(17, weighted=pname == "sssp")
    pg = partition_2d(g, PartitionConfig(p=2, l=2, lane=8, tile_vb=32, tile_eb=32))
    got = run(problem, g, pg, device=cuda_device)
    want = run(problem, g, pg, device="cpu")
    assert got.iterations == want.iterations and got.converged == want.converged
    a, b = got.labels["label"], want.labels["label"]
    assert a.dtype == b.dtype
    if problem.reduce_kind == "min":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **SUM_TOL)


def _fetch(counts, t_tiles, rng, share=0.3):
    """A seeded fetch map that keeps about ``share`` of the real tiles."""
    real = torch.arange(t_tiles).view(1, 1, -1) < counts.unsqueeze(-1)
    return F.active_fetch_map(real & torch.from_numpy(rng.random(tuple(real.shape)) < share))


@pytest.mark.cuda
@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_fetch_arm_matches_plain(graph, variant, cuda_device):
    make, cfg = GRAPHS[graph]
    pg = partition_2d(make(), PartitionConfig(**cfg))
    kind, edge_op, identity = VARIANTS[variant]
    rng = np.random.default_rng(14)
    kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
              kind=kind, edge_op=edge_op, identity=identity)
    for m in range(pg.l):
        hi = pg.tile_word_hi[:, m] if pg.tile_word_hi is not None else None
        w = pg.tile_weights[:, m] if edge_op == "add" and pg.tile_weights is not None else None
        counts = torch.from_numpy(pg.tile_counts[:, m].copy())
        args = [_payload(variant, pg.gathered_size, rng), torch.from_numpy(pg.tile_word[:, m].copy()),
                counts, None if hi is None else torch.from_numpy(hi.copy()),
                None if w is None else torch.from_numpy(w.copy()),
                _fetch(counts, pg.tile_word.shape[3], rng)]
        want = K.gather_reduce_cores(*args, **kw)
        got = K.gather_reduce_cores(
            *[a.to(cuda_device) if a is not None else None for a in args], **kw).cpu()
        if kind == "sum":
            torch.testing.assert_close(got, want, **SUM_TOL)
        else:
            assert torch.equal(got, want)


PUSH_GRAPHS = {
    "rmat10_16bit": (lambda: _with_weights(G.symmetrize(G.rmat(10, 8, seed=4)), 4),
                     dict(p=2, l=2, lane=8, tile_vb=64, push_block=128)),
    "rmat10_32bit": (lambda: _with_weights(G.symmetrize(G.rmat(10, 8, seed=5)), 5),
                     dict(p=4, l=2, lane=8, tile_vb=16, pack_src_bits=32)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["static", "fetch"])
@pytest.mark.parametrize("graph", list(PUSH_GRAPHS))
@pytest.mark.parametrize("variant", ["min_u32", "min_f32_add"])
def test_cuda_scatter_matches_plain(variant, graph, arm, cuda_device):
    make, cfg = PUSH_GRAPHS[graph]
    pg = partition_2d(make(), PartitionConfig(**cfg))
    _, edge_op, identity = VARIANTS[variant]
    rng = np.random.default_rng(15)
    kw = dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits, kind="min",
              edge_op=edge_op, identity=identity)
    key = K.variant_name(torch.int32 if variant == "min_u32" else torch.float32, "min", edge_op)
    for m in range(pg.l):
        hi = pg.push_word_hi[:, m] if pg.push_word_hi is not None else None
        w = pg.push_weights[:, m] if edge_op == "add" else None
        counts = torch.from_numpy(pg.push_counts[:, m].copy())
        args = [_payload(variant, pg.gathered_size, rng), torch.from_numpy(pg.push_word[:, m].copy()),
                counts, None if hi is None else torch.from_numpy(hi.copy()),
                None if w is None else torch.from_numpy(w.copy()),
                _fetch(counts, pg.push_word.shape[3], rng) if arm == "fetch" else None]
        want = S.scatter_reduce_cores(*args, **kw)
        before = S.LAUNCHES.get(key, 0)
        got = S.scatter_reduce_cores(
            *[a.to(cuda_device) if a is not None else None for a in args], **kw).cpu()
        assert S.LAUNCHES[key] == before + 1
        assert got.dtype == want.dtype and torch.equal(got, want)


def _shuffled_path(n=256, seed=11):
    perm = np.random.default_rng(seed).permutation(n).astype(np.uint32)
    a, b = perm[:-1], perm[1:]
    w = np.random.default_rng(seed).uniform(0.5, 2.0, 2 * (n - 1)).astype(np.float32)
    return G.COOGraph(src=np.concatenate([a, b]), dst=np.concatenate([b, a]), num_vertices=n,
                      weights=w)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["auto", "push"])
@pytest.mark.parametrize("pname", ["bfs", "wcc", "sssp"])
def test_dynamic_engine_on_card_matches_cpu(pname, direction, cuda_device):
    """The default options take both arms on a shuffled path (a thin
    wavefront): the same labels, iterations and schedule as on the CPU."""
    problem = {"bfs": P.bfs(0), "wcc": P.wcc(), "sssp": P.sssp(0)}[pname]
    g = _shuffled_path()
    pg = partition_2d(g, PartitionConfig(p=2, l=2, lane=8, tile_vb=32, tile_eb=32))
    opts = EngineOptions(direction=direction)
    S.reset_launch_counts()
    got = run(problem, g, pg, opts, device=cuda_device)
    assert sum(S.LAUNCHES.values()) > 0
    want = run(problem, g, pg, opts, device="cpu")
    assert got.iterations == want.iterations and got.converged
    np.testing.assert_array_equal(got.labels["label"], want.labels["label"])
    tg = run_frontier_trace(problem, g, pg, opts, device=cuda_device)
    tc = run_frontier_trace(problem, g, pg, opts, device="cpu")
    assert tg["direction"] == tc["direction"] and "push" in tg["direction"]
    assert tg["dynamic_skipped_tile_fraction"] == tc["dynamic_skipped_tile_fraction"]


# -- multi-query lane arms -----------------------------------------------------

# lane variant -> (kind, edge_op, identity, lanes, payload kind)
LANE_VARIANTS = {
    "or_w1": ("or", "none", 0.0, 1, "words"),  # K = 16: one packed reach word
    "or_w2": ("or", "none", 0.0, 2, "words"),  # K = 40: a full and a partial word
    "min_f32_add_l16": ("min", "add", INF_F32, 16, "dist"),
    "sum_f32_l16": ("sum", "none", 0.0, 16, "rank"),
    "min_f32_add_l64": ("min", "add", INF_F32, 64, "dist"),  # lane chunks at vb=1024
    "sum_f32_l48": ("sum", "none", 0.0, 48, "rank"),  # lane chunks at vb=1024
}

LANE_GRAPHS = {
    "rmat10_16bit": GRAPHS["rmat10_16bit"],
    "rmat10_32bit": GRAPHS["rmat10_32bit"],
    "hub_split": GRAPHS["hub_split"],
    # vb = 1024, the smoke partition's row block: 64 lanes need two chunks
    "rmat12_vb1024": (lambda: _with_weights(G.symmetrize(G.rmat(12, 8, seed=6)), 6),
                      dict(p=2, l=2, lane=8, tile_vb=1024, build_push=False)),
}


def _lane_payload(pkind, n, lanes, rng):
    if pkind == "words":
        k = 16 if lanes == 1 else 40
        bits = rng.random((n, 32 * lanes)) < 0.15
        bits[:, k:] = False
        w = (bits.reshape(n, lanes, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64))
        return u32.to_bits(w.sum(axis=-1).astype(np.uint32))
    if pkind == "dist":
        v = (rng.random((n, lanes)) * 50).astype(np.float32)
        v[rng.random((n, lanes)) < 0.2] = INF_F32
        return torch.from_numpy(v)
    return torch.from_numpy((rng.random((n, lanes)) / n).astype(np.float32))


def _on(dev, args):
    return [a.to(dev) if a is not None else None for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["static", "fetch"])
@pytest.mark.parametrize("variant", list(LANE_VARIANTS))
@pytest.mark.parametrize("graph", list(LANE_GRAPHS))
def test_cuda_lane_gather_matches_plain(graph, variant, arm, cuda_device):
    """Each lane arm of the gather kernel against its plain version: min and
    OR bit-equal, sum within ``SUM_TOL`` and the same bits on a second
    launch (lane-ordered, warp-ordered partials)."""
    make, cfg = LANE_GRAPHS[graph]
    pg = partition_2d(make(), PartitionConfig(**cfg))
    kind, edge_op, identity, lanes, pkind = LANE_VARIANTS[variant]
    rng = np.random.default_rng(16)
    kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
              kind=kind, edge_op=edge_op, identity=identity)
    payload_dtype = torch.int32 if pkind == "words" else torch.float32
    key = K.variant_name(payload_dtype, kind, edge_op, lanes=True)
    for m in range(pg.l):
        hi = pg.tile_word_hi[:, m] if pg.tile_word_hi is not None else None
        w = pg.tile_weights[:, m] if edge_op == "add" and pg.tile_weights is not None else None
        counts = torch.from_numpy(pg.tile_counts[:, m].copy())
        args = [_lane_payload(pkind, pg.gathered_size, lanes, rng),
                torch.from_numpy(pg.tile_word[:, m].copy()), counts,
                None if hi is None else torch.from_numpy(hi.copy()),
                None if w is None else torch.from_numpy(w.copy()),
                _fetch(counts, pg.tile_word.shape[3], rng) if arm == "fetch" else None]
        want = K.gather_reduce_cores(*args, **kw)
        before = K.LAUNCHES.get(key, 0)
        dev_args = _on(cuda_device, args)
        got = K.gather_reduce_cores(*dev_args, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES[key] == before + 1
        got = got.cpu()
        assert got.dtype == want.dtype and got.shape == want.shape
        if kind == "sum":
            torch.testing.assert_close(got, want, **SUM_TOL)
            again = K.gather_reduce_cores(*dev_args, **kw).cpu()
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        else:
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["static", "fetch"])
@pytest.mark.parametrize("graph", list(PUSH_GRAPHS))
@pytest.mark.parametrize("variant", ["or_w1", "or_w2", "min_f32_add_l16"])
def test_cuda_lane_scatter_matches_plain(variant, graph, arm, cuda_device):
    make, cfg = PUSH_GRAPHS[graph]
    pg = partition_2d(make(), PartitionConfig(**cfg))
    kind, edge_op, identity, lanes, pkind = LANE_VARIANTS[variant]
    rng = np.random.default_rng(17)
    kw = dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits, kind=kind,
              edge_op=edge_op, identity=identity)
    payload_dtype = torch.int32 if pkind == "words" else torch.float32
    key = K.variant_name(payload_dtype, kind, edge_op, lanes=True)
    for m in range(pg.l):
        hi = pg.push_word_hi[:, m] if pg.push_word_hi is not None else None
        w = pg.push_weights[:, m] if edge_op == "add" else None
        counts = torch.from_numpy(pg.push_counts[:, m].copy())
        args = [_lane_payload(pkind, pg.gathered_size, lanes, rng),
                torch.from_numpy(pg.push_word[:, m].copy()), counts,
                None if hi is None else torch.from_numpy(hi.copy()),
                None if w is None else torch.from_numpy(w.copy()),
                _fetch(counts, pg.push_word.shape[3], rng) if arm == "fetch" else None]
        want = S.scatter_reduce_cores(*args, **kw)
        before = S.LAUNCHES.get(key, 0)
        got = S.scatter_reduce_cores(*_on(cuda_device, args), **kw).cpu()
        assert S.LAUNCHES[key] == before + 1
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pname,direction", [("bfs_multi", "auto"), ("bfs_multi", "push"),
                                             ("sssp_multi", "auto"), ("sssp_multi", "push"),
                                             ("ppr_multi", "auto")])
def test_lane_engine_on_card_matches_cpu(pname, direction, cuda_device):
    """K-lane runs on the card against the CPU run: BFS/SSSP labels bit-equal,
    PPR within ``SUM_TOL`` and the same bits on a second card run (sum
    problems stay pull, so PPR has no forced-push case)."""
    g = _shuffled_path() if pname != "ppr_multi" else _hub_graph(19, weighted=False)
    pg = partition_2d(g, PartitionConfig(p=2, l=2, lane=8, tile_vb=32, tile_eb=32))
    roots = np.random.default_rng(20).integers(0, g.num_vertices, 20)
    problem = getattr(P, pname)(roots)
    opts = EngineOptions(direction=direction, lanes=20)
    K.reset_launch_counts()
    S.reset_launch_counts()
    got = run(problem, g, pg, opts, device=cuda_device)
    assert sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values()) == got.iterations * pg.l
    want = run(problem, g, pg, opts, device="cpu")
    assert got.iterations == want.iterations and got.converged
    for k, b in want.labels.items():
        a = got.labels[k]
        assert a.dtype == b.dtype and a.shape == b.shape
        if pname == "ppr_multi" and k == "label":
            np.testing.assert_allclose(a, b, **SUM_TOL)
            again = run(problem, g, pg, opts, device=cuda_device).labels[k]
            assert a.tobytes() == again.tobytes()
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_lane_chunk_splits_only_what_does_not_fit(cuda_device):
    """The gather launcher's lane chunk on the card (the kernel's own
    shared-memory layout against the device's limit per block)."""
    assert K.lane_chunk(1024, 16, "min") == 16  # 64 KiB: one block
    assert K.lane_chunk(1024, 16, "sum") == 16  # 80 KiB with the staged values
    assert K.lane_chunk(1024, 56, "min") == 56  # the most that fits at vb = 1024
    assert K.lane_chunk(1024, 44, "sum") == 44
    # K = 64 at vb = 1024 needs 256 KiB: two chunks of 32 lanes
    assert K.lane_chunk(1024, 64, "min") == 32
    assert K.lane_chunk(1024, 48, "sum") == 24
    for vb, lanes, kind in ((1024, 1024, "min"), (32, 1024, "sum"), (64, 3, "or")):
        lc = K.lane_chunk(vb, lanes, kind)
        chunks = -(-lanes // lc)
        assert lc * chunks >= lanes and lc * (chunks - 1) < lanes
    assert K.lane_chunk(32, 40, "or") == 40
    assert K.lane_chunk(K.smem_limit_rows(), 1, "sum") == 1
    with pytest.raises(ValueError, match="shared memory"):
        K.lane_chunk(1 << 16, 1, "min")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_laneless_is_the_one_lane_case(variant, cuda_device):
    """A laneless (G,) payload and its (G, 1) view launch the same kernel on
    the same memory: the same bits, counted under their own variants."""
    make, cfg = GRAPHS["rmat10_16bit"]
    pg = partition_2d(make(), PartitionConfig(**dict(cfg, build_push=True)))
    kind, edge_op, identity = VARIANTS[variant]
    rng = np.random.default_rng(21)
    payload = _payload(variant, pg.gathered_size, rng).to(cuda_device)
    streams = [(K, K.gather_reduce_cores, pg.tile_word, pg.tile_counts, pg.tile_weights,
                dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits))]
    if kind == "min":
        streams.append((S, S.scatter_reduce_cores, pg.push_word, pg.push_counts,
                        pg.push_weights,
                        dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits)))
    for mod, fn, word, counts, weights, kw in streams:
        for m in range(pg.l):
            w = weights[:, m] if edge_op == "add" else None
            args = _on(cuda_device, [torch.from_numpy(word[:, m].copy()),
                                     torch.from_numpy(counts[:, m].copy()), None,
                                     None if w is None else torch.from_numpy(w.copy())])
            kw2 = dict(kw, kind=kind, edge_op=edge_op, identity=identity)
            before = dict(mod.LAUNCHES)
            flat = fn(payload, *args, **kw2)
            lane = fn(payload.view(-1, 1), *args, **kw2)
            torch.cuda.synchronize()
            flat_key = K.variant_name(payload.dtype, kind, edge_op)
            lane_key = K.variant_name(payload.dtype, kind, edge_op, lanes=True)
            assert mod.LAUNCHES[flat_key] == before.get(flat_key, 0) + 1
            assert mod.LAUNCHES[lane_key] == before.get(lane_key, 0) + 1
            assert lane.shape == flat.shape + (1,)
            assert torch.equal(lane[..., 0].view(torch.int32), flat.view(torch.int32))


# ---------------------------------------------------------------------------
# the embedding bag and DIN

BAG_TOL = dict(rtol=1e-5, atol=1e-7)  # both sum in id order: in fact the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case,n,d,b,length,pad", [
    ("din_profile", 10_000, 18, 512, 32, 0.3),  # float2 rows
    ("odd_width", 1000, 7, 37, 9, 0.3),  # scalar loads
    ("width_16", 1000, 16, 64, 20, 0.3),  # float4 rows
    ("wide", 300, 200, 33, 40, 0.1),  # several column chunks a lane
    ("one_bag", 10_000, 18, 1, 32, 0.3),
    ("cold_table_small_n", 200_003, 18, 256, 100, 0.0),  # scattered rows past L2 reuse
    ("long_bags", 5000, 18, 9, 1000, 0.5),
])
def test_cuda_embedding_bag_matches_plain(case, n, d, b, length, pad, mode, cuda_device):
    rng = np.random.default_rng(len(case) * 31 + d)
    table = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_device)
    ids = rng.integers(0, n, (b, length)).astype(np.int32)
    ids[rng.random(ids.shape) < pad] = -1
    if b > 2:
        ids[2] = -1  # an all-padding bag
    ids = torch.from_numpy(ids).to(cuda_device)
    before = EB.LAUNCHES.get(mode, 0)
    got = embedding_bag(table, ids, mode=mode)
    torch.cuda.synchronize()
    assert EB.LAUNCHES[mode] == before + 1
    want = embedding_bag_reference(table, ids, mode)
    assert got.shape == (b, d) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **BAG_TOL)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if b > 2:
        assert not got[2].any()
    again = embedding_bag(table, ids, mode=mode)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))  # the same bits
    cpu = embedding_bag(table.cpu(), ids.cpu(), mode=mode)  # the plain version on the CPU
    torch.testing.assert_close(got.cpu(), cpu, **BAG_TOL)


@pytest.mark.cuda
def test_cuda_embedding_bag_edges(cuda_device):
    """No bags: nothing launched; empty bags: zeros; an offset table view
    falls back to narrower loads; a launch never falls back to the plain
    version."""
    table = torch.randn(100, 18, device=cuda_device)
    before = dict(EB.LAUNCHES)
    out = embedding_bag(table, torch.zeros(0, 5, dtype=torch.int32, device=cuda_device))
    assert out.shape == (0, 18) and EB.LAUNCHES == before
    empty = embedding_bag(table, torch.zeros(3, 0, dtype=torch.int32, device=cuda_device),
                          mode="mean")
    assert empty.shape == (3, 18) and not empty.any()
    base = torch.randn(100 * 16 + 1, device=cuda_device)
    view = base[1:].view(100, 16)  # 4-B aligned rows: scalar loads
    ids = torch.randint(-1, 100, (7, 11), dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(embedding_bag(view, ids), embedding_bag_reference(view, ids),
                               **BAG_TOL)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.t().contiguous().t(), ids.clamp(max=17))


@pytest.mark.cuda
def test_din_on_card_matches_cpu(cuda_device):
    """DIN at the smoke config with the same weights on the card and on the
    CPU: logits and candidate scores within rtol 1e-5, atol 1e-6, one
    embedding-bag launch per call."""
    from repro_torch.configs.registry import get
    from repro_torch.data.synthetic import recsys_batch, retrieval_batch
    from repro_torch.dist.embedding import make_crossbar_lookup
    from repro_torch.models.recsys import din

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 matmuls on both sides
    cfg = get("din").smoke()
    cpu = din.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = {k: (v.to(cuda_device) if torch.is_tensor(v) else
                {kk: [t.to(cuda_device) for t in vv] for kk, vv in v.items()})
            for k, v in cpu.items()}
    b = recsys_batch(0, 0, 512, cfg.seq_len, cfg.item_vocab, cfg.cate_vocab, cfg.profile_bag_len)
    b = {k: v for k, v in b.items() if k != "labels"}
    rb = retrieval_batch(0, cfg.seq_len, 4096, cfg.item_vocab, cfg.cate_vocab,
                         cfg.profile_bag_len)
    EB.reset_launch_counts()
    got = din.score(card, din.batch_to(b, cuda_device), cfg)
    got_c = din.score_candidates(card, din.batch_to(rb, cuda_device), cfg, chunk=512,
                                 lookup_fn=make_crossbar_lookup())
    torch.cuda.synchronize()
    assert EB.LAUNCHES == {"sum": 2}
    want = din.score(cpu, din.batch_to(b, "cpu"), cfg)
    want_c = din.score_candidates(cpu, din.batch_to(rb, "cpu"), cfg, chunk=512)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_c.cpu(), want_c, rtol=1e-5, atol=1e-6)


# -- the segment-softmax kernel and GAT --------------------------------------

SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-7)  # online rescaling vs the plain version's final max


@pytest.mark.cuda
@pytest.mark.parametrize("heads,r_blocks,t_tiles,eb,vb,fill", [
    (1, 4, 3, 16, 8, 0.85),
    (8, 8, 5, 256, 512, 0.7),  # GAT layer 1 at a small graph
    (3, 2, 40, 128, 8192, 0.9),  # the most rows a block holds
    (8, 3, 2, 64, 64, 0.0),  # every slot padding
    (2, 5, 7, 32, 16, 0.3),  # empty rows and all-invalid tiles
])
def test_cuda_segment_softmax_matches_plain(heads, r_blocks, t_tiles, eb, vb, fill, cuda_device):
    from repro_torch.kernels.segment_softmax import kernel as SK

    rng = np.random.default_rng(heads * 7 + vb)
    shape = (r_blocks, t_tiles, eb)
    dstb = rng.integers(0, max(1, vb // 2), shape).astype(np.int32)  # upper rows stay empty
    valid = rng.random(shape) < fill
    valid[:, -1] = False  # an all-invalid tile in every block
    dstb[0, 0, : eb // 2] = 1  # one heavy row
    scores = ((rng.random((heads,) + shape) - 0.5) * 20).astype(np.float32)
    args = [torch.from_numpy(a) for a in (scores, dstb, valid)]
    want = SK.segment_softmax_tiles(*args, vb=vb)  # the plain version on the CPU
    before = SK.LAUNCHES.get("f32", 0)
    got = SK.segment_softmax_tiles(*[a.to(cuda_device) for a in args], vb=vb)
    again = SK.segment_softmax_tiles(*[a.to(cuda_device) for a in args], vb=vb)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["f32"] == before + 2
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, **SOFTMAX_TOL)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))  # the same bits
    assert not got.cpu()[:, ~torch.from_numpy(valid)].any()
    plain = SK.segment_softmax_tiles_plain(*[a.to(cuda_device) for a in args], vb=vb)
    torch.testing.assert_close(got, plain, **SOFTMAX_TOL)


@pytest.mark.cuda
def test_cuda_gat_forward_and_backward_match_plain(cuda_device):
    """GAT at the smoke config with non-zero attention on the card (the
    softmax kernel) against the CPU run (its plain version): outputs and
    every parameter's gradient."""
    import repro_torch.core.graph as TG
    from repro_torch.configs.registry import get
    from repro_torch.data.synthetic import graph_batch_from_coo
    from repro_torch.kernels.segment_softmax import kernel as SK
    from repro_torch.models.gnn import archs
    from repro_torch.train.optim import tree_flatten, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("gat-cora").smoke()
    g = TG.symmetrize(TG.rmat(10, 8, seed=4))
    b, _ = graph_batch_from_coo(g.src, g.dst, g.num_vertices, 12, seed=4)
    cpu = archs.init(cfg, 12, 5, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):
        cpu[k] = torch.randn(cpu[k].shape, generator=gen) * 0.5
    coef = torch.randn(g.num_vertices, 5, generator=gen)

    def run(params, batch):
        leaves, rebuild = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        out = archs.apply(rebuild(live), batch, cfg)
        grads = torch.autograd.grad((out * coef.to(out.device)).sum(), live)
        return out.detach().cpu(), [x.cpu() for x in grads]

    want_out, want_g = run(cpu, b)
    before = SK.LAUNCHES.get("f32", 0)
    got_out, got_g = run(tree_map(lambda t: t.to(cuda_device), cpu), b.to(cuda_device))
    assert SK.LAUNCHES["f32"] == before + 2  # one per layer: the card never took plain
    torch.testing.assert_close(got_out, want_out, rtol=1e-5, atol=1e-5)
    for a, w in zip(got_g, want_g):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


# -- the one-bucket gather kernel -------------------------------------------

BUCKET_VARIANTS = {  # variant -> (payload dtype, kind, edge_op, identity, weights)
    "min_u32": (np.uint32, "min", "none", float(INF_U32), False),
    "min_f32": (np.float32, "min", "none", INF_F32, False),
    "min_f32_add": (np.float32, "min", "add", INF_F32, True),
    "min_f32_add_unit": (np.float32, "min", "add", INF_F32, False),
    "sum_f32": (np.float32, "sum", "none", 0.0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("g_size", [4096, 1 << 17])  # within and past 16-bit source offsets
@pytest.mark.parametrize("variant", list(BUCKET_VARIANTS))
@pytest.mark.parametrize("layout", ["plain", "packed", "split", "empty"])
def test_cuda_gather_bucket_matches_plain(layout, variant, g_size, cuda_device):
    from repro_torch.kernels.csr_gather_reduce import bucket as B
    from repro_torch.kernels.csr_gather_reduce.ops import gather_reduce, layout_to, prepare_tiles

    dtype, kind, edge_op, identity, weighted = BUCKET_VARIANTS[variant]
    rng = np.random.default_rng(len(layout) * 101 + g_size)
    v, vb, eb = 2048, 256, 128
    e = 0 if layout == "empty" else 20_000
    dst = np.sort(np.concatenate([np.full(e // 4, 17), rng.integers(0, v, e - e // 4)]))
    dst = dst.astype(np.int32)
    src = rng.integers(0, g_size, e).astype(np.int32)
    valid = rng.random(e) < 0.9
    w = rng.random(e).astype(np.float32) if weighted else None
    tiles = prepare_tiles(src, dst, valid, num_rows=v, vb=vb, eb=eb, weights=w,
                          balance_rows=layout != "plain",
                          split_threshold=eb if layout == "split" else None)
    if dtype == np.uint32:
        pay = rng.integers(0, 1 << 32, g_size, dtype=np.uint64).astype(np.uint32)
        pay[rng.random(g_size) < 0.2] = INF_U32
        payload = u32.to_bits(pay)
    else:
        pay = (rng.random(g_size) * 50).astype(np.float32)
        if kind == "min":
            pay[rng.random(g_size) < 0.2] = INF_F32
        payload = torch.from_numpy(pay)
    kw = dict(kind=kind, edge_op=edge_op, identity=identity)
    want = gather_reduce(payload, tiles, **kw)
    key = K.variant_name(payload.dtype, kind, edge_op)
    before = B.LAUNCHES.get(key, 0)
    dev_tiles = layout_to(tiles, cuda_device)
    got = gather_reduce(payload.to(cuda_device), dev_tiles, **kw)
    again = gather_reduce(payload.to(cuda_device), dev_tiles, **kw)
    torch.cuda.synchronize()
    assert B.LAUNCHES[key] == before + 2
    assert got.shape == want.shape == (v,) and got.dtype == want.dtype
    if kind == "sum":
        torch.testing.assert_close(got.cpu(), want, **SUM_TOL)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))  # the same bits
    else:
        assert torch.equal(got.cpu(), want)
    if layout == "empty":
        ident = u32.to_bits(np.full(v, INF_U32, np.uint32)) if dtype == np.uint32 else \
            torch.full((v,), identity)
        assert torch.equal(got.cpu(), ident)


@pytest.mark.cuda
def test_cuda_gather_bucket_without_tiles_writes_the_identity(cuda_device):
    from repro_torch.kernels.csr_gather_reduce import bucket as B

    empty = torch.zeros(4, 0, 8, dtype=torch.int32, device=cuda_device)
    out = B.gather_reduce_bucket(torch.ones(16, device=cuda_device), empty, empty,
                                 empty.bool(), num_rows=64, vb=16, identity=3.0)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), torch.full((64,), 3.0))
    tall = torch.zeros(1, 1, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):  # vb rows past shared memory
        B.gather_reduce_bucket(torch.ones(16, device=cuda_device), tall, tall, tall.bool(),
                               num_rows=1 << 17, vb=1 << 17)
