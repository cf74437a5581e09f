"""Card-only checks of the port: the CUDA kernels against their plain versions.

The gather kernel on its static and fetch-map arms, the scatter kernel on
both push regimes and both arms (min bit-equal, sum within ``SUM_TOL``),
each lane arm of both (the word OR of packed reach words, vector min with
the SSSP add, vector sum, and the lane-chunk path at vb=1024), and the
engine with its default options (dynamic tile skip, 'auto' direction) and
with forced push, laneless and K-lane, on the card against the CPU run; the
scatter on hand-made source runs (hub sources, L = 1 to 64, both push
regimes, odd tile widths) and on float min with -0.0, +0.0 and negatives
against the key order, and the gather's one-lane kernel on hand-made runs;
the embedding-bag kernel against its plain version (sum and mean, odd D, the
DIN width D = 18, B = 1, all-padding bags, a cold-table shape at a small N,
bit-stability, and bit for bit over B = 1 to 512, L = 1 to 100, D = 1 to
130, tables and ids off their aligned bases), its backward kernel bit for
bit against the plain version on the CPU (B = 1 to 512, L = 1 to 100, D = 1
to 130, hub ids, all padding, operands off their aligned bases, two runs)
and through autograd, DIN ``score`` / ``score_candidates`` and one DIN
train step on the card against the CPU run, and BFS on a memmap-backed
streaming partition; the segment-softmax kernel against its plain version (heads,
vb up to 8192, empty rows, all-invalid tiles, bit-stability) and GAT's
forward and backward on the card against the CPU run; the one-bucket
gather kernel against its plain version (every arm, plain, packed, split
and empty layouts, both sizes of source offset, T = 0) and, bit for bit,
against the emulation of its schedule in ``tests/_bucket_order.py`` on
hand-made runs (a hub row over several warp ranges, one-slot rows, whole
16-slot groups of padding, odd tile widths, unaligned operands), a split
hub row's partition and vb at the row limit; the flash-attention
kernel against its plain version and the float32 oracle (the reference's
sweep cases, ragged S, D = 12 to 128, a GQA group of 5, S = 1; float32 and
bf16), LM smoke configs' forward and grads on the card against the CPU run
(one launch a layer), and smollm-135m at published width against a
plain-attention run; the dry run's prediction held against the card on
one-card cells (din/serve_p99, a reduced granite-moe train and decode step).

Every test here needs an NVIDIA GPU (the kernel has no CPU mode) and skips
without one. The file imports neither jax nor ``repro``, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports the JAX reference.)
"""
import dataclasses

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
GNN_TOL = dict(rtol=1e-5, atol=1e-6)  # index_add_ sums in no fixed order on the card

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
    shared-memory layout against the device's limit per block: vb rows of
    Lc lanes, an odd stride apart where Lc is no multiple of 8, and for
    'sum' two staged run pieces a thread group)."""
    assert K.lane_chunk(1024, 16, "min") == 16  # 65 KiB: one block
    assert K.lane_chunk(1024, 16, "sum") == 16  # 74 KiB with the staged run pieces
    assert K.lane_chunk(1024, 56, "min") == 56  # the most that fits at vb = 1024
    assert K.lane_chunk(1024, 52, "min") == 52  # rows an odd stride (53) apart
    assert K.lane_chunk(1024, 52, "sum") == 52  # the most for sum
    assert K.lane_chunk(1024, 44, "sum") == 44
    # K = 64 at vb = 1024 needs 256 KiB: two chunks of 32 lanes
    assert K.lane_chunk(1024, 64, "min") == 32
    assert K.lane_chunk(1024, 48, "sum") == 48
    assert K.lane_chunk(64, 37, "min") == 13  # lanes one at a time: at most 16 a block
    for vb, lanes, kind in ((1024, 1024, "min"), (32, 1024, "sum"), (64, 3, "or")):
        lc = K.lane_chunk(vb, lanes, kind)
        chunks = -(-lanes // lc)
        assert lc * chunks >= lanes and lc * (chunks - 1) < lanes
    assert K.lane_chunk(32, 40, "or") == 40
    assert K.lane_chunk(K.smem_limit_rows(), 1, "sum") == 1
    with pytest.raises(ValueError, match="shared memory"):
        K.lane_chunk(1 << 16, 1, "min")


def _run_layout(rng, blocks, eb, g_size):
    """A 16-bit gather stream of one core from per-block row sequences in
    slot order (each row's slots one run, as the partition lays them out):
    word (1, R, T, Eb), counts (1, R), weights (1, R, T, Eb)."""
    r_blocks = len(blocks)
    t_tiles = max(1, max(-(-len(b) // eb) for b in blocks))
    word = np.zeros((1, r_blocks, t_tiles * eb), np.uint32)
    counts = np.zeros((1, r_blocks), np.int32)
    for r, rows in enumerate(blocks):
        rows = np.asarray(rows, np.uint32)
        src = rng.integers(0, g_size, rows.size).astype(np.uint32)
        word[0, r, : rows.size] = (1 << 31) | (rows << 16) | src
        counts[0, r] = -(-rows.size // eb)
    weights = rng.random(word.shape).astype(np.float32)
    shape = (1, r_blocks, t_tiles, eb)
    return (torch.from_numpy(word.view(np.int32).reshape(shape)), torch.from_numpy(counts),
            torch.from_numpy(weights.reshape(shape)))


def _edge_blocks(rng, vb):
    """Row blocks that stress the lane kernel's runs: one hub row over many
    tiles and warps among light rows, a block that is one row, rows of one
    slot each, an empty block, and dst-sorted random rows."""
    light = np.sort(rng.integers(8, 60, 90))
    return [
        [5] * 3000 + light.tolist() + [vb - 1] * 130,
        [0] * 700,
        rng.permutation(vb).tolist(),
        [],
        np.sort(rng.integers(0, vb, 900)).tolist(),
    ]


LANE_KINDS = {  # kind -> (payload kind, edge_op, identity)
    "or": ("words", "none", 0.0),
    "min_f32_add": ("dist", "add", INF_F32),
    "sum_f32": ("rank", "none", 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["static", "fetch"])
@pytest.mark.parametrize("lanes", [2, 3, 5, 16, 37, 64])
@pytest.mark.parametrize("kind", list(LANE_KINDS))
def test_cuda_lane_gather_runs(kind, lanes, arm, cuda_device):
    """The lane kernel on hand-made runs at vb = 1024 (a hub row, a one-row
    block, one-slot rows, an empty block): lanes one at a time (2, 3, 5, and
    37 in chunks of 13, 13, 11), in quads (16) and in two chunks of 32 (64);
    min and OR bit-equal, sum within SUM_TOL and the same bits twice."""
    vb, eb, g_size = 1024, 128, 4096
    rng = np.random.default_rng(lanes * 10 + len(kind))
    word, counts, weights = _run_layout(rng, _edge_blocks(rng, vb), eb, g_size)
    pkind, edge_op, identity = LANE_KINDS[kind]
    kw = dict(num_rows=word.shape[1] * vb, vb=vb, src_bits=16, kind=kind.split("_")[0],
              edge_op=edge_op, identity=identity)
    if pkind == "words":  # reach words of 32 * lanes sources, 15% set
        bits = rng.random((g_size, lanes, 32)) < 0.15
        w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        payload = u32.to_bits(w.astype(np.uint32))
    else:
        payload = _lane_payload(pkind, g_size, lanes, rng)
    fetch = _fetch(counts, word.shape[2], rng, share=0.5) if arm == "fetch" else None
    args = [payload, word, counts, None, weights if edge_op == "add" else None, fetch]
    want = K.gather_reduce_cores(*args, **kw)
    dev_args = _on(cuda_device, args)
    got = K.gather_reduce_cores(*dev_args, **kw)
    again = K.gather_reduce_cores(*dev_args, **kw)
    torch.cuda.synchronize()
    if kind == "sum_f32":
        torch.testing.assert_close(got.cpu(), want, **SUM_TOL)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(LANE_KINDS))
def test_cuda_lane_gather_without_the_run_property(kind, cuda_device):
    """Rows whose slots come back after other rows (no layout of the port
    does this): min and OR stay bit-equal (atomics), sum within SUM_TOL."""
    vb, eb, g_size, lanes = 256, 64, 2048, 16
    rng = np.random.default_rng(31)
    blocks = [rng.integers(0, 40, 2000).tolist(), ([3, 4] * 300) + [3] * 50]
    word, counts, weights = _run_layout(rng, blocks, eb, g_size)
    pkind, edge_op, identity = LANE_KINDS[kind]
    kw = dict(num_rows=word.shape[1] * vb, vb=vb, src_bits=16, kind=kind.split("_")[0],
              edge_op=edge_op, identity=identity)
    payload = (_lane_payload("words", g_size, 2, rng).repeat(1, 8) if pkind == "words"
               else _lane_payload(pkind, g_size, lanes, rng))
    args = [payload, word, counts, None, weights if edge_op == "add" else None, None]
    want = K.gather_reduce_cores(*args, **kw)
    got = K.gather_reduce_cores(*_on(cuda_device, args), **kw).cpu()
    if kind == "sum_f32":
        torch.testing.assert_close(got, want, **SUM_TOL)
    else:
        assert torch.equal(got, want)


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


# -- the push scatter and the one-lane gather on hand-made runs ----------------

def _push_layout(rng, cores, eb, src_bits):
    """A push stream of p cores from per-core lists of source blocks, each a
    list of (src, dst) edges laid out sorted by (src, dst), as
    prepare_push_tiles lays them: word, word_hi (32-bit regime, else None),
    counts and weights, (p, B, T, Eb)."""
    p, b_blocks = len(cores), max(len(c) for c in cores)
    t_tiles = max(1, max(-(-len(e) // eb) for c in cores for e in c))
    word = np.zeros((p, b_blocks, t_tiles * eb), np.uint32)
    hi = np.zeros_like(word)
    counts = np.zeros((p, b_blocks), np.int32)
    for c, blocks in enumerate(cores):
        for b, edges in enumerate(blocks):
            e = np.asarray(edges, np.uint32).reshape(-1, 2)
            e = e[np.lexsort((e[:, 1], e[:, 0]))]
            k = e.shape[0]
            if src_bits == 16:
                word[c, b, :k] = (1 << 31) | (e[:, 1] << 16) | e[:, 0]
            else:
                word[c, b, :k] = e[:, 0]
                hi[c, b, :k] = (1 << 31) | e[:, 1]
            counts[c, b] = -(-k // eb)
    shape = (p, b_blocks, t_tiles, eb)
    weights = torch.from_numpy(rng.random(shape).astype(np.float32))
    word_hi = torch.from_numpy(hi.view(np.int32).reshape(shape)) if src_bits == 32 else None
    word = torch.from_numpy(word.view(np.int32).reshape(shape))
    return word, word_hi, torch.from_numpy(counts), weights


def _push_blocks(rng, g_size, num_rows):
    """Two cores' source blocks that stress the scatter's source runs: a hub
    source with 3,000 destinations (runs across warps and tiles) then short
    runs, a row that 400 sources hit, one-slot runs, an empty block, and
    random edges."""
    bs = g_size // 4

    def fan(srcs, lo, hi):
        return [(s, int(d)) for s in srcs
                for d in rng.choice(num_rows, int(rng.integers(lo, hi)), replace=False)]

    hub = fan([5], 3000, 3001) + fan(range(6, 60), 1, 20)
    many = [(s, 7) for s in range(bs, bs + 400)] + fan(range(bs, bs + 400), 1, 3)
    one = [(s, int(rng.integers(0, num_rows))) for s in range(2 * bs, 2 * bs + 500)]
    rand = [(int(s), int(d)) for s, d in zip(rng.integers(3 * bs, g_size, 2000),
                                              rng.integers(0, num_rows, 2000))]
    return [[hub, many, one, []], [[], rand, fan([bs + 1], 2500, 2501), many]]


def _scatter_payload(pkind, n, lanes, rng):
    """A (G,) payload for lanes == 1 (a (G, 1) one for packed words), else
    (G, lanes): uint32 labels or reach words, or distances with negatives."""
    width = max(lanes, 1)
    if pkind == "words":  # 15% of the bits set
        bits = rng.random((n, width, 32)) < 0.15
        return u32.to_bits((bits.astype(np.uint64) << np.arange(32, dtype=np.uint64))
                           .sum(-1).astype(np.uint32))
    shape = (n,) if lanes == 1 else (n, width)
    if pkind == "labels":
        v = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        v[rng.random(shape) < 0.2] = INF_U32
        return u32.to_bits(v)
    v = (rng.random(shape) * 60 - 10).astype(np.float32)
    v[rng.random(shape) < 0.2] = INF_F32
    return torch.from_numpy(v)


SCATTER_KINDS = {  # kind -> (payload kind, reduce, edge_op, identity)
    "min_u32": ("labels", "min", "none", float(INF_U32)),
    "min_f32_add": ("dist", "min", "add", INF_F32),
    "or": ("words", "or", "none", 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["static", "fetch", "empty_fetch"])
@pytest.mark.parametrize("src_bits", [16, 32])
@pytest.mark.parametrize("lanes", [1, 2, 3, 5, 16, 37, 64])
@pytest.mark.parametrize("kind", list(SCATTER_KINDS))
def test_cuda_scatter_runs(kind, lanes, src_bits, arm, cuda_device):
    """The scatter kernel on hand-made source runs (a hub source with 3,000
    destinations over warps and tiles, a row 400 sources hit, one-slot runs,
    an empty block) in both push regimes: one lane a thread (1), one lane a
    thread in groups of 2, 4 and 8 (2, 3, 5; 37 in three lane passes), a
    quad a thread (16) and two quads a thread (64); an all-inactive fetch
    map leaves the identity. Bit-equal to the plain version."""
    g_size, num_rows, eb = 4096, 4096, 128
    rng = np.random.default_rng(lanes * 7 + src_bits + len(kind))
    word, hi, counts, weights = _push_layout(rng, _push_blocks(rng, g_size, num_rows), eb,
                                             src_bits)
    pkind, reduce, edge_op, identity = SCATTER_KINDS[kind]
    payload = _scatter_payload(pkind, g_size, lanes, rng)
    fetch = None
    if arm == "fetch":
        fetch = _fetch(counts, word.shape[2], rng, share=0.5)
    elif arm == "empty_fetch":
        fetch = torch.full(tuple(word.shape[:3]), -1, dtype=torch.int32)
    args = [payload, word, counts, hi, weights if edge_op == "add" else None, fetch]
    kw = dict(num_rows=num_rows, src_bits=src_bits, kind=reduce, edge_op=edge_op,
              identity=identity)
    want = S.scatter_reduce_cores(*args, **kw)
    got = S.scatter_reduce_cores(*_on(cuda_device, args), **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    if arm == "empty_fetch":  # nothing runs: every cell holds the identity
        ident = (torch.full_like(want, identity) if want.dtype == torch.float32 else
                 u32.to_bits(np.full(tuple(want.shape), int(identity), np.uint32)))
        assert torch.equal(want, ident)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3, 16])
@pytest.mark.parametrize("kind", list(SCATTER_KINDS))
def test_cuda_scatter_odd_tile_width(kind, lanes, cuda_device):
    """Tiles of eb = 30 slots: no 16-B loads of 4 slots (the lane kernel's
    scalar loads) and a pass shorter than a warp's 128 slots; bit-equal to
    the plain version on the fetch arm."""
    g_size, num_rows, eb = 4096, 4096, 30
    rng = np.random.default_rng(lanes + len(kind))
    word, hi, counts, weights = _push_layout(rng, _push_blocks(rng, g_size, num_rows), eb, 32)
    pkind, reduce, edge_op, identity = SCATTER_KINDS[kind]
    args = [_scatter_payload(pkind, g_size, lanes, rng), word, counts, hi,
            weights if edge_op == "add" else None, _fetch(counts, word.shape[2], rng, share=0.5)]
    kw = dict(num_rows=num_rows, src_bits=32, kind=reduce, edge_op=edge_op, identity=identity)
    want = S.scatter_reduce_cores(*args, **kw)
    got = S.scatter_reduce_cores(*_on(cuda_device, args), **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


def _key_order_min(vals, edges, num_rows, lanes):
    """numpy reference: each row's min over its edges' float32 values in
    f32_key order (negative floats reversed, -0.0 below +0.0), from INF_F32."""
    bits = vals.view(np.uint32).reshape(vals.shape[0], lanes)
    key = np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(np.uint32)
    inf = np.float32(INF_F32).view(np.uint32) | np.uint32(0x80000000)
    out = np.full((num_rows, lanes), inf, np.uint32)
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    np.minimum.at(out, e[:, 1], key[e[:, 0]])
    back = np.where(out & 0x80000000, out & 0x7FFFFFFF, ~out).astype(np.uint32)
    return back.view(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("src_bits", [16, 32])
@pytest.mark.parametrize("lanes", [1, 16])
def test_cuda_scatter_float_min_order(lanes, src_bits, cuda_device):
    """Float min with negative values, -0.0 and +0.0 (the sign-split
    atomics): bit-equal to the plain version on every row that does not get
    both -0.0 and +0.0, and on every row to a numpy min in f32_key order,
    the order of the keyed kernel before it: -1.0 < -0.0 < +0.0."""
    g_size, num_rows, eb = 4096, 4096, 128
    rng = np.random.default_rng(41 + lanes + src_bits)
    vals = (rng.random((g_size, lanes)) * 20 - 10).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = INF_F32
    vals[0], vals[1], vals[2] = -0.0, 0.0, -1.0
    vals[3] = np.float32(-1e-40)  # a negative denormal: below -0.0
    vals[10:2030:2], vals[11:2030:2] = -1.0, -0.0
    # rows whose slots read the identity in one batch and all lower it, -1.0
    # before -0.0, so -0.0 must not win a signed min: a hot row, and rows
    # fed by one pair of adjacent one-edge sources (decided by one batch)
    hot = [(s, 4086) for s in range(10, 2010)]
    pairs = [(s, 4040 + (s - 2010) // 2) for s in range(2010, 2030)]
    rand = [(int(s), int(d)) for s, d in zip(rng.integers(2030, g_size, 6000),
                                              rng.integers(0, 4000, 6000))]
    hand = [(0, 4080), (1, 4080), (2, 4080),  # -1.0
            (0, 4081), (1, 4081),             # -0.0 (mixes the zeros)
            (1, 4082), (9, 4082),             # +0.0 or below
            (0, 4083), (9, 4083),             # -0.0 or below
            (3, 4084), (0, 4084), (1, 4084),  # the denormal
            (1, 4085), (0, 4085)]             # -0.0 (mixes the zeros)
    edges = rand + hand + hot + pairs
    blocks = [[e for e in edges if e[0] // 1024 == b] for b in range(g_size // 1024)]
    word, hi, counts, _ = _push_layout(rng, [blocks], eb, src_bits)
    payload = torch.from_numpy(vals[:, 0].copy() if lanes == 1 else vals)
    kw = dict(num_rows=num_rows, src_bits=src_bits, kind="min", edge_op="none",
              identity=INF_F32)
    args = [payload, word, counts, hi, None, None]
    want = S.scatter_reduce_cores(*args, **kw)
    got = S.scatter_reduce_cores(*_on(cuda_device, args), **kw).cpu()
    ref = _key_order_min(vals, edges, num_rows, lanes).reshape(want.shape[1:])
    assert torch.equal(got[0].view(torch.int32), torch.from_numpy(ref.view(np.int32)))
    mixed = torch.zeros(num_rows, dtype=torch.bool)
    mixed[[4081, 4085]] = True
    assert torch.equal(got[0][~mixed].view(torch.int32), want[0][~mixed].view(torch.int32))
    row = got[0].view(torch.int32).reshape(num_rows, lanes)[:, 0]
    assert row[4080] == int(np.array(-1.0, np.float32).view(np.int32))
    assert row[4081] == -(2 ** 31)  # -0.0
    assert row[4085] == row[4081]
    assert torch.all(row[[4086] + list(range(4040, 4050))] == row[4080])  # -1.0


ONE_LANE_KINDS = {  # kind -> (payload kind, reduce, edge_op, identity)
    "min_u32": ("labels", "min", "none", float(INF_U32)),
    "min_f32_add": ("dist", "min", "add", INF_F32),
    "sum_f32": ("rank", "sum", "none", 0.0),
    "or_w1": ("words", "or", "none", 0.0),
}


def _one_lane_payload(pkind, n, rng):
    if pkind == "rank":
        return torch.from_numpy((rng.random(n) / n).astype(np.float32))
    return _scatter_payload(pkind, n, 1, rng)


def _one_lane_check(kind, args, kw, cuda_device):
    want = K.gather_reduce_cores(*args, **kw)
    dev_args = _on(cuda_device, args)
    got = K.gather_reduce_cores(*dev_args, **kw)
    again = K.gather_reduce_cores(*dev_args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "sum_f32":
        torch.testing.assert_close(got.cpu(), want, **SUM_TOL)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("eb", [128, 30])
@pytest.mark.parametrize("arm", ["static", "fetch"])
@pytest.mark.parametrize("kind", list(ONE_LANE_KINDS))
def test_cuda_one_lane_gather_runs(kind, arm, eb, cuda_device):
    """The one-lane kernel on hand-made runs at vb = 1024: a 3,000-slot hub
    row among light rows, a one-row block, one-slot rows, an empty block,
    dst-sorted random rows, 6,000 slots of runs ~6 long (several steps a
    warp, so runs end at thread, warp and step edges) and a 40,000-slot row
    over more tiles than one tile list holds; eb = 30 takes the scalar
    loads. min and OR bit-equal, sum within SUM_TOL and the same bits
    twice."""
    vb, g_size = 1024, 4096
    rng = np.random.default_rng(eb + len(kind) + len(arm))
    blocks = _edge_blocks(rng, vb) + [np.sort(rng.integers(0, vb, 6000)).tolist(),
                                      [9] * 40000 + [10] * 5]
    word, counts, weights = _run_layout(rng, blocks, eb, g_size)
    pkind, reduce, edge_op, identity = ONE_LANE_KINDS[kind]
    fetch = _fetch(counts, word.shape[2], rng, share=0.5) if arm == "fetch" else None
    args = [_one_lane_payload(pkind, g_size, rng), word, counts, None,
            weights if edge_op == "add" else None, fetch]
    kw = dict(num_rows=word.shape[1] * vb, vb=vb, src_bits=16, kind=reduce, edge_op=edge_op,
              identity=identity)
    _one_lane_check(kind, args, kw, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ONE_LANE_KINDS))
def test_cuda_one_lane_gather_on_split_hub_rows(kind, cuda_device):
    """A partition that splits a 3,000-edge hub row over virtual rows, every
    phase: min and OR bit-equal, sum within SUM_TOL and the same bits twice."""
    make, cfg = GRAPHS["hub_split"]
    pg = partition_2d(make(), PartitionConfig(**cfg))
    assert pg.tile_row_orig is not None  # the hub row was split
    pkind, reduce, edge_op, identity = ONE_LANE_KINDS[kind]
    rng = np.random.default_rng(23)
    kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
              kind=reduce, edge_op=edge_op, identity=identity)
    for m in range(pg.l):
        w = pg.tile_weights[:, m] if edge_op == "add" else None
        args = [_one_lane_payload(pkind, pg.gathered_size, rng),
                torch.from_numpy(pg.tile_word[:, m].copy()),
                torch.from_numpy(pg.tile_counts[:, m].copy()), None,
                None if w is None else torch.from_numpy(w.copy()), None]
        _one_lane_check(kind, args, kw, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ONE_LANE_KINDS))
def test_cuda_one_lane_gather_without_the_run_property(kind, cuda_device):
    """Rows whose slots come back after other rows (no layout of the port
    does this): min and OR stay bit-equal (atomics), sum within SUM_TOL."""
    vb, eb, g_size = 256, 64, 2048
    rng = np.random.default_rng(37)
    blocks = [rng.integers(0, 40, 2000).tolist(), ([3, 4] * 300) + [3] * 50]
    word, counts, weights = _run_layout(rng, blocks, eb, g_size)
    pkind, reduce, edge_op, identity = ONE_LANE_KINDS[kind]
    kw = dict(num_rows=word.shape[1] * vb, vb=vb, src_bits=16, kind=reduce, edge_op=edge_op,
              identity=identity)
    args = [_one_lane_payload(pkind, g_size, rng), word, counts, None,
            weights if edge_op == "add" else None, None]
    want = K.gather_reduce_cores(*args, **kw)
    got = K.gather_reduce_cores(*_on(cuda_device, args), **kw).cpu()
    if kind == "sum_f32":
        torch.testing.assert_close(got, want, **SUM_TOL)
    else:
        assert torch.equal(got, want)


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
    ("bulk", 10_000, 18, 20_000, 32, 0.3),  # past 4 waves of warps: half the loads in flight
    ("bulk_wide", 1000, 64, 9000, 33, 0.3),  # the same with float4 rows and scalar ids
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


BAG_SWEEP_B = [1, 2, 3, 31, 33, 512]
BAG_SWEEP_L = [1, 31, 32, 33, 100]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 18, 64, 130])
def test_cuda_embedding_bag_sweep(d, mode, cuda_device):
    """Every B of BAG_SWEEP_B x L of BAG_SWEEP_L at width d, with a third of
    the ids padding and one bag all padding: bit-equal to the plain version
    (both add each column in id order from +0), on an aligned table, on a
    table one float past an aligned base (one float a load) and with the ids
    one int past an aligned base (scalar id loads)."""
    rng = np.random.default_rng(d * 7 + len(mode))
    n = 3000
    base = torch.from_numpy(rng.standard_normal(n * d + 1).astype(np.float32)).to(cuda_device)
    tables = {"aligned": base[:n * d].view(n, d), "offset": base[1:].view(n, d)}
    for b in BAG_SWEEP_B:
        for length in BAG_SWEEP_L:
            ids = rng.integers(0, n, (b, length)).astype(np.int32)
            ids[rng.random(ids.shape) < 0.3] = -1
            ids[b // 2] = -1
            id_base = torch.full((b * length + 1,), -1, dtype=torch.int32, device=cuda_device)
            id_base[1:].copy_(torch.from_numpy(ids.reshape(-1)).to(cuda_device))
            id_views = {"aligned": torch.from_numpy(ids).to(cuda_device),
                        "offset": id_base[1:].view(b, length)}
            for tname, iname in (("aligned", "aligned"), ("offset", "aligned"),
                                 ("aligned", "offset")):
                table, idv = tables[tname], id_views[iname]
                got = embedding_bag(table, idv, mode=mode)
                want = embedding_bag_reference(table, idv, mode)
                torch.cuda.synchronize()
                where = f"B={b} L={length} table {tname} ids {iname}"
                assert got.shape == (b, d), where
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), where
                assert not got[b // 2].any(), where


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


BAG_BACKWARD_D = [1, 2, 3, 18, 64, 130]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", BAG_BACKWARD_D)
def test_cuda_embedding_bag_backward_sweep(d, mode, cuda_device):
    """The backward kernel bit for bit against its plain version run on the
    CPU (index_add_ there adds in (b, i) order), over B of BAG_SWEEP_B x L
    of BAG_SWEEP_L at width d: random ids with a third padding and one bag
    all padding, hub ids (one id in every slot), all padding; grad_out and
    the ids also one element past an aligned base; the same bits on a
    second launch."""
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_reference
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda

    rng = np.random.default_rng(d * 11 + len(mode))
    n = 700
    for b in BAG_SWEEP_B:
        for length in BAG_SWEEP_L:
            rand = rng.integers(0, n, (b, length)).astype(np.int32)
            rand[rng.random(rand.shape) < 0.3] = -1
            rand[b // 2] = -1
            cases = {"random": rand, "hub": np.full((b, length), 5, np.int32),
                     "padding": np.full((b, length), -1, np.int32)}
            scale = np.float32(10.0) ** rng.integers(-3, 3, (b, 1)).astype(np.float32)
            g = (rng.standard_normal((b, d)).astype(np.float32) * scale).astype(np.float32)
            g_base = torch.zeros(b * d + 1, device=cuda_device)
            g_base[1:].copy_(torch.from_numpy(g.reshape(-1)))
            g_views = {"aligned": torch.from_numpy(g).to(cuda_device),
                       "offset": g_base[1:].view(b, d)}
            for cname, ids in cases.items():
                id_base = torch.full((b * length + 1,), -1, dtype=torch.int32,
                                     device=cuda_device)
                id_base[1:].copy_(torch.from_numpy(ids.reshape(-1)))
                id_views = {"aligned": torch.from_numpy(ids).to(cuda_device),
                            "offset": id_base[1:].view(b, length)}
                want = embedding_bag_backward_reference(torch.from_numpy(g),
                                                        torch.from_numpy(ids), n, mode)
                for gname, iname in (("aligned", "aligned"), ("offset", "aligned"),
                                     ("aligned", "offset")):
                    where = f"{cname} B={b} L={length} grad_out {gname} ids {iname}"
                    before = EB.LAUNCHES.get(f"{mode}_backward", 0)
                    got = embedding_bag_backward_cuda(g_views[gname], id_views[iname], n, mode)
                    again = embedding_bag_backward_cuda(g_views[gname], id_views[iname], n, mode)
                    torch.cuda.synchronize()
                    assert EB.LAUNCHES[f"{mode}_backward"] == before + 2, where
                    assert got.shape == (n, d) and got.dtype == torch.float32, where
                    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), where
                    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), where


@pytest.mark.cuda
def test_cuda_embedding_bag_grad_through_the_op(cuda_device):
    """torch.autograd.grad through ops.embedding_bag on the card: one forward
    and one backward launch, the CPU's gradient bit for bit (untouched rows
    0), and no backward launch where the table needs no gradient; a table of
    no rows or no columns launches nothing."""
    rng = np.random.default_rng(5)
    n, d = 10_000, 18
    table = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    ids = rng.integers(0, n, (512, 32)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids = torch.from_numpy(ids)
    w = torch.from_numpy(rng.standard_normal((512, d)).astype(np.float32))
    for mode in ("sum", "mean"):
        grads = {}
        for dev in ("cpu", cuda_device):
            t = table.to(dev).requires_grad_(True)
            EB.reset_launch_counts()
            loss = (embedding_bag(t, ids.to(dev), mode) * w.to(dev)).sum()
            (grads[str(dev)],) = torch.autograd.grad(loss, t)
            if dev != "cpu":
                torch.cuda.synchronize()
                assert EB.LAUNCHES == {mode: 1, f"{mode}_backward": 1}
        assert torch.equal(grads["cuda"].cpu().view(torch.int32),
                           grads["cpu"].view(torch.int32))
    EB.reset_launch_counts()
    embedding_bag(table.to(cuda_device), ids.to(cuda_device))
    torch.cuda.synchronize()
    assert EB.LAUNCHES == {"sum": 1}
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda

    for rows, cols in ((0, 18), (5, 0)):
        out = embedding_bag_backward_cuda(torch.zeros(512, cols, device=cuda_device),
                                          ids.to(cuda_device).clamp(max=rows - 1), rows, "sum")
        assert out.shape == (rows, cols)
    assert EB.LAUNCHES == {"sum": 1}


@pytest.mark.cuda
def test_cuda_din_train_step_matches_cpu(cuda_device):
    """One DIN train step at the smoke config from the same weights on the
    card and on the CPU: the loss and every gradient within rtol 1e-5 (atol
    1e-8), cate_table's too, with one bag launch forward and one backward."""
    from repro_torch.configs.registry import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models.recsys import din
    from repro_torch.train import steps
    from repro_torch.train.optim import tree_flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("din").smoke()
    cpu = din.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = _tree_to(cpu, cuda_device)
    b = recsys_batch(0, 1, 256, cfg.seq_len, cfg.item_vocab, cfg.cate_vocab,
                     cfg.profile_bag_len)
    loss_fn = steps.make_din_loss(cfg)
    EB.reset_launch_counts()
    loss_g, grads_g = steps.value_and_grad(loss_fn, card, din.batch_to(b, cuda_device))
    torch.cuda.synchronize()
    assert EB.LAUNCHES == {"sum": 1, "sum_backward": 1}
    loss_c, grads_c = steps.value_and_grad(loss_fn, cpu, din.batch_to(b, "cpu"))
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-8)
    for got, want in zip(tree_flatten(grads_g)[0], tree_flatten(grads_c)[0]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(grads_g["cate_table"].cpu(), grads_c["cate_table"], rtol=1e-5,
                               atol=1e-8)
    assert grads_c["cate_table"].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pack_src_bits", [None, 32])
def test_cuda_bfs_on_memmap_streaming_partition(pack_src_bits, tmp_path, cuda_device):
    """partition_2d_streaming of an RMAT stream into memmap files, then BFS on
    the card (default options and the static schedule) against the in-memory
    build's labels on the card."""
    from repro_torch.core.partition import partition_2d_streaming
    from repro_torch.data import materialize, rmat_chunks

    st = rmat_chunks(11, 8, seed=2, chunk_edges=5000, symmetric=True)
    cfg = PartitionConfig(p=4, l=2, lane=8, tile_vb=64, pack_src_bits=pack_src_bits)
    pm = partition_2d_streaming(st, st.num_vertices, cfg, memmap_dir=str(tmp_path))
    assert isinstance(pm.tile_word, np.memmap)
    assert pm.src_bits == (32 if pack_src_bits else 16)
    g = materialize(st)
    pg = partition_2d(g, cfg)
    want = run(P.bfs(0), g, pg, device=cuda_device)
    for opts in (EngineOptions(), EngineOptions(dynamic_tile_skip=False)):
        got = run(P.bfs(0), g, pm, opts, device=cuda_device)
        assert got.iterations == want.iterations
        np.testing.assert_array_equal(got.labels["label"], want.labels["label"])


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


def _softmax_case(case, rng):
    """(dstb, valid, vb) of a softmax layout with each row's slots in one run."""
    if case == "gat_cora_layer1":  # (a): the Cora shape as GAT tiles it
        from repro_torch.kernels.segment_softmax.ops import build_edge_tiles
        from repro_torch.models.gnn.common import SOFTMAX_EB, softmax_vb

        g = G.symmetrize(G.rmat(12, 2, seed=0))
        pad = 16384 - g.num_edges
        dst = np.concatenate([g.dst, np.zeros(pad, g.dst.dtype)])
        mask = np.arange(16384) < g.num_edges
        vb = softmax_vb(g.num_vertices)
        t = build_edge_tiles(dst[rng.permutation(16384)], mask, g.num_vertices, vb=vb,
                             eb=SOFTMAX_EB).tiles
        return t.dstb.astype(np.int32), t.valid, vb
    vb, eb = {"hub_100k": (64, 256), "one_row_blocks": (32, 64),
              "one_slot_rows": (8192, 256), "empty_blocks": (16, 32)}[case]
    if case == "hub_100k":  # one row of 100,000 slots among light rows
        blocks = [[1] * 40 + [3] * 100_000 + [7] * 9 + [0] * 300]
    elif case == "one_row_blocks":
        blocks = [[0] * 5000, [17] * 3, [vb - 1] * 700]
    elif case == "one_slot_rows":
        blocks = [rng.permutation(vb).tolist(), rng.permutation(vb)[:5000].tolist()]
    else:
        blocks = [[], [2] * 40 + [5] * 3, [], [], [9] * 70, []]
    t_tiles = max(1, max(-(-len(b) // eb) for b in blocks))
    dstb = np.zeros((len(blocks), t_tiles * eb), np.int32)
    valid = np.zeros(dstb.shape, bool)
    for r, rows in enumerate(blocks):
        dstb[r, : len(rows)] = rows
        valid[r, : len(rows)] = True
    shape = (len(blocks), t_tiles, eb)
    return dstb.reshape(shape), valid.reshape(shape), vb


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gat_cora_layer1", "hub_100k", "one_row_blocks",
                                  "one_slot_rows", "empty_blocks"])
def test_cuda_segment_softmax_runs(case, cuda_device):
    """The kernel's fast path (each row's slots one run) against the plain
    version at GAT's Cora shape with H = 8 and on hand-made runs: a
    100,000-slot hub row, blocks that are one row, rows of one slot, empty
    row blocks. Within SOFTMAX_TOL, the same bits twice, 0 on padding."""
    from repro_torch.kernels.segment_softmax import kernel as SK

    rng = np.random.default_rng(len(case))
    dstb, valid, vb = _softmax_case(case, rng)
    heads = 8 if case == "gat_cora_layer1" else 2
    scores = ((rng.random((heads,) + dstb.shape) - 0.5) * 20).astype(np.float32)
    args = [torch.from_numpy(a) for a in (scores, dstb, valid)]
    want = SK.segment_softmax_tiles(*args, vb=vb)
    dev_args = [a.to(cuda_device) for a in args]
    got = SK.segment_softmax_tiles(*dev_args, vb=vb)
    again = SK.segment_softmax_tiles(*dev_args, vb=vb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, **SOFTMAX_TOL)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert not got.cpu()[:, ~torch.from_numpy(valid)].any()


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


def _bucket_arrays(rng, blocks, eb, g_size):
    """(R, T, Eb) src, dstb, valid and weights from each row block's rows in
    slot order (-1: a padding slot, which gets a random src and row 0)."""
    t_tiles = max([1] + [-(-len(b) // eb) for b in blocks])
    n = t_tiles * eb
    src = rng.integers(0, g_size, (len(blocks), n)).astype(np.int32)
    dstb = np.zeros((len(blocks), n), np.int32)
    valid = np.zeros((len(blocks), n), bool)
    for r, b in enumerate(blocks):
        b = np.asarray(b, np.int64)
        valid[r, :b.size] = b >= 0
        dstb[r, :b.size] = np.maximum(b, 0)
    weights = rng.random((len(blocks), n)).astype(np.float32)
    shape = (len(blocks), t_tiles, eb)
    return src.reshape(shape), dstb.reshape(shape), valid.reshape(shape), weights.reshape(shape)


def _bucket_payload(dtype, kind, g_size, rng):
    if dtype == np.uint32:
        v = rng.integers(0, 1 << 32, g_size, dtype=np.uint64).astype(np.uint32)
        v[rng.random(g_size) < 0.2] = INF_U32
        return v
    v = (rng.random(g_size) * (50 if kind == "min" else 1.0 / g_size)).astype(np.float32)
    if kind == "min":
        v[rng.random(g_size) < 0.2] = INF_F32
    return v


def _on_card(a, dev, offset):
    """A tensor on the card holding ``a``; ``offset``: a view one element
    past an aligned base (not 16-B aligned: the kernel's scalar loads)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return t.to(dev)
    base = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
    base[1:].copy_(t.reshape(-1).to(dev))
    return base[1:].view(t.shape)


def _bucket_check(variant, payload, arrays, vb, cuda_device, offset=False):
    """The kernel on one bucket against the plain version (min bit-equal,
    sum within SUM_TOL) and the emulation of its schedule (the same bits),
    and the same bits on a second launch."""
    from _bucket_order import emulate_bucket
    from repro_torch.kernels.csr_gather_reduce import bucket as B

    dtype, kind, edge_op, identity, weighted = BUCKET_VARIANTS[variant]
    src, dstb, valid, weights = arrays
    weights = weights if weighted else None
    pay = u32.to_bits(payload) if dtype == np.uint32 else torch.from_numpy(payload)
    kw = dict(num_rows=src.shape[0] * vb, vb=vb, kind=kind, edge_op=edge_op, identity=identity)
    host = [torch.from_numpy(np.ascontiguousarray(a)) if a is not None else None
            for a in (src, dstb, valid, weights)]
    want = B.gather_reduce_bucket_plain(pay, *host, **kw)
    dev = [_on_card(a, cuda_device, offset) if a is not None else None
           for a in (src, dstb, valid, weights)]
    key = K.variant_name(pay.dtype, kind, edge_op)
    before = B.LAUNCHES.get(key, 0)
    got = B.gather_reduce_bucket(pay.to(cuda_device), *dev, **kw)
    again = B.gather_reduce_bucket(pay.to(cuda_device), *dev, **kw)
    torch.cuda.synchronize()
    assert B.LAUNCHES[key] == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    emu_w = weights if weights is not None else (np.ones(src.shape, np.float32)
                                                  if edge_op == "add" else None)
    emu = emulate_bucket(payload, src, dstb, valid, emu_w, vb=vb, kind=kind, edge_op=edge_op,
                         identity=identity)
    got_np = got.cpu().numpy().view(np.uint32 if dtype == np.uint32 else np.float32)
    assert got_np.tobytes() == emu.tobytes()  # the schedule's association, bit for bit
    if kind == "sum":
        torch.testing.assert_close(got.cpu(), want, **SUM_TOL)
    else:
        assert torch.equal(got.cpu(), want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(BUCKET_VARIANTS))
@pytest.mark.parametrize("layout", ["runs", "odd_width", "misaligned"])
def test_cuda_gather_bucket_runs(layout, variant, cuda_device):
    """Hand-made row blocks at vb = 1024: a 10,000-slot hub row over several
    warp ranges and steps with its block's last run ending in the last slot,
    a one-row block, one-slot rows, an empty block, dst-sorted random rows,
    runs separated by whole 16-slot groups of padding (and a block of
    padding groups alone), and rows that end at a block's first slots.
    "odd_width": Eb = 30 (T * Eb % 4 != 0, scalar loads); "misaligned":
    every operand one element past an aligned base (scalar loads)."""
    vb, g_size = 1024, 1 << 17
    eb = 30 if layout == "odd_width" else 128
    rng = np.random.default_rng(len(layout) * 17 + len(variant))
    light = np.sort(rng.integers(8, vb, 240)).tolist()
    padded = []
    for k in range(60):
        padded += [k] * int(rng.integers(1, 40))
        padded += [-1] * (16 - len(padded) % 16 + 16)  # whole 16-slot groups of padding
    blocks = [[7] * 10000 + light, [3] * 5, list(range(1000)), [],
              np.sort(rng.integers(0, vb, 6000)).tolist(), padded, [-1] * 512 + [9] * 3,
              [0, 1, 1, 2] + [-1] * 60]
    arrays = _bucket_arrays(rng, blocks, eb, g_size)
    dtype, kind = BUCKET_VARIANTS[variant][:2]
    _bucket_check(variant, _bucket_payload(dtype, kind, g_size, rng), arrays, vb,
                  cuda_device, offset=layout == "misaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(BUCKET_VARIANTS))
def test_cuda_gather_bucket_on_split_hub_rows(variant, cuda_device):
    """Every bucket of a partition that splits a 3,000-edge hub row, tiled as
    chip_smoke.py's bucket phase tiles it: the raw kernel against the plain
    version and the emulation, and ops.gather_reduce (the level-2 fold) on
    the card against the CPU."""
    from repro_torch.core.partition import _bucket_split_threshold
    from repro_torch.kernels.csr_gather_reduce import ops as BO

    make, cfg = GRAPHS["hub_split"]
    pg = partition_2d(make(), PartitionConfig(**cfg))
    c, vpc, vb, eb = pg.config, pg.vertices_per_core, pg.tile_vb, pg.tile_word.shape[4]
    dtype, kind, edge_op, identity, weighted = BUCKET_VARIANTS[variant]
    rng = np.random.default_rng(29)
    split = 0
    for i in range(pg.p):
        for m in range(pg.l):
            tl = BO.prepare_tiles(
                pg.src_gidx[i, m], pg.dst_lidx[i, m], pg.valid[i, m], num_rows=vpc, vb=vb,
                eb=eb, weights=pg.weights[i, m], balance_rows=c.degree_aware_tiles,
                split_threshold=_bucket_split_threshold(c, int(pg.valid[i, m].sum()), vpc // vb))
            split += tl.row_orig is not None
            payload = _bucket_payload(dtype, kind, pg.gathered_size, rng)
            _bucket_check(variant, payload, (tl.src, tl.dstb, tl.valid, tl.weights), vb,
                          cuda_device)
            pay = u32.to_bits(payload) if dtype == np.uint32 else torch.from_numpy(payload)
            kw = dict(kind=kind, edge_op=edge_op, identity=identity)
            tw = tl if weighted else dataclasses.replace(tl, weights=None)
            want = BO.gather_reduce(pay, tw, **kw)
            got = BO.gather_reduce(pay.to(cuda_device), BO.layout_to(tw, cuda_device), **kw)
            if kind == "sum":
                torch.testing.assert_close(got.cpu(), want, **SUM_TOL)
            else:
                assert torch.equal(got.cpu(), want)
    assert split > 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["min_u32", "sum_f32"])
def test_cuda_gather_bucket_at_the_row_limit(variant, cuda_device):
    """vb at the most rows one block holds (the shared-memory accumulator):
    rows at both ends of the block reached; one row more is refused."""
    from repro_torch.kernels.csr_gather_reduce import bucket as B

    vb = B.max_rows()
    assert vb >= 1024
    rng = np.random.default_rng(41)
    rows = [0] * 3 + np.sort(rng.integers(1, vb - 1, 3000)).tolist() + [vb - 1] * 5
    arrays = _bucket_arrays(rng, [rows, [vb - 1]], 128, 4096)
    dtype, kind = BUCKET_VARIANTS[variant][:2]
    _bucket_check(variant, _bucket_payload(dtype, kind, 4096, rng), arrays, vb, cuda_device)
    src = torch.zeros(1, 1, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        B.gather_reduce_bucket(torch.ones(16, device=cuda_device), src, src, src.bool(),
                               num_rows=vb + 1, vb=vb + 1)


# -- the flash-attention kernel and the LM -----------------------------------

FLASH_F32_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's sweep tolerance
# bf16 out: the kernel and the plain version compute the same float32 values
# up to reassociation, so their bf16 roundings differ by at most one ulp
# (2^-7 of the value)
FLASH_BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)
FLASH_CASES = [  # b, hq, hkv, s, d, bq, bk, causal
    (2, 4, 2, 64, 16, 16, 16, True),  # tests/test_kernels.py's sweep ...
    (1, 8, 8, 128, 32, 32, 64, True),
    (2, 6, 3, 96, 8, 32, 32, False),
    (1, 4, 1, 64, 64, 64, 16, True),
    (1, 2, 2, 32, 128, 16, 32, True),  # ... and its chunked-twin case below
    (2, 4, 2, 64, 16, 16, 16, True),
    (2, 9, 3, 333, 64, 128, 64, True),  # smollm's heads, ragged S
    (1, 40, 8, 200, 128, 128, 64, True),  # qwen3-14b's group of 5, ragged S
    (1, 6, 3, 77, 12, 32, 32, False),  # D = 12, ragged, non-causal
    (3, 4, 4, 1, 64, 128, 128, True),  # S = 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk,causal", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(b, hq, hkv, s, d, bq, bk, causal, dtype, cuda_device):
    from repro_torch.kernels.flash_attention import gqa_attention_reference
    from repro_torch.kernels.flash_attention import kernel as FK

    rng = np.random.default_rng(s * 7 + d + hq)
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to(td)
               for h in (hq, hkv, hkv))
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    want = FK.flash_attention_tiles(q, k, v, **kw)  # the plain version on the CPU
    name = "f32" if dtype == "float32" else "bf16"
    before = FK.LAUNCHES.get(name, 0)
    got = FK.flash_attention_tiles(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    again = FK.flash_attention_tiles(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    assert FK.LAUNCHES[name] == before + 2
    assert got.shape == want.shape and got.dtype == td
    tol = FLASH_F32_TOL if dtype == "float32" else FLASH_BF16_TOL
    torch.testing.assert_close(got.cpu(), want, **tol)
    assert torch.equal(got, again)  # the same bits
    # the oracle in float32 on the same inputs, rounded to the output type
    oracle = gqa_attention_reference(q.float(), k.float(), v.float(), causal=causal).to(td)
    torch.testing.assert_close(got.cpu(), oracle, **tol)


# the bf16 kernel's tensor-core tiles: b, hq, hkv, s, d, bq, bk, causal,
# the largest |logit| (None: the default scale)
FLASH_BF16_CASES = [
    (1, 4, 2, 300, 128, 128, 64, True, None),  # D = 128 at block_q = 128
    (1, 8, 8, 200, 128, 128, 128, True, None),  # the largest tile
    (1, 32, 4, 160, 128, 64, 64, True, None),  # qwen3-moe's group of 8
    (2, 4, 2, 65, 64, 64, 64, True, None),  # S = block_k + 1: a partial diagonal block
    (1, 4, 2, 33, 32, 32, 32, False, None),  # S = block_k + 1, non-causal
    (1, 9, 3, 256, 64, 128, 64, True, 30.0),  # logits scaled to +-30
    (1, 4, 1, 96, 128, 64, 32, False, 30.0),
    (2, 4, 2, 100, 8, 32, 48, True, None),  # D = 8, padded to 16
    (1, 6, 3, 77, 12, 64, 16, True, None),  # D = 12: rows not a multiple of 16 B
    (1, 4, 2, 150, 40, 48, 80, True, None),  # D = 40 padded to 64; odd tile counts
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk,causal,logit_max", FLASH_BF16_CASES)
def test_cuda_flash_attention_bf16_tiles(b, hq, hkv, s, d, bq, bk, causal, logit_max,
                                         cuda_device):
    """The bf16 kernel against its plain version and the float32 oracle
    within one bf16 ulp, the same bits twice."""
    from repro_torch.kernels.flash_attention import gqa_attention_reference
    from repro_torch.kernels.flash_attention import kernel as FK

    rng = np.random.default_rng(s * 5 + d + hq + bk)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    scale = d ** -0.5
    if logit_max is not None:  # scale the logits so that the largest is +-logit_max
        qk = torch.einsum("bkgqd,bkcd->bkgqc", q.float().reshape(b, hkv, hq // hkv, s, d),
                          k.float())
        scale = logit_max / float(qk.abs().max())
    kw = dict(causal=causal, scale=scale, block_q=bq, block_k=bk)
    want = FK.flash_attention_tiles(q, k, v, **kw)  # the plain version on the CPU
    before = FK.LAUNCHES.get("bf16", 0)
    got = FK.flash_attention_tiles(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    again = FK.flash_attention_tiles(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["bf16"] == before + 2
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu(), want, **FLASH_BF16_TOL)
    assert torch.equal(got, again)
    oracle = gqa_attention_reference(q.float(), k.float(), v.float(), causal=causal,
                                     scale=scale).to(torch.bfloat16)
    torch.testing.assert_close(got.cpu(), oracle, **FLASH_BF16_TOL)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_cannot_launch(cuda_device):
    from repro_torch.kernels.flash_attention import kernel as FK

    q = torch.zeros(1, 4, 64, 128, device=cuda_device)
    with pytest.raises(ValueError, match="threads"):
        FK.flash_attention_tiles(q, q, q, block_q=256)
    h = q.to(torch.bfloat16)
    for bq, bk in ((256, 64), (64, 256), (24, 64), (64, 40)):
        with pytest.raises(ValueError, match="multiples of 16"):
            FK.flash_attention_tiles(h, h, h, block_q=bq, block_k=bk)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3)
        FK.flash_attention_tiles(t, t, t)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["qwen3-14b", "granite-moe-1b-a400m"])
def test_cuda_lm_forward_and_grads_match_cpu(arch_id, cuda_device):
    """An LM smoke config (float32; qk-norm or MoE) on the card (the flash
    kernel, one launch a layer) against the CPU run (its plain version):
    logits and every gradient."""
    from repro_torch.configs.registry import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import transformer as tfm
    from repro_torch.train import steps
    from repro_torch.train.optim import tree_flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch_id).smoke()
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in lm_batch(0, 0, 2, 200, cfg.vocab).items()}
    with torch.no_grad():
        want = tfm.forward(cpu, b["tokens"], cfg)[0]
    card = _tree_to(cpu, cuda_device)
    before = FK.LAUNCHES.get("f32", 0)
    with torch.no_grad():
        got = tfm.forward(card, b["tokens"].to(cuda_device), cfg)[0]
    torch.cuda.synchronize()
    assert FK.LAUNCHES["f32"] == before + cfg.n_layers  # the card never took plain
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    loss_fn = steps.make_lm_loss(cfg)
    lw, gw = steps.value_and_grad(loss_fn, cpu, b["tokens"], b["labels"])
    lg, gg = steps.value_and_grad(loss_fn, card, b["tokens"].to(cuda_device),
                                  b["labels"].to(cuda_device))
    torch.testing.assert_close(lg.cpu(), lw, rtol=1e-5, atol=1e-5)
    for a, w in zip(tree_flatten(gg)[0], tree_flatten(gw)[0]):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_cuda_smollm_full_width_forward_matches_plain_attention(cuda_device, monkeypatch):
    """smollm-135m at its published width (30 layers, bf16, seeded weights):
    30 kernel launches a forward, logits within 2e-2 (relative L2) of a run
    with the kernel's plain version."""
    from repro_torch.configs.registry import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import transformer as tfm

    cfg = get("smollm-135m").model
    params = tfm.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    toks = torch.from_numpy(lm_batch(0, 0, 2, 777, cfg.vocab)["tokens"]).to(cuda_device)
    before = FK.LAUNCHES.get("bf16", 0)
    with torch.no_grad():
        got = tfm.forward(params, toks, cfg)[0]
    torch.cuda.synchronize()
    assert FK.LAUNCHES["bf16"] == before + cfg.n_layers == before + 30
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())

    def plain(q, k, v, *, causal, scale, block_q, block_k):
        return FK.flash_attention_tiles_plain(q, k, v, causal=causal,
                                              scale=q.shape[-1] ** -0.5 if scale is None else scale,
                                              block_q=block_q, block_k=block_k)

    monkeypatch.setattr(FK, "flash_attention_tiles", plain)
    with torch.no_grad():
        want = tfm.forward(params, toks, cfg)[0]
    rel = torch.linalg.vector_norm((got.float() - want.float()).reshape(-1)) / \
        torch.linalg.vector_norm(want.float().reshape(-1))
    assert float(rel) <= 2e-2


def _nccl_engine_rank(rank, group):
    """One rank of the NCCL multi-channel engine: its card's BFS, WCC, SSSP
    and PageRank runs and the kernel launches it made."""
    from repro_torch.core.distributed import run_distributed, transport

    g = _with_weights(G.symmetrize(G.rmat(12, 8, seed=5)), 5)
    pg = partition_2d(g, PartitionConfig(p=4, l=2, tile_vb=64))
    K.reset_launch_counts()
    S.reset_launch_counts()
    out = {name: run_distributed(prob, g, pg, group, device="cuda")
           for name, prob in (("bfs", P.bfs(0)), ("wcc", P.wcc()), ("sssp", P.sssp(0)),
                              ("pagerank", P.pagerank()))}
    torch.cuda.synchronize()
    return ({k: (r.labels["label"], r.iterations) for k, r in out.items()},
            sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values()), transport(group),
            torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_distributed_engine_over_nccl_four_cards(cuda_device, tmp_path):
    """The multi-channel engine over NCCL at p = 4, one card a rank (it needs
    four cards and skips on fewer): every rank's labels and iterations
    equal the single-process engine's on one card (min problems bit for
    bit, PageRank within SUM_TOL), and every rank launched the kernels."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one card a rank")
    from repro_torch.launch.mesh import spawn_ranks

    got = spawn_ranks(_nccl_engine_rank, 4, backend="nccl", timeout=300, init_dir=tmp_path)
    g = _with_weights(G.symmetrize(G.rmat(12, 8, seed=5)), 5)
    pg = partition_2d(g, PartitionConfig(p=4, l=2, tile_vb=64))
    for name, prob in (("bfs", P.bfs(0)), ("wcc", P.wcc()), ("sssp", P.sssp(0)),
                       ("pagerank", P.pagerank())):
        want = run(prob, g, pg, device=cuda_device)
        for rank, (res, launches, how, card) in enumerate(got):
            assert how == "nccl" and card == rank and launches > 0
            lab, iters = res[name]
            assert iters == want.iterations, (name, rank)
            if name == "pagerank":
                np.testing.assert_allclose(lab, want.labels["label"], **SUM_TOL)
            else:
                assert np.array_equal(lab, want.labels["label"]), (name, rank)


# -- training infrastructure: checkpoints, compression, the sampled pipeline -----


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip_with_bf16(cuda_device, tmp_path):
    """CUDA leaves (float32, bf16, a 0-d int32 step) saved and restored: the
    same bits, back on the template's device in its dtype; a CPU template
    brings the same bits to the host."""
    from repro_torch.dist.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.optim import AdamWState

    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn((33, 17), generator=g, device=cuda_device)
    state = {"w": w, "h": w.to(torch.bfloat16),
             "opt": AdamWState(step=torch.tensor(7, dtype=torch.int32, device=cuda_device),
                               mu={"w": w * 0.5}, nu={"w": w * w})}
    save_checkpoint(str(tmp_path), 7, state, meta={"next_step": 7})
    for dev in (cuda_device, torch.device("cpu")):
        like = {"w": torch.zeros((33, 17), device=dev),
                "h": torch.zeros((33, 17), dtype=torch.bfloat16, device=dev),
                "opt": AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                                  mu={"w": torch.zeros((33, 17), device=dev)},
                                  nu={"w": torch.zeros((33, 17), device=dev)})}
        got, meta = restore_checkpoint(str(tmp_path), like)
        assert meta == {"next_step": 7} and isinstance(got["opt"], AdamWState)
        for key, a, b in (("w", got["w"], w), ("h", got["h"], state["h"]),
                          ("step", got["opt"].step, state["opt"].step),
                          ("nu", got["opt"].nu["w"], state["opt"].nu["w"])):
            assert a.device.type == dev.type and a.dtype == b.dtype, key
            bits = torch.int16 if a.dtype == torch.bfloat16 else a.dtype
            assert torch.equal(a.view(bits).cpu(), b.view(bits).cpu()), key


@pytest.mark.cuda
def test_cuda_compression_bit_equal_to_cpu(cuda_device):
    """int8 quantization (round half to even, the scale) and top-k (ties at
    the threshold kept) give the CPU's bits on CUDA tensors; the scale's
    quotient too over 512 seeded maxima (CUDA turns a division by a Python
    number into a product with its reciprocal, whose rounding can differ)."""
    from repro_torch.dist.compression import int8_compress, int8_decompress, topk_sparsify

    rng = np.random.default_rng(0)
    peaks = rng.standard_normal((512, 1)).astype(np.float32) * np.float32(10.0) ** \
        rng.integers(-6, 6, (512, 1)).astype(np.float32)
    rows = torch.from_numpy(peaks * rng.random((512, 33)).astype(np.float32))
    for r in range(512):
        assert int8_compress(rows[r].to(cuda_device))[1].cpu().view(torch.int32) == \
            int8_compress(rows[r])[1].view(torch.int32), r
    ties = (rng.integers(-40, 40, 600) / 2.0).astype(np.float32)
    ties[0] = 63.5
    for x in (rng.standard_normal(1_000_003).astype(np.float32),
              rng.standard_normal((576, 1536)).astype(np.float32) * 3e-3,
              ties, np.repeat(rng.standard_normal(25).astype(np.float32), 8),
              np.zeros(64, np.float32)):
        cpu, dev = torch.from_numpy(x), torch.from_numpy(x).to(cuda_device)
        (qc, sc), (qd, sd) = int8_compress(cpu), int8_compress(dev)
        assert torch.equal(qd.cpu(), qc) and sd.cpu().view(torch.int32) == sc.view(torch.int32)
        assert torch.equal(int8_decompress(qd, sd).cpu().view(torch.int32),
                           int8_decompress(qc, sc).view(torch.int32))
        for frac in (0.01, 0.1):
            (spc, mc), (spd, md) = topk_sparsify(cpu, frac), topk_sparsify(dev, frac)
            assert torch.equal(md.cpu(), mc)
            assert torch.equal(spd.cpu().view(torch.int32), spc.view(torch.int32))


@pytest.mark.cuda
def test_cuda_sampled_graphsage_step_matches_cpu(cuda_device):
    """One GraphSAGE train step on NeighborSampler batches that reach the
    card through ShardedLoader + prefetch (pinned memory, a side stream,
    the consumer waiting on the copy's event): the batch bit for bit the
    host's, the loss and gradients within GNN_TOL of the CPU's on the same
    batch (not the parameters after AdamW: its first update is ~lr *
    sign(g), which turns the card's reassociation of a near-zero gradient
    into a step of up to lr), and three train steps finite."""
    from repro_torch.configs.registry import get as get_arch
    from repro_torch.data.neighbor_sampler import NeighborSampler
    from repro_torch.data.pipeline import ShardedLoader, prefetch
    from repro_torch.models.gnn import archs
    from repro_torch.train import steps
    from repro_torch.train.optim import AdamWConfig, tree_flatten, tree_map

    g = G.symmetrize(G.rmat(14, 8, seed=2))
    sampler = NeighborSampler(g, fanouts=(15, 10), d_feat=602)
    cfg = get_arch("graphsage").model
    ocfg = AdamWConfig(lr=1e-3, total_steps=3, warmup_steps=1)
    step = steps.make_gnn_train_step(cfg, ocfg, task="node_class", loss_nodes=64)
    make = lambda seed, i: sampler.sample(seed, i, batch_nodes=64)  # noqa: E731
    it = prefetch(ShardedLoader(make, seed=0, device=cuda_device), depth=2)
    states = {}
    for dev in (cuda_device, torch.device("cpu")):
        gen = torch.Generator(device="cpu").manual_seed(0)
        params = archs.init(cfg, 602, 41, gen, "cpu")
        states[dev.type] = steps.init_train_state(tree_map(lambda t: t.to(dev), params), ocfg)
    batch, labels = next(it)
    host, host_lab = make(0, 0)
    assert batch.node_feat.device.type == "cuda"
    assert torch.equal(batch.node_feat.cpu(), host.node_feat)
    assert torch.equal(batch.edge_src.cpu(), host.edge_src)
    loss_fn = steps.make_gnn_loss(cfg, "node_class", loss_nodes=64)
    l_dev, g_dev = steps.value_and_grad(loss_fn, states["cuda"]["params"], batch, labels)
    l_cpu, g_cpu = steps.value_and_grad(loss_fn, states["cpu"]["params"], host,
                                        torch.from_numpy(host_lab))
    assert torch.allclose(l_dev.cpu(), l_cpu, **GNN_TOL)
    for a, b in zip(tree_flatten(g_dev)[0], tree_flatten(g_cpu)[0]):
        assert torch.allclose(a.cpu(), b, **GNN_TOL)
    got = states["cuda"]
    for b in [(batch, labels), next(it), next(it)]:
        got, m = step(got, *b)
        assert bool(torch.isfinite(m["loss"]))
    it.close()


# ---------------------------------------------------------------------------
# the launch tooling: the kernels' output rules on fake tensors, and the dry
# run's prediction held against the card


def _rule_cases(dev):
    """(name, launcher, real CUDA args, kwargs, launch counters) for each of
    the seven kernel entry points, at small shapes."""
    from repro_torch.kernels.csr_gather_reduce import bucket as B
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.segment_softmax import kernel as SK

    rng = np.random.default_rng(31)
    pg = partition_2d(G.symmetrize(G.rmat(9, 8, seed=5)),
                      PartitionConfig(p=2, l=2, tile_vb=64, build_push=True))
    m = 0
    pay = torch.from_numpy((rng.random(pg.gathered_size) / 7).astype(np.float32))
    gather = (pay, torch.from_numpy(pg.tile_word[:, m].copy()),
              torch.from_numpy(pg.tile_counts[:, m].copy()),
              None if pg.tile_word_hi is None else torch.from_numpy(pg.tile_word_hi[:, m].copy()))
    scatter = (pay, torch.from_numpy(pg.push_word[:, m].copy()),
               torch.from_numpy(pg.push_counts[:, m].copy()),
               None if pg.push_word_hi is None else torch.from_numpy(pg.push_word_hi[:, m].copy()))
    shape = (3, 4, 32)
    src = torch.from_numpy(rng.integers(0, 100, shape).astype(np.int32))
    dstb = torch.from_numpy(rng.integers(0, 16, shape).astype(np.int32))
    valid = torch.from_numpy(rng.random(shape) < 0.7)
    table = torch.from_numpy(rng.random((50, 18)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 50, (6, 9)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((2, 4, 40, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 2, 40, 16)).astype(np.float32))
    to = (lambda *ts: [t.to(dev) if t is not None else None for t in ts])
    return [
        ("gather_reduce_cores", K.gather_reduce_cores, to(*gather),
         dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
              kind="sum"), K.LAUNCHES),
        ("scatter_reduce_cores", S.scatter_reduce_cores, to(*scatter),
         dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits, kind="min",
              identity=INF_F32), S.LAUNCHES),
        ("gather_reduce", B.gather_reduce_bucket, to(pay[:100], src, dstb, valid),
         dict(num_rows=3 * 16, vb=16, kind="sum"), B.LAUNCHES),
        ("embedding_bag", EB.embedding_bag_cuda, to(table, ids) + ["sum"], {}, EB.LAUNCHES),
        ("embedding_bag_backward", embedding_bag_backward_cuda,
         to(torch.ones(6, 18), ids) + [50, "sum"], {}, EB.LAUNCHES),
        ("segment_softmax", SK.segment_softmax_tiles,
         to(torch.from_numpy(rng.standard_normal((2,) + shape).astype(np.float32)), dstb, valid),
         dict(vb=16), SK.LAUNCHES),
        ("flash_attention", FK.flash_attention_tiles, to(q, kv, kv.clone()),
         dict(block_q=32, block_k=32), FK.LAUNCHES),
    ]


@pytest.mark.cuda
def test_cuda_kernel_output_rules_match_the_kernels(cuda_device):
    """Each entry point on fake CUDA tensors (a dry run's trace) returns the
    kernel's output shape and dtype on the same inputs, launches nothing
    and counts no launch; the real call launches once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.fake import KernelWork, is_fake

    for name, fn, args, kw, counter in _rule_cases(cuda_device):
        before = sum(counter.values())
        with KernelWork() as real_work:
            got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert sum(counter.values()) == before + 1, name
        mode = FakeTensorMode()
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with mode, KernelWork() as fake_work:
            fake = fn(*fargs, **kw)
        assert is_fake(fake) and sum(counter.values()) == before + 1, name
        assert fake.shape == got.shape and fake.dtype == got.dtype, name
        assert fake.device == got.device, name
        assert fake_work.calls == real_work.calls == {name: 1}, name
        assert fake_work.flops == real_work.flops > 0 and fake_work.bytes == real_work.bytes, name


@pytest.mark.cuda
def test_cuda_dry_run_prediction_of_din_serve_p99(cuda_device, tmp_path):
    """din/serve_p99 traced fake on a one-rank mesh, then run on the card
    (its own process): FlopCounterMode's count equal to the trace's, the
    bag kernel's FLOPs equal, the card's peak within 1.10 x the prediction
    (the trace's peak plus the measured cuBLAS workspaces) + 64 MiB, and the
    bag kernel's own counter at one launch a run (the workspace run, the
    gated run and 3 timed runs)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--on-card",
                          "din/serve_p99"], capture_output=True, text=True, env=env, cwd=root,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    rec = [json.loads(ln)["on_card"] for ln in res.stdout.splitlines()
           if ln.startswith('{"on_card"')][0]
    assert rec["flops_equal"] and rec["card_aten_flops"] == rec["fake_aten_flops"] > 0
    assert rec["card_kernel_flops"] == rec["fake_kernel_flops"] > 0
    assert rec["card_peak_bytes"] <= 1.10 * rec["predicted_peak_bytes"] + 64 * 2 ** 20
    assert rec["predicted_peak_bytes"] == rec["traced_peak_bytes"] + rec["cublas_workspace_bytes"]
    assert rec["launches"] == {"embedding_bag": {"sum": 5}}


_MOE_ON_CARD = r'''
import dataclasses, json
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get
from repro_torch.launch.dryrun import check_on_card

a = get("granite-moe-1b-a400m")
arch = dataclasses.replace(a, model=dataclasses.replace(a.model, n_layers=2), shapes=(
    ShapeCell("train", "train", dict(seq=512, batch=4)),
    ShapeCell("decode", "decode", dict(seq=8192, batch=1))))
for shape in ("train", "decode"):
    print(json.dumps({"on_card": check_on_card(arch, shape, seed=0, device="cuda", reps=1)}))
'''


@pytest.mark.cuda
def test_cuda_dry_run_prediction_of_a_reduced_moe_cell(cuda_device):
    """granite-moe-1b-a400m at its published width cut to 2 layers, a train
    step (B = 4, S = 512) and a decode step against an 8,192-slot cache, each
    traced fake on a one-rank mesh and run on the card (its own process):
    FlopCounterMode's count and the flash kernel's FLOPs equal to the
    trace's, the card's peak within 1.10 x the prediction + 64 MiB."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _MOE_ON_CARD], capture_output=True, text=True,
                         env=env, cwd=root, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    recs = [json.loads(ln)["on_card"] for ln in res.stdout.splitlines()
            if ln.startswith('{"on_card"')]
    assert len(recs) == 2
    for rec in recs:
        assert rec["flops_equal"] and rec["card_aten_flops"] == rec["fake_aten_flops"] > 0
        assert rec["card_peak_bytes"] <= 1.10 * rec["predicted_peak_bytes"] + 64 * 2 ** 20, rec
    assert recs[0]["card_kernel_flops"] == recs[0]["fake_kernel_flops"] > 0
