"""Card-only checks of the port: the CUDA kernels against their plain versions.

The gather kernel on its static and fetch-map arms, the scatter kernel on
both push regimes and both arms (min bit-equal, sum within ``SUM_TOL``),
and the engine with its default options (dynamic tile skip, 'auto'
direction) and with forced push, on the card against the CPU run.

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
