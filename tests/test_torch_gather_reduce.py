"""The port's gather-reduce kernel entry against the reference Pallas kernel.

On CPU tensors ``repro_torch``'s ``gather_reduce_cores`` runs its plain
PyTorch version; it must agree with ``repro``'s
``gather_reduce_cores_pallas(..., interpret=True)`` on the same packed
arrays: min exactly (uint32 BFS/WCC payloads, float32 SSSP payloads with the
saturating weight add), sum within rtol=1e-6, atol=1e-9 — the reference's
own Pallas-vs-XLA tolerance (tests/test_engine_fused.py), on the static tile
counts and on seeded fetch maps (the dynamic tile skip). The CUDA kernel
itself is checked against the plain version by tests/test_torch_cuda.py,
which skips on machines without a card, and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.graph as RG
from repro.core import frontier_words as RF
from repro.core.partition import PartitionConfig as RConfig
from repro.core.partition import partition_2d as r_partition
from repro.data.synthetic import skewed_graph
from repro.kernels.csr_gather_reduce.kernel import gather_reduce_cores_pallas
from repro.kernels.csr_gather_reduce.ops import combine_split_rows as r_combine

from repro_torch.core import u32
from repro_torch.kernels.csr_gather_reduce import kernel as K
from repro_torch.kernels.csr_gather_reduce.ops import combine_split_rows as t_combine

INF_U32 = 0xFFFFFFFF
INF_F32 = float(np.finfo(np.float32).max)
SUM_TOL = dict(rtol=1e-6, atol=1e-9)

# variant -> (kind, edge_op, identity)
VARIANTS = {
    "min_u32": ("min", "none", float(INF_U32)),
    "min_f32_add": ("min", "add", INF_F32),
    "min_f32": ("min", "none", INF_F32),
    "sum_f32": ("sum", "none", 0.0),
}


def _weighted(g, seed):
    w = np.random.default_rng(seed).random(g.num_edges).astype(np.float32)
    return RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


GRAPHS = {
    "rmat9_16bit": (lambda: _weighted(RG.symmetrize(RG.rmat(9, 6, seed=2)), 2),
                    dict(p=2, l=2, lane=4, tile_vb=16)),
    "rmat9_32bit": (lambda: _weighted(RG.symmetrize(RG.rmat(9, 6, seed=3)), 3),
                    dict(p=4, l=2, lane=4, tile_vb=8, pack_src_bits=32, build_push=False)),
    "hub_split": (lambda: _weighted(skewed_graph(512, kind="star", hub_in_degree=2000,
                                                 avg_degree=2, seed=3), 7),
                  dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32, build_push=False)),
}


def _payload(variant, n, rng):
    if variant == "min_u32":
        v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        v[rng.random(n) < 0.2] = INF_U32
        return v
    if variant.startswith("min_f32"):
        v = (rng.random(n) * 50).astype(np.float32)
        v[rng.random(n) < 0.2] = INF_F32
        return v
    return (rng.random(n) / n).astype(np.float32)


def _to_port(a):
    return u32.to_bits(a) if a.dtype == np.uint32 else torch.from_numpy(np.array(a))


def _from_port(t):
    return u32.from_bits(t) if t.dtype == torch.int32 else t.numpy()


def _phase_args(pg, m, with_weights):
    word = pg.tile_word[:, m]
    hi = pg.tile_word_hi[:, m] if pg.tile_word_hi is not None else None
    w = pg.tile_weights[:, m] if with_weights else None
    return word, pg.tile_counts[:, m], hi, w


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_reference_kernel(graph, variant):
    make, cfg = GRAPHS[graph]
    pg = r_partition(make(), RConfig(**cfg))
    kind, edge_op, identity = VARIANTS[variant]
    rng = np.random.default_rng(11)
    for m in range(pg.l):
        word, counts, hi, w = _phase_args(pg, m, with_weights=edge_op == "add")
        payload = _payload(variant, pg.gathered_size, rng)
        kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
                  kind=kind, edge_op=edge_op, identity=identity)
        want = np.asarray(gather_reduce_cores_pallas(
            jnp.asarray(payload), jnp.asarray(word), jnp.asarray(counts),
            None if hi is None else jnp.asarray(hi), None if w is None else jnp.asarray(w),
            interpret=True, **kw))
        got = K.gather_reduce_cores(
            _to_port(payload), _to_port(word), _to_port(counts),
            None if hi is None else _to_port(hi), None if w is None else _to_port(w), **kw)
        got = _from_port(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        if kind == "sum":
            np.testing.assert_allclose(got, want, **SUM_TOL)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fetch_arm_matches_reference_kernel(graph, variant):
    """The dynamic arm: a tile runs iff fetch[c, r, t] == t, with a seeded
    map that keeps about 30% of the real tiles."""
    make, cfg = GRAPHS[graph]
    pg = r_partition(make(), RConfig(**cfg))
    kind, edge_op, identity = VARIANTS[variant]
    rng = np.random.default_rng(12)
    for m in range(pg.l):
        word, counts, hi, w = _phase_args(pg, m, with_weights=edge_op == "add")
        real = np.arange(word.shape[2])[None, None, :] < counts[..., None]
        fetch = np.asarray(RF.active_fetch_map(jnp.asarray(real & (rng.random(real.shape) < 0.3))))
        payload = _payload(variant, pg.gathered_size, rng)
        kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
                  kind=kind, edge_op=edge_op, identity=identity)
        want = np.asarray(gather_reduce_cores_pallas(
            *(None if a is None else jnp.asarray(a) for a in (payload, word, counts, hi, w, fetch)),
            interpret=True, **kw))
        got = K.gather_reduce_cores(
            *(None if a is None else _to_port(a) for a in (payload, word, counts, hi, w, fetch)),
            **kw)
        got = _from_port(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        if kind == "sum":
            np.testing.assert_allclose(got, want, **SUM_TOL)
        else:
            np.testing.assert_array_equal(got, want)


def test_sssp_unit_weights_without_weight_stream():
    """edge_op='add' with no weight array adds 1.0, as the reference does."""
    make, cfg = GRAPHS["rmat9_16bit"]
    pg = r_partition(make(), RConfig(**cfg))
    word, counts, _, _ = _phase_args(pg, 0, with_weights=False)
    payload = _payload("min_f32_add", pg.gathered_size, np.random.default_rng(5))
    kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=16,
              kind="min", edge_op="add", identity=INF_F32)
    want = np.asarray(gather_reduce_cores_pallas(
        jnp.asarray(payload), jnp.asarray(word), jnp.asarray(counts), interpret=True, **kw))
    got = K.gather_reduce_cores(_to_port(payload), _to_port(word), _to_port(counts), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,dtype", [("min", np.uint32), ("min", np.float32), ("sum", np.float32)])
def test_combine_split_rows_matches_reference(kind, dtype):
    make, cfg = GRAPHS["hub_split"]
    pg = r_partition(make(), RConfig(**cfg))
    assert pg.tile_split_map is not None
    rng = np.random.default_rng(3)
    sm = pg.tile_split_map[:, 0]  # (p, Vl, S)
    shape = (pg.p, pg.packed_rows_per_core)
    if dtype == np.uint32:
        red = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        identity = float(INF_U32)
    else:
        red = rng.random(shape).astype(np.float32)
        identity = INF_F32 if kind == "min" else 0.0
    want = np.asarray(r_combine(jnp.asarray(red), jnp.asarray(sm), kind=kind, identity=identity))
    got = t_combine(_to_port(red), torch.from_numpy(sm).long(), kind=kind, identity=identity)
    got = _from_port(got)
    if kind == "sum":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_untouched_rows_keep_identity():
    """Row blocks with counts 0 and rows no edge reaches hold the identity."""
    word = torch.zeros((2, 3, 2, 4), dtype=torch.int32)
    # core 0, block 1: one valid edge src=1 -> dstb=2
    word[0, 1, 0, 0] = int(np.uint32((1 << 31) | (2 << 16) | 1).view(np.int32))
    counts = torch.tensor([[0, 1, 0], [0, 0, 0]], dtype=torch.int32)
    payload = u32.to_bits(np.array([7, 5, 9], np.uint32))
    out = K.gather_reduce_cores(payload, word, counts, num_rows=12, vb=4,
                                identity=float(INF_U32))
    want = np.full((2, 12), INF_U32, np.uint32)
    want[0, 4 + 2] = 5
    np.testing.assert_array_equal(u32.from_bits(out), want)
    # a valid word in a tile at or past counts is never read
    counts[0, 1] = 0
    out = K.gather_reduce_cores(payload, word, counts, num_rows=12, vb=4,
                                identity=float(INF_U32))
    np.testing.assert_array_equal(u32.from_bits(out), np.full((2, 12), INF_U32, np.uint32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    word = torch.zeros((1, 1, 1, 4), dtype=torch.int32)
    counts = torch.zeros((1, 1), dtype=torch.int32)
    f32 = torch.zeros(4)
    with pytest.raises(ValueError, match="fetch"):
        K.gather_reduce_cores(f32, word, counts, fetch=torch.zeros((1, 1, 2), dtype=torch.int32),
                              num_rows=8, vb=8)
    with pytest.raises(ValueError, match="fetch"):
        K.gather_reduce_cores(f32, word, counts, fetch=torch.zeros((1, 1, 1), dtype=torch.int64),
                              num_rows=8, vb=8)
    big = K.smem_limit_rows() + 1
    with pytest.raises(ValueError, match="shared memory"):
        K.gather_reduce_cores(f32, word, counts, num_rows=big, vb=big)
    with pytest.raises(ValueError, match="num_rows"):
        K.gather_reduce_cores(f32, word, counts, num_rows=16, vb=8)
    with pytest.raises(ValueError, match="uint32"):
        K.gather_reduce_cores(torch.zeros(4, dtype=torch.int32), word, counts,
                              num_rows=8, vb=8, kind="sum")
    with pytest.raises(ValueError, match="word_hi"):
        K.gather_reduce_cores(f32, word, counts, num_rows=8, vb=8, src_bits=32)
