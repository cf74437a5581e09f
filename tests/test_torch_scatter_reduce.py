"""The port's push scatter entry against the reference Pallas kernel.

On CPU tensors ``repro_torch``'s ``scatter_reduce_cores`` runs its plain
PyTorch version; it must be bit-equal to ``repro``'s
``scatter_reduce_cores_pallas(..., interpret=True)`` on the same real push
streams: min over uint32 (BFS/WCC) and over float32 with and without the
saturating weight add (SSSP), in both packed-word regimes, on the static
tile counts and on seeded fetch maps. Min is exact, so there is no
tolerance. The CUDA kernel itself is checked against the plain version by
tests/test_torch_cuda.py (skips without a card) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.graph as RG
from repro.core import frontier_words as RF
from repro.core.partition import PartitionConfig as RConfig
from repro.core.partition import partition_2d as r_partition
from repro.kernels.csr_gather_reduce.kernel import scatter_reduce_cores_pallas

from repro_torch.core import u32
from repro_torch.kernels.csr_gather_reduce import scatter as S

INF_U32 = 0xFFFFFFFF
INF_F32 = float(np.finfo(np.float32).max)

# variant -> (edge_op, identity, stream the weights)
VARIANTS = {
    "min_u32": ("none", float(INF_U32), False),
    "min_f32_add": ("add", INF_F32, True),
    "min_f32_add_unit": ("add", INF_F32, False),
    "min_f32": ("none", INF_F32, False),
}


def _weighted(g, seed):
    w = np.random.default_rng(seed).random(g.num_edges).astype(np.float32)
    return RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


GRAPHS = {  # both src-bit regimes of the push stream; several source blocks
    "rmat9_16bit": (lambda: _weighted(RG.symmetrize(RG.rmat(9, 6, seed=2)), 2),
                    dict(p=2, l=2, lane=4, tile_vb=16, push_block=64)),
    "rmat9_32bit": (lambda: _weighted(RG.symmetrize(RG.rmat(9, 6, seed=3)), 3),
                    dict(p=4, l=2, lane=4, tile_vb=8, pack_src_bits=32, push_eb=64)),
}


def _payload(variant, n, rng):
    if variant == "min_u32":
        v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        v[rng.random(n) < 0.2] = INF_U32
        return v
    v = (rng.random(n) * 50 - 10).astype(np.float32)  # negatives order too
    v[rng.random(n) < 0.2] = INF_F32
    return v


def _to_port(a):
    if a is None:
        return None
    return u32.to_bits(a) if a.dtype == np.uint32 else torch.from_numpy(np.array(a))


def _fetch(counts, t_tiles, rng, share=0.3):
    """A seeded fetch map that keeps about ``share`` of the real tiles."""
    real = np.arange(t_tiles)[None, None, :] < counts[..., None]
    active = real & (rng.random(real.shape) < share)
    return np.asarray(RF.active_fetch_map(jnp.asarray(active)))


@pytest.mark.parametrize("arm", ["static", "fetch"])
@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_reference_kernel(variant, graph, arm):
    make, cfg = GRAPHS[graph]
    pg = r_partition(make(), RConfig(**cfg))
    assert pg.push_src_bits == (32 if "32bit" in graph else 16)
    assert pg.push_word.shape[2] > 1  # several source blocks
    edge_op, identity, with_w = VARIANTS[variant]
    rng = np.random.default_rng(11)
    for m in range(pg.l):
        word, counts = pg.push_word[:, m], pg.push_counts[:, m]
        hi = pg.push_word_hi[:, m] if pg.push_word_hi is not None else None
        w = pg.push_weights[:, m] if with_w else None
        fetch = _fetch(counts, word.shape[2], rng) if arm == "fetch" else None
        payload = _payload(variant, pg.gathered_size, rng)
        kw = dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits, kind="min",
                  edge_op=edge_op, identity=identity)
        want = np.asarray(scatter_reduce_cores_pallas(
            *(None if a is None else jnp.asarray(a) for a in (payload, word, counts, hi, w, fetch)),
            interpret=True, **kw))
        got = S.scatter_reduce_cores(*(_to_port(a) for a in (payload, word, counts, hi, w, fetch)),
                                     **kw)
        got = u32.from_bits(got) if got.dtype == torch.int32 else got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_inactive_fetch_map_leaves_the_identity():
    """An all-inactive map (a phase with no live source) reduces nothing."""
    make, cfg = GRAPHS["rmat9_16bit"]
    pg = r_partition(make(), RConfig(**cfg))
    word, counts = pg.push_word[:, 0], pg.push_counts[:, 0]
    fetch = torch.full(word.shape[:3], -1, dtype=torch.int32)
    payload = u32.to_bits(np.zeros(pg.gathered_size, np.uint32))
    out = S.scatter_reduce_cores(payload, _to_port(word), _to_port(counts), fetch=fetch,
                                 num_rows=pg.vertices_per_core, identity=float(INF_U32))
    np.testing.assert_array_equal(u32.from_bits(out), np.full(out.shape, INF_U32, np.uint32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    word = torch.zeros((1, 1, 2, 4), dtype=torch.int32)
    counts = torch.zeros((1, 1), dtype=torch.int32)
    f32 = torch.zeros(4)
    with pytest.raises(ValueError, match="min"):  # the reference asserts min/or
        S.scatter_reduce_cores(f32, word, counts, num_rows=8, kind="sum")
    with pytest.raises(ValueError, match="min"):  # 'or' comes with multi-query lanes
        S.scatter_reduce_cores(f32, word, counts, num_rows=8, kind="or")
    with pytest.raises(ValueError, match="16-bit"):
        S.scatter_reduce_cores(f32, word, counts, num_rows=(1 << 15) + 1)
    with pytest.raises(ValueError, match="fetch"):
        S.scatter_reduce_cores(f32, word, counts, torch.zeros((1, 1, 1, 4), dtype=torch.int32),
                               fetch=torch.zeros((1, 1, 3), dtype=torch.int32), num_rows=8,
                               src_bits=32)
    with pytest.raises(ValueError, match="word_hi"):
        S.scatter_reduce_cores(f32, word, counts, num_rows=8, src_bits=32)


# -- the kernel's float min: sign-split atomics on float32 bits ----------------

_SIGN = 0x80000000
_MASK = 0xFFFFFFFF


def _f32_key(bits):
    """The kernels' order-preserving map float32 bits -> uint32 (negative
    floats reversed, -0.0 below +0.0), on int64 tensors of uint32 bits."""
    return torch.where((bits & _SIGN) != 0, ~bits & _MASK, bits | _SIGN)


def _sign_split_min(cell, v):
    """What the scatter kernel's atomic leaves in a cell holding the float32
    bits ``cell`` when the value with bits ``v`` lowers it: a signed atomicMin
    on the bits when v's sign bit is clear, an unsigned atomicMax when it is
    set (int64 tensors of uint32 bits)."""
    def signed(x):
        return torch.where(x >= 1 << 31, x - (1 << 32), x)

    as_int_min = torch.minimum(signed(cell), signed(v)) & _MASK
    return torch.where((v & _SIGN) != 0, torch.maximum(cell, v), as_int_min)


def _bits(values):
    return torch.from_numpy(np.asarray(values, np.float32).view(np.uint32).astype(np.int64))


_FAMILIES = {
    "zeros": [0.0, -0.0],
    "denormals": [1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38, -1.1754942e-38],
    "infinities": [np.inf, -np.inf],
    "extremes": [INF_F32, -INF_F32, 1.0, -1.0],
    "random": list(np.random.default_rng(3).standard_normal(40) * 1e3),
}


@pytest.mark.parametrize("family", list(_FAMILIES) + ["bit_patterns"])
def test_sign_split_float_min_follows_the_key_order(family):
    """For every pair of a cell and a value from a sweep of floats (or of
    raw bit patterns, NaNs included), the sign-split atomic leaves the one of
    the two that is smaller in f32_key order, which is what the keyed
    kernel's atomicMin on keys gave."""
    base = [0.0, -0.0, 1e-40, -1e-40, np.inf, -np.inf, INF_F32, 2.5, -2.5]
    if family == "bit_patterns":
        raw = np.random.default_rng(9).integers(0, 1 << 32, 300, dtype=np.uint64)
        vals = torch.cat([_bits(base), torch.from_numpy(raw.astype(np.int64))])
    else:
        vals = _bits(base + _FAMILIES[family])
    cell, v = torch.meshgrid(vals, vals, indexing="ij")
    want = torch.where(_f32_key(v) < _f32_key(cell), v, cell)
    assert torch.equal(_sign_split_min(cell, v), want)


def test_sign_split_float_min_is_order_free():
    """Lowering the identity by a set of values in any order leaves the value
    of least key: -1.0 below -0.0 below +0.0, the negative denormal below
    -0.0."""
    vals = _bits([3.0, -0.0, 0.0, -1e-40, 7.5, -1.0, 0.0, -0.0])
    rng = np.random.default_rng(4)
    for _ in range(20):
        cell = _bits([INF_F32])[0]
        for i in rng.permutation(vals.numel()):
            cell = _sign_split_min(cell, vals[i])
        assert int(cell) == int(_bits([-1.0])[0])
    for group, least in (([0.0, -0.0], -0.0), ([-0.0, -1e-40, 0.0], -1e-40), ([0.0, 2.0], 0.0)):
        for order in (group, group[::-1]):
            cell = _bits([INF_F32])[0]
            for x in _bits(order):
                cell = _sign_split_min(cell, x)
            assert int(cell) == int(_bits([least])[0])


def test_key_order_is_float_order_with_negative_zero_first():
    """f32_key sorts non-NaN floats as their values sort, with -0.0 just
    below +0.0: the order the kernel's float min reduces in."""
    rng = np.random.default_rng(6)
    vals = np.concatenate([rng.standard_normal(200) * 10.0 ** rng.integers(-40, 38, 200),
                           [INF_F32, -INF_F32, np.inf, -np.inf, 1e-45, -1e-45]]).astype(np.float32)
    vals = np.unique(vals[vals != 0])
    keys = _f32_key(_bits(vals))
    assert torch.equal(torch.argsort(keys), torch.arange(vals.size))
    assert int(_f32_key(_bits([-0.0]))[0]) + 1 == int(_f32_key(_bits([0.0]))[0])
