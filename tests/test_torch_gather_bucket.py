"""The port's one-bucket accumulator on the CPU against the JAX reference.

``ops.gather_reduce`` (the plain version of the bucket kernel for a CPU
tensor, then the level-2 split-row fold or the row-packing undo) against
``repro.kernels.csr_gather_reduce.gather_reduce`` with the Pallas kernel in
interpret mode: ``tests/test_kernels.py``'s sweep and weighted min-plus,
``tests/test_hub_split.py``'s split, multi-way split and empty-bucket cases,
degree-aware row packing (``row_pos``), and ``tests/test_system.py``'s
per-bucket case on a real partition. Min must be bit-equal, sum within rtol
1e-6. ``use_reference`` against the reference's, and the wrapper's checks.

The CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase ``bucket``). Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as RG
from repro.core.partition import PartitionConfig as RConfig, partition_2d as r_partition_2d
from repro.kernels.csr_gather_reduce import gather_reduce as r_gather_reduce
from repro.kernels.csr_gather_reduce import prepare_tiles as r_prepare_tiles

from repro_torch.kernels.csr_gather_reduce import gather_reduce, prepare_tiles
from repro_torch.kernels.csr_gather_reduce.bucket import gather_reduce_bucket

INF_F32 = float(np.finfo(np.float32).max)
INF_U32 = float(np.iinfo(np.uint32).max)
SUM_TOL = dict(rtol=1e-6, atol=0.0)


def _payload(p):
    """numpy payload -> the port's tensor (uint32 as int32 bits)."""
    return torch.from_numpy(p.view(np.int32) if p.dtype == np.uint32 else p)


def _back(t, dtype):
    a = t.numpy()
    return a.view(np.uint32) if dtype == np.uint32 else a


def _both(payload, kw_tiles, **kw):
    """(reference out, port out, port use_reference out) for one layout."""
    rt = r_prepare_tiles(**kw_tiles)
    tt = prepare_tiles(**kw_tiles)
    want = np.asarray(r_gather_reduce(jnp.asarray(payload), rt, **kw))
    got = _back(gather_reduce(_payload(payload), tt, **kw), payload.dtype)
    ref = _back(gather_reduce(_payload(payload), tt, use_reference=True, **kw), payload.dtype)
    want_ref = np.asarray(r_gather_reduce(jnp.asarray(payload), rt, use_reference=True, **kw))
    return want, got, ref, want_ref


def _agree(got, want, kind):
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **SUM_TOL)


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize(
    "v,e,g,vb,eb,kind,dtype",
    [
        (64, 300, 128, 8, 16, "min", np.uint32),
        (64, 300, 128, 8, 16, "sum", np.float32),
        (128, 1000, 256, 16, 32, "min", np.float32),
        (32, 10, 64, 8, 8, "sum", np.float32),
        (256, 2048, 512, 32, 128, "min", np.uint32),
        (64, 64, 64, 64, 8, "sum", np.float32),  # single row block
    ],
)
def test_sweep_matches_pallas(v, e, g, vb, eb, kind, dtype, balance):
    """``balance`` packs rows by degree: the kernel's rows come back through
    ``row_pos``."""
    rng = np.random.default_rng(v * 31 + e)
    dst = np.sort(rng.integers(0, v, size=e)).astype(np.int32)
    src = rng.integers(0, g, size=e).astype(np.int32)
    valid = rng.random(e) < 0.9
    if dtype == np.uint32:
        ident = INF_U32
        payload = rng.integers(0, 1000, size=g).astype(dtype)
    else:
        ident = 0.0 if kind == "sum" else INF_F32
        payload = rng.random(g).astype(np.float32)
    want, got, ref, want_ref = _both(
        payload, dict(src_gidx=src, dst_lidx=dst, valid=valid, num_rows=v, vb=vb, eb=eb,
                      balance_rows=balance), kind=kind, identity=ident)
    if balance and v > vb:
        assert prepare_tiles(src, dst, valid, num_rows=v, vb=vb, eb=eb,
                             balance_rows=True).row_pos is not None
    _agree(got, want, kind)
    _agree(ref, want_ref, kind)


@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_min_plus_matches_pallas(weighted):
    """SSSP's saturating add; no weights means unit weights in both."""
    rng = np.random.default_rng(5)
    v, e, g = 64, 400, 128
    dst = np.sort(rng.integers(0, v, size=e)).astype(np.int32)
    src = rng.integers(0, g, size=e).astype(np.int32)
    w = rng.random(e).astype(np.float32) if weighted else None
    payload = rng.random(g).astype(np.float32)
    payload[::5] = INF_F32  # unreached vertices stay saturated
    want, got, ref, want_ref = _both(
        payload, dict(src_gidx=src, dst_lidx=dst, valid=np.ones(e, bool), num_rows=v, vb=8,
                      eb=16, weights=w), kind="min", edge_op="add", identity=INF_F32)
    _agree(got, want, "min")
    _agree(ref, want_ref, "min")
    assert (got < INF_F32).any()


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_single_row_majority_split_matches_pallas(kind):
    """test_hub_split's hub row: split (level-2 fold) and unsplit layouts."""
    rng = np.random.default_rng(1)
    v, vb, eb = 32, 8, 8
    dst = np.sort(np.concatenate([np.full(600, 9), rng.integers(0, v, 200)]).astype(np.int32))
    e = dst.shape[0]
    src = rng.integers(0, 64, e).astype(np.int32)
    payload = rng.random(64).astype(np.float32)
    ident = INF_F32 if kind == "min" else 0.0
    for thr in (None, 64):
        kw = dict(src_gidx=src, dst_lidx=dst, valid=np.ones(e, bool), num_rows=v, vb=vb,
                  eb=eb, balance_rows=True, split_threshold=thr)
        if thr is not None:
            assert prepare_tiles(**kw).row_orig is not None
        want, got, _, _ = _both(payload, kw, kind=kind, identity=ident)
        _agree(got, want, kind)


def test_multiway_split_matches_pallas():
    rng = np.random.default_rng(2)
    v, vb, eb = 16, 8, 8
    dst = np.sort(np.concatenate([np.full(1000, 2), rng.integers(0, v, 50)]).astype(np.int32))
    src = rng.integers(0, 32, dst.shape[0]).astype(np.int32)
    kw = dict(src_gidx=src, dst_lidx=dst, valid=np.ones(dst.shape[0], bool), num_rows=v,
              vb=vb, eb=eb, balance_rows=True, split_threshold=eb)
    tt = prepare_tiles(**kw)
    assert tt.src.shape[0] > v // vb  # R grew to hold the virtual rows
    for kind, ident in (("min", INF_F32), ("sum", 0.0)):
        want, got, _, _ = _both(rng.random(32).astype(np.float32), kw, kind=kind,
                                identity=ident)
        _agree(got, want, kind)


def test_empty_bucket_is_the_identity():
    kw = dict(src_gidx=np.zeros(0, np.int32), dst_lidx=np.zeros(0, np.int32),
              valid=np.zeros(0, bool), num_rows=16, vb=4, eb=4, balance_rows=True,
              split_threshold=2)
    want, got, _, _ = _both(np.ones(8, np.float32), kw, kind="min", identity=7.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.full(16, 7.0, np.float32))
    # T = 0 (no tile at all) writes the identity too
    empty = torch.zeros(4, 0, 4, dtype=torch.int32)
    for pay, ident in ((torch.ones(8), 7.0), (torch.ones(8, dtype=torch.int32), INF_U32)):
        out = gather_reduce_bucket(pay, empty, empty, empty.bool(), num_rows=16, vb=4,
                                   identity=ident)
        want = np.full(16, ident, np.float32 if pay.dtype == torch.float32 else np.uint32)
        np.testing.assert_array_equal(_back(out, want.dtype), want)
    out = gather_reduce_bucket(torch.ones(8), empty, empty, empty.bool(), num_rows=16, vb=4,
                               kind="sum")
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_engine_bucket_on_real_partition_matches_pallas():
    """test_system's per-bucket case: every core of phase 0, BFS labels."""
    g = RG.symmetrize(RG.rmat(9, 6, seed=5))
    pg = r_partition_2d(g, RConfig(p=2, l=2, lane=8))
    labels = np.full(pg.padded_vertices, 0xFFFFFFFF, dtype=np.uint32)
    labels[7] = 0
    labels = labels.reshape(pg.p, pg.vertices_per_core)
    m = 0
    payload = np.where(labels == 0xFFFFFFFF, labels, labels + 1)
    sub = payload[:, m * pg.sub_size: (m + 1) * pg.sub_size].reshape(-1)
    reached = 0
    for core in range(pg.p):
        kw = dict(src_gidx=pg.src_gidx[core, m], dst_lidx=pg.dst_lidx[core, m],
                  valid=pg.valid[core, m], num_rows=pg.vertices_per_core, vb=8, eb=16)
        want, got, ref, want_ref = _both(sub, kw, kind="min", identity=INF_U32)
        _agree(got, want, "min")
        _agree(ref, want_ref, "min")
        reached += int((got < 0xFFFFFFFF).sum())
    assert reached > 0


def test_wrapper_checks():
    s = torch.zeros(2, 3, 4, dtype=torch.int32)
    ok = torch.ones(2, 3, 4, dtype=torch.bool)
    pay = torch.zeros(8)
    with pytest.raises(ValueError, match="num_rows"):
        gather_reduce_bucket(pay, s, s, ok, num_rows=9, vb=4)
    with pytest.raises(ValueError, match="kind"):
        gather_reduce_bucket(pay, s, s, ok, num_rows=8, vb=4, kind="or")
    with pytest.raises(ValueError, match="uint32"):
        gather_reduce_bucket(pay.int(), s, s, ok, num_rows=8, vb=4, kind="sum")
    with pytest.raises(ValueError, match="valid"):
        gather_reduce_bucket(pay, s, s, ok.int(), num_rows=8, vb=4)
    with pytest.raises(ValueError, match="weights"):
        gather_reduce_bucket(pay, s, s, ok, torch.zeros(2, 3), num_rows=8, vb=4,
                             edge_op="add")


# -- the CUDA kernel's schedule, emulated on the CPU -------------------------
# tests/_bucket_order.py repeats gather_reduce.cu's schedule step by step
# (warp ranges, slots a lane, runs folded in registers, the segmented
# shuffle scan, the staged pieces joined in warp order). The card tests hold
# the kernel's bits to it; here it is held to the plain version: min
# bit-equal (the run bookkeeping loses and repeats nothing), sum within the
# kernel's tolerance against the plain version (another association).

from _bucket_order import KERNEL_SLOTS, KERNEL_THREADS, emulate_bucket  # noqa: E402

from repro_torch.kernels.csr_gather_reduce.bucket import gather_reduce_bucket_plain  # noqa: E402

KERNEL_SUM_TOL = dict(rtol=1e-5, atol=1e-9)  # tests/test_torch_cuda.py's SUM_TOL
EMULATED_LAYOUTS = {  # name -> (v, e, vb, eb, balance_rows, split_threshold, weighted, hub)
    "natural": (256, 6000, 64, 32, False, None, False, 1500),
    "row_pos": (256, 6000, 64, 32, True, None, False, 0),
    "split_weighted": (256, 6000, 64, 32, True, 32, True, 2000),
    "multiway_split": (16, 1050, 8, 8, True, 8, False, 1000),
}
EMULATED_FORMS = {  # variant -> (payload dtype, kind, edge_op, identity)
    "min_u32": (np.uint32, "min", "none", INF_U32),
    "min_f32_add": (np.float32, "min", "add", INF_F32),
    "sum_f32": (np.float32, "sum", "none", 0.0),
}


@pytest.mark.parametrize("threads,slots", [(KERNEL_THREADS, KERNEL_SLOTS), (64, 4), (64, 16)])
@pytest.mark.parametrize("variant", list(EMULATED_FORMS))
@pytest.mark.parametrize("layout", list(EMULATED_LAYOUTS))
def test_kernel_schedule_emulation_matches_plain(layout, variant, threads, slots):
    """The kernel's schedule at its own block shape and at two small ones
    (2 warps: runs cross warp ranges and steps), on prepare_tiles' layouts:
    natural rows with a hub row, row packing, weighted hub-row splits."""
    v, e, vb, eb, balance, split, weighted, hub = EMULATED_LAYOUTS[layout]
    dtype, kind, edge_op, identity = EMULATED_FORMS[variant]
    rng = np.random.default_rng(v + e + len(variant))
    dst = np.sort(np.concatenate([np.full(hub, 5), rng.integers(0, v, e - hub)]))
    g = 512
    w = rng.random(e).astype(np.float32) if weighted else None
    t = prepare_tiles(rng.integers(0, g, e).astype(np.int32), dst.astype(np.int32),
                      rng.random(e) < 0.9, num_rows=v, vb=vb, eb=eb, weights=w,
                      balance_rows=balance, split_threshold=split)
    if dtype == np.uint32:
        payload = rng.integers(0, 1 << 32, g, dtype=np.uint64).astype(np.uint32)
        payload[rng.random(g) < 0.2] = 0xFFFFFFFF
    else:
        payload = (rng.random(g) * (50 if kind == "min" else 1.0 / g)).astype(np.float32)
        if kind == "min":
            payload[rng.random(g) < 0.2] = INF_F32
    weights = t.weights if edge_op == "add" else None
    if edge_op == "add" and weights is None:
        weights = np.ones(t.src.shape, np.float32)
    got = emulate_bucket(payload, t.src, t.dstb, t.valid, weights, vb=vb, kind=kind,
                         edge_op=edge_op, identity=identity, threads=threads, slots=slots)
    r_blocks = t.src.shape[0]
    want = gather_reduce_bucket_plain(
        _payload(payload), torch.from_numpy(t.src), torch.from_numpy(t.dstb),
        torch.from_numpy(t.valid), None if weights is None else torch.from_numpy(weights),
        num_rows=r_blocks * vb, vb=vb, kind=kind, edge_op=edge_op, identity=identity)
    want = _back(want, payload.dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **KERNEL_SUM_TOL)
        assert (got != 0).sum() > r_blocks  # rows were reached
