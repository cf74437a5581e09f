"""The port's segment softmax on the CPU against the JAX reference.

  * ``kernel.segment_softmax_tiles_plain`` (the plain version on the tile
    schedule) against ``segment_softmax_pallas`` in interpret mode, in tile
    order, and ``ops.segment_softmax`` (which runs it for a CPU tensor)
    against ``repro.kernels.segment_softmax.segment_softmax(use_pallas=True,
    tiles=...)``, on ``tests/test_kernels.py``'s three shapes, with a head
    axis, empty rows and all-invalid tiles; rtol 1e-5, atol 1e-7 (another
    association of the same sums), and every non-empty segment sums to 1;
  * GAT's form (``build_edge_tiles`` over UNSORTED edges, the dst sort
    composed into ``gather_idx``) against the reference's segment form;
  * the autograd backward against ``jax.grad`` of
    ``segment_softmax_reference``, rtol 1e-5, atol 1e-6; its segment sum the
    fixed-order op over the caller's destination layout, bit for bit the
    sequential fold.

The CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase ``softmax_kernel``). Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.csr_gather_reduce.ops import prepare_tiles as r_prepare_tiles
from repro.kernels.segment_softmax import segment_softmax as r_segment_softmax
from repro.kernels.segment_softmax.kernel import segment_softmax_pallas
from repro.kernels.segment_softmax.ref import segment_softmax_reference as r_reference

from repro_torch.kernels.csr_gather_reduce.ops import prepare_tiles
from repro_torch.kernels.segment_softmax import kernel as SK
from repro_torch.kernels.segment_softmax import segment_softmax
from repro_torch.kernels.segment_softmax.ops import (
    build_edge_tiles, device_tiles, segment_softmax_edges,
)

TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(64, 300, 8, 16), (32, 40, 8, 8), (128, 2000, 16, 64)]  # v, e, vb, eb


def _edges(seed, v, e, hole=None):
    """Sorted dst, validity, scores; ``hole`` rows get no edge (empty rows
    and, at vb granularity, all-invalid tiles)."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, v, size=e)).astype(np.int32)
    if hole is not None:
        dst = np.sort(np.where((dst >= hole[0]) & (dst < hole[1]), hole[0] - 1, dst))
    valid = rng.random(e) < 0.85
    scores = ((rng.random(e).astype(np.float32) - 0.5) * 10)
    return dst.astype(np.int32), valid, scores


def _sums_to_one(w, dst, valid, v):
    seg = np.zeros(v)
    np.add.at(seg, dst[valid], w[valid])
    nonempty = np.bincount(dst[valid], minlength=v) > 0
    np.testing.assert_allclose(seg[nonempty], 1.0, rtol=1e-5)
    np.testing.assert_array_equal(w[~valid], 0.0)


@pytest.mark.parametrize("hole", [None, (16, 32)])
@pytest.mark.parametrize("v,e,vb,eb", SHAPES)
def test_op_matches_pallas(v, e, vb, eb, hole):
    dst, valid, scores = _edges(v + e, v, e, hole)
    rt = r_prepare_tiles(np.zeros(e, np.int32), dst, valid, num_rows=v, vb=vb, eb=eb)
    want = np.asarray(r_segment_softmax(jnp.asarray(scores), jnp.asarray(dst),
                                        jnp.asarray(valid), v, use_pallas=True, tiles=rt))
    tt = prepare_tiles(np.zeros(e, np.int32), dst, valid, num_rows=v, vb=vb, eb=eb)
    got = segment_softmax(torch.from_numpy(scores), torch.from_numpy(dst),
                          torch.from_numpy(valid), v, tiles=tt).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    _sums_to_one(got, dst, valid, v)
    if hole is not None:
        assert np.bincount(dst[valid], minlength=v)[hole[0]:hole[1]].sum() == 0


@pytest.mark.parametrize("v,e,vb,eb", SHAPES)
def test_plain_version_matches_pallas_in_tile_order(v, e, vb, eb):
    """Tile order, so padding slots (0) and all-invalid tiles are compared too."""
    dst, valid, scores = _edges(3 * v + e, v, e, hole=(v // 4, v // 2))
    tt = prepare_tiles(np.zeros(e, np.int32), dst, valid, num_rows=v, vb=vb, eb=eb)
    tiled = np.where(tt.valid, scores[tt.gather_idx], 0.0).astype(np.float32)
    want = np.asarray(segment_softmax_pallas(jnp.asarray(tiled), jnp.asarray(tt.dstb),
                                             jnp.asarray(tt.valid), num_rows=v, vb=vb))
    got = SK.segment_softmax_tiles_plain(torch.from_numpy(tiled)[None],
                                         torch.from_numpy(tt.dstb),
                                         torch.from_numpy(tt.valid), vb=vb)[0].numpy()
    assert (~tt.valid.reshape(tt.valid.shape[0], tt.valid.shape[1], -1).any(-1)).any(), \
        "no all-invalid tile in this layout"
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("v,e,vb,eb", SHAPES)
def test_head_axis_matches_pallas_per_head(v, e, vb, eb, heads):
    dst, valid, _ = _edges(v * 7 + e, v, e)
    scores = (np.random.default_rng(e).random((e, heads)).astype(np.float32) - 0.5) * 8
    rt = r_prepare_tiles(np.zeros(e, np.int32), dst, valid, num_rows=v, vb=vb, eb=eb)
    want = np.stack([np.asarray(r_segment_softmax(
        jnp.asarray(scores[:, h]), jnp.asarray(dst), jnp.asarray(valid), v,
        use_pallas=True, tiles=rt)) for h in range(heads)], axis=1)
    tt = prepare_tiles(np.zeros(e, np.int32), dst, valid, num_rows=v, vb=vb, eb=eb)
    got = segment_softmax(torch.from_numpy(scores), torch.from_numpy(dst),
                          torch.from_numpy(valid), v, tiles=tt).numpy()
    assert got.shape == (e, heads)
    np.testing.assert_allclose(got, want, **TOL)
    for h in range(heads):
        _sums_to_one(got[:, h], dst, valid, v)


@pytest.mark.parametrize("n,e,heads,vb,eb", [(100, 700, 2, 16, 32), (300, 3000, 4, 64, 128)])
def test_unsorted_edges_match_reference(n, e, heads, vb, eb):
    """GAT's layout: unsorted edges, rows rounded up to vb, LPT packing."""
    rng = np.random.default_rng(n + e)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[rng.random(e) < 0.3] = 5  # a hub row
    valid = rng.random(e) < 0.9
    scores = ((rng.random((e, heads)) - 0.5) * 6).astype(np.float32)
    assert not np.all(np.diff(dst) >= 0)
    et = build_edge_tiles(dst, valid, n, vb=vb, eb=eb)
    assert et.tiles.row_pos is not None and et.tiles.row_orig is None
    assert et.tiles.num_rows % vb == 0 and et.tiles.num_rows >= n
    dt = device_tiles(et, "cpu")
    got = segment_softmax(torch.from_numpy(scores), torch.from_numpy(dst),
                          torch.from_numpy(valid), n, tiles=dt).numpy()
    want = np.stack([np.asarray(r_reference(jnp.asarray(scores[:, h]), jnp.asarray(dst),
                                            jnp.asarray(valid), n)) for h in range(heads)], 1)
    np.testing.assert_allclose(got, want, **TOL)
    ref_port = segment_softmax(torch.from_numpy(scores), torch.from_numpy(dst),
                               torch.from_numpy(valid), n, use_reference=True).numpy()
    np.testing.assert_allclose(ref_port, want, **TOL)


@pytest.mark.parametrize("heads", [1, 4])
def test_backward_matches_jax_grad(heads):
    n, e = 80, 600
    rng = np.random.default_rng(heads)
    dst = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.9
    scores = ((rng.random((e, heads)) - 0.5) * 6).astype(np.float32)
    coef = rng.standard_normal((e, heads)).astype(np.float32)

    def r_loss(s):
        w = jax.vmap(lambda c: r_reference(c, jnp.asarray(dst), jnp.asarray(valid), n),
                     in_axes=1, out_axes=1)(s)
        return jnp.sum(w * coef)

    want = np.asarray(jax.grad(r_loss)(jnp.asarray(scores)))
    dt = device_tiles(build_edge_tiles(dst, valid, n, vb=16, eb=32), "cpu")
    s = torch.from_numpy(scores).requires_grad_(True)
    w = segment_softmax_edges(s, dt, torch.from_numpy(dst), torch.from_numpy(valid))
    (w * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), want, **GRAD_TOL)
    np.testing.assert_array_equal(s.grad.numpy()[~valid], 0.0)


@pytest.mark.parametrize("heads", [1, 4])
def test_backward_sums_over_the_given_layout(heads, monkeypatch):
    """The backward's segment sum is the fixed-order op over the layout the
    caller passes (``segment_layout`` of the edges' destinations), no
    ``index_add``; its gradient bit for bit the one with no layout passed
    (the sum's own, built per call) and the sequential float32 fold of
    ``w * g`` over the valid edges."""
    from repro_torch.kernels.segment_sum import kernel as SS
    from repro_torch.kernels.segment_sum import segment_layout

    n, e = 70, 500
    rng = np.random.default_rng(heads + 20)
    dst = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.85
    scores = ((rng.random((e, heads)) - 0.5) * 6).astype(np.float32)
    coef = torch.from_numpy(rng.standard_normal((e, heads)).astype(np.float32))
    dt = device_tiles(build_edge_tiles(dst, valid, n, vb=16, eb=32), "cpu")
    layout = segment_layout(torch.from_numpy(dst), n)
    seen = []
    real = SS.segment_sum_rows
    monkeypatch.setattr(SS, "segment_sum_rows",
                        lambda x, seg, layout, k: seen.append(layout) or real(x, seg, layout, k))
    monkeypatch.setattr(torch.Tensor, "index_add_", lambda *a, **k: pytest.fail("index_add_"))

    def grad(given):
        s = torch.from_numpy(scores).requires_grad_(True)
        w = segment_softmax_edges(s, dt, torch.from_numpy(dst), torch.from_numpy(valid), given)
        (w * coef).sum().backward()
        return s.grad, w.detach()

    got, w = grad(layout)
    assert len(seen) == 1 and seen[0] is layout
    bare, _ = grad(None)
    assert torch.equal(got, bare)
    wg = w * coef
    seg = torch.zeros(n, heads)
    for i in np.nonzero(valid)[0]:
        seg[dst[i]] = seg[dst[i]] + wg[i]
    assert torch.equal(got, w * (coef - seg[torch.from_numpy(dst).long()]))


def test_wrapper_checks():
    s = torch.zeros(2, 3, 8)
    d = torch.zeros(2, 3, 8, dtype=torch.int32)
    ok = torch.ones(2, 3, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="float32"):
        SK.segment_softmax_tiles(s.double(), d, ok, vb=4)
    with pytest.raises(ValueError, match="dstb"):
        SK.segment_softmax_tiles(s, d.long(), ok, vb=4)
    with pytest.raises(ValueError, match="valid"):
        SK.segment_softmax_tiles(s, d, ok.int(), vb=4)
    with pytest.raises(ValueError, match="vb"):
        SK.segment_softmax_tiles(s, d, ok, vb=SK.MAX_VB + 1)
    with pytest.raises(ValueError, match="tile layout"):
        segment_softmax(torch.zeros(5), torch.zeros(5, dtype=torch.int32),
                        torch.ones(5, dtype=torch.bool), 4)
    assert SK.segment_softmax_tiles(s, d, ok, vb=4).shape == (2, 3, 8)
    assert SK.segment_softmax_tiles(s[None], d, ok, vb=4).shape == (1, 2, 3, 8)
