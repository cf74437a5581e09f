"""The port's fixed-order segment sum on the CPU against the JAX reference.

  * ``segment_sum`` (its plain version on a CPU tensor) against
    ``jax.ops.segment_sum`` on float32 rows (rtol 1e-6: both add in index
    order; the reference's CPU scatter may associate otherwise) and on bf16
    rows (both sides from the same bf16 inputs; the port sums in float32 and
    rounds once, bit for bit the float32 sum rounded; the reference rounds
    each partial sum to bf16 as it goes, so for a segment of n rows the two
    differ by at most (n 2^-9 + 2^-8) times its sum of |terms|: n roundings
    of a partial sum, half a bf16 ulp each, and the port's one), with empty
    segments, ids < 0 and ids past the last segment (dropped by both);
  * the order: float32 sums bit for bit equal to a sequential float32 fold
    in row order, and, with ``CHUNK`` cut to 4, to the chunked order the
    tree's levels give (chunks of 4 rows, their sums again in chunks); the
    layout the card builds (order and one start, no levels) gives through
    the derived tree the old multi-level layout's levels and bits; an
    emulation of the CUDA kernel's schedule (items found by the layout's
    marks, scratch slots, ticket rows, levels in place) gives the same bits;
    two calls the
    same bits, the second on the rows shuffled across segments but kept in
    order inside each;
  * the gradient (``torch.autograd.gradcheck`` in float64) of the sum and
    of ``take``, and ``take``'s table gradient bit for bit the sum's;
  * ``max_run`` (one level, no host read) and ``covers_all`` as the caller
    says them, a layout passed in,
    the fake output rule (the ``index_add`` it stands in for, no kernel
    work noted) and the wrapper's refusals.

The CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase ``segment_sum``). Inputs come from numpy seeds.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.fake import KernelWork, is_fake
from repro_torch.kernels.segment_sum import (
    SegmentLayout, kernel as SS, segment_layout, segment_sum, segment_sum_plain, take,
)

F32_TOL = dict(rtol=1e-6, atol=1e-6)
# rows, d, segments
CASES = [(1, 1, 1), (50, 3, 7), (300, 18, 40), (2000, 64, 9), (500, 5, 1000)]


def _case(rows, d, segs, seed, bad=True):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-1 if bad else 0, segs + 1 if bad else segs, rows).astype(np.int64)
    scale = 10.0 ** rng.integers(-2, 3, (rows, 1))
    x = (rng.standard_normal((rows, d)) * scale).astype(np.float32)
    return x, seg


def _reference(x, seg, segs):
    return np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg), num_segments=segs))


@pytest.mark.parametrize("rows,d,segs", CASES)
def test_float32_matches_jax_segment_sum(rows, d, segs):
    x, seg = _case(rows, d, segs, rows + d)
    got = segment_sum(torch.from_numpy(x), torch.from_numpy(seg), segs)
    assert got.dtype == torch.float32 and got.shape == (segs, d)
    np.testing.assert_allclose(got.numpy(), _reference(x, seg, segs), **F32_TOL)


@pytest.mark.parametrize("rows,d,segs", CASES)
def test_bf16_matches_jax_segment_sum(rows, d, segs):
    x, seg = _case(rows, d, segs, rows * 3 + d)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = segment_sum(xb, torch.from_numpy(seg), segs)
    assert got.dtype == torch.bfloat16
    want = jax.ops.segment_sum(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(seg), num_segments=segs)
    n = _reference(np.ones((rows, 1), np.float32), seg, segs)
    bound = (n * 2.0 ** -9 + 2.0 ** -8) * _reference(np.abs(xb.float().numpy()), seg, segs)
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-30)).max())
    # the float32 sum of the same inputs, rounded once
    once = segment_sum(xb.float(), torch.from_numpy(seg), segs).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), once.view(torch.int16))


def test_empty_segments_are_zero():
    x = torch.ones(6, 2)
    seg = torch.tensor([1, 1, 4, 4, 4, 9])
    got = segment_sum(x, seg, 7)
    want = np.zeros((7, 2), np.float32)
    want[1], want[4] = 2, 3
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, torch.from_numpy(_reference(x.numpy(), seg.numpy(), 7).copy()))
    assert not torch.signbit(segment_sum(-torch.zeros(3, 1), torch.tensor([0, 0, 2]), 3)).any()


def _sequential(x, seg, segs):
    out = torch.zeros((segs,) + tuple(x.shape[1:]), dtype=torch.float32)
    for i in range(x.shape[0]):
        s = int(seg[i])
        if 0 <= s < segs:
            out[s] = out[s] + x[i]
    return out


def _chunked(x, seg, segs, c):
    """The layout's order written out: a run of more than c rows summed in
    chunks of c (each from +0), the chunk sums again, until one is left."""
    out = torch.zeros((segs,) + tuple(x.shape[1:]), dtype=torch.float32)
    for s in range(segs):
        terms = [x[i] for i in range(x.shape[0]) if int(seg[i]) == s]
        while len(terms) > c:
            chunks = [terms[j:j + c] for j in range(0, len(terms), c)]
            terms = [_fold(ch) for ch in chunks]
        out[s] = _fold(terms) if terms else 0.0
    return out


def _fold(terms):
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


@pytest.mark.parametrize("rows,d,segs", CASES[:4])
def test_float32_bits_are_the_sequential_fold(rows, d, segs):
    x, seg = _case(rows, d, segs, 7 * rows)
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    assert torch.equal(segment_sum(xt, st, segs), _sequential(xt, st, segs))


@pytest.mark.parametrize("hub", [5, 17, 70])
def test_long_runs_sum_in_chunks(monkeypatch, hub):
    monkeypatch.setattr(SS, "CHUNK", 4)
    rng = np.random.default_rng(hub)
    seg = np.concatenate([np.full(hub, 2), rng.integers(-1, 6, 40)])
    rng.shuffle(seg)
    x = (rng.standard_normal((seg.shape[0], 3)) * 1e3).astype(np.float32)
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    layout = segment_layout(st, 5)
    levels, longest = 1, int(np.bincount(seg[seg >= 0]).max())
    while longest > 4:  # each level cuts the longest run into chunks of 4
        levels, longest = levels + 1, -(-longest // 4)
    assert len(layout.levels) == levels > 1
    got = segment_sum(xt, st, 5, layout)
    assert torch.equal(got, _chunked(xt, st, 5, 4))
    assert torch.equal(got, segment_sum_plain(xt, st, 5))
    np.testing.assert_allclose(got.numpy(), _reference(x, seg, 5), rtol=1e-5, atol=1e-3)


def _old_levels(start, c):
    """The multi-level layout as it was built before the kernel computed the
    tree itself: every run past c rows cut into chunks of c, the chunks' sums
    a run of the next level, until no run is longer."""
    lens = start[1:] - start[:-1]
    longest = int(lens.max())
    levels, cur, s = [], start, lens.shape[0]
    while longest > c:
        nc = (lens + c - 1) // c
        cs = torch.cat([cur.new_zeros(1), torch.cumsum(nc, 0)])
        run_of = torch.repeat_interleave(torch.arange(s), nc)
        j = torch.arange(int(cs[-1])) - cs[run_of]
        levels.append(torch.cat([cur[run_of] + j * c, cur[-1:]]))
        cur, lens, longest = cs, nc, -(-longest // c)
    return tuple(levels) + (cur,)


@pytest.mark.parametrize("hub", [5, 17, 70])
def test_card_layout_derives_the_old_levels(monkeypatch, hub):
    """The layout as the card builds it (the sort's order and one start, no
    levels, nothing read from the device) gives through the plain version's
    derived tree the levels and the bits of the multi-level layout."""
    monkeypatch.setattr(SS, "CHUNK", 4)
    rng = np.random.default_rng(hub + 1)
    seg = np.concatenate([np.full(hub, 3), rng.integers(-1, 7, 60)])
    rng.shuffle(seg)
    x = (rng.standard_normal((seg.shape[0], 5)) * 1e3).astype(np.float32)
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    layout = segment_layout(st, 6)
    assert "levels" not in layout.__dict__  # the tree is derived only when asked
    assert layout.start.shape == (7,) and layout.order.shape == (seg.shape[0],)
    old = _old_levels(layout.start, 4)
    assert len(layout.levels) == len(old) > 1
    assert all(torch.equal(a, b) for a, b in zip(layout.levels, old))
    got = segment_sum(xt, st, 6, layout)
    old_layout = types.SimpleNamespace(order=layout.order, levels=old)
    assert torch.equal(got, SS.sum_levels(xt, old_layout, SS.fold_runs_plain))
    assert torch.equal(got, _chunked(xt, st, 6, 4))


def _kernel_schedule(x, order, start, marks, c, m, mark):
    """The CUDA kernel's tree mode step by step in numpy float32, with chunk
    c, tiles of m <= c positions and the layout's ``marks``, the run of
    every ``mark``-th position (mark divides m): the run part folds each run
    of at most m rows; tile t's items are A, the chunk k >= 1 that starts in
    the tile of the run holding its first position (mark t * m / mark), and
    B, the run holding the next tile's first position where it starts in
    the tile and is longer than m (whole up to c rows, else its chunk 0). A
    whole run is folded into the output; a chunk into its run's scratch
    slot, and the last arrival of each group of c slots (its ticket row)
    folds them into the slot of its first, level by level, the top group
    into the output. Returns the output and the items the tiles took: (run,
    chunk) or (run, -1) for a whole run."""
    n_runs, d, n_pos = start.shape[0] - 1, x.shape[1], order.shape[0]
    out = np.full((n_runs, d), np.nan, np.float32)

    def fold(vals):
        acc = np.zeros(d, np.float32)
        for v in vals:
            acc = acc + v
        return acc

    n_ctiles = -(-n_pos // c) if n_pos > c else 0
    n_tiles = -(-n_pos // m) if n_ctiles else 0
    for s in range(n_runs):
        lo, hi = start[s], start[s + 1]
        if not (n_tiles and hi - lo > m):
            out[s] = fold(x[order[lo:hi]])

    def run_at_mark(i):
        if i >= marks.shape[0]:
            return -1
        return marks[i] if 0 <= marks[i] < n_runs else -1

    scratch, tickets, owner, taken = {}, {}, {}, []
    step = m // mark
    for t in range(n_tiles):
        first = t * m
        items = []
        s0 = run_at_mark(t * step)
        if s0 >= 0:
            lo, hi = start[s0], start[s0 + 1]
            k = -(-(first - lo) // c)
            if k >= 1 and lo + k * c < min(hi, first + m):
                items.append((s0, k))
        s1 = run_at_mark((t + 1) * step)
        if s1 >= 0 and first <= start[s1] < first + m and start[s1 + 1] - start[s1] > m:
            items.append((s1, 0 if start[s1 + 1] - start[s1] > c else -1))
        for s, k in items:
            lo, hi = start[s], start[s + 1]
            taken.append((s, k))
            if k < 0:
                out[s] = fold(x[order[lo:hi]])
                continue
            a, nc = lo // c, -(-(hi - lo) // c)

            def slot(j, a=a):
                return 2 * (a + j) + (j == 0)

            assert slot(k) not in scratch
            scratch[slot(k)] = fold(x[order[lo + k * c:min(lo + k * c + c, hi)]])
            # the tree by the last arrivals: a ticket row a group of c values
            # and level, 2 * (a // c^level + the group's first value) + (it
            # is 0), below the level's 2 * ((n_ctiles - 1) // c^level + 1)
            # rows, no two groups on one
            i, cnt, scale, level = k, nc, 1, 0
            while True:
                k0 = i // c * c
                n_in = min(c, cnt - k0)
                row = 2 * (a // scale + k0) + (k0 == 0)
                assert row < 2 * ((n_ctiles - 1) // scale + 1)
                assert owner.setdefault((level, row), (s, k0)) == (s, k0)
                tickets[level, row] = tickets.get((level, row), 0) + 1
                if tickets[level, row] < n_in:
                    break
                vals = [scratch[slot(j * scale)] for j in range(k0, k0 + n_in)]
                if cnt <= c:
                    out[s] = fold(vals)
                    break
                scratch[slot(k0 * scale)] = fold(vals)  # into the slot of its first
                i, cnt, scale, level = i // c, -(-cnt // c), scale * c, level + 1
    return out, taken


@pytest.mark.parametrize("m", [4, 2])
@pytest.mark.parametrize("hubs", [(5,), (17, 9), (70,), (300, 6, 21), ()])
def test_kernel_schedule_is_the_tree_order(monkeypatch, hubs, m):
    """The kernel's schedule (``_kernel_schedule``: its items found by the
    layout's marks, scratch slots, ticket rows and in-place levels, at chunk
    4 and marks every 2 positions, tiles of 4 as for many positions and of 2
    as for the staged few) takes every run longer than a tile once, whole or
    chunk by chunk, and gives the plain version's bits, with empty segments,
    ids < 0, ids past the last segment and runs that cross tiles; the marks
    the layout keeps from its sort name the runs ``kernel.run_marks``
    derives from ``start``."""
    monkeypatch.setattr(SS, "CHUNK", 4)
    monkeypatch.setattr(SS, "MARK", 2)
    rng = np.random.default_rng(sum(hubs) + 3)
    segs = 40
    seg = np.concatenate([np.full(h, 2 + 3 * i) for i, h in enumerate(hubs)]
                         + [rng.integers(-2, segs + 2, 90)])
    rng.shuffle(seg)
    x = (rng.standard_normal((seg.shape[0], 3)) * 10.0 ** rng.integers(-3, 3, (seg.shape[0], 1))
         ).astype(np.float32)
    layout = segment_layout(torch.from_numpy(seg), segs)
    start, order, marks = layout.start.numpy(), layout.order.numpy(), layout.marks.numpy()
    derived = SS.run_marks(layout.start, seg.shape[0]).numpy()
    in_run = (marks >= 0) & (marks < segs)
    assert np.array_equal(np.where(in_run, marks, -1), np.where(derived < segs, derived, -1))
    got, taken = _kernel_schedule(x, order, start, marks, 4, m, 2)
    lens = np.diff(start)
    assert sorted(taken) == sorted([(s, k) for s in range(segs) if lens[s] > 4
                                    for k in range(-(-lens[s] // 4))]
                                   + [(s, -1) for s in range(segs) if m < lens[s] <= 4])
    want = segment_sum(torch.from_numpy(x), torch.from_numpy(seg), segs, layout).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("chunk", [256, 4])
def test_same_bits_with_rows_shuffled_across_segments(monkeypatch, chunk):
    """The order is each segment's own rows in index order, nothing else:
    moving rows between positions, each segment's kept in order, leaves the
    bits."""
    monkeypatch.setattr(SS, "CHUNK", chunk)
    x, seg = _case(3000, 6, 50, 11)
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    first = segment_sum(xt, st, 50)
    assert torch.equal(first, segment_sum(xt, st, 50))
    # a random interleaving of the segments' row lists, each list in order:
    # a random permutation, then each position takes its segment's next row
    order = np.random.default_rng(3).permutation(seg.shape[0])
    by_seg = {}
    for i in range(seg.shape[0]):
        by_seg.setdefault(int(seg[i]), []).append(i)
    perm = np.array([by_seg[int(seg[i])].pop(0) for i in order])
    xs, ss = torch.from_numpy(x[perm]), torch.from_numpy(seg[perm])
    assert not np.array_equal(perm, np.arange(perm.shape[0]))
    assert torch.equal(segment_sum(xs, ss, 50), first)


def test_gradcheck_float64():
    rng = np.random.default_rng(0)
    seg = torch.from_numpy(rng.integers(-1, 8, 40))
    x = torch.from_numpy(rng.standard_normal((40, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a: segment_sum(a, seg, 7), (x,))
    layout = segment_layout(seg, 7)
    assert torch.autograd.gradcheck(lambda a: segment_sum(a, seg, 7, layout), (x,))
    ids = torch.from_numpy(rng.integers(0, 9, (5, 6)))
    table = torch.from_numpy(rng.standard_normal((9, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: take(t, ids), (table,))


def test_take_gradient_is_the_segment_sum():
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 30, (64, 7)).astype(np.int32))
    table = torch.from_numpy(rng.standard_normal((30, 18)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((64, 7, 18)).astype(np.float32))
    t = table.clone().requires_grad_(True)
    rows = take(t, ids)
    assert torch.equal(rows, table[ids.long()])
    rows.backward(g)
    assert torch.equal(t.grad, segment_sum(g.reshape(-1, 18), ids.reshape(-1), 30))
    assert torch.equal(t.grad, _sequential(g.reshape(-1, 18), ids.reshape(-1), 30))


def test_take_layout_of_fewer_segments_leaves_the_last_rows_out():
    """The MoE dispatch's zero row: ids naming rows past the layout's
    segments take no gradient, and those rows get none."""
    x = torch.randn(5, 3, requires_grad=True)
    pad = torch.cat([x, torch.zeros(1, 3)])
    ids = torch.tensor([0, 5, 2, 5, 0])
    layout = segment_layout(ids, 5, max_run=4)
    take(pad, ids, layout).sum().backward()
    assert torch.equal(x.grad, torch.tensor([[2.0] * 3, [0.0] * 3, [1.0] * 3, [0.0] * 3,
                                             [0.0] * 3]))


def test_max_run_skips_the_host_read_and_keeps_the_order():
    rng = np.random.default_rng(2)
    seg = torch.from_numpy(rng.integers(0, 100, 300))
    x = torch.from_numpy(rng.standard_normal((300, 4)).astype(np.float32))
    free = segment_layout(seg, 100, max_run=SS.CHUNK)
    read = segment_layout(seg, 100, covers_all=True)
    assert len(free.levels) == 1 and not free.covers_all and read.covers_all
    assert torch.equal(segment_sum(x, seg, 100, free), segment_sum(x, seg, 100, read))
    by_runs = SegmentLayout(order=None, start=read.start, num_rows=300)
    assert torch.equal(segment_sum(x[read.order], seg[read.order], 100, by_runs),
                       segment_sum(x, seg, 100))


def test_fake_output_rule_is_the_index_add():
    from torch._subclasses.fake_tensor import FakeTensorMode

    x = torch.randn(40, 6)
    seg = torch.randint(0, 9, (40,))
    mode = FakeTensorMode()
    with mode, KernelWork() as work:
        fx, fs = mode.from_tensor(x), mode.from_tensor(seg)
        got = segment_sum(fx, fs, 9)
    assert is_fake(got) and got.shape == (9, 6) and got.dtype == torch.float32
    assert work.calls == {} and work.flops == 0
    before = dict(SS.LAUNCHES)
    segment_sum(x, seg, 9)
    assert SS.LAUNCHES == before  # the CPU never launches


def test_wrapper_checks():
    x = torch.randn(10, 4)
    seg = torch.randint(0, 3, (10,))
    with pytest.raises(ValueError, match="layout"):
        segment_sum(x, seg, 4, segment_layout(seg, 3))
    with pytest.raises(ValueError, match="layout"):
        segment_sum(x[:9], seg[:9], 3, segment_layout(seg, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        SS.fold_runs(x.to("meta"), None, torch.zeros(2, dtype=torch.int64, device="meta"),
                     torch.float32)
