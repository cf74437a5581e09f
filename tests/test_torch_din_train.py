"""DIN training in the port against the JAX reference, on the CPU.

  * ``steps.make_din_train_step``: one step's loss, and every gradient of
    the loss (``cate_table``'s asserted on its own: the profile bag's part
    reaches it only through the embedding bag's backward), within rtol 1e-5
    of ``jax.value_and_grad`` of the reference's DIN loss; three AdamW steps'
    losses and parameters within the GNN train tests' tolerance; the
    reference's weights carried across (``din.params_from_reference``);
  * ``make_din_serve`` and ``make_din_retrieval`` (one pass and two chunk
    sizes) against the reference's builders;
  * the embedding bag's ``torch.autograd.Function`` on the CPU: its
    backward bit for bit against ``np.add.at`` (unbuffered, in index order)
    over the (b, i) row-major terms, sum and mean, on repeated ids in a bag,
    all-padding bags, B = 1 and L = 1, one id in 5,000 slots; the backward
    kernel's run layout
    (``kernel.backward_runs``: the stable sort and the run starts) walked in
    order on the CPU gives the same bits; ``torch.autograd.grad`` through
    ``ops.embedding_bag`` against ``jax.grad`` through the reference's
    ``embedding_bag_reference``.

The trainer CLI's ``--arch din`` run is in tests/test_torch_train.py.
Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as RS
from repro.configs.registry import get as r_get
from repro.kernels.embedding_bag.ref import embedding_bag_reference as r_bag
from repro.models.recsys import din as rdin
from repro.train import losses as rlosses
from repro.train import optim as roptim
from repro.train import steps as rsteps

import repro_torch.data.synthetic as TS
from repro_torch.configs.registry import get as t_get
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_backward_reference
from repro_torch.kernels.embedding_bag.kernel import backward_runs
from repro_torch.models.recsys import din as tdin
from repro_torch.train import optim, steps
from repro_torch.train.optim import tree_flatten

TOL = dict(rtol=1e-5, atol=1e-6)  # the DIN scoring and GNN train tests' tolerance
GRAD_TOL = dict(rtol=1e-5, atol=1e-8)


@pytest.fixture(scope="module")
def smoke():
    cfg_r, cfg_t = r_get("din").smoke(), t_get("din").smoke()
    params = rdin.init(jax.random.key(0), cfg_r)
    tree = jax.tree.map(np.asarray, params)
    return cfg_r, cfg_t, params, tree


def _batch(cfg, step, batch=64):
    return TS.recsys_batch(1, step, batch, cfg.seq_len, cfg.item_vocab, cfg.cate_vocab,
                           cfg.profile_bag_len)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _ref_loss(cfg):
    def loss_fn(params, batch):
        return rlosses.binary_xent(rdin.score(params, batch, cfg), batch["labels"])

    return loss_fn


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_recsys_batch_matches_reference(smoke):
    _, cfg_t, _, _ = smoke
    got = _batch(cfg_t, 3)
    want = RS.recsys_batch(1, 3, 64, cfg_t.seq_len, cfg_t.item_vocab, cfg_t.cate_vocab,
                           cfg_t.profile_bag_len)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("step", [0, 5])
def test_din_loss_and_grads_match_reference(smoke, step):
    cfg_r, cfg_t, params, tree = smoke
    b = _batch(cfg_t, step)
    want_loss, want_grads = jax.value_and_grad(_ref_loss(cfg_r))(params, _jnp(b))
    tparams = tdin.params_from_reference(tree, "cpu")
    loss, grads = steps.value_and_grad(steps.make_din_loss(cfg_t), tparams,
                                       tdin.batch_to(b, "cpu"))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    got = [g.numpy() for g in tree_flatten(grads)[0]]
    want = _leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    # the profile bag's gradient reaches cate_table only through the bag's
    # backward: it must be there, and not be what the history takes give
    # alone
    np.testing.assert_allclose(grads["cate_table"].numpy(), np.asarray(want_grads["cate_table"]),
                               **GRAD_TOL)
    kernel_bag = tdin.embedding_bag
    tdin.embedding_bag = lambda table, ids, mode: kernel_bag(table, ids, mode).detach()
    try:
        _, detached = steps.value_and_grad(steps.make_din_loss(cfg_t), tparams,
                                           tdin.batch_to(b, "cpu"))
    finally:
        tdin.embedding_bag = kernel_bag
    assert not torch.equal(detached["cate_table"], grads["cate_table"])
    assert torch.equal(detached["item_table"], grads["item_table"])


class _AddAtTake(torch.autograd.Function):
    """``table[ids]`` whose table gradient is ``np.add.at`` in flat id order:
    the sequential float32 fold the fixed-order segment sum promises."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = tuple(table.shape)
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        out = np.zeros(ctx.shape, np.float32)
        np.add.at(out, ids.reshape(-1).numpy(), g.reshape(-1, ctx.shape[1]).numpy())
        return torch.from_numpy(out), None


@pytest.mark.parametrize("step", [0, 5])
def test_din_takes_sum_their_gradients_in_fixed_order(smoke, step, monkeypatch):
    """The four takes (history and target, items and categories) run through
    ``kernels.segment_sum.take``: one fixed-order sum each in the backward
    (no ``index_select`` backward), and the tables' gradients bit for bit
    those of takes summed by ``np.add.at`` in id order."""
    from repro_torch.kernels.segment_sum import kernel as SS

    _, cfg_t, _, tree = smoke
    b = tdin.batch_to(_batch(cfg_t, step), "cpu")
    tparams = tdin.params_from_reference(tree, "cpu")
    calls = []
    real = SS.segment_sum_rows
    monkeypatch.setattr(SS, "segment_sum_rows",
                        lambda x, seg, layout, n: calls.append(n) or real(x, seg, layout, n))
    _, grads = steps.value_and_grad(steps.make_din_loss(cfg_t), tparams, b)
    assert sorted(calls) == [cfg_t.cate_vocab] * 2 + [cfg_t.item_vocab] * 2
    monkeypatch.setattr(tdin, "take", _AddAtTake.apply)
    _, want = steps.value_and_grad(steps.make_din_loss(cfg_t), tparams, b)
    assert len(calls) == 4
    for k in ("item_table", "cate_table"):
        assert torch.equal(grads[k], want[k]), k


def test_din_train_steps_match_reference(smoke):
    cfg_r, cfg_t, params, tree = smoke
    ocfg = dict(lr=1e-3, total_steps=3, warmup_steps=2)
    r_step = jax.jit(rsteps.make_din_train_step(cfg_r, roptim.AdamWConfig(**ocfg)))
    t_step = steps.make_din_train_step(cfg_t, optim.AdamWConfig(**ocfg))
    rs = rsteps.init_train_state(jax.tree.map(jnp.asarray, tree), roptim.AdamWConfig(**ocfg))
    ts = steps.init_train_state(tdin.params_from_reference(tree, "cpu"),
                                optim.AdamWConfig(**ocfg))
    r_losses, t_losses = [], []
    for i in range(3):
        b = _batch(cfg_t, i)
        rs, rm = r_step(rs, _jnp(b))
        ts, tm = t_step(ts, tdin.batch_to(b, "cpu"))
        r_losses.append(float(rm["loss"]))
        t_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(t_losses, r_losses, **TOL)
    got = [x.numpy() for x in tree_flatten(ts["params"])[0]]
    want = _leaves(rs["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert int(ts["opt"].step) == 3


def test_din_serve_matches_reference(smoke):
    cfg_r, cfg_t, params, tree = smoke
    b = {k: v for k, v in _batch(cfg_t, 2, batch=37).items() if k != "labels"}
    want = np.asarray(rsteps.make_din_serve(cfg_r)(params, _jnp(b)))
    got = steps.make_din_serve(cfg_t)(tdin.params_from_reference(tree, "cpu"),
                                      tdin.batch_to(b, "cpu"))
    assert got.shape == (37,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("chunk", [None, 32, 128])
def test_din_retrieval_matches_reference(smoke, chunk):
    cfg_r, cfg_t, params, tree = smoke
    rb = TS.retrieval_batch(4, cfg_t.seq_len, 256, cfg_t.item_vocab, cfg_t.cate_vocab,
                            cfg_t.profile_bag_len)
    want = np.asarray(rsteps.make_din_retrieval(cfg_r, chunk=chunk)(params, _jnp(rb)))
    got = steps.make_din_retrieval(cfg_t, chunk=chunk)(tdin.params_from_reference(tree, "cpu"),
                                                       tdin.batch_to(rb, "cpu"))
    assert got.shape == (256,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _bag_case(kind, seed=0):
    """(ids (B, L) int32, grad_out (B, D) float32, N) for a named case."""
    rng = np.random.default_rng(seed)
    shapes = {"random": (40, 12, 9, 18), "repeats": (16, 20, 3, 5), "all_padding": (9, 7, 6, 3),
              "one_bag": (1, 32, 50, 18), "one_id": (33, 1, 8, 2), "hub": (24, 10, 5, 4)}
    b, length, n, d = shapes[kind]
    ids = rng.integers(0, n, (b, length)).astype(np.int32)
    ids[rng.random((b, length)) < 0.3] = -1
    if kind == "repeats":  # each bag names few rows many times
        ids = rng.integers(-1, n, (b, length)).astype(np.int32)
    if kind == "all_padding":
        ids[::2] = -1  # every other bag all padding
        ids[3] = -1
    if kind == "hub":  # one id in every slot
        ids[:] = 2
    # magnitudes spread over six decades so that the order of the adds shows
    scale = np.float32(10.0) ** rng.integers(-3, 3, (b, 1)).astype(np.float32)
    g = (rng.standard_normal((b, d)).astype(np.float32) * scale).astype(np.float32)
    return ids, g, n


def _add_at(ids, g, n, mode):
    """The (b, i) row-major sum from +0 with np.add.at (unbuffered, in order)."""
    valid = ids >= 0
    terms = g / np.maximum(valid.sum(1), 1).astype(np.float32)[:, None] if mode == "mean" else g
    out = np.zeros((n, g.shape[1]), np.float32)
    bb, ii = np.nonzero(valid)  # row-major: (b, i) order
    np.add.at(out, ids[bb, ii], terms[bb])
    return out


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["random", "repeats", "all_padding", "one_bag", "one_id", "hub"])
def test_bag_backward_bits_match_add_at(kind, mode):
    ids, g, n = _bag_case(kind)
    want = _add_at(ids, g, n, mode)
    ref = embedding_bag_backward_reference(torch.from_numpy(g), torch.from_numpy(ids), n, mode)
    assert np.array_equal(_bits(ref.numpy()), _bits(want))
    table = torch.zeros((n, g.shape[1]), requires_grad=True)
    out = embedding_bag(table, torch.from_numpy(ids), mode)
    (grad,) = torch.autograd.grad(out, table, torch.from_numpy(g))
    assert grad.dtype == torch.float32 and grad.shape == (n, g.shape[1])
    assert np.array_equal(_bits(grad.numpy()), _bits(want))
    untouched = np.setdiff1d(np.arange(n), ids[ids >= 0])
    assert not grad[torch.from_numpy(untouched)].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["random", "repeats", "all_padding", "one_id", "hub"])
def test_bag_backward_runs_walked_in_order(kind, mode):
    """What the backward kernel does, on the CPU: each row's run of the
    stably sorted positions walked in order from +0."""
    ids, g, n = _bag_case(kind, seed=1)
    order, start = backward_runs(torch.from_numpy(ids), n)
    order, start = order.numpy(), start.numpy()
    length = ids.shape[1]
    assert start.shape == (n + 1,) and start[-1] == ids.size
    assert start[0] == int((ids < 0).sum())  # padding sorts first, in no run
    cnt = np.maximum((ids >= 0).sum(1), 1).astype(np.float32)
    out = np.zeros((n, g.shape[1]), np.float32)
    for row in range(n):
        run = order[start[row]:start[row + 1]]
        assert np.all(np.diff(run) > 0)  # (b, i) order
        assert np.all(ids.reshape(-1)[run] == row)
        acc = np.zeros(g.shape[1], np.float32)
        for pos in run:
            term = g[pos // length] / cnt[pos // length] if mode == "mean" else g[pos // length]
            acc = (acc + term).astype(np.float32)
        out[row] = acc
    assert np.array_equal(_bits(out), _bits(_add_at(ids, g, n, mode)))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["random", "repeats", "all_padding", "one_id", "hub",
                                  "long_hub"])
def test_bag_backward_launch_is_the_segment_sum_walk(kind, mode):
    """The backward's launch (the segment-sum kernel over the ids' runs, each
    term its bag's gradient row, divided first for mean) on the CPU, where
    the segment sum's plain version walks the kernel's order: the bits of
    ``np.add.at`` in (b, i) order, a hub of 1,200 ids (past the segment
    sum's 256-row chunk) in one level, and no launch counted."""
    from repro_torch.kernels.embedding_bag import kernel as EBK
    from repro_torch.kernels.segment_sum import kernel as SS

    if kind == "long_hub":
        ids, g, n = _bag_case("hub", seed=2)
        ids = np.tile(ids, (5, 5))  # (120, 50), 2 in every slot
        g = np.tile(g, (5, 1))
    else:
        ids, g, n = _bag_case(kind, seed=2)
    t_ids = torch.from_numpy(ids)
    order, start = backward_runs(t_ids, n)
    counts = (t_ids >= 0).sum(dim=1, dtype=torch.int32) if mode == "mean" else None
    before, ss_before = dict(EBK.LAUNCHES), dict(SS.LAUNCHES)
    got = EBK.launch_backward(torch.from_numpy(g), order, start, counts, ids.shape[1], mode)
    assert EBK.LAUNCHES == before and SS.LAUNCHES == ss_before
    assert got.dtype == torch.float32 and got.shape == (n, g.shape[1])
    assert np.array_equal(_bits(got.numpy()), _bits(_add_at(ids, g, n, mode)))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_backward_run_of_5000_bits_match_add_at(mode):
    """One id in 5,000 slots (a run past the segment sum's 256-row chunk,
    which the bag's backward walks whole, not in chunks) beside random ids:
    the op's gradient and the backward's launch on the CPU bit for bit
    ``np.add.at`` in (b, i) order."""
    from repro_torch.kernels.embedding_bag import kernel as EBK

    rng = np.random.default_rng(5)
    b, length, n, d = 250, 24, 40, 18
    ids = rng.integers(-1, n, (b, length)).astype(np.int32)
    ids[:, :20] = 7
    assert int((ids == 7).sum()) >= 5000
    scale = np.float32(10.0) ** rng.integers(-3, 3, (b, 1)).astype(np.float32)
    g = (rng.standard_normal((b, d)).astype(np.float32) * scale).astype(np.float32)
    want = _add_at(ids, g, n, mode)
    table = torch.zeros((n, d), requires_grad=True)
    out = embedding_bag(table, torch.from_numpy(ids), mode)
    (grad,) = torch.autograd.grad(out, table, torch.from_numpy(g))
    assert np.array_equal(_bits(grad.numpy()), _bits(want))
    t_ids = torch.from_numpy(ids)
    order, start = backward_runs(t_ids, n)
    counts = (t_ids >= 0).sum(dim=1, dtype=torch.int32) if mode == "mean" else None
    got = EBK.launch_backward(torch.from_numpy(g), order, start, counts, length, mode)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_grad_matches_jax_grad(mode):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((30, 7)).astype(np.float32)
    ids = rng.integers(-1, 30, (25, 9)).astype(np.int32)
    ids[4] = -1
    w = rng.standard_normal((25, 7)).astype(np.float32)

    def r_loss(t):
        return jnp.sum(jnp.sin(r_bag(t, jnp.asarray(ids), mode)) * w)

    want = np.asarray(jax.grad(r_loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    loss = (torch.sin(embedding_bag(t, torch.from_numpy(ids), mode)) * torch.from_numpy(w)).sum()
    (got,) = torch.autograd.grad(loss, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bag_without_grad_is_the_plain_forward():
    ids, _, n = _bag_case("random", seed=2)
    table = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 18)).astype(np.float32))
    from repro_torch.kernels.embedding_bag import embedding_bag_reference

    for mode in ("sum", "mean"):
        out = embedding_bag(table, torch.from_numpy(ids), mode)
        assert not out.requires_grad
        assert torch.equal(out, embedding_bag_reference(table, torch.from_numpy(ids), mode))
