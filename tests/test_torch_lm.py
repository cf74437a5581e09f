"""The port's LM family against the JAX reference, on the CPU.

At every LM arch's ``smoke()`` config and the reference's ``TINY``
(``tests/test_models.py``), with the reference's weights carried across by
``params_from_reference``:

  * ``forward`` logits and aux loss; each ``decode_step``'s logits over a
    16-token prompt fed one token at a time; the train step's loss and
    every gradient (``make_lm_loss`` under ``value_and_grad`` against
    ``jax.value_and_grad`` of the reference's loss), all within rtol 1e-5;
    two ``make_lm_train_step`` steps (AdamW) against the reference's, and
    ``grad_accum=2`` against the reference's scan;
  * greedy decode tokens (``launch.serve.serve_lm``'s loop) equal;
  * the three MoE cases of ``tests/test_models.py`` (capacity drop and
    combine, grouped equal to ungrouped, zero-capacity overflow) against
    ``repro``'s ``moe_ffn`` / ``moe_ffn_grouped``, and inputs with tied
    gates, where the expert choice must follow ``jax.lax.top_k``'s order;
    on inputs where every float op is exact (dyadic values, gates of 1 or
    1/2), an expert that gets no token and tied gates: ``_route``'s slots
    bit-equal to the reference's (read from its traced program) and the
    outputs bit-equal;
  * the MoE dispatch's take and combine's sum through the fixed-order
    segment sum (one each a call, grouped or not), gradients against
    ``jax.grad``;
  * ``count_params`` / ``active_params``, ``lm_batch`` bit for bit, the LM
    configs and ``LM_SHAPES`` value for value, the registry's ``ASSIGNED``,
    ``EXTRA`` and ``ASSIGNED_IDS`` id for id;
  * ``repro_torch.models.transformer``, ``repro_torch.kernels.flash_attention``
    and the launchers import neither jax nor ``repro``.

Inputs come from numpy seeds. The smoke configs are float32; the model's
attention on the CPU is the flash kernel's plain version (blocks of 128 x
64 keys), the reference's the chunked twin, so logits agree to rounding.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as RS
from repro.configs.base import LM_SHAPES as R_LM_SHAPES
from repro.configs.registry import get as r_get
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro.train import losses as rlosses
from repro.train import optim as roptim
from repro.train import steps as rsteps

import repro_torch.data.synthetic as TS
from repro_torch.configs.base import LM_SHAPES
from repro_torch.configs.registry import get as t_get
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.train import optim, steps
from repro_torch.train.optim import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ("smollm-135m", "llama3-8b", "qwen3-14b", "qwen3-moe-30b-a3b",
            "granite-moe-1b-a400m")
RTOL = 1e-5

R_TINY = rtfm.LMConfig(name="tiny", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab=101, qk_norm=True, dtype=jnp.float32, attn_chunk=8)
T_TINY = tfm.LMConfig(name="tiny", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab=101, qk_norm=True, dtype=torch.float32, attn_chunk=8)


def _cfgs(name):
    if name == "tiny":
        return R_TINY, T_TINY
    return r_get(name).smoke(), t_get(name).smoke()


def _setup(name, seed=0):
    cfg_r, cfg_t = _cfgs(name)
    tree = jax.tree.map(np.asarray, rtfm.init_params(jax.random.key(seed), cfg_r))
    return cfg_r, cfg_t, tree, tfm.params_from_reference(tree, cfg_t, "cpu")


def _close(got, want, rtol=RTOL):
    """Within rtol of the reference, with an atol of rtol times the
    largest magnitude (entries near 0 carry the rounding of the others)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1e-6, np.abs(want).max()))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", LM_ARCHS + ("tiny",))
def test_forward_matches_reference(name):
    cfg_r, cfg_t, tree, params = _setup(name)
    toks = _tokens(cfg_r, 2, 16, seed=1)
    want, want_aux = jax.jit(lambda p, t: rtfm.forward(p, t, cfg_r))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tfm.forward(params, torch.from_numpy(toks), cfg_t)
    assert got.shape == (2, 16, cfg_t.vocab) and got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(aux.numpy(), want_aux)


@pytest.mark.parametrize("name", LM_ARCHS + ("tiny",))
def test_decode_steps_match_reference(name):
    cfg_r, cfg_t, tree, params = _setup(name, seed=2)
    toks = _tokens(cfg_r, 2, 16, seed=3)
    rp = jax.tree.map(jnp.asarray, tree)
    cache_r = rtfm.init_kv_cache(cfg_r, 2, 16, dtype=jnp.float32)
    cache_t = tfm.init_kv_cache(cfg_t, 2, 16, device="cpu")
    step_r = jax.jit(lambda p, c, t, i: rtfm.decode_step(p, c, t, i, cfg_r))
    step_t = steps.make_lm_decode_step(cfg_t)
    for i in range(16):
        want, cache_r = step_r(rp, cache_r, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        got, cache_t = step_t(params, cache_t, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(got.numpy(), want)
    _close(cache_t["k"].numpy(), cache_r["k"])
    _close(cache_t["v"].numpy(), cache_r["v"])


def _reference_loss(cfg):
    """The reference's LM train loss (``repro.train.steps.make_lm_train_step``)."""
    def loss_fn(params, tokens, labels):
        logits, aux = rtfm.forward(params, tokens, cfg)
        if cfg.vocab_real is not None and cfg.vocab_real < cfg.vocab:
            pad_mask = jnp.arange(cfg.vocab) >= cfg.vocab_real
            logits = jnp.where(pad_mask, jnp.asarray(-1e30, logits.dtype), logits)
        return rlosses.softmax_xent(logits, labels) + aux

    return loss_fn


@pytest.mark.parametrize("name", LM_ARCHS + ("tiny",))
def test_loss_and_grads_match_reference(name):
    cfg_r, cfg_t, tree, params = _setup(name, seed=4)
    batch = RS.lm_batch(seed=5, step=0, batch=2, seq=24, vocab=cfg_r.vocab)
    loss_r, grads_r = jax.jit(jax.value_and_grad(_reference_loss(cfg_r)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["labels"]))
    loss_t, grads_t = steps.value_and_grad(steps.make_lm_loss(cfg_t), params,
                                           torch.from_numpy(batch["tokens"]),
                                           torch.from_numpy(batch["labels"]))
    _close(loss_t.numpy(), loss_r)
    flat_t, _ = tree_flatten(grads_t)
    flat_r = jax.tree.leaves(grads_r)  # sorted keys, as tree_flatten
    assert len(flat_t) == len(flat_r)
    for a, b in zip(flat_t, flat_r):
        assert a.shape == b.shape
        _close(a.numpy(), b)


def test_padded_vocab_is_masked_in_the_loss():
    cfg_r = dataclasses.replace(r_get("granite-moe-1b-a400m").smoke(), vocab=256, vocab_real=250)
    cfg_t = dataclasses.replace(t_get("granite-moe-1b-a400m").smoke(), vocab=256, vocab_real=250)
    tree = jax.tree.map(np.asarray, rtfm.init_params(jax.random.key(6), cfg_r))
    params = tfm.params_from_reference(tree, cfg_t, "cpu")
    batch = RS.lm_batch(seed=6, step=1, batch=2, seq=16, vocab=250)
    want = _reference_loss(cfg_r)(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]))
    with torch.no_grad():
        got = steps.make_lm_loss(cfg_t)(params, torch.from_numpy(batch["tokens"]),
                                        torch.from_numpy(batch["labels"]))
    _close(got.numpy(), want)


@pytest.mark.parametrize("name,accum", [("smollm-135m", 1), ("qwen3-moe-30b-a3b", 1),
                                        ("tiny", 2)])
def test_train_steps_match_reference(name, accum):
    cfg_r, cfg_t, tree, params = _setup(name, seed=7)
    ocfg = dict(lr=1e-3, total_steps=2, warmup_steps=1)
    step_r = jax.jit(rsteps.make_lm_train_step(cfg_r, roptim.AdamWConfig(**ocfg),
                                               grad_accum=accum))
    step_t = steps.make_lm_train_step(cfg_t, optim.AdamWConfig(**ocfg), grad_accum=accum)
    rs = rsteps.init_train_state(jax.tree.map(jnp.asarray, tree), roptim.AdamWConfig(**ocfg))
    ts = steps.init_train_state(params, optim.AdamWConfig(**ocfg))
    for i in range(2):
        b = RS.lm_batch(seed=8, step=i, batch=4, seq=16, vocab=cfg_r.vocab)
        rs, rm = step_r(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = step_t(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        _close(tm["loss"].numpy(), rm["loss"])
    for a, b in zip(tree_flatten(ts["params"])[0], jax.tree.leaves(rs["params"])):
        _close(a.numpy(), b, rtol=1e-4)  # AdamW's update ~ lr * sign(g) where g ~ 0


@pytest.mark.parametrize("name", ["smollm-135m", "granite-moe-1b-a400m", "tiny"])
def test_greedy_decode_tokens_equal(name):
    from repro_torch.launch.serve import serve_lm

    cfg_r, cfg_t, tree, params = _setup(name, seed=0)
    n, batch = 12, 3
    rp = jax.tree.map(jnp.asarray, tree)
    cache = rtfm.init_kv_cache(cfg_r, batch, n + 8, dtype=jnp.float32)
    step = jax.jit(lambda p, c, t, i: rtfm.decode_step(p, c, t, i, cfg_r))
    tok = jnp.zeros((batch, 1), jnp.int32)
    want = []
    for i in range(n):
        logits, cache = step(rp, cache, tok, jnp.int32(i))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    got, _ = serve_lm(None, n, batch, "cpu", cfg=cfg_t, params=params)
    np.testing.assert_array_equal(got, np.stack(want, 1))


# -- MoE: tests/test_models.py's cases, port against reference ---------------


def _moe_inputs(seed, t, d, e, f=8, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * scale).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    return [x, router, *w]


def _moe_both(args, cfg_kw, capacity, groups=None):
    rcfg, tcfg = rlayers.MoEConfig(**cfg_kw), layers.MoEConfig(**cfg_kw)
    if groups is None:
        want = rlayers.moe_ffn(*map(jnp.asarray, args), rcfg, capacity=capacity)
        got = layers.moe_ffn(*map(torch.from_numpy, args), tcfg, capacity=capacity)
    else:
        want = rlayers.moe_ffn_grouped(*map(jnp.asarray, args), rcfg, capacity=capacity,
                                       groups=groups)
        got = layers.moe_ffn_grouped(*map(torch.from_numpy, args), tcfg, capacity=capacity,
                                     groups=groups)
    return got, want


def test_moe_capacity_drop_and_combine_matches_reference():
    t, k = 32, 2
    got, want = _moe_both(_moe_inputs(0, t, 16, 4), dict(num_experts=4, top_k=k, d_ff_expert=8),
                          capacity=t * k)
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    assert float(got[1]) >= 0


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_grouped_matches_reference(groups):
    t, k = 64, 2
    args = _moe_inputs(3, t, 16, 4)
    cfg = dict(num_experts=4, top_k=k, d_ff_expert=8)
    got, want = _moe_both(args, cfg, capacity=(t // groups) * k, groups=groups)
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    ungrouped, _ = _moe_both(args, cfg, capacity=t * k)  # the reference's own check
    np.testing.assert_allclose(got[0].numpy(), ungrouped[0].numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("groups", [None, 2])
def test_moe_dispatch_and_combine_run_through_the_fixed_order_op(groups, monkeypatch):
    """The dispatch's take and the combine's sum go through
    ``kernels.segment_sum``, one of each a call over all groups (no
    ``index_add`` and no ``gather``), and the gradients of the tokens and
    every weight match ``jax.grad`` of the reference's MoE."""
    from repro_torch.kernels.segment_sum import kernel as SS

    t, k = 32, 2
    args = _moe_inputs(5, t, 16, 4)
    cfg_kw = dict(num_experts=4, top_k=k, d_ff_expert=8)
    rcfg, tcfg = rlayers.MoEConfig(**cfg_kw), layers.MoEConfig(**cfg_kw)
    capacity = (t // (groups or 1)) * k // 2  # some slots dropped, some empty
    coef = np.random.default_rng(6).standard_normal((t, 16)).astype(np.float32)

    def r_loss(*a):
        out, aux = (rlayers.moe_ffn(*a, rcfg, capacity=capacity) if groups is None else
                    rlayers.moe_ffn_grouped(*a, rcfg, capacity=capacity, groups=groups))
        return (out * coef).sum() + aux

    want = jax.grad(r_loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    calls = []
    real = SS.segment_sum_rows
    monkeypatch.setattr(SS, "segment_sum_rows",
                        lambda x, seg, layout, n: calls.append(n) or real(x, seg, layout, n))
    for name in ("index_add", "index_add_", "gather"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **kw: pytest.fail(name))
    monkeypatch.setattr(torch, "gather", lambda *a, **kw: pytest.fail("gather"))
    live = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out, aux = (layers.moe_ffn(*live, tcfg, capacity=capacity) if groups is None else
                layers.moe_ffn_grouped(*live, tcfg, capacity=capacity, groups=groups))
    ((out * torch.from_numpy(coef)).sum() + aux).backward()
    assert calls == [t, t]  # the combine, then the take's gradient
    for got, w in zip(live, want):
        _close(got.grad.numpy(), np.asarray(w))


def test_moe_capacity_zero_overflow_matches_reference():
    got, want = _moe_both(_moe_inputs(1, 16, 8, 4, f=4, scale=1.0),
                          dict(num_experts=4, top_k=1, d_ff_expert=4), capacity=8)
    assert got[0].shape == (16, 8) and bool(torch.isfinite(got[0]).all())
    _close(got[0].numpy(), want[0])


@pytest.mark.parametrize("top_k,groups", [(1, None), (2, None), (2, 2)])
def test_moe_tied_gates_follow_top_k_order(top_k, groups):
    """Experts 1 and 2 get bit-equal gates for every token: where the pair
    straddles the top-k boundary, the reference's top_k takes the lower index
    first, so must the port; the other order routes those tokens to the
    other expert and moves the output."""
    t, d, e = 32, 16, 4
    args = _moe_inputs(9, t, d, e)
    args[1][:, 2] = args[1][:, 1]
    capacity = (t // (groups or 1)) * top_k
    got, want = _moe_both(args, dict(num_experts=e, top_k=top_k, d_ff_expert=8),
                          capacity=capacity, groups=groups)
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    # a tie broken the other way gives another output
    flipped = [a.copy() for a in args]
    for w in flipped[2:]:
        w[[1, 2]] = w[[2, 1]]
    other, _ = _moe_both(flipped, dict(num_experts=e, top_k=top_k, d_ff_expert=8),
                         capacity=capacity, groups=groups)
    assert not np.allclose(other[0].numpy(), want[0], rtol=1e-3, atol=1e-4)


def _reference_scatters(fn, *args):
    """The outputs of every ``scatter`` the reference's ``fn`` runs on ``args``
    (its jaxpr evaluated one equation at a time): ``moe_ffn``'s slot tokens
    and slot gates, (E*C + 1,) each, or (G, E*C + 1) under the grouped
    dispatch's ``vmap``."""
    closed = jax.make_jaxpr(fn)(*args)
    env, got = {}, []

    def read(v):
        return v.val if isinstance(v, jax.extend.core.Literal) else env[v]

    env.update(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, args))
    for eqn in closed.jaxpr.eqns:
        outs = eqn.primitive.bind(*map(read, eqn.invars), **eqn.params)
        outs = outs if eqn.primitive.multiple_results else [outs]
        if eqn.primitive.name == "scatter":
            got.append(np.asarray(outs[0]))
        env.update(zip(eqn.outvars, outs))
    return got


def _exact_moe_inputs(seed, t, top_k):
    """Inputs on which every float op of the dispatch is exact in both
    packages: dyadic x and weights; h = x @ w1 >= 20, where silu(h) = h in
    float32; top_k 1 (a gate of g / g = 1) with random routing, or top_k 2
    with experts 1 and 2 always the pair (gates 1/2). Experts 1 and 2 share
    a router column, so their gates tie bit for bit: with top_k 1 expert 2
    never wins (the lower index does), with top_k 2 experts 0 and 3 get no
    token; with top_k 1 expert 3's column keeps it empty."""
    d, e, f = 8, 4, 4
    rng = np.random.default_rng(seed)
    x = rng.integers(2, 6, (t, d)).astype(np.float32) * 0.5
    router = (rng.standard_normal((d, e)) * 0.3).astype(np.float32)
    if top_k == 1:
        router[:, 3] = -4.0
    else:
        router[:, [0, 3]] = -0.25
        router[:, 1] = 0.25
    router[:, 2] = router[:, 1]
    w13 = [rng.integers(5, 7, (e, d, f)).astype(np.float32) * 0.5 for _ in range(2)]
    w2 = rng.integers(-2, 3, (e, f, d)).astype(np.float32) * 0.5
    return [x, router, w13[0], w13[1], w2]


@pytest.mark.parametrize("top_k,groups", [(1, None), (1, 2), (2, None), (2, 2)])
def test_moe_empty_expert_and_tied_gates_are_bit_equal(top_k, groups):
    t, capacity = 32, 8  # expert 1 (top_k 1) or 1 and 2 (top_k 2) overflow it
    args = _exact_moe_inputs(5, t, top_k)
    cfg_kw = dict(num_experts=4, top_k=top_k, d_ff_expert=4)
    rcfg, tcfg = rlayers.MoEConfig(**cfg_kw), layers.MoEConfig(**cfg_kw)
    jargs = list(map(jnp.asarray, args))
    if groups is None:
        ref = _reference_scatters(lambda *a: rlayers.moe_ffn(*a, rcfg, capacity=capacity), *jargs)
    else:
        ref = _reference_scatters(lambda *a: rlayers.moe_ffn_grouped(
            *a, rcfg, capacity=capacity, groups=groups), *jargs)
    tok_ref, gate_ref = (r.reshape(groups or 1, -1)[:, :-1] for r in ref)
    x, router = torch.from_numpy(args[0]), torch.from_numpy(args[1])
    load = np.zeros(4, int)
    for i, xg in enumerate(x.reshape(groups or 1, -1, x.shape[1])):
        tok, gate, _, ce = layers._route(xg, router, tcfg, capacity)
        np.testing.assert_array_equal(tok.numpy(), tok_ref[i])
        np.testing.assert_array_equal(gate.numpy(), gate_ref[i])
        load += (ce.numpy() * xg.shape[0] * top_k).round().astype(int)
    assert (load == 0).sum() >= 2 and load.max() > (groups or 1) * capacity  # empty, dropped
    got, want = _moe_both(args, cfg_kw, capacity=capacity, groups=groups)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), want[1])


# -- counts, data, configs ---------------------------------------------------


@pytest.mark.parametrize("name", LM_ARCHS + ("tiny",))
def test_param_counts_match_reference(name):
    pairs = [_cfgs(name)]
    if name != "tiny":
        pairs.append((r_get(name).model, t_get(name).model))
    for cr, ct in pairs:
        assert tfm.count_params(ct) == rtfm.count_params(cr)
        assert tfm.active_params(ct) == rtfm.active_params(cr)
    _, cfg_t = _cfgs(name)
    params = tfm.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in tree_flatten(params)[0]) == tfm.count_params(cfg_t)
    tree = jax.tree.map(np.asarray, rtfm.init_params(jax.random.key(0), _cfgs(name)[0]))
    mine = tfm.params_from_reference(tree, cfg_t, "cpu")
    assert [tuple(p.shape) for p in tree_flatten(params)[0]] == \
        [tuple(p.shape) for p in tree_flatten(mine)[0]]


def test_init_params_draws_layer_slices_in_the_configs_type():
    cfg = dataclasses.replace(t_get("granite-moe-1b-a400m").smoke(), dtype=torch.bfloat16)
    p = tfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert p["layers"]["ffn"]["w1"].dtype == torch.bfloat16
    assert p["layers"]["ffn"]["router"].dtype == torch.float32  # as the reference
    assert p["layers"]["ffn"]["w1"].shape == (2, 8, 48, 32)
    w1 = p["layers"]["ffn"]["w1"].float()
    assert not torch.equal(w1[0], w1[1])  # each layer its own draw
    assert abs(float(w1.std()) - 48 ** -0.5) < 0.02
    again = tfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again["layers"]["attn"]["wq"], p["layers"]["attn"]["wq"])


def test_params_from_reference_carries_bf16_exactly():
    cfg_r = dataclasses.replace(r_get("smollm-135m").smoke(), dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(t_get("smollm-135m").smoke(), dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, rtfm.init_params(jax.random.key(3), cfg_r))
    mine = tfm.params_from_reference(tree, cfg_t, "cpu")
    for a, b in zip(tree_flatten(mine)[0], jax.tree.leaves(tree)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [(0, 0, 8, 128, 256), (3, 5, 2, 4096, 49152),
                                                       (1, 9, 4, 33, 49155)])
def test_lm_batch_byte_identical(seed, step, batch, seq, vocab):
    got = TS.lm_batch(seed, step, batch, seq, vocab)
    want = RS.lm_batch(seed, step, batch, seq, vocab)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def _same_field(a, b, name):
    if name == "dtype":
        return str(a).split(".")[-1] == np.dtype(b).name
    if name == "moe":
        return (a is None and b is None) or dataclasses.asdict(a) == dataclasses.asdict(b)
    return a == b


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_configs_match_reference(name):
    ra, ta = r_get(name), t_get(name)
    for f in dataclasses.fields(ra):
        if f.name not in ("model", "smoke", "shapes"):
            assert getattr(ta, f.name) == getattr(ra, f.name), f.name
    assert [dataclasses.asdict(s) for s in ta.shapes] == [dataclasses.asdict(s) for s in ra.shapes]
    for mr, mt in ((ra.model, ta.model), (ra.smoke(), ta.smoke())):
        assert [f.name for f in dataclasses.fields(mt)] == [f.name for f in dataclasses.fields(mr)]
        for f in dataclasses.fields(mr):
            assert _same_field(getattr(mt, f.name), getattr(mr, f.name), f.name), f.name
        assert mt.hd == mr.hd


def test_registry_names_match_reference():
    from repro.configs import registry as rreg

    from repro_torch.configs import registry as treg

    assert treg.ASSIGNED_IDS == rreg.ASSIGNED_IDS
    assert [m.ARCH.arch_id for m in treg.ASSIGNED] == [m.ARCH.arch_id for m in rreg.ASSIGNED]
    assert [m.ARCH.arch_id for m in treg.EXTRA] == [m.ARCH.arch_id for m in rreg.EXTRA]
    assert list(treg.ARCHS) == list(rreg.ARCHS)


def test_lm_shapes_match_reference():
    assert [dataclasses.asdict(s) for s in LM_SHAPES] == \
        [dataclasses.asdict(s) for s in R_LM_SHAPES]
    assert LM_SHAPES[1].dims == {"seq": 32768, "batch": 32}


def test_lm_modules_import_no_jax():
    """The LM path of the port pulls in neither jax nor the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch.models.transformer, repro_torch.kernels.flash_attention\n"
        "import repro_torch.launch.serve, repro_torch.launch.train, repro_torch.train.steps\n"
        "import repro_torch.configs.registry, repro_torch.kernels.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
