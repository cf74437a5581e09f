"""The port's flash attention against the JAX reference, on the CPU.

  * ``flash_attention_tiles_plain`` (the kernel's plain version) and
    ``ops.flash_attention`` on CPU tensors against the Pallas kernel in
    interpret mode (``repro.kernels.flash_attention.flash_attention(...,
    use_pallas=True)``) at every case of the reference's sweep and of its
    chunked-twin test, within atol/rtol 2e-5 (the reference's own);
  * the full-logit oracle against the reference's, float32 and bfloat16;
  * a ragged S (not a multiple of either block) against the oracle;
  * the port's ``chunked_gqa_attention`` against the reference's, and the
    op's autograd backward against ``jax.grad`` of the reference's
    ``chunked_gqa_attention``;
  * the wrapper's checks.

Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.flash_attention.ref import gqa_attention_reference as r_oracle
from repro.models.layers import chunked_gqa_attention as r_chunked

from repro_torch.kernels.flash_attention import flash_attention, gqa_attention_reference
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models.layers import chunked_gqa_attention

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's

# tests/test_kernels.py::test_flash_attention_sweep's cases, then
# test_flash_matches_chunked_xla_twin's
CASES = [
    (2, 4, 2, 64, 16, 16, 16, True),
    (1, 8, 8, 128, 32, 32, 64, True),
    (2, 6, 3, 96, 8, 32, 32, False),
    (1, 4, 1, 64, 64, 64, 16, True),
    (1, 2, 2, 32, 128, 16, 32, True),
    (2, 4, 2, 64, 16, 16, 16, True),
]


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk,causal", CASES)
def test_plain_and_op_match_pallas_interpret(b, hq, hkv, s, d, bq, bk, causal):
    q, k, v = _qkv(b, hq, hkv, s, d, seed=s + d + hq)
    want = np.asarray(r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              use_pallas=True, block_q=bq, block_k=bk))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = FK.flash_attention_tiles_plain(tq, tk, tv, causal=causal, scale=d ** -0.5,
                                           block_q=bq, block_k=bk)
    op = flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_allclose(op.numpy(), want, **TOL)
    assert torch.equal(op, plain)  # on the CPU the op is the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_oracle_matches_reference(dtype, causal):
    q, k, v = _qkv(2, 6, 2, 40, 16, seed=3)
    jd = jnp.dtype(dtype)
    want = r_oracle(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), causal=causal)
    td = getattr(torch, dtype)
    got = gqa_attention_reference(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                  causal=causal)
    assert got.dtype == td
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)  # bf16 logits and weights
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("s,bq,bk,causal", [(77, 32, 16, True), (50, 16, 64, True),
                                           (1, 128, 128, True), (45, 32, 32, False)])
def test_ragged_s_matches_oracle(s, bq, bk, causal):
    q, k, v = _qkv(2, 6, 3, s, 24, seed=s)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_k=bk)
    want = r_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,chunk,causal", [(64, 16, True), (48, 48, False), (32, 8, True)])
def test_chunked_twin_matches_reference(s, chunk, causal):
    q, k, v = _qkv(2, 4, 2, s, 16, seed=chunk)
    want = r_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, chunk=chunk)
    got = chunked_gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_twin_ragged_tail_matches_one_chunk():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 37, 16, seed=9))
    np.testing.assert_allclose(chunked_gqa_attention(q, k, v, chunk=16).numpy(),
                               chunked_gqa_attention(q, k, v, chunk=37).numpy(), **TOL)


@pytest.mark.parametrize("hq,hkv,s,chunk,causal", [(4, 2, 32, 8, True), (6, 3, 24, 24, False),
                                                    (5, 1, 16, 4, True)])
def test_backward_matches_jax_grad(hq, hkv, s, chunk, causal):
    q, k, v = _qkv(2, hq, hkv, s, 16, seed=hq * s)
    cot = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        out = r_chunked(q_, k_, v_, causal=causal, chunk=chunk)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, block_q=16, block_k=8, chunk=chunk)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        FK.flash_attention_tiles(q, k, k)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        FK.flash_attention_tiles(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="D=129"):
        big = torch.zeros(1, 1, 4, 129)
        FK.flash_attention_tiles(big, big, big)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        FK.flash_attention_tiles(q, q.to(torch.bfloat16), q)
    assert FK.threads_per_row(64) == 2 and FK.threads_per_row(128) == 4
    # llama3-8b's D = 128 at the model's blocks fits a block's shared memory
    assert FK.shared_bytes(128, 128, 64) <= FK.MAX_SHARED
