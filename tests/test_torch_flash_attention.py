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


# -- the bf16 tensor-core kernel: launchability and its P arithmetic ----------

# bf16 out within one bf16 ulp of the float32 plain version (the card's gate)
FLASH_BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,bq,bk,bh,match", [
    (BF16, 64, 128, 128, 9, None),  # smollm's prefill tile
    (BF16, 128, 128, 64, 32, None),  # llama3-8b's
    (BF16, 8, 16, 16, 4, None),  # the smallest tile, D padded to 16
    (BF16, 12, 48, 80, 8, None),  # any multiples of 16
    (BF16, 64, 256, 64, 9, "multiples of 16"),  # past 128
    (BF16, 64, 64, 256, 9, "multiples of 16"),
    (BF16, 64, 24, 64, 9, "multiples of 16"),  # not a multiple of 16
    (BF16, 64, 64, 40, 9, "multiples of 16"),
    (BF16, 64, 0, 64, 9, "multiples of 16"),
    (BF16, 64, 128, 128, 65536, "grid"),
    (F32, 128, 128, 64, 32, None),
    (F32, 128, 256, 64, 32, "threads"),  # 4 threads a row at D = 128
    (F32, 32, 256, 64, 32, None),  # 1 thread a row at D = 32
    (F32, 128, 128, 256, 32, "shared memory"),
    (F32, 16, 24, 40, 65535, None),  # float32 takes any tile
])
def test_check_launchable(dtype, d, bq, bk, bh, match):
    if match is None:
        FK.check_launchable(dtype, d, bq, bk, bh)
    else:
        with pytest.raises(ValueError, match=match):
            FK.check_launchable(dtype, d, bq, bk, bh)


def test_shared_bytes_and_threads_follow_the_type():
    # bf16: a 64-row Q tile a warpgroup, a ring of two K and V tiles, bf16,
    # head dims padded to 64 or 128, 1 KB of alignment, two TMA barriers
    assert FK.shared_bytes(64, 128, 128, BF16) == 1024 + (2 * 64 + 2 * 2 * 128) * 64 * 2 + 16
    assert FK.shared_bytes(8, 16, 16, BF16) == 1024 + (64 + 2 * 2 * 16) * 64 * 2 + 16
    assert FK.shared_bytes(100, 80, 32, BF16) == 1024 + (2 * 64 + 2 * 2 * 32) * 128 * 2 + 16
    assert FK.shared_bytes(64, 16, 128, BF16) == FK.shared_bytes(64, 64, 128, BF16)
    # float32: K and V tiles padded to 32 a thread and the score tile
    assert FK.shared_bytes(64, 128, 128, F32) == (2 * 128 * 64 + 128 * 129) * 4
    assert FK.shared_bytes(64, 128, 128) == FK.shared_bytes(64, 128, 128, F32)
    assert [FK.threads_per_row(d, BF16) for d in (8, 64, 128)] == [2, 2, 2]
    assert [FK.threads_per_row(d, F32) for d in (8, 64, 128)] == [1, 2, 4]
    # every legal bf16 tile fits a block at D = 128
    for bq in range(16, 129, 16):
        for bk in range(16, 129, 16):
            FK.check_launchable(BF16, 128, bq, bk, 1)


def _top16(x):
    """x's top 16 bits (sign, exponent, 7 mantissa bits): a bf16 value."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _split(p, parts):
    """The kernel's split of float32 p into bf16 parts, each the top 16 bits
    of what the parts before it left."""
    out = []
    for _ in range(parts):
        out.append(_top16(p))
        p = p - out[-1]
    return out


def _emulate_bf16_kernel(q, k, v, *, causal, scale, block_k, parts=3):
    """The bf16 kernel's arithmetic on the CPU: float32 scores of the bf16
    inputs, p = 2^(s log2 e - m' log2 e), P in ``parts`` bf16 parts whose
    products with V (exact in float32) a block sums from zero in float32,
    acc = acc * alpha + pv, l summed from the unrounded p."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    kf, vf = k.float(), v.float()
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, hkv, hq // hkv, s), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, hq // hkv, s, d)
    pos = torch.arange(s)
    for k0 in range(0, s, block_k):
        k1 = min(s, k0 + block_k)
        x = torch.einsum("bkgqd,bkcd->bkgqc", qf, kf[:, :, k0:k1]) * scale
        if causal:
            x = torch.where(pos[:, None] >= pos[None, k0:k1], x, -1e30)
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2(x * log2e - (m_new * log2e)[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = sum(torch.einsum("bkgqc,bkcd->bkgqd", part, vf[:, :, k0:k1])
                 for part in reversed(_split(p, parts)))
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(b, hq, s, d).to(q.dtype)


def test_p_split_parts_are_bf16_and_sum_to_p():
    p = torch.from_numpy(np.random.default_rng(0).random(4096).astype(np.float32) ** 8)
    p = torch.cat([p, torch.tensor([0.0, 1.0, 2.0 ** -126, 0.99999994])])
    parts = _split(p, 3)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)  # exact in bf16
    rest3 = (p - sum(parts)).abs()
    assert bool((rest3 <= 2.0 ** -23 * p).all())  # within one float32 ulp of p
    hi, mid = _split(p, 2)
    assert float(((p - hi - mid).abs() / p.clamp(min=1e-30)).max()) > 2.0 ** -20  # two: ~2^-16


# b, hq, hkv, s, d, block_k, causal, the largest |logit| (None: the default scale)
SPLIT_CASES = [
    (1, 4, 2, 256, 64, 64, True, None),
    (1, 4, 1, 200, 128, 128, True, None),
    (2, 6, 3, 96, 8, 32, False, None),
    (1, 2, 2, 32, 128, 32, True, None),  # short rows: two parts miss the gate here
    (1, 4, 2, 256, 64, 64, True, 30.0),  # logits scaled to +-30
    (1, 2, 2, 160, 128, 32, False, 30.0),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,bk,causal,logit_max", SPLIT_CASES)
def test_p_split_stays_within_one_bf16_ulp(b, hq, hkv, s, d, bk, causal, logit_max):
    """The kernel's three-part P.V against the float32 P.V of the plain
    version, both rounded to bf16: within FLASH_BF16_TOL."""
    rng = np.random.default_rng(s + d + bk)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    scale = d ** -0.5
    if logit_max is not None:
        qk = torch.einsum("bkgqd,bkcd->bkgqc", q.float().reshape(b, hkv, hq // hkv, s, d),
                          k.float())
        scale = logit_max / float(qk.abs().max())
    want = FK.flash_attention_tiles_plain(q, k, v, causal=causal, scale=scale, block_q=bk,
                                          block_k=bk)
    got = _emulate_bf16_kernel(q, k, v, causal=causal, scale=scale, block_k=bk)
    torch.testing.assert_close(got, want, **FLASH_BF16_TOL)


def test_two_part_split_misses_the_gate():
    """Why three parts: with two (16 of p's bits) the short rows' outputs
    near zero move by more than one bf16 ulp."""
    b, hq, hkv, s, d, bk = 1, 2, 2, 32, 128, 32
    rng = np.random.default_rng(s * 7 + d + hq)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    want = FK.flash_attention_tiles_plain(q, k, v, causal=True, scale=d ** -0.5, block_q=16,
                                          block_k=bk)
    two = _emulate_bf16_kernel(q, k, v, causal=True, scale=d ** -0.5, block_k=bk, parts=2)
    three = _emulate_bf16_kernel(q, k, v, causal=True, scale=d ** -0.5, block_k=bk)
    assert not torch.allclose(two.float(), want.float(), **FLASH_BF16_TOL)
    assert torch.allclose(three.float(), want.float(), **FLASH_BF16_TOL)
