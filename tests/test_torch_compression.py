"""The port's gradient compression against ``repro.dist.compression``, on the
CPU.

  * ``int8_compress`` / ``int8_decompress`` and ``topk_sparsify`` bit for
    bit against the reference's on seeded inputs: normal, ties at half
    steps (round half to even), ties at the top-k threshold (every tied
    entry kept), all zeros, a bf16 input, tiny and huge magnitudes;
  * ``compressed_psum`` (int8 and top-k) and two rounds of error feedback
    (int8 and top-k) at 4 spawned gloo ranks (rank bodies in
    ``tests/_torch_ranks.py``) within rtol 1e-6 of the reference's
    functions applied per rank and averaged; the residuals bit for bit;
  * ``wire_bytes``: int8 sends one byte an entry and a scale a tensor;
  * unknown modes raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as RCmp

import _torch_ranks as ranks
from repro_torch.dist import compression as TCmp
from repro_torch.launch.mesh import spawn_ranks

SPAWN_TIMEOUT = 60
WORLD = 4


def _inputs():
    rng = np.random.default_rng(0)
    ties = (rng.integers(-40, 40, 600) / 2.0).astype(np.float32)  # half steps of max/127
    ties[0] = 127.0 / 2.0
    return {
        "normal": rng.standard_normal(1000).astype(np.float32),
        "matrix": rng.standard_normal((37, 29)).astype(np.float32) * 3e-3,
        "ties": ties,
        "topk_ties": np.repeat(rng.standard_normal(25).astype(np.float32), 8),
        "zeros": np.zeros(64, np.float32),
        "tiny": (rng.standard_normal(100) * 1e-30).astype(np.float32),
        "huge": (rng.standard_normal(100) * 1e30).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_int8_bit_equal_to_reference(name):
    x = _inputs()[name]
    rq, rs = RCmp.int8_compress(jnp.asarray(x))
    tq, ts = TCmp.int8_compress(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == ()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert ts.numpy().tobytes() == np.asarray(rs).tobytes()
    rd = np.asarray(RCmp.int8_decompress(rq, rs))
    assert TCmp.int8_decompress(tq, ts).numpy().tobytes() == rd.tobytes()


def test_int8_bf16_input_bit_equal_to_reference():
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    rq, rs = RCmp.int8_compress(jnp.asarray(x, jnp.bfloat16))
    tq, ts = TCmp.int8_compress(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert ts.numpy().tobytes() == np.asarray(rs).tobytes()


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.25, 1.0])
@pytest.mark.parametrize("name", ["normal", "matrix", "topk_ties", "zeros"])
def test_topk_bit_equal_to_reference(name, frac):
    x = _inputs()[name]
    rsp, rmask = RCmp.topk_sparsify(jnp.asarray(x), frac)
    tsp, tmask = TCmp.topk_sparsify(torch.from_numpy(x), frac)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(rmask))
    assert tsp.numpy().tobytes() == np.asarray(rsp).tobytes()
    if name == "topk_ties" and frac == 0.01:
        assert int(tmask.sum()) == 8 > np.ceil(0.01 * x.size)  # the tie group is kept whole


def _per_rank_grads(rounds):
    rng = np.random.default_rng(5)
    return [[{"a": rng.standard_normal(200).astype(np.float32) * (r + 1),
              "b": rng.standard_normal((6, 7)).astype(np.float32)} for _ in range(rounds)]
            for r in range(WORLD)]


def _ref_sent(mode, x, frac):
    if mode == "int8":
        return np.asarray(RCmp.int8_decompress(*RCmp.int8_compress(jnp.asarray(x))))
    return np.asarray(RCmp.topk_sparsify(jnp.asarray(x), frac)[0])


def test_compressed_sync_at_four_ranks_matches_reference(tmp_path):
    rounds = 2
    grads = _per_rank_grads(rounds)
    outs = spawn_ranks(ranks.compression_sync, WORLD, (grads, rounds), backend="gloo",
                       timeout=SPAWN_TIMEOUT, init_dir=tmp_path)
    for mode, frac in (("int8", None), ("topk", 0.1)):
        want = np.mean([_ref_sent(mode, grads[r][0]["a"], frac).astype(np.float64)
                        for r in range(WORLD)], axis=0)
        for o in outs:
            np.testing.assert_allclose(o[mode], want, rtol=1e-6, atol=1e-7)
            assert o[mode].tobytes() == outs[0][mode].tobytes()  # every rank the same bits
    for mode in ("int8", "topk"):
        ef = [{k: np.zeros(v.shape, np.float32) for k, v in grads[r][0].items()}
              for r in range(WORLD)]
        for i in range(rounds):
            sent = []
            for r in range(WORLD):
                corrected = {k: grads[r][i][k] + ef[r][k] for k in ef[r]}
                s = {k: _ref_sent(mode, v, 0.25) for k, v in corrected.items()}
                ef[r] = {k: (corrected[k] - s[k]).astype(np.float32) for k in corrected}
                sent.append(s)
            for r, o in enumerate(outs):
                synced, _ = o["ef/" + mode]
                for k in ("a", "b"):
                    want = np.mean([s[k].astype(np.float64) for s in sent], axis=0)
                    np.testing.assert_allclose(synced[i][k], want, rtol=1e-6, atol=1e-7)
        for r, o in enumerate(outs):
            for k in ("a", "b"):
                assert o["ef/" + mode][1][k].tobytes() == ef[r][k].tobytes()


def test_wire_bytes_and_unknown_modes():
    tree = {"a": torch.zeros(1000), "b": [torch.zeros(3, 4)]}
    assert TCmp.wire_bytes(tree, "int8") == 1000 + 4 + 12 + 4
    assert TCmp.wire_bytes(tree, "topk") == 4 * 1012
    for bad in (lambda: TCmp.make_error_feedback("fp16"),
                lambda: TCmp.wire_bytes(tree, "fp16"),
                lambda: TCmp.compressed_psum(torch.zeros(3), None, "fp16")):
        with pytest.raises(ValueError, match="unknown compression mode"):
            bad()
