"""The port's embedding bag on the CPU against the JAX reference.

  * ``ref.embedding_bag_reference`` (the plain version) and
    ``ops.embedding_bag`` (which runs it for a CPU tensor) against
    ``repro.kernels.embedding_bag.embedding_bag(..., use_pallas=True)``, the
    Pallas kernel in interpret mode, on the sweep of ``tests/test_kernels.py``
    (rtol 1e-6: the same rows summed in another association);
  * against ``repro``'s ``embedding_bag_reference`` where the Pallas kernel
    cannot go: B not a multiple of bags_per_tile, the DIN width D = 18,
    all-padding bags, per-id weights;
  * the wrapper's checks, and the vector width the CUDA launcher is given.

The CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase ``bag_kernel``). Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as r_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_reference as r_reference

from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_reference
from repro_torch.kernels.embedding_bag.kernel import vector_width

PORT_FNS = {
    "plain": lambda table, ids, mode: embedding_bag_reference(table, ids, mode),
    "ops": lambda table, ids, mode: embedding_bag(table, ids, mode=mode),
}


def _inputs(seed, n, d, b, length, lo=-1):
    rng = np.random.default_rng(seed)
    table = rng.random((n, d), np.float32)
    ids = rng.integers(lo, n, (b, length)).astype(np.int32)
    return table, ids


@pytest.mark.parametrize("fn", list(PORT_FNS))
@pytest.mark.parametrize(
    "n,d,b,length,mode,bpt",
    [
        (100, 16, 16, 10, "sum", 8),
        (1000, 32, 32, 7, "mean", 4),
        (50, 8, 8, 1, "sum", 8),
        (64, 128, 24, 20, "mean", 8),
        (128, 64, 8, 33, "sum", 2),
    ],
)
def test_matches_pallas_kernel(n, d, b, length, mode, bpt, fn):
    table, ids = _inputs(n * 7 + d, n, d, b, length)
    want = r_embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode=mode, use_pallas=True,
                           bags_per_tile=bpt)
    got = PORT_FNS[fn](torch.from_numpy(table), torch.from_numpy(ids), mode)
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize(
    "case,n,d,b,length",
    [
        ("b_not_multiple_of_8", 200, 16, 13, 9),
        ("b_is_1", 200, 16, 1, 32),
        ("din_width", 10_000, 18, 40, 32),
        ("odd_width", 300, 7, 11, 5),
    ],
)
def test_matches_reference_where_pallas_cannot_go(case, n, d, b, length, mode):
    table, ids = _inputs(len(case) + d, n, d, b, length)
    ids[0, : length // 2] = -1  # a partly padded bag
    want = np.asarray(r_reference(jnp.asarray(table), jnp.asarray(ids), mode=mode))
    for fn in PORT_FNS.values():
        got = fn(torch.from_numpy(table), torch.from_numpy(ids), mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_all_padding_bags_are_zero(mode):
    table, ids = _inputs(3, 10, 18, 5, 6)
    ids[1] = -1
    ids[3] = -7  # any negative id is padding
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode=mode).numpy()
    want = np.asarray(r_reference(jnp.asarray(table), jnp.asarray(ids), mode=mode))
    np.testing.assert_array_equal(got[[1, 3]], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    empty = embedding_bag(torch.from_numpy(table), torch.full((4, 0), -1, dtype=torch.int32),
                          mode=mode)
    assert empty.shape == (4, 18) and not empty.any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_weights_match_reference(mode):
    table, ids = _inputs(11, 64, 18, 9, 12)
    w = np.random.default_rng(12).random(ids.shape, np.float32)
    want = np.asarray(r_reference(jnp.asarray(table), jnp.asarray(ids), mode=mode,
                                  weights=jnp.asarray(w)))
    got = embedding_bag_reference(torch.from_numpy(table), torch.from_numpy(ids), mode,
                                  weights=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_wrapper_checks():
    table = torch.zeros(10, 4)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(table, ids, mode="max")
    with pytest.raises(ValueError, match="int32"):
        embedding_bag(table, ids.long())
    with pytest.raises(ValueError, match="float32"):
        embedding_bag(table.double(), ids)
    with pytest.raises(ValueError, match="table"):
        embedding_bag(table[0], ids)
    with pytest.raises(ValueError, match="ids"):
        embedding_bag(table, ids[0])


@pytest.mark.parametrize("d,offset,vec", [(18, 0, 2), (16, 0, 4), (7, 0, 1), (16, 2, 2),
                                          (16, 1, 1), (128, 0, 4)])
def test_vector_width(d, offset, vec):
    """float4 needs D % 4 == 0 and 16-B aligned rows, float2 D % 2 == 0 and
    8-B aligned rows (D = 18: float2); an offset view narrows it."""
    base = torch.zeros(8 * d + offset)
    table = base[offset:].view(8, d)
    out = torch.zeros(3, d)
    assert vector_width(table, out) == vec
