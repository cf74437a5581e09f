"""The port's frontier words against ``repro.core.frontier_words``.

Every function runs on the same numpy inputs, made from a seed, through
both packages and must agree bit for bit: the port holds the reference's
uint32 words as int32 tensors with the same bits (``core.u32``), so each
port output is compared through ``u32.from_bits``. The coverage words of
``frontier_active_tiles`` come from real partitions (pull and push
streams), as the engines use them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.graph as RG
from repro.core import frontier_words as RF
from repro.core.partition import PartitionConfig as RConfig
from repro.core.partition import partition_2d as r_partition

from repro_torch.core import frontier_words as TF
from repro_torch.core import u32


def _bits(a):
    return u32.to_bits(np.asarray(a, dtype=np.uint32))


@pytest.mark.parametrize("sub_size", [1, 31, 32, 33, 100, 256])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_word_counts_match_reference(sub_size, p):
    assert TF.words_per_sub(sub_size) == RF.words_per_sub(sub_size)
    assert TF.coverage_word_count(p, sub_size) == RF.coverage_word_count(p, sub_size)


@pytest.mark.parametrize("shape", [(32,), (3, 64), (2, 5, 96)])
def test_pack_bits_matches_reference(shape):
    bits = np.random.default_rng(1).random(shape) < 0.4
    bits.reshape(-1)[::7] = True  # bit 31 of some words: the sign bit of int32
    want = np.asarray(RF.pack_bits(jnp.asarray(bits)))
    got = u32.from_bits(TF.pack_bits(torch.from_numpy(bits)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
@pytest.mark.parametrize("l,sub_size", [(1, 32), (2, 40), (3, 17)])
def test_frontier_words_from_labels_matches_reference(dtype, l, sub_size):
    rng = np.random.default_rng(2)
    shape = (2, l * sub_size)
    if dtype == np.uint32:
        old = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    else:
        old = rng.random(shape).astype(np.float32)
    new = old.copy()
    flip = rng.random(shape) < 0.15
    new[flip] = 0 if dtype == np.uint32 else -1.0
    want = np.asarray(RF.frontier_words_from_labels(jnp.asarray(old), jnp.asarray(new), l, sub_size))

    def port(a):
        return _bits(a) if dtype == np.uint32 else torch.from_numpy(a)

    got = u32.from_bits(TF.frontier_words_from_labels(port(old), port(new), l, sub_size))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l,sub_size,lead", [(1, 32, ()), (2, 40, (3,)), (4, 17, (2,))])
def test_full_frontier_words_and_popcount_match_reference(l, sub_size, lead):
    want = np.asarray(RF.full_frontier_words(l, sub_size, lead=lead))
    got = TF.full_frontier_words(l, sub_size, lead=lead)
    np.testing.assert_array_equal(u32.from_bits(got), want)
    # the tail bits of a sub-interval's last word stay clear
    assert int(TF.frontier_popcount(got)) == int(np.prod(lead, dtype=int)) * l * sub_size
    assert int(TF.frontier_popcount(got)) == int(RF.frontier_popcount(jnp.asarray(want)))


def test_frontier_popcount_matches_reference():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (3, 5, 7), dtype=np.uint64).astype(np.uint32)
    words[0, 0, :3] = [0xFFFFFFFF, 0x80000000, 0]
    want = int(RF.frontier_popcount(jnp.asarray(words)))
    assert int(TF.frontier_popcount(_bits(words))) == want


def _partition():
    g = RG.symmetrize(RG.rmat(9, 6, seed=4))
    return r_partition(g, RConfig(p=4, l=2, lane=8, tile_vb=32, tile_eb=32))


@pytest.mark.parametrize("stream", ["pull", "push"])
@pytest.mark.parametrize("use_dense", [None, True, False])
def test_frontier_active_tiles_matches_reference(stream, use_dense):
    pg = _partition()
    if stream == "pull":
        cov, cnt = pg.tile_coverage, pg.tile_counts
    else:
        cov, cnt = pg.push_coverage, pg.push_counts
    rng = np.random.default_rng(5)
    ws = RF.words_per_sub(pg.sub_size)
    for m in range(pg.l):
        for density in (0.0, 0.05, 0.5):
            fw = rng.integers(0, 1 << 32, (pg.p, pg.l, ws), dtype=np.uint64).astype(np.uint32)
            fw[rng.random(fw.shape) >= density] = 0
            gfw = fw[:, m].reshape(-1)
            dense = None if use_dense is None else jnp.bool_(use_dense)
            want = np.asarray(RF.frontier_active_tiles(
                jnp.asarray(cov[:, m]), jnp.asarray(gfw), jnp.asarray(cnt[:, m]), dense))
            got = TF.frontier_active_tiles(
                _bits(cov[:, m]), _bits(gfw), torch.from_numpy(cnt[:, m].copy()), use_dense)
            np.testing.assert_array_equal(got.numpy(), want)
            wf = np.asarray(RF.active_fetch_map(jnp.asarray(want)))
            np.testing.assert_array_equal(TF.active_fetch_map(got).numpy(), wf)


def test_active_fetch_map_matches_reference():
    active = np.random.default_rng(6).random((3, 4, 9)) < 0.3
    active[0, 0] = False  # no active tile: -1 throughout
    active[1, 1] = True
    want = np.asarray(RF.active_fetch_map(jnp.asarray(active)))
    got = TF.active_fetch_map(torch.from_numpy(active))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lane_union_holds_a_vertex_iff_one_of_its_lanes_changed():
    """The frontier over a lane axis is the union of the lanes' frontiers:
    empty when no lane changed, and a vertex enters when any one of its
    lanes does (the comparison with the reference is in
    test_torch_multi_query.py)."""
    lab = torch.zeros((1, 32, 2), dtype=torch.int32)
    assert not TF.frontier_words_from_labels(lab, lab, 1, 32, lanes=True).any()
    new = lab.clone()
    new[0, 5, 1] = 1  # vertex 5, lane 1 only
    words = u32.from_bits(TF.frontier_words_from_labels(lab, new, 1, 32, lanes=True))
    assert words.reshape(-1).tolist() == [1 << 5]
