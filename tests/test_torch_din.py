"""The port's DIN path against the JAX reference, on the CPU.

  * ``repro_torch.models.recsys.din`` with the reference's weights carried
    across (``params_from_reference``): ``score`` and ``score_candidates``
    (chunked and in one pass, with and without the crossbar lookup) against
    ``repro.models.recsys.din`` on the same ``recsys_batch`` /
    ``retrieval_batch``, within rtol 1e-5, atol 1e-6;
  * the recsys generators byte-identical, the configs value for value,
    ``in_degrees`` equal;
  * ``dist.embedding.crossbar_lookup_local`` at one shard and at four
    simulated shards (threads exchanging through a barrier) with a small
    capacity, against the reference's run in process under ``jax.vmap``
    with a named axis: rows and ``dropped`` counts equal.

Inputs come from numpy seeds.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as RG
import repro.data.synthetic as RS
from repro.configs.registry import get as r_get
from repro.dist.embedding import crossbar_lookup_local as r_crossbar
from repro.models.recsys import din as rdin

import repro_torch.core.graph as TG
import repro_torch.data.synthetic as TS
from repro_torch.configs.registry import ARCHS, get as t_get
from repro_torch.dist.embedding import crossbar_lookup_local, make_crossbar_lookup
from repro_torch.models.recsys import din as tdin

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def smoke():
    cfg_r, cfg_t = r_get("din").smoke(), t_get("din").smoke()
    params = rdin.init(jax.random.key(0), cfg_r)
    tree = jax.tree.map(np.asarray, params)
    return cfg_r, cfg_t, params, tdin.params_from_reference(tree, "cpu")


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("lookup", ["take", "crossbar"])
@pytest.mark.parametrize("batch,step", [(64, 0), (13, 3)])
def test_score_matches_reference(smoke, batch, step, lookup):
    cfg_r, cfg_t, params, tparams = smoke
    b = TS.recsys_batch(1, step, batch, cfg_t.seq_len, cfg_t.item_vocab, cfg_t.cate_vocab,
                        cfg_t.profile_bag_len)
    b = {k: v for k, v in b.items() if k != "labels"}
    want = np.asarray(rdin.score(params, _jnp(b), cfg_r))
    fn = make_crossbar_lookup() if lookup == "crossbar" else None
    got = tdin.score(tparams, tdin.batch_to(b, "cpu"), cfg_t, lookup_fn=fn)
    assert got.shape == (batch,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("chunk", [None, 64, 256])
@pytest.mark.parametrize("lookup", ["take", "crossbar"])
def test_score_candidates_matches_reference(smoke, chunk, lookup):
    cfg_r, cfg_t, params, tparams = smoke
    rb = TS.retrieval_batch(2, cfg_t.seq_len, 256, cfg_t.item_vocab, cfg_t.cate_vocab,
                            cfg_t.profile_bag_len)
    want = np.asarray(rdin.score_candidates(params, _jnp(rb), cfg_r, chunk=chunk))
    fn = make_crossbar_lookup() if lookup == "crossbar" else None
    got = tdin.score_candidates(tparams, tdin.batch_to(rb, "cpu"), cfg_t, chunk=chunk,
                                lookup_fn=fn)
    assert got.shape == (256,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="divide"):
        tdin.score_candidates(tparams, tdin.batch_to(rb, "cpu"), cfg_t, chunk=100)


def test_init_shapes_match_reference(smoke):
    cfg_r, cfg_t, params, _ = smoke
    mine = tdin.init(cfg_t, torch.Generator().manual_seed(3), "cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params)
    assert tuple(mine["item_table"].shape) == want["item_table"][0]
    assert tuple(mine["cate_table"].shape) == want["cate_table"][0]
    for k in ("attn", "out"):
        for part in ("w", "b"):
            assert [tuple(t.shape) for t in mine[k][part]] == [s for s, _ in want[k][part]]
    np.testing.assert_array_equal(mine["prelu"].numpy(), np.asarray(params["prelu"]))
    assert all(not b.any() for b in mine["out"]["b"])
    # seeded: the same generator seed gives the same parameters
    again = tdin.init(cfg_t, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(again["item_table"], mine["item_table"])
    assert torch.equal(again["attn"]["w"][1], mine["attn"]["w"][1])


@pytest.mark.parametrize("seed,step,batch", [(0, 0, 8), (4, 2, 33)])
def test_recsys_generators_byte_identical(seed, step, batch):
    for args in ((12, 500, 20, 6), (100, 10_000_384, 10_000, 32)):
        got = TS.recsys_batch(seed, step, batch, *args)
        want = RS.recsys_batch(seed, step, batch, *args)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
        got = TS.retrieval_batch(seed, args[0], 4 * batch, *args[1:])
        want = RS.retrieval_batch(seed, args[0], 4 * batch, *args[1:])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_configs_match_reference():
    assert set(ARCHS) == {"din", "gat-cora", "gcn-cora", "gin-tu", "graphsage",
                          "meshgraphnet", "schnet"}
    ra, ta = r_get("din"), t_get("din")
    for f in dataclasses.fields(ra):
        if f.name in ("model", "smoke", "shapes"):
            continue
        assert getattr(ta, f.name) == getattr(ra, f.name), f.name
    assert [dataclasses.asdict(s) for s in ta.shapes] == [dataclasses.asdict(s) for s in ra.shapes]
    assert ta.shape("serve_p99").dims == {"batch": 512}
    for mr, mt in ((ra.model, ta.model), (ra.smoke(), ta.smoke())):
        for f in dataclasses.fields(mr):
            a, b = getattr(mt, f.name), getattr(mr, f.name)
            if f.name == "dtype":
                assert str(a).split(".")[-1] == np.dtype(b).name
            else:
                assert a == b, f.name
    with pytest.raises(KeyError):
        t_get("llama3-8b")


def test_in_degrees_match_reference():
    g = RG.symmetrize(RG.rmat(7, 4, seed=5))
    tg = TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices)
    got, want = TG.in_degrees(tg), RG.in_degrees(g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the crossbar lookup


def _ref_crossbar(tables, ids, shards, cap):
    """The reference's one-shard function over ``shards`` shards, run in
    process: jax.vmap with a named axis makes its all_to_all a transpose."""
    fn = jax.vmap(lambda t, i: r_crossbar(t, i, "x", shards, cap), axis_name="x")
    rows, dropped = fn(jnp.asarray(tables), jnp.asarray(ids))
    return np.asarray(rows), np.asarray(dropped)


def _port_crossbar(tables, ids, shards, cap):
    """The port's function on ``shards`` threads, one per shard, whose
    exchange is an all-to-all through a barrier."""
    sent = [None] * shards
    barrier = threading.Barrier(shards, timeout=60)  # a failed shard breaks it
    results = [None] * shards

    def exchange_of(me):
        def exchange(send):
            sent[me] = send
            barrier.wait()
            recv = torch.stack([sent[s][me] for s in range(shards)])
            barrier.wait()  # every shard has read before the next exchange writes
            return recv
        return exchange

    def shard(me):
        results[me] = crossbar_lookup_local(torch.from_numpy(tables[me]),
                                            torch.from_numpy(ids[me]), exchange_of(me),
                                            shards, cap)

    threads = [threading.Thread(target=shard, args=(s,)) for s in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and all(r is not None for r in results)
    return (np.stack([r[0].numpy() for r in results]),
            np.stack([r[1].numpy() for r in results]))


@pytest.mark.parametrize(
    "shards,rows,d,n,cap,kind",
    [
        (1, 40, 5, 24, 48, "uniform"),  # make_crossbar_lookup's capacity: ceil(2n)
        (1, 40, 5, 24, 7, "uniform"),  # one shard can drop too
        (4, 12, 3, 20, 6, "uniform"),
        (4, 12, 3, 20, 3, "skewed"),  # every id to shard 0: most drop
        (4, 8, 6, 16, 2, "padding"),
        (4, 16, 4, 32, 16, "uniform"),
    ],
)
def test_crossbar_lookup_matches_reference(shards, rows, d, n, cap, kind):
    rng = np.random.default_rng(shards * 100 + cap)
    tables = rng.random((shards, rows, d), np.float32)
    if kind == "uniform":
        ids = rng.integers(-1, shards * rows, (shards, n))
    elif kind == "skewed":
        ids = rng.integers(0, rows, (shards, n))
    else:
        ids = np.where(rng.random((shards, n)) < 0.7, -1, rng.integers(0, shards * rows,
                                                                        (shards, n)))
    ids = ids.astype(np.int32)
    want_rows, want_drop = _ref_crossbar(tables, ids, shards, cap)
    got_rows, got_drop = _port_crossbar(tables, ids, shards, cap)
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_drop, want_drop)
    assert got_drop.dtype == np.int32
    if kind == "skewed":
        assert got_drop.sum() > 0
    full = tables.reshape(shards * rows, d)  # every row served is the table's row
    served = np.abs(got_rows).max(axis=-1) > 0
    np.testing.assert_array_equal(got_rows[served], full[ids[served]])


def test_make_crossbar_lookup_is_a_masked_take_at_one_shard():
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.random((50, 18), np.float32))
    ids = torch.from_numpy(rng.integers(-1, 50, (4, 9)).astype(np.int32))
    got = make_crossbar_lookup()(table, ids)
    want = torch.where((ids >= 0)[..., None], table[ids.clamp(min=0).long()], 0.0)
    assert got.shape == (4, 9, 18) and torch.equal(got, want)
