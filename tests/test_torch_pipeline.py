"""The port's neighbor sampler and data pipeline against the reference's,
on the CPU.

  * ``NeighborSampler`` on ``symmetrize(rmat(12, 8))`` at fanouts (5, 3):
    three steps' batches (every field), features and labels bit for bit
    ``repro``'s, plus tests/test_system.py's shape and validity checks, and
    ``max_nodes`` / ``max_edges`` at minibatch_lg's 1,024 seeds equal to the
    cell's padded sizes;
  * ``ShardedLoader``: the reference's batches in the reference's order, a
    restart from ``state()`` replays nothing, ``prefetch`` hands over the
    same sequence (a ``GraphBatch`` loader too) and its ``state()`` counts
    only what was handed over, an error in the thread reaches the
    consumer, closing the generator stops the thread; a stress run at a
    short switch interval keeps the order. (Per-rank slices through
    ``shardings`` run in tests/test_torch_elastic.py's ranks.)
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core.graph as RG
from repro.data.neighbor_sampler import NeighborSampler as RSampler
from repro.data.pipeline import ShardedLoader as RLoader
from repro.data.synthetic import lm_batch

import repro_torch.core.graph as TG
from repro_torch.configs.registry import get
from repro_torch.data.neighbor_sampler import NeighborSampler
from repro_torch.data.pipeline import ShardedLoader, prefetch
from repro_torch.models.gnn.common import GraphBatch


def _graphs():
    g = RG.symmetrize(RG.rmat(12, 8, seed=0))
    return g, TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices)


def test_neighbor_sampler_bit_equal_to_reference():
    rg, tg = _graphs()
    ref = RSampler(rg, fanouts=(5, 3), d_feat=16)
    port = NeighborSampler(tg, fanouts=(5, 3), d_feat=16)
    for step in range(3):
        want, want_lab = ref.sample(seed=0, step=step, batch_nodes=64)
        got, got_lab = port.sample(seed=0, step=step, batch_nodes=64)
        assert isinstance(got, GraphBatch) and got.n_graphs == want.n_graphs == 1
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if not isinstance(a, torch.Tensor):  # n_graphs, the absent edge_feat
                assert a == b, f.name
                continue
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == b.tobytes(), f.name
        assert got_lab.dtype == want_lab.dtype and got_lab.tobytes() == want_lab.tobytes()


def test_neighbor_sampler_shapes_and_validity():
    _, g = _graphs()
    s = NeighborSampler(g, fanouts=(5, 3), d_feat=16)
    batch, labels = s.sample(seed=0, step=0, batch_nodes=64)
    assert batch.node_feat.shape == (s.max_nodes(64), 16)
    assert batch.edge_src.shape == (s.max_edges(64),)
    ne = int(batch.edge_mask.sum())
    assert 0 < ne <= s.max_edges(64)
    src = batch.edge_src[batch.edge_mask].long()
    dst = batch.edge_dst[batch.edge_mask].long()
    nm = batch.node_mask
    assert bool(nm[src].all()) and bool(nm[dst].all())
    assert labels.shape == (64,)
    b2, _ = s.sample(seed=0, step=0, batch_nodes=64)
    assert torch.equal(batch.edge_src, b2.edge_src)
    dims = get("graphsage").shape("minibatch_lg").dims
    big = NeighborSampler(g, fanouts=(dims["fanout1"], dims["fanout2"]), d_feat=8)
    assert big.max_nodes(dims["batch_nodes"]) == dims["n_nodes"]
    assert big.max_edges(dims["batch_nodes"]) == dims["n_edges"]


def _make(seed, step):
    return lm_batch(seed=seed, step=step, batch=4, seq=8, vocab=50)


def test_loader_matches_reference_and_restarts_exactly():
    ref = RLoader(_make, seed=3)
    port = ShardedLoader(_make, seed=3, device="cpu")
    for _ in range(4):
        a, b = next(port), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].numpy().tobytes() == np.asarray(b[k]).tobytes()
    state = port.state()
    assert state == {"seed": 3, "next_step": 4} == ref.state()
    resumed = ShardedLoader(_make, seed=state["seed"], start_step=state["next_step"], device="cpu")
    want = next(port)
    got = next(resumed)
    for k in want:
        assert torch.equal(got[k], want[k])


def test_prefetch_same_sequence_and_counts_only_handed_over():
    direct = [next(ShardedLoader(_make, seed=1, start_step=i, device="cpu")) for i in range(6)]
    loader = ShardedLoader(_make, seed=1, device="cpu")
    it = prefetch(loader, depth=2)
    for i in range(3):
        got = next(it)
        for k in got:
            assert torch.equal(got[k], direct[i][k])
    assert loader.state()["next_step"] == 3  # the thread may have built ahead
    it.close()
    restart = prefetch(ShardedLoader(_make, seed=1, start_step=loader.state()["next_step"],
                                     device="cpu"))
    for i in range(3, 6):
        got = next(restart)
        for k in got:
            assert torch.equal(got[k], direct[i][k])
    restart.close()


def test_prefetch_of_graph_batches_and_plain_iterators():
    _, g = _graphs()
    s = NeighborSampler(g, fanouts=(3, 2), d_feat=8)
    make = lambda seed, step: s.sample(seed, step, batch_nodes=16)  # noqa: E731
    it = prefetch(ShardedLoader(make, seed=0, device="cpu"), depth=1)
    for step in range(3):
        (b, lab), (want, want_lab) = next(it), s.sample(0, step, batch_nodes=16)
        assert isinstance(b, GraphBatch) and torch.equal(b.node_feat, want.node_feat)
        assert torch.equal(lab, torch.from_numpy(want_lab))
    it.close()
    assert list(prefetch(iter(range(5)), depth=2)) == list(range(5))  # ends with its source


def test_prefetch_raises_the_threads_error_and_stops_on_close():
    def bad(seed, step):
        if step == 2:
            raise ValueError("no batch 2")
        return _make(seed, step)

    it = prefetch(ShardedLoader(bad, seed=0, device="cpu"))
    next(it), next(it)
    with pytest.raises(ValueError, match="no batch 2"):
        next(it)
    it = prefetch(ShardedLoader(_make, seed=0, device="cpu"), depth=1)
    next(it)
    it.close()
    assert not any(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())


def test_prefetch_stress_keeps_order():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        it = prefetch(ShardedLoader(lambda seed, step: {"s": np.array([step])}, seed=0,
                                    device="cpu"), depth=1)
        assert [int(next(it)["s"]) for _ in range(300)] == list(range(300))
        it.close()
    finally:
        sys.setswitchinterval(interval)
