"""Delta ingest in the port against the JAX reference.

``repro_torch.core.partition.apply_edge_deltas`` must return, field by
field and byte for byte, what ``repro.core.partition.apply_edge_deltas``
returns for the same partition and insertions, on the cases of
tests/test_delta_ingest.py (weighted, multi-flush, stride permutation,
hub-split flush, pos-to-split mode transition, edge-pad growth, empty
delta, validation errors, ``in_neighbors``); and the port's flushed
partition must equal its own cold ``partition_2d`` of the grown graph.

The stale-device-copy trap: a flushed partition is a new object whose
``device_cache`` starts empty, so the engine never runs the pre-flush
tiles; ``engine.evict_from_cache`` empties the retired partition's cache.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.graph as RG
from repro.core import partition as RPart
from repro.data.synthetic import edge_insertion_stream, skewed_graph

import repro_torch.core.graph as TG
from repro_torch.core import problems as TP
from repro_torch.core.engine import EngineOptions, evict_from_cache, run
from repro_torch.core.partition import (
    PartitionConfig,
    apply_edge_deltas,
    bucket_coords,
    partition_2d,
)
from repro_torch.serve import DeltaBuffer


def _weighted(g, seed=0):
    w = (np.random.default_rng(seed).random(g.num_edges) + 0.1).astype(np.float32)
    return RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


def _port_graph(g):
    return TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=g.weights)


def _grown(g, src, dst, w=None):
    return TG.COOGraph(
        src=np.concatenate([g.src, np.asarray(src, g.src.dtype)]),
        dst=np.concatenate([g.dst, np.asarray(dst, g.dst.dtype)]),
        num_vertices=g.num_vertices,
        weights=(np.concatenate([g.weights, np.asarray(w, np.float32)])
                 if g.weights is not None else None),
    )


def assert_same_partition(pa, pb):
    """Every field of two partitions (port or reference) byte for byte; the
    port's device cache is no partition data."""
    for f in dataclasses.fields(pa):
        if f.name == "device_cache":
            continue
        a, b = getattr(pa, f.name), getattr(pb, f.name)
        if f.name == "config":
            assert dataclasses.asdict(a) == dataclasses.asdict(b), "config"
            continue
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, (f.name, a.dtype, b.dtype)
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, (f.name, a, b)


def assert_same_report(ra, rb):
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
    assert ra.repacked_fraction == rb.repacked_fraction


def _flush_both(g, cfg, batches):
    """Flush ``batches`` of (src, dst, w) into both packages' partitions of
    ``g``; check every step against the reference, the end against the
    port's own cold partition of the grown graph."""
    r_pg = RPart.partition_2d(g, RPart.PartitionConfig(**cfg))
    t_pg = partition_2d(_port_graph(g), PartitionConfig(**cfg))
    t_g = _port_graph(g)
    reports = []
    for src, dst, w in batches:
        r_pg, r_rep = RPart.apply_edge_deltas(r_pg, src, dst, w)
        t_pg, t_rep = apply_edge_deltas(t_pg, src, dst, w)
        assert_same_partition(t_pg, r_pg)
        assert_same_report(t_rep, r_rep)
        t_g = _grown(t_g, src, dst, w)
        reports.append(t_rep)
    assert_same_partition(t_pg, partition_2d(t_g, PartitionConfig(**cfg)))
    return t_g, t_pg, reports


def _random_batch(n_vertices, n, seed, weighted=True, dst=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n)
    d = rng.integers(0, n_vertices, n) if dst is None else dst
    return src, d, (rng.random(n).astype(np.float32) if weighted else None)


def test_single_flush_weighted():
    g = _weighted(RG.symmetrize(RG.rmat(7, 4, seed=1)), seed=2)
    _, _, (rep,) = _flush_both(g, dict(p=4, l=2), [_random_batch(g.num_vertices, 40, 3)])
    assert rep.edges_added == 40 and 0 < rep.buckets_retiled <= rep.total_buckets


def test_multi_flush_composes():
    g = _weighted(RG.symmetrize(RG.rmat(7, 4, seed=2)), seed=4)
    _flush_both(g, dict(p=2, l=2),
                [_random_batch(g.num_vertices, 24, s) for s in (5, 6)])


def test_stride_permutation_flush():
    g = RG.symmetrize(RG.rmat(7, 4, seed=3))
    _, t_pg, _ = _flush_both(g, dict(p=2, l=2, stride=10),
                             [_random_batch(g.num_vertices, 32, 7, weighted=False)])
    assert t_pg.perm is not None


def test_hub_split_bucket_flush():
    g = skewed_graph(256, kind="star", hub_in_degree=700, avg_degree=2, seed=7)
    hub = int(np.argmax(np.bincount(g.dst, minlength=g.num_vertices)))
    batch = _random_batch(g.num_vertices, 64, 8, weighted=False,
                          dst=np.full(64, hub, dtype=np.int64))
    _, t_pg, (rep,) = _flush_both(g, dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32), [batch])
    assert t_pg.split_rows > 0 and rep.buckets_retiled < rep.total_buckets


def test_pos_to_split_mode_transition():
    g = RG.symmetrize(RG.rmat(7, 3, seed=4))
    batch = _random_batch(g.num_vertices, 600, 9, weighted=False,
                          dst=np.zeros(600, dtype=np.int64))
    _, t_pg, (rep,) = _flush_both(g, dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32), [batch])
    assert rep.mode_changed and t_pg.tile_split_map is not None


def test_edge_pad_growth():
    g = RG.symmetrize(RG.rmat(6, 3, seed=5))
    pg = partition_2d(_port_graph(g), PartitionConfig(p=2, l=2, edge_pad=8))
    batch = _random_batch(g.num_vertices, 2 * pg.edge_pad, 10, weighted=False)
    _, t_pg, (rep,) = _flush_both(g, dict(p=2, l=2, edge_pad=8), [batch])
    assert rep.grew_edge_pad and t_pg.edge_pad > pg.edge_pad


def test_hub_stream_flushes_and_labels():
    """The reference's acceptance case: hub-biased weighted insertions in two
    flushes onto a split hub bucket; BFS/WCC/SSSP labels and iterations on
    the flushed partition equal the cold partition's."""
    g = _weighted(skewed_graph(192, kind="star", hub_in_degree=500, avg_degree=2, seed=11),
                  seed=12)
    batches = edge_insertion_stream(48, g.num_vertices, num_batches=2, hub_bias=0.7,
                                    weighted=True, seed=13)
    cfg = dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32)
    t_g, t_pg, _ = _flush_both(g, cfg, batches)
    cold = partition_2d(t_g, PartitionConfig(**cfg))
    for prob in (TP.bfs(0), TP.wcc(), TP.sssp(0)):
        ra = run(prob, t_g, t_pg, EngineOptions(), device="cpu")
        rb = run(prob, t_g, cold, EngineOptions(), device="cpu")
        assert ra.iterations == rb.iterations, prob.name
        np.testing.assert_array_equal(ra.labels["label"], rb.labels["label"])


def test_flush_is_o_dirty_buckets():
    g = RG.symmetrize(RG.rmat(8, 6, seed=6))
    pg = partition_2d(_port_graph(g), PartitionConfig(p=4, l=4))
    rng = np.random.default_rng(14)
    src = rng.integers(0, pg.sub_size, 20)
    dst = rng.integers(0, pg.vertices_per_core, 20)
    core, phase, _, _ = bucket_coords(pg, src, dst)
    r_pg = RPart.partition_2d(g, RPart.PartitionConfig(p=4, l=4))
    want = RPart.bucket_coords(r_pg, src, dst)
    for a, b in zip((core, phase) + tuple(bucket_coords(pg, src, dst)[2:]), want):
        np.testing.assert_array_equal(a, b)
    assert set(zip(core.tolist(), phase.tolist())) == {(0, 0)}
    _, _, (rep,) = _flush_both(g, dict(p=4, l=4), [(src, dst, None)])
    assert rep.buckets_retiled == 1 and rep.total_buckets == 16
    assert rep.repacked_fraction == pytest.approx(1 / 16, rel=0.05)


def test_empty_delta_is_identity():
    g = _port_graph(RG.symmetrize(RG.rmat(6, 3, seed=7)))
    pg = partition_2d(g, PartitionConfig(p=2, l=2))
    new_pg, rep = apply_edge_deltas(pg, np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert new_pg is pg and rep.edges_added == 0 and rep.buckets_retiled == 0


def test_delta_validation():
    g = _port_graph(_weighted(RG.symmetrize(RG.rmat(6, 3, seed=8)), seed=15))
    pg = partition_2d(g, PartitionConfig(p=2, l=2))
    with pytest.raises(ValueError):  # out-of-range vertex id
        apply_edge_deltas(pg, [0], [g.num_vertices], [1.0])
    with pytest.raises(ValueError):  # weighted partition, unweighted delta
        apply_edge_deltas(pg, [0], [1])
    gu = _port_graph(RG.symmetrize(RG.rmat(6, 3, seed=8)))
    pgu = partition_2d(gu, PartitionConfig(p=2, l=2))
    with pytest.raises(ValueError):  # unweighted partition, weighted delta
        apply_edge_deltas(pgu, [0], [1], [1.0])
    with pytest.raises(ValueError):  # src/dst of different lengths
        apply_edge_deltas(pgu, [0, 1], [1])
    bare = dataclasses.replace(pgu, config=None)
    with pytest.raises(ValueError):  # no partition_2d provenance
        apply_edge_deltas(bare, [0], [1])
    with pytest.raises(ValueError):
        DeltaBuffer(bare)


def test_in_neighbors_matches_reference():
    g = RG.symmetrize(RG.rmat(6, 4, seed=10))
    for cfg in (dict(p=2, l=2), dict(p=2, l=2, stride=10)):
        t_pg = partition_2d(_port_graph(g), PartitionConfig(**cfg))
        r_pg = RPart.partition_2d(g, RPart.PartitionConfig(**cfg))
        for v in (0, 1, 17, g.num_vertices - 1):
            got = t_pg.in_neighbors(v)
            np.testing.assert_array_equal(got, r_pg.in_neighbors(v))
            np.testing.assert_array_equal(np.sort(got), np.sort(g.src[g.dst == v]).astype(got.dtype))
        with pytest.raises(ValueError):
            t_pg.in_neighbors(g.num_vertices)


def test_flush_never_reuses_stale_device_copies():
    """Run the engine (the partition's device cache fills), flush a delta,
    run on the new partition: the result is the cold repartition's, the new
    partition started with an empty cache, and ``evict_from_cache`` empties
    the retired one."""
    g = _port_graph(_weighted(RG.symmetrize(RG.rmat(7, 4, seed=16)), seed=17))
    cfg = PartitionConfig(p=2, l=2, lane=4)
    pg = partition_2d(g, cfg)
    run(TP.sssp(0), g, pg, device="cpu")
    run(TP.bfs_multi([0, 5, 9]), g, pg, device="cpu")
    assert pg.device_cache, "the runs upload the edge tensors once"
    src, dst, w = _random_batch(g.num_vertices, 64, 18)
    new_pg, rep = apply_edge_deltas(pg, src, dst, w)
    assert rep.edges_added == 64 and new_pg is not pg
    assert new_pg.device_cache == {} and new_pg.device_cache is not pg.device_cache
    g2 = _grown(g, src, dst, w)
    cold = partition_2d(g2, cfg)
    for prob in (TP.sssp(0), TP.bfs_multi([0, 5, 9])):
        a = run(prob, g2, new_pg, device="cpu")
        b = run(prob, g2, cold, device="cpu")
        assert a.iterations == b.iterations
        for k in b.labels:
            np.testing.assert_array_equal(a.labels[k], b.labels[k])
    stale = run(TP.sssp(0), g, pg, device="cpu").labels["label"]  # the old graph still runs
    assert not np.array_equal(stale, run(TP.sssp(0), g2, cold, device="cpu").labels["label"])
    assert evict_from_cache(pg) and pg.device_cache == {}
    assert not evict_from_cache(pg)
