"""The edge-centric baseline and the small host pieces of the multi-channel
slice against the reference, on the CPU:

  * ``partition_edge_centric``'s arrays, ``csr_to_coo``, ``inverse_coo``,
    ``bytes_per_edge``, ``path_grid_graph`` and the paper config
    (``configs.graphscale``) byte-identical / equal to ``repro``'s;
  * ``run_edge_centric`` for BFS, WCC and SSSP on karate, RMAT scale 10, a
    grid and a weighted graph: labels and iteration counts bit-equal to
    ``repro.core.edge_centric.run_edge_centric``; PageRank within
    rtol=2e-5, atol=1e-8 (the port sums in float64, the reference in
    float32) with equal iterations;
  * the baseline's fixed point equals the GraphScale engine's (the paper's
    Fig. 1 comparison holds the algorithm fixed), in more iterations on a
    high-diameter graph.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.graph as RG
from repro.configs import graphscale as r_gs
from repro.core import problems as RP
from repro.core.edge_centric import run_edge_centric as r_run_ec
from repro.core.partition import partition_edge_centric as r_partition_ec
from repro.data.synthetic import path_grid_graph as r_path_grid

import repro_torch.core.graph as TG
from repro_torch.configs import graphscale as t_gs
from repro_torch.core import problems as TP
from repro_torch.core.edge_centric import EdgeCentricOptions, run_edge_centric
from repro_torch.core.engine import run
from repro_torch.core.partition import PartitionConfig, partition_2d, partition_edge_centric
from repro_torch.data.synthetic import path_grid_graph

PR_TOL = dict(rtol=2e-5, atol=1e-8)
GRAPHS = ["karate", "rmat10", "grid", "weighted"]


def _graph(name, G):
    if name == "karate":
        return G.karate_club()
    if name == "rmat10":
        return G.symmetrize(G.rmat(10, 8, seed=1))
    if name == "grid":
        return G.grid_2d(13, 17)
    g0 = G.symmetrize(G.rmat(9, 6, seed=4))
    w = np.random.default_rng(4).random(g0.num_edges).astype(np.float32)
    return G.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)


def _same_arrays(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("p", [1, 3, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_partition_edge_centric_byte_identical(name, p):
    _same_arrays(partition_edge_centric(_graph(name, TG), p),
                 r_partition_ec(_graph(name, RG), p))


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_helpers_equal_reference(name):
    g, rg = _graph(name, TG), _graph(name, RG)
    csr = TG.coo_to_csr(g)
    _same_arrays(TG.csr_to_coo(csr), RG.csr_to_coo(RG.coo_to_csr(rg)))
    _same_arrays(TG.inverse_coo(g), RG.inverse_coo(rg))
    for compressed in (False, True):
        assert TG.bytes_per_edge(g, compressed) == RG.bytes_per_edge(rg, compressed)


@pytest.mark.parametrize("shape", [(50, 1, False, 0), (20, 7, False, 0), (16, 9, True, 3)])
def test_path_grid_graph_equal_reference(shape):
    w, h, shuffle, seed = shape
    _same_arrays(path_grid_graph(w, h, shuffle=shuffle, seed=seed),
                 r_path_grid(w, h, shuffle=shuffle, seed=seed))


def test_paper_config_equal_reference():
    assert dataclasses.asdict(t_gs.paper_partition_config()) == dataclasses.asdict(
        r_gs.paper_partition_config())
    assert dataclasses.asdict(t_gs.paper_partition_config(p=8, stride=None, lane=128)) == \
        dataclasses.asdict(r_gs.paper_partition_config(p=8, stride=None, lane=128))
    assert dataclasses.asdict(t_gs.PAPER_KERNEL_TILING) == dataclasses.asdict(
        r_gs.PAPER_KERNEL_TILING)
    for k in ("PAPER_SCRATCH_LABELS", "PAPER_STRIDE", "PAPER_CHANNELS"):
        assert getattr(t_gs, k) == getattr(r_gs, k)


def _problems(pname):
    if pname == "bfs":
        return RP.bfs(3), TP.bfs(3)
    if pname == "wcc":
        return RP.wcc(), TP.wcc()
    if pname == "sssp":
        return RP.sssp(1), TP.sssp(1)
    return RP.pagerank(), TP.pagerank()


@pytest.mark.parametrize("pname", ["bfs", "wcc", "sssp", "pagerank"])
@pytest.mark.parametrize("name", GRAPHS)
def test_run_edge_centric_matches_reference(name, pname):
    rprob, tprob = _problems(pname)
    want = r_run_ec(rprob, _graph(name, RG), r_partition_ec(_graph(name, RG), 4))
    g = _graph(name, TG)
    got = run_edge_centric(tprob, g, partition_edge_centric(g, 4), device="cpu")
    assert got.iterations == want.iterations and got.converged == want.converged
    assert set(got.labels) == set(want.labels)
    for k, v in want.labels.items():
        v = np.asarray(v)
        if pname == "pagerank":
            np.testing.assert_allclose(got.labels[k], v, **PR_TOL)
        else:
            assert got.labels[k].dtype == v.dtype and np.array_equal(got.labels[k], v), k


def test_edge_centric_max_iters_stops_unconverged():
    g = TG.grid_2d(13, 17)
    got = run_edge_centric(TP.bfs(0), g, partition_edge_centric(g, 2),
                           EdgeCentricOptions(max_iters=3), device="cpu")
    assert got.iterations == 3 and not got.converged


def test_baseline_reaches_the_engines_fixed_point_in_more_iterations():
    """Synchronous edge-centric vs asynchronous GraphScale on a path grid:
    the same labels, and the async engine needs fewer iterations."""
    g = path_grid_graph(64, 4)
    pg = partition_2d(g, PartitionConfig(p=4, l=4, lane=8))
    for prob in (TP.bfs(0), TP.wcc()):
        base = run_edge_centric(prob, g, partition_edge_centric(g, 4), device="cpu")
        eng = run(prob, g, pg, device="cpu")
        assert np.array_equal(base.labels["label"], eng.labels["label"])
        assert base.iterations > eng.iterations, (prob.name, base.iterations, eng.iterations)


def test_edge_centric_refuses_lane_batches():
    g = TG.karate_club()
    with pytest.raises(ValueError, match="laneless"):
        run_edge_centric(TP.bfs_multi([0, 1]), g, partition_edge_centric(g, 2), device="cpu")
