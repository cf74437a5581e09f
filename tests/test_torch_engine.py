"""The port's engine against the reference engine on the same inputs.

``repro_torch.core.engine.run`` (kernel backend on CPU tensors = the
kernels' plain versions) must give BFS/WCC/SSSP labels and iteration counts
bit-identical to ``repro.core.engine.run``, and PageRank equal iteration
counts and labels within rtol=1e-6, atol=1e-9 (the reference's own
Pallas-vs-XLA tolerance, tests/test_engine_fused.py; 2e-5 on hub graphs):

  * on the static schedule (``dynamic_tile_skip=False, direction="pull"``)
    in both packages, in both apply modes;
  * on both packages' defaults: the frontier-aware dynamic tile skip and
    the 'auto' push/pull switch, which the reference guarantees equal to
    its static schedule;
  * under a forced ``direction='push'``;
  * step by step: ``run_frontier_trace``'s per-iteration directions,
    skipped-tile fractions and dense-fallback counts are equal.

The graphs are those of tests/test_engine_fused.py, tests/test_hub_split.py,
tests/test_dynamic_skip.py and tests/test_direction_switch.py.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.graph as RG
from repro.core import problems as RP
from repro.core.engine import EngineOptions as REngineOptions
from repro.core.engine import prepare_labels as r_prepare_labels
from repro.core.engine import run as r_run
from repro.core.partition import PartitionConfig as RConfig
from repro.core.engine import run_frontier_trace as r_trace
from repro.core.partition import partition_2d as r_partition
from repro.data.synthetic import path_grid_graph, skewed_graph

import repro_torch.core.graph as TG
from repro_torch.core import problems as TP
from repro_torch.core import reference as t_reference
from repro_torch.core.engine import (
    EngineOptions, dynamic_skip_enabled, labels_from_numpy, push_enabled, run,
    run_frontier_trace,
)
from repro_torch.core.partition import PartitionConfig, PartitionedGraph, partition_2d

PROBLEMS = ["bfs", "wcc", "sssp", "pagerank"]
PR_TOL = dict(rtol=1e-6, atol=1e-9)
# the reference's own split-vs-oracle tolerance for PageRank on hub graphs
# (tests/test_hub_split.py): the oracle sums a hub row in another order
HUB_PR_TOL = dict(rtol=2e-5, atol=1e-8)
STATIC = dict(dynamic_tile_skip=False, direction="pull")


def _problems(pname):
    if pname == "bfs":
        return RP.bfs(3), TP.bfs(3)
    if pname == "wcc":
        return RP.wcc(), TP.wcc()
    if pname == "sssp":
        return RP.sssp(1), TP.sssp(1)
    return RP.pagerank(), TP.pagerank()


def _case_graph(pname):
    """tests/test_engine_fused.py's graphs, weights from a private seed."""
    if pname == "sssp":
        g0 = RG.rmat(8, 6, seed=11)
        w = np.random.default_rng(11).random(g0.num_edges).astype(np.float32)
        return RG.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)
    if pname == "pagerank":
        return RG.rmat(8, 6, seed=12)
    return RG.symmetrize(RG.rmat(8, 6, seed=13))


def _hub_graph(pname):
    """tests/test_hub_split.py's hub multigraph (one dominant in-degree row)."""
    rng = np.random.default_rng(17)
    n, hub_deg, bg = 512, 3000, 1000
    src = np.concatenate([rng.integers(0, n, hub_deg), rng.integers(0, n, bg)]).astype(np.uint32)
    dst = np.concatenate([np.full(hub_deg, 3), rng.integers(0, n, bg)]).astype(np.uint32)
    w = rng.random(src.shape[0]).astype(np.float32) if pname == "sssp" else None
    return RG.COOGraph(src=src, dst=dst, num_vertices=n, weights=w)


def _port_graph(g):
    return TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=g.weights)


def _assert_agree(rp, got, want, tol=PR_TOL):
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    a, b = got.labels["label"], want.labels["label"]
    assert a.dtype == b.dtype and a.shape == b.shape
    if rp.reduce_kind == "min":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("pname", PROBLEMS)
@pytest.mark.parametrize("immediate", [True, False])
@pytest.mark.parametrize("p,l", [(1, 1), (2, 3), (4, 2)])
def test_engine_matches_reference_static(pname, immediate, p, l):
    rp, tp = _problems(pname)
    g = _case_graph(pname)
    cfg = dict(p=p, l=l, lane=4)
    want = r_run(rp, g, r_partition(g, RConfig(**cfg)),
                 REngineOptions(immediate_updates=immediate, backend="pallas", **STATIC))
    got = run(tp, _port_graph(g), partition_2d(_port_graph(g), PartitionConfig(**cfg)),
              EngineOptions(immediate_updates=immediate, **STATIC), device="cpu")
    _assert_agree(rp, got, want)


@pytest.mark.parametrize("pname", PROBLEMS)
@pytest.mark.parametrize("immediate", [True, False])
@pytest.mark.parametrize("p,l", [(2, 3), (4, 2)])
def test_engine_matches_reference_defaults(pname, immediate, p, l):
    """Both packages' defaults (dynamic skip, 'auto' direction) agree; the
    reference's oracle backend equals the port's oracle."""
    rp, tp = _problems(pname)
    g = _case_graph(pname)
    cfg = dict(p=p, l=l, lane=8, tile_vb=8)
    rpg = r_partition(g, RConfig(**cfg))
    tpg = partition_2d(_port_graph(g), PartitionConfig(**cfg))
    want = r_run(rp, g, rpg, REngineOptions(immediate_updates=immediate))
    got = run(tp, _port_graph(g), tpg, EngineOptions(immediate_updates=immediate), device="cpu")
    _assert_agree(rp, got, want)
    want_x = r_run(rp, g, rpg, REngineOptions(immediate_updates=immediate, backend="xla"))
    got_o = run(tp, _port_graph(g), tpg,
                EngineOptions(immediate_updates=immediate, backend="oracle"), device="cpu")
    _assert_agree(rp, got_o, want_x)


@pytest.mark.parametrize("pname", PROBLEMS)
@pytest.mark.parametrize("bits", [16, 32])
def test_engine_hub_split_matches_reference(pname, bits):
    """Hub-row splitting (two-level reduce) in both packed-word regimes,
    with the stride permutation on the 32-bit case."""
    rp, tp = _problems(pname)
    g = _hub_graph(pname)
    cfg = dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32, build_push=False)
    if bits == 32:
        cfg.update(pack_src_bits=32, stride=100)
    rpg = r_partition(g, RConfig(**cfg))
    assert rpg.split_rows > 0 and rpg.src_bits == bits
    want = r_run(rp, g, rpg, REngineOptions(backend="pallas", **STATIC))
    tpg = partition_2d(_port_graph(g), PartitionConfig(**cfg))
    _assert_agree(rp, run(tp, _port_graph(g), tpg, device="cpu"), want)
    _assert_agree(rp, run(tp, _port_graph(g), tpg, EngineOptions(backend="oracle"),
                          device="cpu"), want, tol=HUB_PR_TOL)


@pytest.mark.parametrize("pname", ["bfs", "pagerank"])
def test_engine_on_reference_partition_and_labels(pname):
    """State carry-over: the port runs on the reference's own partition
    arrays and label tree (``from_numpy`` / ``labels_from_numpy``)."""
    rp, tp = _problems(pname)
    g = _case_graph(pname)
    rpg = r_partition(g, RConfig(p=2, l=2, lane=4, stride=7))
    pg = PartitionedGraph.from_numpy({f.name: getattr(rpg, f.name) for f in dataclasses.fields(rpg)})
    tree = {k: np.asarray(v) for k, v in r_prepare_labels(rp, g, rpg).items()}
    got = run(tp, None, pg, labels=labels_from_numpy(tree, device="cpu"), device="cpu")
    _assert_agree(rp, got, r_run(rp, g, rpg, REngineOptions(backend="pallas", **STATIC)))


def test_engine_matches_numpy_oracles():
    g = RG.symmetrize(RG.rmat(9, 6, seed=5))
    w = np.random.default_rng(5).random(g.num_edges).astype(np.float32)
    tg = TG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)
    pg = partition_2d(tg, PartitionConfig(p=2, l=2, lane=4))
    np.testing.assert_array_equal(run(TP.bfs(0), tg, pg, device="cpu").labels["label"],
                                  t_reference.bfs_reference(tg, 0))
    np.testing.assert_array_equal(run(TP.wcc(), tg, pg, device="cpu").labels["label"],
                                  t_reference.wcc_reference(tg))
    np.testing.assert_array_equal(run(TP.sssp(0), tg, pg, device="cpu").labels["label"],
                                  t_reference.sssp_reference(tg, 0))
    np.testing.assert_allclose(run(TP.pagerank(), tg, pg, device="cpu").labels["label"],
                               t_reference.pagerank_reference(tg), atol=1e-4)


def test_bfs_saturating_add_keeps_inf():
    """Unreached vertices stay at INF_U32 through the int32-bits convention
    (the saturating +1 must not wrap INF to 0)."""
    g = TG.COOGraph(src=np.array([0, 2], np.uint32), dst=np.array([1, 3], np.uint32),
                    num_vertices=8)
    pg = partition_2d(g, PartitionConfig(p=2, l=2, lane=2))
    lab = run(TP.bfs(0), g, pg, device="cpu").labels["label"]
    assert lab.dtype == np.uint32
    np.testing.assert_array_equal(lab, [0, 1] + [0xFFFFFFFF] * 6)


# graphs of tests/test_dynamic_skip.py and tests/test_direction_switch.py
DIRECTION_CFG = dict(p=2, l=2, lane=8, tile_vb=32, tile_eb=32)


def _shuffled_path(pname):
    g = path_grid_graph(256, 1, shuffle=True, seed=11)
    if pname != "sssp":
        return g
    w = np.random.default_rng(11).uniform(0.5, 2.0, g.num_edges).astype(np.float32)
    return RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


def _hub_split(pname):
    g = skewed_graph(256, kind="star", hub_in_degree=700, avg_degree=2, seed=7)
    w = np.random.default_rng(0).uniform(0.5, 2.0, g.num_edges).astype(np.float32)
    return RG.COOGraph(src=g.src, dst=g.dst, num_vertices=g.num_vertices, weights=w)


def _weighted_rmat(pname):
    rng = np.random.default_rng(11)
    g0 = RG.symmetrize(RG.rmat(8, 6, seed=11))
    w = (rng.random(g0.num_edges) + 0.1).astype(np.float32)
    return RG.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)


DYNAMIC_GRAPHS = {"shuffled_path": _shuffled_path, "hub_split": _hub_split,
                  "weighted_rmat": _weighted_rmat}


def _problem_at(pname, gname):
    rp, tp = _problems(pname)
    if gname == "shuffled_path" and pname in ("bfs", "sssp"):  # root at the path's end
        rp, tp = (RP.bfs(0), TP.bfs(0)) if pname == "bfs" else (RP.sssp(0), TP.sssp(0))
    return rp, tp


def _both_partitions(g):
    rpg = r_partition(g, RConfig(**DIRECTION_CFG))
    tpg = partition_2d(_port_graph(g), PartitionConfig(**DIRECTION_CFG))
    return rpg, tpg


@pytest.mark.parametrize("pname", PROBLEMS)
@pytest.mark.parametrize("gname", list(DYNAMIC_GRAPHS))
def test_engine_defaults_match_reference_on_dynamic_graphs(gname, pname):
    """Default options in both packages: BFS/WCC/SSSP bit-equal, PageRank
    within 2e-5 and still on the dense pull schedule."""
    g = DYNAMIC_GRAPHS[gname](pname)
    rp, tp = _problem_at(pname, gname)
    rpg, tpg = _both_partitions(g)
    assert tpg.push_word is not None and tpg.tile_coverage is not None
    want = r_run(rp, g, rpg)
    got = run(tp, _port_graph(g), tpg, device="cpu")
    _assert_agree(rp, got, want, tol=HUB_PR_TOL)
    assert dynamic_skip_enabled(tp, tpg, EngineOptions()) == (pname != "pagerank")
    assert push_enabled(tp, tpg, EngineOptions()) == (pname != "pagerank")


@pytest.mark.parametrize("immediate", [True, False])
@pytest.mark.parametrize("pname", ["bfs", "wcc", "sssp"])
@pytest.mark.parametrize("gname", list(DYNAMIC_GRAPHS))
def test_engine_forced_push_matches_reference(gname, pname, immediate):
    g = DYNAMIC_GRAPHS[gname](pname)
    rp, tp = _problem_at(pname, gname)
    rpg, tpg = _both_partitions(g)
    want = r_run(rp, g, rpg, REngineOptions(direction="push", immediate_updates=immediate))
    got = run(tp, _port_graph(g), tpg,
              EngineOptions(direction="push", immediate_updates=immediate), device="cpu")
    _assert_agree(rp, got, want)


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
@pytest.mark.parametrize("pname", ["bfs", "wcc", "sssp"])
@pytest.mark.parametrize("gname", list(DYNAMIC_GRAPHS))
def test_frontier_trace_matches_reference(gname, pname, direction):
    """The schedule itself, iteration by iteration."""
    g = DYNAMIC_GRAPHS[gname](pname)
    rp, tp = _problem_at(pname, gname)
    rpg, tpg = _both_partitions(g)
    want = r_trace(rp, g, rpg, REngineOptions(direction=direction))
    got = run_frontier_trace(tp, _port_graph(g), tpg, EngineOptions(direction=direction),
                             device="cpu")
    for key in ("iterations", "converged", "direction", "push_iterations",
                "dense_iterations", "dynamic_skipped_tile_fraction"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["labels"]["label"], want["labels"]["label"])
    if direction == "auto" and gname == "shuffled_path" and pname == "bfs":
        assert "push" in got["direction"] and "pull" in got["direction"]


def test_frontier_trace_density_and_hysteresis_match_reference():
    """The switches' knobs: the dense fallback everywhere or nowhere, and a
    no-band alpha == beta run next to the default band."""
    g = _shuffled_path("bfs")
    rpg, tpg = _both_partitions(g)
    for kw in (dict(dynamic_skip_density=0.0), dict(dynamic_skip_density=1.5),
               dict(direction_alpha=0.05, direction_beta=0.05),
               dict(direction_alpha=2.0, direction_beta=2.0)):
        want = r_trace(RP.bfs(5), g, rpg, REngineOptions(**kw))
        got = run_frontier_trace(TP.bfs(5), _port_graph(g), tpg, EngineOptions(**kw),
                                 device="cpu")
        assert got["direction"] == want["direction"], kw
        assert got["dense_iterations"] == want["dense_iterations"], kw
        assert got["dynamic_skipped_tile_fraction"] == want["dynamic_skipped_tile_fraction"], kw


def test_unported_options_and_default_device_raise():
    """The reference's option validation, the push admissibility errors, the
    options not ported yet (multi-query lanes, the 'or' scatter), and the
    default device."""
    with pytest.raises(ValueError, match="backend"):
        EngineOptions(backend="pallas")
    with pytest.raises(ValueError, match="direction"):
        EngineOptions(direction="sideways")
    with pytest.raises(ValueError, match="alpha"):
        EngineOptions(direction_alpha=0.5, direction_beta=0.1)
    g = _port_graph(path_grid_graph(128, 1, shuffle=True, seed=5))
    pg = partition_2d(g, PartitionConfig(**DIRECTION_CFG))
    with pytest.raises(ValueError, match="push"):  # sum stays pull-only
        run(TP.pagerank(tol=1e-4), g, pg, EngineOptions(direction="push"), device="cpu")
    pg_nopush = partition_2d(g, PartitionConfig(**DIRECTION_CFG, build_push=False))
    with pytest.raises(ValueError, match="push"):
        run(TP.bfs(0), g, pg_nopush, EngineOptions(direction="push"), device="cpu")
    with pytest.raises(ValueError, match="push"):
        run(TP.bfs(0), g, pg, EngineOptions(direction="push", dynamic_tile_skip=False),
            device="cpu")
    with pytest.raises(ValueError, match="push"):
        run(TP.bfs(0), g, pg, EngineOptions(direction="push", backend="oracle"), device="cpu")
    with pytest.raises(ValueError, match="dynamic"):
        run_frontier_trace(TP.pagerank(), g, pg, device="cpu")
    # 'auto' on a pull-only partition silently stays pull
    a = run(TP.bfs(0), g, pg_nopush, device="cpu")
    b = run(TP.bfs(0), g, pg_nopush, EngineOptions(direction="pull"), device="cpu")
    np.testing.assert_array_equal(a.labels["label"], b.labels["label"])
    from repro_torch.kernels.csr_gather_reduce.scatter import scatter_reduce_cores
    with pytest.raises(ValueError, match="min"):
        scatter_reduce_cores(torch.zeros(4), torch.zeros((1, 1, 1, 4), dtype=torch.int32),
                             torch.zeros((1, 1), dtype=torch.int32), num_rows=8, kind="or")
    gk = TG.karate_club()
    pgk = partition_2d(gk, PartitionConfig(p=1, l=1, lane=4))
    if not torch.cuda.is_available():  # entry points default to the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(TP.bfs(0), gk, pgk)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_frontier_trace(TP.bfs(0), gk, pgk)


def test_import_isolation():
    """Importing the port pulls in neither jax nor the reference package."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(src)!r})
        import repro_torch.core.engine, repro_torch.core.reference
        import repro_torch.core.frontier_words, repro_torch.push_footprint
        import repro_torch.kernels.build
        import repro_torch.kernels.csr_gather_reduce.scatter
        bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]
        print(','.join(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
