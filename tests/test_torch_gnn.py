"""The port's GNN models against the JAX reference, on the CPU.

  * ``archs.apply`` of all six archs at their smoke configs, with the
    reference's weights carried across (``params_from_reference``; GAT's
    zero-initialized attention vectors set to seeded non-zero values first,
    so that the softmax is not uniform), on
    ``graph_batch_from_coo(symmetrize(rmat(8, 4)))`` (unsorted edges, some
    masked) and on ``batched_molecules``: within rtol 1e-5 and an atol of
    1e-6 times the output's scale (max(1, max |out|)): GIN's sums reach
    ~100 there, where float32 matmuls and segment sums taken in another
    order differ by a few ulps (up to 7e-5);
  * ``graph_readout`` and ``aggregate`` (sum, mean, max, with empty rows);
  * every arch's sums (forward and backward, GAT's softmax backward too)
    through the fixed-order segment sum over the batch's kept destination
    or source layout, built once, each aggregate's sum bit for bit the
    sequential float32 fold of the valid messages in edge order;
  * ``mlp`` with its activation, final activation and layer norm;
  * the graph generators byte-identical, the GNN configs value for value.

Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as RG
import repro.data.synthetic as RS
from repro.configs.base import GNN_SHAPES as R_GNN_SHAPES
from repro.configs.registry import get as r_get
from repro.models.gnn import archs as rarchs
from repro.models.gnn import common as rcommon

import repro_torch.core.graph as TG
import repro_torch.data.synthetic as TS
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.configs.registry import get as t_get
from repro_torch.models.gnn import archs, common
from repro_torch.train.optim import tree_flatten

TOL = dict(rtol=1e-5, atol=1e-6)
ARCH_IDS = ["gat-cora", "gcn-cora", "gin-tu", "graphsage", "schnet", "meshgraphnet"]


def _np_batch(b):
    """A port GraphBatch as the reference's (jnp leaves)."""
    kw = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    kw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    return rcommon.GraphBatch(**kw)


def _graphs():
    g = TG.symmetrize(TG.rmat(8, 4, seed=1))
    b, lab = TS.graph_batch_from_coo(g.src, g.dst, g.num_vertices, 12, seed=3)
    mask = np.random.default_rng(4).random(b.num_edges) < 0.9  # some edges masked
    b = dataclasses.replace(b, edge_mask=torch.from_numpy(mask))
    m, _ = TS.batched_molecules(2, n_graphs=6, nodes_per=8, edges_per=16, d_feat=12)
    return {"rmat": b, "molecules": m}


def _params(arch_id, in_dim, out_dim, seed=0):
    cfg_r = r_get(arch_id).smoke()
    tree = jax.tree.map(np.asarray, rarchs.init(jax.random.key(seed), cfg_r, in_dim, out_dim))
    if cfg_r.name == "gat":  # non-zero attention, or every softmax is uniform
        rng = np.random.default_rng(seed + 10)
        for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):
            tree[k] = (rng.standard_normal(tree[k].shape) * 0.5).astype(np.float32)
    return cfg_r, tree


@pytest.mark.parametrize("graph", ["rmat", "molecules"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_apply_matches_reference(arch_id, graph):
    b = _graphs()[graph]
    cfg_r, tree = _params(arch_id, 12, 5)
    cfg_t = t_get(arch_id).smoke()
    want = np.asarray(rarchs.apply(jax.tree.map(jnp.asarray, tree), _np_batch(b), cfg_r))
    got = archs.apply(archs.params_from_reference(tree, cfg_t, "cpu"), b, cfg_t)
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    if cfg_t.name == "gat":
        assert common.softmax_tiles(b).vb == common.softmax_vb(b.num_nodes)
        assert not np.all(np.diff(b.edge_dst.numpy()) >= 0)  # unsorted edges


def test_init_tree_matches_reference():
    for arch_id in ARCH_IDS:
        cfg_r, tree = _params(arch_id, 7, 3)
        cfg_t = t_get(arch_id).smoke()
        mine = archs.init(cfg_t, 7, 3, torch.Generator().manual_seed(0), "cpu")
        want = [x.shape for x in jax.tree.leaves(tree)]
        assert [tuple(x.shape) for x in tree_flatten(mine)[0]] == want, arch_id


@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
def test_aggregate_and_readout_match_reference(kind):
    rng = np.random.default_rng(7)
    n, e, d = 20, 60, 3
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    dst = rng.integers(0, n - 4, e).astype(np.int32)  # rows n-4.. stay empty
    mask = rng.random(e) < 0.8
    for m in (mask, None):
        want = np.asarray(rcommon.aggregate(jnp.asarray(msgs), jnp.asarray(dst), n, kind,
                                            None if m is None else jnp.asarray(m)))
        got = common.aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), n, kind,
                               None if m is None else torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got[n - 4:], 0.0)
    b = _graphs()["molecules"]
    out = np.random.default_rng(8).standard_normal((b.num_nodes, 4)).astype(np.float32)
    want = np.asarray(rarchs.graph_readout(jnp.asarray(out), _np_batch(b), kind))
    got = archs.graph_readout(torch.from_numpy(out), b, kind).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_sums_run_through_the_fixed_order_op(arch_id, monkeypatch):
    """The forward's and backward's segment sums all go through
    ``kernels.segment_sum`` (no ``index_add``), each over the one destination
    or source layout kept on the batch (GAT's softmax backward too); an
    aggregate's sum is the sequential float32 fold of its valid messages in
    edge order, as the kernel adds on the card."""
    from repro_torch.kernels.segment_sum import kernel as SS

    b = _graphs()["rmat"]
    calls = []
    real = SS.segment_sum_rows
    monkeypatch.setattr(SS, "segment_sum_rows",
                        lambda x, seg, layout, n: calls.append((n, layout))
                        or real(x, seg, layout, n))
    add = torch.Tensor.index_add
    monkeypatch.setattr(torch.Tensor, "index_add", lambda *a, **k: pytest.fail("index_add"))
    monkeypatch.setattr(torch.Tensor, "index_add_", lambda *a, **k: pytest.fail("index_add_"))
    cfg_r, tree = _params(arch_id, 12, 5)
    cfg_t = t_get(arch_id).smoke()
    leaves, rebuild = tree_flatten(archs.params_from_reference(tree, cfg_t, "cpu"))
    live = [p.requires_grad_(True) for p in leaves]
    archs.apply(rebuild(live), b, cfg_t).square().sum().backward()
    layout = common.edge_layout(b)
    assert layout is common.edge_layout(b)
    kept = (layout, common.edge_layout(b, "src"))
    assert calls and all(n == b.num_nodes and any(l_ is k for k in kept) for n, l_ in calls)
    monkeypatch.setattr(torch.Tensor, "index_add", add)
    msgs = torch.from_numpy(np.random.default_rng(9).standard_normal((b.num_edges, 3))
                            .astype(np.float32))
    got = common.aggregate(msgs, b.edge_dst, b.num_nodes, "sum", b.edge_mask, layout=layout)
    want = torch.zeros(b.num_nodes, 3)
    for i in np.nonzero(b.edge_mask.numpy())[0]:
        want[b.edge_dst[i]] = want[b.edge_dst[i]] + msgs[i]
    assert torch.equal(got, want)


@pytest.mark.parametrize("layer_norm,final_act", [(False, False), (True, False), (True, True)])
def test_mlp_options_match_reference(layer_norm, final_act):
    p = jax.tree.map(np.asarray, rcommon.init_mlp(jax.random.key(3), [6, 9, 5],
                                                  layer_norm=layer_norm))
    if layer_norm:
        rng = np.random.default_rng(9)
        p["ln_scale"] = rng.random(5).astype(np.float32) + 0.5
        p["ln_bias"] = rng.standard_normal(5).astype(np.float32)
    x = np.random.default_rng(10).standard_normal((11, 6)).astype(np.float32)
    want = np.asarray(rcommon.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                  act=jax.nn.elu, final_act=final_act))
    pt = {k: ([torch.tensor(a) for a in v] if isinstance(v, list) else torch.tensor(v))
          for k, v in p.items()}
    got = common.mlp(pt, torch.from_numpy(x), act=torch.nn.functional.elu,
                     final_act=final_act).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    mine = common.init_mlp(torch.Generator().manual_seed(0), [6, 9, 5], layer_norm=layer_norm)
    assert ("ln_scale" in mine) == layer_norm


@pytest.mark.parametrize("seed,scale,d_feat", [(0, 8, 12), (3, 7, 5)])
def test_graph_generators_byte_identical(seed, scale, d_feat):
    g = RG.symmetrize(RG.rmat(scale, 4, seed=seed))
    rb, rl = RS.graph_batch_from_coo(g.src, g.dst, g.num_vertices, d_feat, seed=seed,
                                     n_classes=5)
    tb, tl = TS.graph_batch_from_coo(g.src, g.dst, g.num_vertices, d_feat, seed=seed,
                                     n_classes=5)
    rm, rml = RS.batched_molecules(seed, 4, 8, 16, d_feat)
    tm, tml = TS.batched_molecules(seed, 4, 8, 16, d_feat)
    for r, t in ((rb, tb), (rm, tm)):
        assert r.n_graphs == t.n_graphs
        for f in dataclasses.fields(r):
            a, b = getattr(r, f.name), getattr(t, f.name)
            if f.name == "n_graphs" or a is None:
                assert b is None or f.name == "n_graphs"
                continue
            b = b.numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    assert rl.tobytes() == tl.tobytes() and rml.tobytes() == tml.tobytes()
    rng_r, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    for a, b in zip(RS.random_positions_distances(rng_r, g.src, g.dst, g.num_vertices),
                    TS.random_positions_distances(rng_t, g.src, g.dst, g.num_vertices)):
        assert a.tobytes() == b.tobytes()


def test_configs_match_reference():
    assert [dataclasses.asdict(s) for s in GNN_SHAPES] == \
        [dataclasses.asdict(s) for s in R_GNN_SHAPES]
    for arch_id in ARCH_IDS:
        ra, ta = r_get(arch_id), t_get(arch_id)
        for f in dataclasses.fields(ra):
            if f.name in ("model", "smoke", "shapes"):
                continue
            assert getattr(ta, f.name) == getattr(ra, f.name), (arch_id, f.name)
        assert ta.shapes == GNN_SHAPES
        for mr, mt in ((ra.model, ta.model), (ra.smoke(), ta.smoke())):
            for f in dataclasses.fields(mr):
                a, b = getattr(mt, f.name), getattr(mr, f.name)
                if f.name == "dtype":
                    assert str(a).split(".")[-1] == np.dtype(b).name
                else:
                    assert a == b, (arch_id, f.name)
