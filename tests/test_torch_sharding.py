"""The port's mesh rules and partition-spec builders against
``repro.dist.sharding``, on the CPU.

Meshes (pod, data, model) = (2, 16, 16), (data, model) = (4, 1) after a
1-sized pod, and (data,) = (8,), given to both packages as a stand-in with
``axis_names`` and a ``shape`` mapping (no 512 devices here); the port also
reads a ``DeviceMesh``'s ``mesh_dim_names`` and sizes. Every spec tree equals
the reference's leaf for leaf (same paths, same per-dim axes): the five LM
configs at published width (parameters, train state, batch, KV cache), DIN
with ``take`` and ``crossbar_full`` (parameters, batch, retrieval), GNN
batches and replicated GNN parameters. The port reads parameter shapes
under ``FakeTensorMode``: building llama3-8b's specs allocates nothing.
``placements`` turns specs into DTensor placements; ``_wsc`` is the
identity on plain tensors.
"""
import dataclasses
import resource
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs.registry import get as r_get
from repro.dist import sharding as RS
from repro.models.gnn import archs as r_gnn

from repro_torch.configs.registry import get as t_get
from repro_torch.dist import sharding as TS
from repro_torch.models.gnn import archs as t_gnn

LM_ARCHS = ("smollm-135m", "llama3-8b", "qwen3-14b", "qwen3-moe-30b-a3b",
            "granite-moe-1b-a400m")
MESHES = {
    "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "pod1x4x1": (("pod", "data", "model"), (1, 4, 1)),
    "data8": (("data",), (8,)),
}


def _mesh(name):
    names, sizes = MESHES[name]
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(tuple(_key(k) for k in path), tuple(spec)) for path, spec in flat]


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _port_leaves(getattr(tree, f), path + (f,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _port_leaves(v, path + (str(i),))]
    assert isinstance(tree, TS.P), (path, tree)
    return [(path, tuple(tree))]


def _assert_same(port, ref):
    got, want = _port_leaves(port), _ref_leaves(ref)
    assert len(got) == len(want) and got == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rules_for_mesh_match_reference(mesh):
    r, t = RS.rules_for_mesh(_mesh(mesh)), TS.rules_for_mesh(_mesh(mesh))
    assert (t.axis_sizes, t.fsdp, t.tp, t.all_axes) == (r.axis_sizes, r.fsdp, r.tp, r.all_axes)
    for axis in (None, "data", t.fsdp, t.all_axes):
        for dim in (1, 4, 6, 16, 96, 512, 1000):
            assert t.axis_if(axis, dim) == r.axis_if(axis, dim)
    names, sizes = MESHES[mesh]
    device_mesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)  # a DeviceMesh's fields
    d = TS.rules_for_mesh(device_mesh)
    assert (d.axis_sizes, d.fsdp, d.tp) == (t.axis_sizes, t.fsdp, t.tp)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_specs_match_reference(arch, mesh):
    r, t = RS.rules_for_mesh(_mesh(mesh)), TS.rules_for_mesh(_mesh(mesh))
    rcfg, tcfg = r_get(arch).model, t_get(arch).model
    rp, tp = RS.lm_param_specs(r, rcfg), TS.lm_param_specs(t, tcfg)
    _assert_same(tp, rp)
    _assert_same(TS.state_specs(tp), RS.state_specs(rp))
    for batch in (1, 8, 256):
        _assert_same(TS.lm_batch_specs(t, batch), RS.lm_batch_specs(r, batch))
        _assert_same(TS.lm_cache_specs(t, tcfg, batch, 32768),
                     RS.lm_cache_specs(r, rcfg, batch, 32768))


def test_lm_specs_at_full_width_allocate_nothing():
    """llama3-8b's ~16 GB of parameters: the spec build reads shapes only."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    specs = TS.lm_param_specs(TS.rules_for_mesh(_mesh("pod2x16x16")), t_get("llama3-8b").model)
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert specs["embed"] == TS.P("model", ("pod", "data")) and grown_kb < 1_000_000


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("lookup", ["take", "crossbar_full"])
def test_din_specs_match_reference(lookup, mesh):
    r, t = RS.rules_for_mesh(_mesh(mesh)), TS.rules_for_mesh(_mesh(mesh))
    rcfg = dataclasses.replace(r_get("din").model, lookup=lookup)
    tcfg = dataclasses.replace(t_get("din").model, lookup=lookup)
    _assert_same(TS.din_param_specs(t, tcfg), RS.din_param_specs(r, rcfg))
    for batch in (1, 512, 65536):
        _assert_same(TS.din_batch_specs(t, batch), RS.din_batch_specs(r, batch))
    for n in (4096, 1048576, 1000):
        _assert_same(TS.din_retrieval_specs(t, n), RS.din_retrieval_specs(r, n))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", ["full_graph_sm", "minibatch_lg", "ogb_products"])
def test_gnn_specs_match_reference(cell, mesh):
    r, t = RS.rules_for_mesh(_mesh(mesh)), TS.rules_for_mesh(_mesh(mesh))
    dims = t_get("graphsage").shape(cell).dims
    got = TS.gnn_batch_specs(t, dims["n_nodes"], dims["n_edges"], 1)
    want = RS.gnn_batch_specs(r, dims["n_nodes"], dims["n_edges"], 1)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (tuple(a) if isinstance(a, TS.P) else a) == \
            (tuple(b) if isinstance(b, PartitionSpec) else b), f.name
    cfg = t_get("gat-cora").model
    tparams = t_gnn.init(cfg, 16, 4, torch.Generator(), "cpu")
    rparams = r_gnn.init(jax.random.key(0), r_get("gat-cora").model, 16, 4)
    _assert_same(TS.replicated_specs(tparams), RS.replicated_specs(rparams))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TS.placements(TS.P(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert TS.placements(TS.P(("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert TS.placements(TS.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="not in mesh"):
        TS.placements(TS.P("graph"), mesh)


def test_wsc_is_the_identity_on_plain_tensors():
    from repro_torch.models import transformer as tfm

    x = torch.randn(2, 3)
    mesh = SimpleNamespace(mesh_dim_names=("data",))
    assert tfm._wsc(x, None) is x and tfm._wsc(x, (mesh, TS.placements(TS.P("data"), mesh))) is x
    cfg = t_get("smollm-135m").smoke()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    sharded = dataclasses.replace(cfg, act_sharding=(mesh, ()), logit_sharding=(mesh, ()),
                                  attn_sharding=(mesh, ()))
    with torch.no_grad():
        a, _ = tfm.forward(params, tokens, cfg)
        b, _ = tfm.forward(params, tokens, sharded)
    assert torch.equal(a, b)
