"""Dry-run cells: (arch x shape x mesh) -> (step fn, fake inputs placed
on the mesh, their partition specs, donation, analytic MODEL_FLOPS).

Counterpart of ``repro.launch.cells``. Where the reference gives
``jax.ShapeDtypeStruct``s carrying ``NamedSharding``s, a cell here holds
fake tensors (``FakeTensorMode``: shapes, dtypes and devices, no storage)
made by the models' own ``init`` functions, with the reference's spec trees
beside them (``specs``, ``out_specs``: trees of ``dist.sharding.P``). On a
mesh of more than one rank each input is a ``DTensor`` of fake tensors, its
local shard this rank's, placed by ``dist.sharding.placements``; on a mesh
of one rank it is the fake tensor itself. ``launch.dryrun`` traces
``fn(*args)`` under the cell's ``mode``; ``make_real(device, seed)`` gives
the same inputs as real tensors drawn from ``seed`` (one rank), so the step
that was traced runs on the card.

A GNN cell's index arrays are real, drawn from the seed on the host: GAT's
softmax layout is built from the batch's destination ids before the trace
(``setup``), and the traced step reads its shapes. Only the cell's floats
(and the index leaves the trace sees) are fake.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import archs as gnn
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.recsys import din as din_mod
from repro_torch.train import steps as steps_mod
from repro_torch.train.optim import AdamWConfig, tree_flatten

__all__ = ["Cell", "build_cell", "OPT_CFG", "spec_leaves"]

OPT_CFG = AdamWConfig(lr=3e-4, total_steps=100_000, warmup_steps=2000)


@dataclasses.dataclass
class Cell:
    key: str
    fn: Callable
    args: Tuple[Any, ...]  # fake tensors (DTensors of them on a mesh of > 1 rank)
    specs: Tuple[Any, ...]  # the reference's in-sharding spec trees, arg for arg
    out_specs: Any  # the reference's out_shardings as spec trees
    donate_argnums: Tuple[int, ...]
    meta: Dict[str, Any]
    mode: Any = None  # the FakeTensorMode that owns ``args``
    make_real: Optional[Callable] = None  # (device, seed) -> real args on one rank
    setup: Optional[Callable] = None  # host work before a trace (GAT's layout)
    dtype: torch.dtype = torch.float32  # the type the cell's matmuls run in


# ---------------------------------------------------------------------------
# fake inputs on a mesh
# ---------------------------------------------------------------------------


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # real host arrays (GAT's layout) become fake tensors inside the trace
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fake_active() -> bool:
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def _is_leaf_spec(x) -> bool:
    return isinstance(x, P)


def _place(tree, spec_tree, mesh, device):
    """``tree``'s fake tensors on ``device``, each as a DTensor of its local
    shard under ``spec_tree`` when the mesh has more than one rank."""
    if isinstance(tree, GraphBatch):  # its tensor fields, each under its field's spec
        return dataclasses.replace(tree, **{
            f.name: _place(getattr(tree, f.name), getattr(spec_tree, f.name), mesh, device)
            for f in dataclasses.fields(tree) if isinstance(getattr(tree, f.name), torch.Tensor)})
    leaves, rebuild = tree_flatten(tree)
    specs, _ = tree_flatten(spec_tree, is_leaf=_is_leaf_spec)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    out = []
    for t, spec in zip(leaves, specs):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        # a fresh fake on ``device`` (a fake CPU tensor cannot move to a card
        # this build of torch lacks)
        t = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
        if mesh.size() > 1:
            from torch.distributed.tensor import DTensor, Shard

            place = shd.placements(spec, mesh)
            local_shape = list(t.shape)  # rank 0's: the first chunk of each split
            for mdim, pl in enumerate(place):
                if isinstance(pl, Shard):
                    local_shape[pl.dim] = -(-local_shape[pl.dim] // mesh.size(mdim))
            local = torch.empty(local_shape, dtype=t.dtype, device=device)
            t = DTensor.from_local(local, mesh, place, run_check=False, shape=t.shape,
                                   stride=t.stride())
        out.append(t)
    return rebuild(out)


def _sharding(mesh, spec: P):
    """An LM config's sharding field: the ``(mesh, placements)`` pair
    ``models.transformer._wsc`` redistributes a DTensor to."""
    return (mesh, shd.placements(spec, mesh))


def _device(mesh) -> torch.device:
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (the reference's formulas, float for float)
# ---------------------------------------------------------------------------


def _lm_flops(cfg: tfm.LMConfig, kind: str, batch: int, seq: int) -> float:
    n_act = tfm.active_params(cfg)
    if kind == "train":
        t = batch * seq
        attn = 12 * cfg.n_layers * batch * seq * seq * cfg.n_heads * cfg.hd // 2
        return 6.0 * n_act * t + attn  # 6ND + causal attention term
    if kind == "prefill":
        t = batch * seq
        attn = 4 * cfg.n_layers * batch * seq * seq * cfg.n_heads * cfg.hd // 2
        return 2.0 * n_act * t + attn
    # decode: one token per sequence against a seq-length cache
    attn = 4.0 * cfg.n_layers * batch * cfg.n_heads * cfg.hd * seq
    return 2.0 * n_act * batch + attn


def _gnn_flops(arch: ArchConfig, dims: Dict[str, int], train: bool) -> float:
    cfg: gnn.GNNConfig = arch.model
    n, e, h = dims.get("n_nodes", 0), dims.get("n_edges", 0), cfg.d_hidden
    f = dims.get("d_feat", 16)
    if cfg.name in ("gin", "gcn", "sage"):
        fwd = 2 * n * (f * h + h * h) + cfg.n_layers * (e * h + 2 * n * 2 * h * h)
    elif cfg.name == "gat":
        hh = h * cfg.n_heads
        fwd = 2 * n * f * hh + 2 * (2 * n * hh * hh + 3 * e * hh) + 2 * n * hh * arch.gnn_out_dim
    elif cfg.name == "schnet":
        fwd = 2 * n * (f * h + h * h) + cfg.n_layers * (
            2 * e * (cfg.rbf * h + h * h) + 2 * n * (3 * h * h) + e * h
        )
    else:  # meshgraphnet
        fwd = 2 * n * (f * h + h * h) + cfg.n_layers * (
            2 * e * (3 * h * h + h * h) + 2 * n * (2 * h * h + h * h) + e * h
        )
    fwd += 2 * n * (h * h + h * arch.gnn_out_dim)
    return 3.0 * fwd if train else fwd


def _din_flops(cfg: din_mod.DINConfig, batch: int, n_cand: int = 0, train: bool = False) -> float:
    e = 2 * cfg.embed_dim
    a1, a2 = cfg.attn_mlp
    o1, o2 = cfg.out_mlp
    per_pair = 2 * (4 * e * a1 + a1 * a2 + a2)  # attention unit per history elem
    per_user = cfg.seq_len * per_pair + 2 * ((2 * e + cfg.embed_dim) * o1 + o1 * o2 + o2)
    units = batch if n_cand == 0 else n_cand
    return (3.0 if train else 1.0) * units * per_user


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_cell(arch: ArchConfig, shape: ShapeCell, mesh) -> Cell:
    r = shd.rules_for_mesh(mesh)
    d = shape.dims
    # activations are SEQUENCE-sharded over the model axis (Megatron-SP
    # style), batch over fsdp; MoE dispatch in one group per data shard when
    # the token count divides (the reference's choices, cells.py:121-154)
    b_axis = r.axis_if(r.fsdp, d["batch"])
    seq = d["seq"] if shape.kind != "decode" else 1
    s_axis = r.axis_if(r.tp, seq)
    tokens = d["batch"] * (d["seq"] if shape.kind in ("train", "prefill") else 1)
    moe_groups = (
        r.size(r.fsdp)
        if arch.model.moe is not None and tokens % r.size(r.fsdp) == 0
        else 1
    )
    if arch.model.moe is None:
        expert_sharding = None
    else:
        e_axis = r.axis_if(r.tp, arch.model.moe.num_experts)
        expert_sharding = _sharding(mesh, P(r.fsdp, e_axis, None, None) if moe_groups > 1
                                    else P(e_axis, None, None))
    cfg: tfm.LMConfig = dataclasses.replace(
        arch.model,
        act_sharding=_sharding(mesh, P(b_axis, s_axis, None)),
        logit_sharding=_sharding(mesh, P(b_axis, None, r.axis_if(r.tp, arch.model.vocab))),
        attn_sharding=_sharding(mesh, P(b_axis, None, s_axis, None)),
        expert_sharding=expert_sharding,
        moe_groups=moe_groups,
    )
    pspecs = shd.lm_param_specs(r, cfg)
    key = f"{arch.arch_id}/{shape.name}"
    dev = _device(mesh)
    mode = _fake_mode()

    def params(device, gen):
        return tfm.init_params(cfg, gen, device)

    def tokens_of(gen, device, b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=gen.device,
                             dtype=torch.int32).to(device)

    if shape.kind == "train":
        sspecs = shd.state_specs(pspecs)
        bspecs = shd.lm_batch_specs(r, d["batch"])

        def trees(device, gen):
            state = steps_mod.init_train_state(params(device, gen), OPT_CFG)
            batch = {k: tokens_of(gen, device, d["batch"], d["seq"]) for k in ("tokens", "labels")}
            return state, batch

        specs = (sspecs, {k: bspecs[k] for k in ("tokens", "labels")})
        return _finish(Cell(
            key=key, fn=steps_mod.make_lm_train_step(cfg, OPT_CFG), args=(), specs=specs,
            out_specs=(sspecs, {"loss": P()}), donate_argnums=(0,),
            meta=dict(family="lm", kind="train",
                      model_flops=_lm_flops(cfg, "train", d["batch"], d["seq"]),
                      tokens=d["batch"] * d["seq"],
                      params=tfm.count_params(cfg), active_params=tfm.active_params(cfg)),
            mode=mode, dtype=cfg.dtype), trees, mesh, dev)

    if shape.kind == "prefill":
        def trees(device, gen):
            return params(device, gen), tokens_of(gen, device, d["batch"], d["seq"])

        logits_spec = P(r.axis_if(r.fsdp, d["batch"]), None, r.axis_if(r.tp, cfg.vocab))
        return _finish(Cell(
            key=key, fn=steps_mod.make_lm_prefill(cfg), args=(),
            specs=(pspecs, shd.lm_batch_specs(r, d["batch"])["tokens"]),
            out_specs=logits_spec, donate_argnums=(),
            meta=dict(family="lm", kind="prefill",
                      model_flops=_lm_flops(cfg, "prefill", d["batch"], d["seq"]),
                      tokens=d["batch"] * d["seq"], params=tfm.count_params(cfg)),
            mode=mode, dtype=cfg.dtype), trees, mesh, dev)

    # decode (decode_32k / long_500k): one token against a seq-long cache,
    # written at the last slot
    cspecs = shd.lm_cache_specs(r, cfg, d["batch"], d["seq"])

    def trees(device, gen):
        cache = tfm.init_kv_cache(cfg, d["batch"], d["seq"], device=device)
        return (params(device, gen), cache, tokens_of(gen, device, d["batch"], 1), d["seq"] - 1)

    return _finish(Cell(
        key=key, fn=steps_mod.make_lm_decode_step(cfg), args=(),
        specs=(pspecs, cspecs, P(b_axis, None), P()),
        out_specs=(P(b_axis, r.axis_if(r.tp, cfg.vocab)), cspecs), donate_argnums=(1,),
        meta=dict(family="lm", kind="decode",
                  model_flops=_lm_flops(cfg, "decode", d["batch"], d["seq"]),
                  tokens=d["batch"], params=tfm.count_params(cfg)),
        mode=mode, dtype=cfg.dtype), trees, mesh, dev)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_indices(d: Dict[str, int], kind: str, seed: int) -> Dict[str, np.ndarray]:
    """The batch's index arrays, drawn from ``seed`` on the host: uniform
    edges (within each graph for molecules), every node and edge valid."""
    rng = np.random.default_rng(seed)
    n, e = d["n_nodes"], d["n_edges"]
    if kind == "gnn_molecule":
        g, npg, epg = d["n_graphs"], d["nodes_per"], d["edges_per"]
        base = np.repeat(np.arange(g) * npg, epg)
        src = base + rng.integers(0, npg, e)
        dst = base + rng.integers(0, npg, e)
        graph_id = np.repeat(np.arange(g), npg)
    else:
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        graph_id = np.zeros(n)
    return dict(edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
                node_mask=np.ones(n, bool), edge_mask=np.ones(e, bool),
                graph_id=graph_id.astype(np.int32))


def _gnn_cell(arch: ArchConfig, shape: ShapeCell, mesh, seed: int) -> Cell:
    cfg: gnn.GNNConfig = (
        arch.model if arch.model.remat else dataclasses.replace(arch.model, remat=True)
    )
    r = shd.rules_for_mesh(mesh)
    d = dict(shape.dims)
    if shape.kind == "gnn_molecule":
        d["n_nodes"] = d["n_graphs"] * d["nodes_per"]
        d["n_edges"] = d["n_graphs"] * d["edges_per"]
        n_graphs = d["n_graphs"]
        task = "graph_class"
    else:
        n_graphs = 1
        task = arch.gnn_task
    out_dim = d.get("n_classes", arch.gnn_out_dim) if task.endswith("class") else arch.gnn_out_dim
    n, e, f = d["n_nodes"], d["n_edges"], d["d_feat"]
    host = {}  # the seeded index arrays, drawn at first real use

    def indices():
        if not host:
            host.update(_gnn_indices(d, shape.kind, seed))
        return host

    def trees(device, gen):
        p = gnn.init(cfg, f, out_dim, gen, device)
        state = steps_mod.init_train_state(p, OPT_CFG)
        if _fake_active():  # shapes only
            idx = {k: torch.zeros(n if k.startswith(("node", "graph")) else e,
                                  dtype=torch.bool if k.endswith("mask") else torch.int32)
                   for k in ("edge_src", "edge_dst", "node_mask", "edge_mask", "graph_id")}
        else:
            idx = {k: torch.from_numpy(v).to(device) for k, v in indices().items()}
        batch = GraphBatch(
            node_feat=torch.randn(n, f, generator=gen, device=gen.device).to(device),
            n_graphs=n_graphs,
            edge_dist=(torch.rand(e, generator=gen, device=gen.device) * 10).to(device),
            **idx)
        if task == "graph_class":
            labels = torch.randint(0, out_dim, (n_graphs,), generator=gen, device=gen.device,
                                   dtype=torch.int32)
        elif task == "node_reg":
            labels = torch.randn(n, out_dim, generator=gen, device=gen.device)
        else:
            labels = torch.randint(0, out_dim, (n,), generator=gen, device=gen.device,
                                   dtype=torch.int32)
        return state, batch, labels.to(device)

    with _fake_mode():
        pstruct = gnn.init(cfg, f, out_dim, torch.Generator(), "cpu")
    sspecs = shd.state_specs(shd.replicated_specs(pstruct))
    bspecs = shd.gnn_batch_specs(r, n, e, n_graphs)
    gaxes = r.all_axes
    if task == "graph_class":
        lspec = P(r.axis_if(gaxes, n_graphs))
    elif task == "node_reg":
        lspec = P(r.axis_if(gaxes, n), None)
    else:
        lspec = P(r.axis_if(gaxes, n))
    loss_nodes = d.get("batch_nodes") if shape.kind == "gnn_minibatch" else None
    cell = Cell(
        key=f"{arch.arch_id}/{shape.name}",
        fn=steps_mod.make_gnn_train_step(cfg, OPT_CFG, task=task, loss_nodes=loss_nodes),
        args=(), specs=(sspecs, bspecs, lspec), out_specs=(sspecs, {"loss": P()}),
        donate_argnums=(0,),
        meta=dict(family="gnn", kind=shape.kind, task=task,
                  model_flops=_gnn_flops(arch, d, train=True),
                  edges=d["n_edges"], nodes=d["n_nodes"]),
        mode=_fake_mode(), dtype=cfg.dtype)
    cell = _finish(cell, trees, mesh, _device(mesh))
    if cfg.name == "gat":
        def setup(batch=None):
            """Build GAT's softmax layout on the host from the seeded
            destination ids and keep it on ``batch`` (a real one), or on the
            traced batch when None."""
            from repro_torch.kernels.segment_softmax.ops import build_edge_tiles
            from repro_torch.models.gnn.common import SOFTMAX_EB, softmax_vb

            layout = build_edge_tiles(indices()["edge_dst"], indices()["edge_mask"], n,
                                      vb=softmax_vb(n), eb=SOFTMAX_EB)
            object.__setattr__(cell.args[1] if batch is None else batch, "_softmax_host", layout)

        cell.setup = setup
    return cell


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _din_lookup(mesh, table_axes, batch_axes, capacity_factor=2.0):
    """The reference's ``make_crossbar_lookup(mesh, table_axis, batch_axes)``
    on DTensors: each rank's table shard and share of the ids go through
    ``dist.embedding.make_crossbar_lookup`` over the groups of
    ``table_axes`` (``local_map``); at one rank the one-shard crossbar."""
    from repro_torch.dist.embedding import make_crossbar_lookup

    if mesh.size() == 1:
        return make_crossbar_lookup(capacity_factor=capacity_factor)
    from torch.distributed.tensor.experimental import local_map

    taxes = (table_axes,) if isinstance(table_axes, str) else tuple(table_axes)
    baxes = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes)
    groups = [mesh.get_group(a) for a in taxes]
    inner = make_crossbar_lookup(groups if len(groups) > 1 else groups[0], capacity_factor)

    def lookup(table, ids):
        tspec = P(taxes if len(taxes) > 1 else taxes[0], None)
        ispec = P(baxes if len(baxes) > 1 else baxes[0], *([None] * (ids.dim() - 1)))
        ospec = P(*ispec, None)
        fn = local_map(inner, out_placements=list(shd.placements(ospec, mesh)),
                       in_placements=(list(shd.placements(tspec, mesh)),
                                      list(shd.placements(ispec, mesh))),
                       device_mesh=mesh, redistribute_inputs=True)
        return fn(table, ids)

    return lookup


def _din_cell(arch: ArchConfig, shape: ShapeCell, mesh) -> Cell:
    cfg: din_mod.DINConfig = arch.model
    # training takes the FULL crossbar (table grads and Adam moments shard
    # over the whole mesh); serving keeps the tp crossbar (cells.py:354-355)
    if shape.kind == "serve_train" and cfg.lookup == "crossbar":
        cfg = dataclasses.replace(cfg, lookup="crossbar_full")
    r = shd.rules_for_mesh(mesh)
    d = shape.dims
    pspecs = shd.din_param_specs(r, cfg)
    lookup_fn = None
    if cfg.lookup == "crossbar":
        lookup_fn = _din_lookup(mesh, r.tp, r.all_axes)
    elif cfg.lookup == "crossbar_full":
        lookup_fn = _din_lookup(mesh, r.all_axes, r.all_axes)
    key = f"{arch.arch_id}/{shape.name}"
    mode = _fake_mode()

    def ids(gen, device, shape_, hi):
        return torch.randint(0, hi, shape_, generator=gen, device=gen.device,
                             dtype=torch.int32).to(device)

    def din_batch(gen, device, batch, with_labels):
        tree = {
            "hist_items": ids(gen, device, (batch, cfg.seq_len), cfg.item_vocab),
            "hist_cates": ids(gen, device, (batch, cfg.seq_len), cfg.cate_vocab),
            "target_item": ids(gen, device, (batch,), cfg.item_vocab),
            "target_cate": ids(gen, device, (batch,), cfg.cate_vocab),
            "profile_bag": ids(gen, device, (batch, cfg.profile_bag_len), cfg.cate_vocab),
        }
        if with_labels:
            tree["labels"] = (torch.rand(batch, generator=gen, device=gen.device) < 0.5) \
                .to(device=device, dtype=torch.float32)
        return tree

    if shape.kind == "serve_train":
        sspecs = shd.state_specs(pspecs)
        bspecs = shd.din_batch_specs(r, d["batch"])

        def trees(device, gen):
            state = steps_mod.init_train_state(din_mod.init(cfg, gen, device), OPT_CFG)
            return state, din_batch(gen, device, d["batch"], True)

        return _finish(Cell(
            key=key, fn=steps_mod.make_din_train_step(cfg, OPT_CFG, lookup_fn=lookup_fn),
            args=(), specs=(sspecs, {k: bspecs[k] for k in bspecs}),
            out_specs=(sspecs, {"loss": P()}), donate_argnums=(0,),
            meta=dict(family="recsys", kind="train",
                      model_flops=_din_flops(cfg, d["batch"], train=True)),
            mode=mode, dtype=cfg.dtype), trees, mesh, _device(mesh))

    if shape.kind == "serve":
        bspecs = shd.din_batch_specs(r, d["batch"])
        bspecs = {k: v for k, v in bspecs.items() if k != "labels"}
        b = r.axis_if(r.all_axes, d["batch"]) or r.axis_if(r.fsdp, d["batch"])

        def trees(device, gen):
            return din_mod.init(cfg, gen, device), din_batch(gen, device, d["batch"], False)

        return _finish(Cell(
            key=key, fn=steps_mod.make_din_serve(cfg, lookup_fn=lookup_fn), args=(),
            specs=(pspecs, bspecs), out_specs=P(b), donate_argnums=(),
            meta=dict(family="recsys", kind="serve", model_flops=_din_flops(cfg, d["batch"])),
            mode=mode, dtype=cfg.dtype), trees, mesh, _device(mesh))

    # retrieval: one user, n_candidates items (vectorized, no chunk loop)
    nc = d["n_candidates"]
    rspecs = shd.din_retrieval_specs(r, nc)

    def trees(device, gen):
        return din_mod.init(cfg, gen, device), {
            "hist_items": ids(gen, device, (1, cfg.seq_len), cfg.item_vocab),
            "hist_cates": ids(gen, device, (1, cfg.seq_len), cfg.cate_vocab),
            "profile_bag": ids(gen, device, (1, cfg.profile_bag_len), cfg.cate_vocab),
            "cand_items": ids(gen, device, (nc,), cfg.item_vocab),
            "cand_cates": ids(gen, device, (nc,), cfg.cate_vocab),
        }

    return _finish(Cell(
        key=key, fn=steps_mod.make_din_retrieval(cfg, chunk=None), args=(),
        specs=(pspecs, rspecs), out_specs=P(r.axis_if(r.all_axes, nc)), donate_argnums=(),
        meta=dict(family="recsys", kind="retrieval",
                  model_flops=_din_flops(cfg, 1, n_cand=nc)),
        mode=mode, dtype=cfg.dtype), trees, mesh, _device(mesh))


def _finish(cell: Cell, trees: Callable, mesh, device) -> Cell:
    """Fill ``cell.args`` (``trees`` under the cell's fake mode on the CPU,
    moved to ``device`` and placed on the mesh) and ``cell.make_real``."""
    with cell.mode:
        fake = trees("cpu", torch.Generator())
        cell.args = tuple(_place(t, s, mesh, device) for t, s in zip(fake, cell.specs))

    def make_real(device, seed: int):
        if mesh.size() != 1:
            raise ValueError(f"real inputs are made for a mesh of one rank, not {mesh.size()}")
        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return trees(dev, gen)

    cell.make_real = make_real
    return cell


def build_cell(
    arch: ArchConfig,
    shape_name: str,
    mesh,
    model_overrides: Optional[Dict[str, Any]] = None,
    seed: int = 0,
) -> Cell:
    """The cell of ``arch`` at ``shape_name`` on ``mesh`` (a ``DeviceMesh``
    with the reference's axis names; ``launch.mesh.make_production_mesh``).
    ``seed`` draws a GNN cell's index arrays."""
    shape = arch.shape(shape_name)
    if model_overrides:
        arch = dataclasses.replace(
            arch, model=dataclasses.replace(arch.model, **model_overrides)
        )
    if arch.family == "lm":
        return _lm_cell(arch, shape, mesh)
    if arch.family == "gnn":
        return _gnn_cell(arch, shape, mesh, seed)
    return _din_cell(arch, shape, mesh)


def spec_leaves(tree) -> list:
    """A spec tree's ``P`` leaves in ``tree_flatten`` order."""
    return tree_flatten(tree, is_leaf=_is_leaf_spec)[0]
