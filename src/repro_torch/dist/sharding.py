"""Mesh axis roles and partition-spec trees for every architecture family.

Counterpart of ``repro.dist.sharding``. ``rules_for_mesh`` classifies a
mesh's axes into the two roles the launchers reason about: ``fsdp`` (batch
and parameter-shard axes, ``pod`` + ``data``) and ``tp`` (the
tensor-parallel ``model`` axis). It reads a ``torch.distributed``
``DeviceMesh`` (``mesh_dim_names`` and its sizes) or anything with
``axis_names`` and a ``shape`` mapping (the reference's ``jax.sharding.Mesh``,
or a stand-in for a mesh larger than the machine). ``axis_if(axis, dim)``
returns the axis only when ``dim`` divides evenly over it, so an
indivisible dim stays replicated.

The spec builders return trees of ``P``, the port's partition spec: per
tensor dim a mesh axis name, a tuple of names, or None. They match the
parameter, batch and cache trees leaf for leaf, and equal the reference's
``PartitionSpec`` trees. The LM and DIN builders read the parameter shapes
from the models' own ``init`` run under ``FakeTensorMode``: nothing is
allocated (llama3-8b's parameters are ~16 GB).

``placements(spec, mesh)`` turns a spec into DTensor ``Shard``/``Replicate``
placements on a ``DeviceMesh``; ``local_shard`` cuts a rank's shard out of a
logical tensor without a collective (the checkpoint's elastic restore and
the data pipeline's per-rank batches).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple, Union

import torch

from repro_torch.train.optim import AdamWState, tree_map

__all__ = [
    "P",
    "MeshRules",
    "rules_for_mesh",
    "placements",
    "is_sharding",
    "local_shard",
    "lm_param_specs",
    "lm_batch_specs",
    "lm_cache_specs",
    "state_specs",
    "replicated_specs",
    "gnn_batch_specs",
    "din_param_specs",
    "din_batch_specs",
    "din_retrieval_specs",
]

Axis = Union[str, Tuple[str, ...], None]


class P(tuple):
    """A partition spec: one entry per tensor dim, each a mesh axis name, a
    tuple of names (sharded over their product, major first) or None
    (replicated). A one-name tuple is that name and an empty one None, as
    ``PartitionSpec`` normalises them. A leaf of
    ``train.optim.tree_flatten``, as the reference's ``PartitionSpec`` is of
    ``jax.tree``."""

    def __new__(cls, *dims: Axis):
        def norm(d):
            if isinstance(d, tuple):
                return None if not d else d[0] if len(d) == 1 else d
            return d

        return super().__new__(cls, tuple(norm(d) for d in dims))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Axis roles of one mesh. ``fsdp``/``tp`` are spec-ready (str, tuple of
    strs, or None)."""

    axis_sizes: Tuple[Tuple[str, int], ...]  # mesh axes in order
    fsdp: Axis  # batch + parameter-shard axes ('pod','data')
    tp: Axis  # tensor-parallel axis ('model')

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axis_sizes)

    def size(self, axis: Axis) -> int:
        """Total device count across ``axis`` (1 for None)."""
        if axis is None:
            return 1
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        sizes = dict(self.axis_sizes)
        return math.prod(sizes[n] for n in names)

    def axis_if(self, axis: Axis, dim: int) -> Axis:
        """``axis`` when ``dim`` shards evenly over it, else None (replicate).
        A 1-sized axis still counts (it divides everything)."""
        if axis is None:
            return None
        n = self.size(axis)
        return axis if n > 0 and dim % n == 0 else None


def _axis_sizes(mesh) -> Tuple[Tuple[str, int], ...]:
    if hasattr(mesh, "mesh_dim_names"):  # a DeviceMesh: shape is a tuple of sizes
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh has no mesh_dim_names")
        return tuple(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return tuple((n, int(mesh.shape[n])) for n in mesh.axis_names)


def rules_for_mesh(mesh) -> MeshRules:
    sizes = _axis_sizes(mesh)
    names = tuple(n for n, _ in sizes)
    tp: Axis = "model" if "model" in names else None
    data_axes = tuple(n for n in names if n != "model")
    fsdp: Axis
    if len(data_axes) == 0:
        fsdp = None
    elif len(data_axes) == 1:
        fsdp = data_axes[0]
    else:
        fsdp = data_axes  # ('pod', 'data'): pod is data-parallel only
    return MeshRules(axis_sizes=sizes, fsdp=fsdp, tp=tp)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): mesh
    dim i is ``Shard(d)`` when tensor dim d names it, else ``Replicate()``.
    A tuple of names shards one tensor dim over each of them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = []
    for name in names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    known = set(names)
    for ax in spec:
        for n in (ax,) if isinstance(ax, str) else (ax or ()):
            if n not in known:
                raise ValueError(f"spec {spec} names axis {n!r}, not in mesh {names}")
    return tuple(out)


def is_sharding(x) -> bool:
    """A ``(DeviceMesh, placements)`` pair: a leaf of a shardings tree."""
    return isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "mesh_dim_names")


def local_shard(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's shard of the logical tensor ``full`` under ``place`` on
    ``mesh`` (``DTensor``'s split: ``torch.chunk`` along each sharded dim,
    empty past the last chunk), as a ``DTensor`` on the mesh's device. Reads
    nothing from other ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    local = full
    for mdim, pl in enumerate(place):
        if isinstance(pl, Shard):
            pieces = torch.chunk(local, mesh.size(mdim), dim=pl.dim)
            k = coord[mdim]
            local = pieces[k] if k < len(pieces) else local.narrow(pl.dim, 0, 0)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} is not Shard or Replicate")
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    return DTensor.from_local(local.contiguous().to(dev), mesh, tuple(place), run_check=False,
                              shape=full.shape, stride=full.stride())


def _shape_tree(build):
    """``build()``'s tensor tree with its shapes only: run under
    ``FakeTensorMode``, so no parameter is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return build()


def _map_named(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a nested dict/list tree, ``name`` the nearest
    dict key above the leaf (the reference's ``_leaf_name`` of its path)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def _lm_leaf_spec(r: MeshRules, name: str, shape: Tuple[int, ...]) -> P:
    """One LM parameter leaf -> spec. Layer-stacked leaves carry a leading L
    dim (always replicated); matmul weights shard tp on the 'wide' dim
    (heads / d_ff / experts / vocab) and fsdp on d_model."""
    if name == "embed":  # (V, d)
        return P(r.axis_if(r.tp, shape[0]), r.axis_if(r.fsdp, shape[1]))
    if name == "unembed":  # (d, V)
        return P(r.axis_if(r.fsdp, shape[0]), r.axis_if(r.tp, shape[1]))
    if name in ("wq", "wk", "wv"):  # (L, d, H*hd)
        return P(None, r.axis_if(r.fsdp, shape[1]), r.axis_if(r.tp, shape[2]))
    if name == "wo":  # (L, H*hd, d)
        return P(None, r.axis_if(r.tp, shape[1]), r.axis_if(r.fsdp, shape[2]))
    if name == "router":  # (L, d, E)
        return P(None, None, r.axis_if(r.tp, shape[2]))
    if name in ("w1", "w3"):
        if len(shape) == 4:  # MoE (L, E, d, f): experts over tp, d over fsdp
            return P(None, r.axis_if(r.tp, shape[1]), r.axis_if(r.fsdp, shape[2]), None)
        return P(None, r.axis_if(r.fsdp, shape[1]), r.axis_if(r.tp, shape[2]))
    if name == "w2":
        if len(shape) == 4:  # MoE (L, E, f, d)
            return P(None, r.axis_if(r.tp, shape[1]), None, r.axis_if(r.fsdp, shape[3]))
        return P(None, r.axis_if(r.tp, shape[1]), r.axis_if(r.fsdp, shape[2]))
    # norms / scales / anything small: replicate
    return P(*([None] * len(shape)))


def lm_param_specs(r: MeshRules, cfg) -> Any:
    """Spec tree matching ``transformer.init_params(cfg, ...)``."""
    from repro_torch.models.transformer import init_params

    struct = _shape_tree(lambda: init_params(cfg, torch.Generator(), "cpu"))
    return _map_named(lambda name, leaf: _lm_leaf_spec(r, name, tuple(leaf.shape)), struct)


def lm_batch_specs(r: MeshRules, batch: int) -> dict:
    b = r.axis_if(r.fsdp, batch)
    return {"tokens": P(b, None), "labels": P(b, None)}


def lm_cache_specs(r: MeshRules, cfg, batch: int, max_len: int) -> dict:
    """KV cache (L, B, Hkv, S, hd): batch over fsdp, SEQUENCE over tp (the
    kv-head count rarely divides a 16-way model axis; sequence always can be
    padded to)."""
    b = r.axis_if(r.fsdp, batch)
    s = r.axis_if(r.tp, max_len)
    spec = P(None, b, None, s, None)
    return {"k": spec, "v": spec}


# ---------------------------------------------------------------------------
# generic state / replicated helpers
# ---------------------------------------------------------------------------


def state_specs(param_specs) -> dict:
    """Extend parameter specs to the full train state: Adam moments mirror
    the parameter layout leaf for leaf, the step counter is replicated."""
    return {
        "params": param_specs,
        "opt": AdamWState(step=P(), mu=param_specs, nu=param_specs),
    }


def replicated_specs(struct) -> Any:
    """Fully replicated spec tree matching ``struct`` (GNN params are small)."""
    return tree_map(lambda _: P(), struct)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def gnn_batch_specs(r: MeshRules, n_nodes: int, n_edges: int, n_graphs: int):
    """GraphBatch specs: nodes and edges shard over the WHOLE mesh when
    divisible (graph tensors dwarf the replicated params)."""
    from repro_torch.models.gnn.common import GraphBatch

    an = r.axis_if(r.all_axes, n_nodes)
    ae = r.axis_if(r.all_axes, n_edges)
    return GraphBatch(
        node_feat=P(an, None),
        edge_src=P(ae),
        edge_dst=P(ae),
        node_mask=P(an),
        edge_mask=P(ae),
        graph_id=P(an),
        n_graphs=n_graphs,
        edge_feat=None,
        edge_dist=P(ae),
    )


# ---------------------------------------------------------------------------
# RecSys (DIN)
# ---------------------------------------------------------------------------


def din_param_specs(r: MeshRules, cfg) -> Any:
    """DIN params: the (huge) item table is row-sharded, over tp for the
    'take'/'crossbar' lookups, over the WHOLE mesh for 'crossbar_full'. The
    cate table and MLPs are small and replicate."""
    from repro_torch.models.recsys.din import init

    struct = _shape_tree(lambda: init(cfg, torch.Generator(), "cpu"))
    rows_axis = r.all_axes if cfg.lookup == "crossbar_full" else r.tp

    def spec(name, leaf):
        if name == "item_table":
            return P(r.axis_if(rows_axis, leaf.shape[0]), None)
        return P(*([None] * len(leaf.shape)))

    return _map_named(spec, struct)


def din_batch_specs(r: MeshRules, batch: int) -> dict:
    b = r.axis_if(r.all_axes, batch) or r.axis_if(r.fsdp, batch)
    return {
        "hist_items": P(b, None),
        "hist_cates": P(b, None),
        "target_item": P(b),
        "target_cate": P(b),
        "profile_bag": P(b, None),
        "labels": P(b),
    }


def din_retrieval_specs(r: MeshRules, n_candidates: int) -> dict:
    c = r.axis_if(r.all_axes, n_candidates)
    return {
        "hist_items": P(None, None),
        "hist_cates": P(None, None),
        "profile_bag": P(None, None),
        "cand_items": P(c),
        "cand_cates": P(c),
    }
