"""Config schema for the architectures.

Counterpart of ``repro.configs.base`` (the schema, the GNN and the recsys
shapes; the LM shapes come with the LM models). Every arch module exposes
``ARCH: ArchConfig`` registered in ``configs.registry``; ``smoke()`` returns
a CPU-sized reduction of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["ShapeCell", "ArchConfig", "GNN_SHAPES", "RECSYS_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | gnn_full | gnn_minibatch | gnn_molecule | serve | serve_train | retrieval
    dims: Dict[str, int]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # 'lm' | 'gnn' | 'recsys'
    model: Any  # GNNConfig | DINConfig
    shapes: Tuple[ShapeCell, ...]
    source: str  # public provenance tag
    # family-specific extras
    gnn_task: str = "node_class"  # gnn: default task kind
    gnn_out_dim: int = 8
    smoke: Optional[Callable[[], Any]] = None  # reduced model cfg for CPU

    def shape(self, name: str) -> ShapeCell:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}: {[s.name for s in self.shapes]}")


# GNN shapes: node/edge counts padded to multiples of 512 (mesh divisibility);
# originals in notes. Features/classes per standard datasets.
GNN_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell(
        "full_graph_sm",
        "gnn_full",
        dict(n_nodes=4096, n_edges=16384, d_feat=1433, n_classes=7),
        note="cora 2708/10556 padded to 4096/16384",
    ),
    ShapeCell(
        "minibatch_lg",
        "gnn_minibatch",
        dict(
            batch_nodes=1024, fanout1=15, fanout2=10,
            n_nodes=169984, n_edges=168960,  # sampler max_nodes/max_edges
            d_feat=602, n_classes=41,
        ),
        note="reddit-scale (233k nodes / 115M edges) via fanout-15,10 sampler",
    ),
    ShapeCell(
        "ogb_products",
        "gnn_full",
        dict(n_nodes=2449408, n_edges=61859328, d_feat=100, n_classes=47),
        note="ogbn-products 2,449,029/61,859,140 padded to x512 multiples",
    ),
    ShapeCell(
        "molecule",
        "gnn_molecule",
        dict(n_graphs=128, nodes_per=32, edges_per=64, d_feat=16, n_classes=2),
        note="30 nodes padded to 32 for lane alignment; batch=128 graphs",
    ),
)

RECSYS_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_batch", "serve_train", dict(batch=65536)),
    ShapeCell("serve_p99", "serve", dict(batch=512)),
    ShapeCell("serve_bulk", "serve", dict(batch=262144)),
    ShapeCell(
        "retrieval_cand",
        "retrieval",
        dict(batch=1, n_candidates=1048576),
        note="1,000,000 padded to 2^20 for mesh divisibility",
    ),
)
