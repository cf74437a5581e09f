"""Config schema for the architectures.

Counterpart of ``repro.configs.base`` (the schema and the recsys shapes;
the LM and GNN shapes come with those models). Every arch module exposes
``ARCH: ArchConfig`` registered in ``configs.registry``; ``smoke()`` returns
a CPU-sized reduction of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["ShapeCell", "ArchConfig", "RECSYS_SHAPES"]


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
    model: Any  # DINConfig (the port's only family so far)
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
