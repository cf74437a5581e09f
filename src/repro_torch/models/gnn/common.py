"""MLP helpers shared by the models.

Counterpart of ``init_mlp`` and ``mlp`` in ``repro.models.gnn.common``,
which DIN imports. The rest of that module (``GraphBatch``, ``aggregate``,
the segment softmax) and ``mlp``'s options (its activation, a final
activation, layer norm) come with the GNN models, which set them; DIN uses
the defaults.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["init_mlp", "mlp"]


def init_mlp(generator: torch.Generator, sizes, dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Weights ~ N(0, 1/fan_in), zero biases, drawn on the generator's device
    and moved to ``device``."""
    dev = device if device is not None else generator.device
    ws = [
        (torch.randn(a, b, generator=generator, device=generator.device) * a ** -0.5)
        .to(dtype=dtype, device=dev)
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    return {"w": ws, "b": [torch.zeros(b, dtype=dtype, device=dev) for b in sizes[1:]]}


def mlp(p, x):
    """ReLU between the layers, none after the last."""
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < n - 1:
            x = torch.relu(x)
    return x
