"""Device selection shared by the port's entry points.

Entry points default to the card. They run on the CPU only when the caller
asks for it (the tests pass ``device="cpu"``); a CUDA request on a machine
without a GPU raises instead of silently running elsewhere.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
