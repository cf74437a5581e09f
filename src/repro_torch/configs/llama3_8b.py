"""llama3-8b [dense] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
— GQA 128k vocab [arXiv:2407.21783; unverified]. Counterpart of
``repro.configs.llama3_8b``, value for value."""
import torch

from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.transformer import LMConfig


def _smoke():
    return LMConfig(
        name="llama3-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab=256, dtype=torch.float32, attn_chunk=32,
    )


ARCH = ArchConfig(
    arch_id="llama3-8b",
    family="lm",
    model=LMConfig(
        name="llama3-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=14336, vocab=128256, rope_theta=500_000.0,
        dtype=torch.bfloat16, attn_chunk=512,
    ),
    shapes=LM_SHAPES,
    source="arXiv:2407.21783; unverified",
    smoke=_smoke,
)
