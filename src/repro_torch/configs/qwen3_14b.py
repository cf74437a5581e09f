"""qwen3-14b [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]. Counterpart of
``repro.configs.qwen3_14b``, value for value."""
import torch

from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.transformer import LMConfig


def _smoke():
    return LMConfig(
        name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, qk_norm=True, dtype=torch.float32,
        attn_chunk=32,
    )


ARCH = ArchConfig(
    arch_id="qwen3-14b",
    family="lm",
    model=LMConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=17408, vocab=151936, qk_norm=True,
        rope_theta=1_000_000.0, dtype=torch.bfloat16,
        # the reference's small KV chunk (its scores stay head-replicated on
        # a 16-way model axis); here the backward's chunk
        attn_chunk=256,
    ),
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen3-8B; hf",
    smoke=_smoke,
)
