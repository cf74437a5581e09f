"""qwen3-moe-30b-a3b [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf]. Counterpart of
``repro.configs.qwen3_moe_30b_a3b``, value for value."""
import torch

from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer import LMConfig


def _smoke():
    return LMConfig(
        name="qwen3-moe-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        head_dim=12, d_ff=64, vocab=255, qk_norm=True, dtype=torch.float32,
        attn_chunk=32, moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32),
    )


ARCH = ArchConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="lm",
    model=LMConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936, qk_norm=True,
        rope_theta=1_000_000.0, dtype=torch.bfloat16, attn_chunk=512,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    ),
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    smoke=_smoke,
)
