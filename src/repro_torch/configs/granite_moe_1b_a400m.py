"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
Counterpart of ``repro.configs.granite_moe_1b_a400m``, value for value."""
import torch

from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer import LMConfig


def _smoke():
    return LMConfig(
        name="granite-moe-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        head_dim=12, d_ff=64, vocab=255, dtype=torch.float32, attn_chunk=32,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32),
    )


ARCH = ArchConfig(
    arch_id="granite-moe-1b-a400m",
    family="lm",
    model=LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, head_dim=64, d_ff=512,
        # the true vocab 49155 padded to a 128-multiple as the reference
        # does; the loss masks columns >= vocab_real
        vocab=49280, vocab_real=49155,
        rope_theta=10_000.0, dtype=torch.bfloat16, attn_chunk=512,
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512),
    ),
    shapes=LM_SHAPES,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    smoke=_smoke,
)
