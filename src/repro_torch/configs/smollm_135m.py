"""smollm-135m [dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]. Counterpart of
``repro.configs.smollm_135m``, value for value."""
import torch

from repro_torch.configs.base import ArchConfig, LM_SHAPES
from repro_torch.models.transformer import LMConfig


def _smoke():
    return LMConfig(
        name="smollm-135m-smoke", n_layers=2, d_model=48, n_heads=3, n_kv_heads=3,
        head_dim=16, d_ff=128, vocab=256, dtype=torch.float32, attn_chunk=32,
    )


ARCH = ArchConfig(
    arch_id="smollm-135m",
    family="lm",
    model=LMConfig(
        name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        head_dim=64, d_ff=1536, vocab=49152, rope_theta=10_000.0,
        dtype=torch.bfloat16, attn_chunk=512,
    ),
    shapes=LM_SHAPES,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
    smoke=_smoke,
)
