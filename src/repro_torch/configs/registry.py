"""--arch <id> registry of the port: the five LM archs, the six GNNs and
``din``, as ``repro.configs.registry`` has them."""
from repro_torch.configs import (
    din,
    gat_cora,
    gcn_cora,
    gin_tu,
    granite_moe_1b_a400m,
    graphsage,
    llama3_8b,
    meshgraphnet,
    qwen3_14b,
    qwen3_moe_30b_a3b,
    schnet,
    smollm_135m,
)

ARCHS = {
    m.ARCH.arch_id: m.ARCH
    for m in (qwen3_14b, smollm_135m, llama3_8b, granite_moe_1b_a400m, qwen3_moe_30b_a3b,
              meshgraphnet, schnet, gat_cora, gin_tu, din, gcn_cora, graphsage)
}


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
