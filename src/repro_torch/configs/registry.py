"""--arch <id> registry of the port: the ten ASSIGNED architectures + extra
pool archs, as ``repro.configs.registry`` has them."""
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

ASSIGNED = (
    qwen3_14b, smollm_135m, llama3_8b, granite_moe_1b_a400m,
    qwen3_moe_30b_a3b, meshgraphnet, schnet, gat_cora, gin_tu, din,
)
EXTRA = (gcn_cora, graphsage)

ARCHS = {m.ARCH.arch_id: m.ARCH for m in ASSIGNED + EXTRA}
ASSIGNED_IDS = tuple(m.ARCH.arch_id for m in ASSIGNED)


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
