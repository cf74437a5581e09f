"""--arch <id> registry of the port: the archs it has (the six GNNs and
``din``; the LM archs come with the LM slice)."""
from repro_torch.configs import din, gat_cora, gcn_cora, gin_tu, graphsage, meshgraphnet, schnet

ARCHS = {
    m.ARCH.arch_id: m.ARCH
    for m in (meshgraphnet, schnet, gat_cora, gin_tu, din, gcn_cora, graphsage)
}


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
