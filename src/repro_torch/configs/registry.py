"""--arch <id> registry of the port: the archs it has (``din``)."""
from repro_torch.configs import din

ARCHS = {m.ARCH.arch_id: m.ARCH for m in (din,)}


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
