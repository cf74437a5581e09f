from repro_torch.data import rmat, synthetic  # noqa: F401
from repro_torch.data.rmat import RMATStream, materialize, rmat_chunks  # noqa: F401
