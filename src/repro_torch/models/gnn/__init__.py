from repro_torch.models.gnn import common  # noqa: F401
