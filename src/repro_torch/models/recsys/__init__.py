from repro_torch.models.recsys import din  # noqa: F401
