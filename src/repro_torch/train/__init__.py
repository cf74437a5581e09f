from repro_torch.train import losses, optim, steps  # noqa: F401
