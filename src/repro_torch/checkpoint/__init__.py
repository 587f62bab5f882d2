from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
