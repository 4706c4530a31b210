from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint  # noqa: F401
