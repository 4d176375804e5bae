from .ckpt import restore_checkpoint, save_checkpoint  # noqa: F401
