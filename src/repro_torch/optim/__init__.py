from .adam import adam_init, adam_update  # noqa: F401
