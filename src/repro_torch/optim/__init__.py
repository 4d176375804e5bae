from .adam import adam_init, adam_update  # noqa: F401
from .sgd import sgd_init, sgd_update  # noqa: F401
