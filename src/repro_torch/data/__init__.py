from .graphs import synthetic_graph  # noqa: F401
from .pipeline import batch_for, synthetic_lm_batches  # noqa: F401
