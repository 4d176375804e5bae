from .graphs import synthetic_graph  # noqa: F401
