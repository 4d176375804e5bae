"""repro_torch: auto-differentiation of relational computations (ICML 2023),
ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module and imports nothing of it. The front door is the
**Database session**::

    import repro_torch

    db = repro_torch.Database()              # runs on "cuda"
    db.put("Rx", X, keys=("row", "col"))
    db.put("theta", theta, keys=("col",))
    loss, grads = db.sql(LOGREG_SQL, wrt=("theta",)).step()

The hot operators run on hand-written CUDA kernels (``repro_torch.kernels``),
built from source at first use. Exports resolve lazily, so importing the
package touches no device and builds nothing.
"""

_LAZY = {
    "Database": ("repro_torch.core.session", "Database"),
    "QueryHandle": ("repro_torch.core.session", "QueryHandle"),
    "CatalogError": ("repro_torch.core.session", "CatalogError"),
    "current": ("repro_torch.core.session", "current"),
    "DenseRelation": ("repro_torch.core.relation", "DenseRelation"),
    "CooRelation": ("repro_torch.core.relation", "CooRelation"),
    "RelationStats": ("repro_torch.core.planner", "RelationStats"),
    "SQLError": ("repro_torch.core.sql", "SQLError"),
    "Diagnostic": ("repro_torch.analysis.diagnostics", "Diagnostic"),
    "CheckReport": ("repro_torch.analysis.diagnostics", "CheckReport"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
