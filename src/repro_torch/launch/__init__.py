"""Mesh construction, the collective layer and the sharding rules of the
port on several ranks (``launch/mesh.py``, ``launch/collectives.py``,
``launch/sharding.py``), and the dry run with its roofline terms on the
H100's published figures (``launch/dryrun.py``, ``launch/roofline.py``).
Names resolve lazily, so importing the package initialises nothing."""

_LAZY = {
    "make_host_mesh": "mesh", "make_production_mesh": "mesh", "resolve_mesh": "mesh",
    "start_ranks": "mesh", "init_ranks": "mesh",
    "MeshComm": "collectives", "ShapeComm": "collectives", "last_collectives": "collectives",
    "reset_collectives": "collectives",
    "active_params": "roofline", "model_flops": "roofline",
    "dryrun_one": "dryrun",
    "DP": "sharding", "P": "sharding", "Placement": "sharding", "batch_pspecs": "sharding",
    "cache_pspecs": "sharding", "catalog_shardings": "sharding", "coo_pspecs": "sharding",
    "hint": "sharding", "param_pspec": "sharding", "param_pspecs": "sharding",
    "to_shardings": "sharding",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
