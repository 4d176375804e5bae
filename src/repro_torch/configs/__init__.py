"""Architecture registry: one module per architecture this package builds.

Every config cites its source in brackets. ``get_config(name)`` returns the
full production config; ``get_config(name).reduced()`` is the smoke-test
variant (≤2 superblocks, d_model≤256). ``ARCH_IDS`` lists only the
architectures whose blocks the port has; ROADMAP.md lists the others.
"""

from importlib import import_module

from .base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

ARCH_IDS = ("olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b")


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG
