"""The run's own checks on where it ran and what it loaded.

A module counts by its top-level name, the part before the first dot,
compared whole: ``repro_torch`` (the program) is not ``repro`` (the JAX
package it was ported from)."""

from __future__ import annotations

from typing import Iterable, List

#: top-level names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the device the benchmark measures
DEVICE = "NVIDIA H100"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The loaded modules among ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def device_problem(chips: int) -> str:
    """Why this process may not measure a cell of ``chips`` cards ('' where
    it may): no CUDA, too few cards, or cards other than H100s."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark measures only on the GPU"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards and {torch.cuda.device_count()} are visible"
    names = {torch.cuda.get_device_name(i) for i in range(chips)}
    if any(not n.startswith(DEVICE) for n in names):
        return f"the cards are {sorted(names)}, not {DEVICE}"
    return ""
