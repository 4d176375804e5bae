"""Segment-sum kernel package: the CUDA kernel's wrapper (ops.py) and its
plain version (ref.py)."""

from .ops import segment_sum
from .ref import segment_sum_ref

__all__ = ["segment_sum", "segment_sum_ref"]
