"""Blocked-matmul kernel package: the CUDA kernel's wrapper (ops.py) and its
plain version (ref.py)."""

from .ops import blocked_matmul
from .ref import matmul_ref

__all__ = ["blocked_matmul", "matmul_ref"]
