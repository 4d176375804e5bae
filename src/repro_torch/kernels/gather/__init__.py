"""Row-gather kernel package: the CUDA kernel's wrapper (ops.py) and its
plain version (ref.py)."""

from .ops import gather_rows
from .ref import gather_rows_ref

__all__ = ["gather_rows", "gather_rows_ref"]
