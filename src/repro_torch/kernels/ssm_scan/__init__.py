"""Selective-scan kernel package: the CUDA kernel's wrapper (ops.py) and its
plain version (ref.py)."""

from .ops import ssm_scan
from .ref import ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_ref"]
