"""Plain PyTorch version of the blocked-matmul kernel."""

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ y`` computed in f32, returned in ``out_dtype`` (default:
    ``x``'s dtype)."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.to(torch.float32), y.to(torch.float32)).to(out_dtype)
