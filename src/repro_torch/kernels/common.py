"""What every kernel wrapper shares: where a tensor sends a call, the checks
before a launch, and the launch itself on PyTorch's current stream."""

from __future__ import annotations

import torch

from . import build


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the call takes the plain version: every tensor lies on the
    CPU. A CUDA tensor launches the kernel; any other device raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(
        f"kernel inputs must all lie on the CPU or all on one CUDA device; got {sorted(kinds)}"
    )


def require(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str) -> None:
    """Raise unless ``t`` is what the kernel takes: ``dtype``, ``ndim`` dims,
    contiguous, on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {what} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point of the kernel library on ``device``'s current
    stream and raise if it reports a CUDA error."""
    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn_name)(*args, stream)
    build.check(code, name)
