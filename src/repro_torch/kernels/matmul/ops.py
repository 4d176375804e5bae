"""Blocked matmul: the ``cuda`` tier of the engine's ``blocked_matmul``
dispatch op (core/kernels.py), over the hand-written kernel in
``csrc/matmul.cu``.

``blocked_matmul(x, y)`` launches the kernel for CUDA tensors and takes the
plain version (ref.py) for CPU tensors; ragged shapes are masked inside the
kernel, so no operand is padded. It is a ``torch.autograd.Function`` whose
backward stays in the same tier, as the paper's Fig. 4 RJP kernels:
``dX = g @ Yᵀ`` and ``dY = Xᵀ @ g`` are two more launches.
"""

from __future__ import annotations

import torch

from ..common import launch, on_cpu, require
from .ref import matmul_ref


def _launch(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> None:
    m, k = x.shape
    n = y.shape[1]
    launch(
        "blocked_matmul", "repro_matmul_f32", x.device,
        x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
    )
    blocked_matmul.launches += 1


def blocked_matmul_forward(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The forward alone (no autograd record)."""
    if on_cpu(x, y):
        return matmul_ref(x, y)
    require("blocked_matmul", x, torch.float32, 2, "x")
    require("blocked_matmul", y, torch.float32, 2, "y")
    m, k = x.shape
    if y.shape[0] != k:
        raise ValueError(f"blocked_matmul: shapes {tuple(x.shape)} @ {tuple(y.shape)} do not chain")
    n = y.shape[1]
    if max(m, n, k) >= 2**31:
        raise ValueError(f"blocked_matmul: extents {(m, n, k)} exceed the kernel's int32 range")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        _launch(x, y, out)
    return out


class _BlockedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return blocked_matmul_forward(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = blocked_matmul_forward(g, y.t().contiguous())
        if ctx.needs_input_grad[1]:
            dy = blocked_matmul_forward(x.t().contiguous(), g)
        return dx, dy


def blocked_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` for ``x`` (M, K) and ``y`` (K, N) f32, summed in f32.
    Differentiable with respect to both operands."""
    return _BlockedMatmul.apply(x, y)


#: launches of the CUDA kernel since the count was last set to 0.
blocked_matmul.launches = 0
