"""Selective scan ``h_t = a_t ⊙ h_{t-1} + b_t`` over the hand-written kernel
in ``csrc/ssm_scan.cu``.

Unlike segment_sum, gather and matmul it is not a dispatch op of the
compiler: the model layer (``models/ssm.py``) calls it directly when
``ModelConfig.ssm_pallas`` is set, as the reference does. ``ssm_scan(a, b)``
launches the kernel for CUDA tensors and takes the plain version (ref.py)
for CPU tensors. The reference's TPU tile arguments ``bt`` and ``bc`` are
gone: one thread owns one lane, so any shape runs and nothing falls back.

It is a ``torch.autograd.Function`` whose backward is the reference's VJP,
run on the same kernel walking time backwards::

    ĝ_t = ĥ_t + a_{t+1} ⊙ ĝ_{t+1}      (reverse scan, a_S = 0)
    ∂b_t = ĝ_t,   ∂a_t = ĝ_t ⊙ h_{t-1}   (h_{-1} = 0)
"""

from __future__ import annotations

import torch

from ..common import launch, on_cpu
from .ref import ssm_scan_ref

#: the element types the kernel reads and writes (its state is f32 always)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for what, t in (("a", a), ("b", b)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"ssm_scan: {what} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"ssm_scan: {what} must be (B, S, C, N), got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {what} must be contiguous")
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        raise ValueError(
            f"ssm_scan: a {a.dtype} {tuple(a.shape)} on {a.device} and "
            f"b {b.dtype} {tuple(b.shape)} on {b.device} differ"
        )


def ssm_scan_forward(a: torch.Tensor, b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The scan alone (no autograd record); ``reverse`` walks from the last
    step to the first."""
    if on_cpu(a, b):
        return ssm_scan_ref(a, b, reverse)
    _check(a, b)
    h = torch.empty_like(a)
    bsz, s, c, n = a.shape
    if h.numel():
        launch(
            "ssm_scan", "repro_ssm_scan", a,
            a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, c * n,
            DTYPE_CODES[a.dtype], int(reverse),
        )
        ssm_scan.launches += 1
    return h


class _SsmScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = ssm_scan_forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, hbar):
        a, h = ctx.saved_tensors
        # the decay shifted one step left: a_{t+1}, zero at the end
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = ssm_scan_forward(a_next, hbar.to(a.dtype).contiguous(), reverse=True)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return (g * h_prev).to(a.dtype), g


def ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Selective scan ``h_t = a_t ⊙ h_{t-1} + b_t`` over axis 1 of ``a``, ``b``
    (B, S, C, N), both f32 or both bf16; the state is f32 and ``h`` comes back
    in the inputs' dtype. Differentiable with respect to both."""
    return _SsmScan.apply(a, b)


#: launches of the CUDA kernel since the count was last set to 0.
ssm_scan.launches = 0
