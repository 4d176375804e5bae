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

``plan`` mirrors the launch ``repro_ssm_scan`` makes, and ``CONTRACT``
(core/kernels.py's vocabulary) models it for the static certifier
(analysis/kernelcheck.py) and the card's launch record.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ...core.kernels import AccumModel, BlockModel, GridModel, KernelContract
from ..common import launch, on_cpu
from .ref import ssm_scan_ref

#: the element types the kernel reads and writes (its state is f32 always)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads per block (kThreads): one lane each
THREADS = 128
#: CUDA's limit on gridDim.x
GRID_X_MAX = 2**31 - 1


@dataclass(frozen=True)
class Plan:
    """What ``repro_ssm_scan`` launches for (B, S, L) lanes of a scan."""

    lanes: int     #: B·L: one thread walks one lane's S steps
    blocks: int    #: ceil(B·L / THREADS), the grid


def plan(batch: int, seq: int, lanes: int) -> Plan:
    """The launch for a (batch, seq, lanes) scan (lanes = C·N), as
    ``repro_ssm_scan`` makes it; a degenerate extent launches nothing
    (blocks 0)."""
    if min(batch, seq, lanes) <= 0:
        return Plan(0, 0)
    total = batch * lanes
    blocks = -(-total // THREADS)
    if blocks > GRID_X_MAX:
        raise ValueError(f"ssm_scan: {total} lanes need {blocks} blocks, beyond {GRID_X_MAX}")
    return Plan(total, blocks)


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


# -- contract ----------------------------------------------------------------


def _grid_model(info: Dict[str, Any], **concrete: Any) -> Optional[GridModel]:
    """``plan``'s launch: a block of THREADS lanes of the (B·L, S) lane ×
    time view of a, b and h (lane g = b·L + l; step t at (b·S + t)·L + l),
    its loop over time the innermost grid axis; the f32 state starts at 0
    and every step stores its h_t (``store="every"``). ``reverse`` walks t
    from S − 1 down to 0."""
    bsz, s = int(info["batch"]), int(info["seq"])
    lanes = int(info["channels"]) * int(info["state"])
    p = plan(bsz, s, lanes)
    if p.blocks == 0:
        return None  # repro_ssm_scan returns before the launch
    rev = bool(info.get("reverse", False))

    def step(i, t):
        return (i, s - 1 - t if rev else t)

    shape, block = (p.lanes, s), (THREADS, 1)
    return GridModel(
        grid=(p.blocks, s),
        inputs=(BlockModel("a", shape, block, step), BlockModel("b", shape, block, step)),
        output=BlockModel("h", shape, block, step),
        accumulator=AccumModel(axis=1, init_at=0, store="every"),
        kernel=f"ssm_scan.{int(rev)}", block=(THREADS, 1, 1), loops=1,
    )


#: the statically checkable contract of this package. ssm_scan is not a
#: dispatch op — the models layer calls it directly — so the contract has
#: no registry entries, only the launch model.
CONTRACT = KernelContract(
    op="ssm_scan",
    dtypes="floating",
    accum_dtype="float32",
    masking=(
        "no tile has to divide anything: a thread per lane, and the "
        "threads of the last block past B·L return at once",
        "B, S or L = 0 returns before the launch",
    ),
    vjp="the same kernel walking time backwards (autograd.Function)",
    vjp_pairs=(),
    grid_model=_grid_model,
)
