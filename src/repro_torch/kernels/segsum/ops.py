"""Segment sum: the ``cuda`` tier of the engine's ``segment_sum`` dispatch op
(core/kernels.py), over the hand-written kernel in ``csrc/segsum.cu``.

``segment_sum(msg, seg, num_segments)`` launches the kernel for CUDA tensors
and takes the plain version (ref.py) for CPU tensors. It is a
``torch.autograd.Function`` whose backward stays in the same tier: the
cotangent of ``msg`` is the gather ``g[seg]`` (zero rows for invalid ids),
i.e. the gather kernel on the card.
"""

from __future__ import annotations

import torch

from ..common import launch, on_cpu, require
from .ref import segment_sum_ref


def _launch(msg: torch.Tensor, seg: torch.Tensor, out: torch.Tensor) -> None:
    launch(
        "segment_sum", "repro_segsum_f32", msg.device,
        msg.data_ptr(), seg.data_ptr(), out.data_ptr(),
        msg.shape[0], msg.shape[1], out.shape[0],
    )
    segment_sum.launches += 1


def segment_sum_forward(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The forward alone (no autograd record)."""
    if on_cpu(msg, seg):
        return segment_sum_ref(msg, seg, num_segments)
    require("segment_sum", msg, torch.float32, 2, "msg")
    require("segment_sum", seg, torch.int32, 1, "seg")
    if seg.shape[0] != msg.shape[0]:
        raise ValueError(f"segment_sum: seg {tuple(seg.shape)} does not match msg {tuple(msg.shape)}")
    if num_segments < 0:
        raise ValueError(f"segment_sum: num_segments={num_segments} < 0")
    out = torch.zeros((num_segments, msg.shape[1]), dtype=msg.dtype, device=msg.device)
    if msg.shape[0] and msg.shape[1] and num_segments:
        _launch(msg, seg, out)
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, seg, num_segments):
        ctx.save_for_backward(seg)
        return segment_sum_forward(msg, seg, num_segments)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        from ..gather.ops import gather_rows

        return gather_rows(g.contiguous(), seg), None, None


def segment_sum(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum the rows of ``msg`` (E, D) f32 into ``num_segments`` rows by
    ``seg`` (E,) int32; ids outside ``[0, num_segments)`` are dropped.
    Differentiable with respect to ``msg``."""
    return _SegmentSum.apply(msg, seg, int(num_segments))


#: launches of the CUDA kernel since the count was last set to 0.
segment_sum.launches = 0
