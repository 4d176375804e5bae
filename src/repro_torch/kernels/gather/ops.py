"""Row gather: the ``cuda`` tier of the engine's ``gather_join`` dispatch op
(core/kernels.py), over the hand-written kernel in ``csrc/gather.cu``.

``gather_rows(table, rows)`` launches the kernel for CUDA tensors and takes
the plain version (ref.py) for CPU tensors. Ids outside ``[0, N)`` give zero
rows, written by the kernel itself; an empty ``rows`` returns ``(0, D)``
without a launch. It is a ``torch.autograd.Function`` whose backward stays
in the same tier: the cotangent of ``table`` is the scatter-add of ``g`` by
``rows``, i.e. the segment-sum kernel on the card.
"""

from __future__ import annotations

import torch

from ..common import launch, on_cpu, require
from .ref import gather_rows_ref


def _launch(table: torch.Tensor, rows: torch.Tensor, out: torch.Tensor) -> None:
    launch(
        "gather_rows", "repro_gather_f32", table.device,
        table.data_ptr(), rows.data_ptr(), out.data_ptr(),
        rows.shape[0], table.shape[0], table.shape[1],
    )
    gather_rows.launches += 1


def gather_rows_forward(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The forward alone (no autograd record)."""
    if on_cpu(table, rows):
        return gather_rows_ref(table, rows)
    require("gather_rows", table, torch.float32, 2, "table")
    require("gather_rows", rows, torch.int32, 1, "rows")
    out = torch.empty((rows.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if rows.shape[0] and table.shape[1]:
        _launch(table, rows, out)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.num_rows = table.shape[0]
        return gather_rows_forward(table, rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        from ..segsum.ops import segment_sum

        return segment_sum(g.contiguous(), rows, ctx.num_rows), None


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (N, D) f32 at ``rows`` (E,) int32; ids outside
    ``[0, N)`` give zero rows. Differentiable with respect to ``table``."""
    return _GatherRows.apply(table, rows)


#: launches of the CUDA kernel since the count was last set to 0.
gather_rows.launches = 0
