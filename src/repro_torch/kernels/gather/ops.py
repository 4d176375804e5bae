"""Row gather: the ``cuda`` tier of the engine's ``gather_join`` dispatch op
(core/kernels.py), over the hand-written kernel in ``csrc/gather.cu``.

``gather_rows(table, rows)`` launches the kernel for CUDA tensors and takes
the plain version (ref.py) for CPU tensors. ``table`` is f32, bf16 or f16:
the copy moves bits, so the result equals the plain version exactly. Ids
outside ``[0, N)`` give zero rows, written by the kernel itself; an empty
result returns without a launch. It is a ``torch.autograd.Function`` whose
backward stays in the same tier: the cotangent of ``table`` is the
scatter-add of ``g`` by ``rows``, i.e. the segment-sum kernel on the card.

``plan`` mirrors the launch that ``repro_gather`` makes, so that the CPU
tests can check that its grid covers every (row, column) once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..common import launch, on_cpu, require
from .ref import gather_rows_ref

#: element types the kernel copies, by their size in bytes
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
#: threads per block (kThreads)
THREADS = 256


@dataclass(frozen=True)
class Plan:
    """What ``repro_gather`` launches for E rows of D elements."""

    unit: int                #: bytes a lane moves per access: 16, or the element size
    width: int               #: units per row
    lanes: int               #: lanes per row (blockDim.x)
    slots: int               #: rows a block takes per pass (blockDim.y)
    per_lane: int            #: units per lane per row (V)
    rows_per_thread: int     #: R: a lane has R·V units in flight
    grid: Tuple[int, int]    #: (row groups, column slabs)


def plan(e: int, d: int, elem_bytes: int = 4, aligned: bool = True) -> Plan:
    """The launch for ``e`` rows of ``d`` elements of ``elem_bytes`` each;
    ``aligned`` says both pointers are 16-byte aligned."""
    if aligned and d * elem_bytes % 16 == 0:
        unit, width = 16, d * elem_bytes // 16
    else:
        unit, width = elem_bytes, d
    if width >= 128:
        lanes, v, r = 32, 4, 2
    elif width >= 64:
        lanes, v, r = 32, 2, 4
    else:
        lanes, v, r = 1, 1, 8
        while lanes < width and lanes < 32:
            lanes *= 2
    slots = THREADS // lanes
    grid = (-(-e // (slots * r)), -(-width // (lanes * v)))
    return Plan(unit, width, lanes, slots, v, r, grid)


def gather_rows_forward(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The forward alone (no autograd record)."""
    if on_cpu(table, rows):
        return gather_rows_ref(table, rows)
    require("gather_rows", table, ELEM_BYTES, 2, "table")
    require("gather_rows", rows, torch.int32, 1, "rows")
    out = table.new_empty((rows.shape[0], table.shape[1]))
    if out.numel():
        launch(
            "gather_rows", "repro_gather", table,
            table.data_ptr(), rows.data_ptr(), out.data_ptr(),
            rows.shape[0], table.shape[0], table.shape[1], ELEM_BYTES[table.dtype],
        )
        gather_rows.launches += 1
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
    """Rows of ``table`` (N, D) f32, bf16 or f16 at ``rows`` (E,) int32;
    ids outside ``[0, N)`` give zero rows. Differentiable with respect to
    ``table``."""
    return _GatherRows.apply(table, rows)


#: launches of the CUDA kernel since the count was last set to 0.
gather_rows.launches = 0
