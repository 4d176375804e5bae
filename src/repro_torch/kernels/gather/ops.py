"""Row gather: the ``cuda`` tier of the engine's ``gather_join`` dispatch op
(core/kernels.py), over the hand-written kernel in ``csrc/gather.cu``.

``gather_rows(table, rows)`` launches the kernel for CUDA tensors and takes
the plain version (ref.py) for CPU tensors. ``table`` is f32, bf16 or f16:
the copy moves bits, so the result equals the plain version exactly. Ids
outside ``[0, N)`` give zero rows, written by the kernel itself; an empty
result returns without a launch. It is a ``torch.autograd.Function`` whose
backward stays in the same tier: the cotangent of ``table`` is the
scatter-add of ``g`` by ``rows``, i.e. the segment-sum kernel on the card.

``plan`` mirrors the launch that ``repro_gather`` makes, and ``CONTRACT``
(core/kernels.py's vocabulary) models it for the static certifier
(analysis/kernelcheck.py), the sanitizer tier and the card's launch record.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ...core.kernels import BlockModel, GridModel, Interval, KernelContract, VjpPair
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


# -- contract ----------------------------------------------------------------


def _row_span(rows: torch.Tensor, n: int, per_block: int, blocks: int):
    """Per block of ``per_block`` consecutive output rows, the least and
    the largest valid id it reads (-1, -1 where it reads none)."""
    ids = rows.detach().to("cpu", torch.int64)
    pad = blocks * per_block - ids.shape[0]
    ids = torch.cat([ids, ids.new_full((pad,), -1)]).view(blocks, per_block)
    valid = (ids >= 0) & (ids < n)
    lo = torch.where(valid, ids, ids.new_full((), n)).min(1).values
    hi = torch.where(valid, ids, ids.new_full((), -1)).max(1).values
    return torch.where(lo == n, lo.new_full((), -1), lo).tolist(), hi.tolist()


def _grid_model(info: Dict[str, Any], rows: Optional[torch.Tensor] = None,
                aligned: bool = True, **concrete: Any) -> Optional[GridModel]:
    """``repro_gather``'s launch: a block per (row group, column slab) of
    ``plan``, over the (E, width) output in the plan's units; it reads its
    group's ids and, for each valid one, that table row's slab. Statically
    the table rows only lie in ``[0, N)`` (an Interval); the sanitizer
    passes the concrete ``rows`` to sharpen each block's rows into the span
    of the valid ids it reads (a block with none reads no table row)."""
    e, n, d = int(info["rows"]), int(info["num_rows"]), int(info["dim"])
    if e == 0 or d == 0:
        return None  # an empty result returns before the launch
    p = plan(e, d, ELEM_BYTES.get(info["dtype"], 4), aligned)
    per_block, slab = p.slots * p.rows_per_thread, p.lanes * p.per_lane
    if rows is not None:
        lo, hi = _row_span(rows, n, per_block, p.grid[0])

        def table_map(i, j):
            return None if hi[i] < 0 else (Interval(lo[i], hi[i]), j)
    else:
        span = Interval(0, n - 1)

        def table_map(i, j):
            return None if n == 0 else (span, j)

    return GridModel(
        grid=p.grid,
        inputs=(
            BlockModel("rows", (e,), (per_block,), lambda i, j: (i,)),
            BlockModel("table", (n, p.width), (1, slab), table_map),
        ),
        output=BlockModel("out", (e, p.width), (per_block, slab), lambda i, j: (i, j)),
        kernel=f"gather.{p.unit}",
        block=(p.lanes, p.slots, 1),
    )


def _vjp_info(info: Dict[str, Any]) -> Dict[str, Any]:
    # dtable = Σ_e 1[rows_e == r]·g[e] — the segment-sum dispatch op
    return {
        "nnz": info["rows"],
        "dim": info["dim"],
        "num_segments": info["num_rows"],
        "dtype": info["dtype"],
    }


#: the statically checkable contract of this package (proven by
#: analysis.kernelcheck, cross-checked by the sanitizer tier, held to the
#: launch record on the card).
CONTRACT = KernelContract(
    op="gather_join",
    dtypes="floating",
    accum_dtype="none",
    masking=(
        "row ids outside [0, N) (COO padding) are never read: the kernel "
        "writes their output rows as zeros",
        "the last row group and the last column slab are ragged: a lane "
        "skips rows e >= E and units c >= width (no padding in memory)",
        "an empty result (E = 0 or D = 0) returns before the launch",
    ),
    vjp="same-tier segment_sum of the cotangent by rows (dispatch op)",
    vjp_pairs=(VjpPair("segment_sum", _vjp_info),),
    grid_model=_grid_model,
)
