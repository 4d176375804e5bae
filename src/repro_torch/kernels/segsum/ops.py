"""Segment sum: the ``cuda`` tier of the engine's ``segment_sum`` dispatch op
(core/kernels.py), over the hand-written kernel in ``csrc/segsum.cu``.

``segment_sum(msg, seg, num_segments)`` launches the kernel for CUDA tensors
and takes the plain version (ref.py) for CPU tensors. ``msg`` is f32, bf16
or f16; the sum is f32, rounded once to ``msg``'s dtype. It is a
``torch.autograd.Function`` whose backward stays in the same tier: the
cotangent of ``msg`` is the gather ``g[seg]`` (zero rows for invalid ids),
i.e. the gather kernel on the card.

The kernel sums in one order (ref.segment_sum_in_kernel_order writes it
out): a segment's terms in ascending edge index, in chunks of ``CHUNK``
summed from 0, the chunk sums added in order. Both paths keep it, so a
call's bits depend on its inputs alone and repeat from call to call.
``plan`` picks the path by E, as ``segment_sum_forward`` does, and mirrors
the grids that ``repro_segsum`` launches:

- ``scan`` (E ≤ ``SCAN_MAX_EDGES``): one launch; a block per (WARPS output
  rows, column slab) reads all E ids and each warp adds its row's edges.
- ``sorted``: ``torch.sort`` orders the ids (stable), ``repro_segsum_starts``
  finds each segment's start, and a warp per (segment chunk, column slab)
  sums its chunk; segments longer than ``CHUNK`` add their chunk sums in a
  second grid over an f32 workspace.

Every output row is written by the kernel, so the output is ``torch.empty``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ..common import launch, on_cpu, require
from .ref import CHUNK, segment_sum_ref

#: element type codes of repro_segsum (its sums are f32 whatever the type)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: E up to this takes the scan path: the crossover measured by chip_smoke.py
#: phase 6 on the H100 (PERF.md)
SCAN_MAX_EDGES = 4096
#: warps per block (kWarps)
WARPS = 8
#: CUDA's limit on gridDim.y
GRID_Y_MAX = 65535


@dataclass(frozen=True)
class Plan:
    """What one call launches for E edges, D columns and S segments."""

    path: str                      #: "scan" or "sorted"
    unit: int                      #: elements a lane moves per access (16 bytes, or 1)
    per_lane: int                  #: units a lane covers per row (V)
    grid: Tuple[int, int]          #: the sum kernel's (blocks of WARPS warps, column slabs)
    tiles: int                     #: ceil(E / CHUNK) on the sorted path, else 0
    combine_grid: Tuple[int, int]  #: the in-order sum of chunk sums; (0, 0) if none
    workspace: int                 #: f32 chunk sums the wrapper allocates


@functools.lru_cache(maxsize=1024)
def plan(e: int, d: int, s: int, elem_bytes: int = 4, aligned: bool = True) -> Plan:
    """The launch for a call, as ``segment_sum_forward`` and
    ``repro_segsum`` make it; ``aligned`` says ``msg`` and the output are
    16-byte aligned."""
    path = "scan" if e <= SCAN_MAX_EDGES else "sorted"
    vec = 16 // elem_bytes
    unit = vec if aligned and d % vec == 0 else 1
    width = d // unit
    v = 4 if width >= 128 else 2 if width >= 64 else 1
    slabs = -(-width // (32 * v))
    if slabs > GRID_Y_MAX:
        raise ValueError(f"segment_sum: D={d} needs {slabs} column slabs, beyond {GRID_Y_MAX}")
    if path == "scan":
        return Plan(path, unit, v, (-(-s // WARPS), slabs), 0, (0, 0), 0)
    tiles = -(-e // CHUNK)
    combine = (-(-tiles // WARPS), min(-(-d // 32), GRID_Y_MAX)) if tiles else (0, 0)
    return Plan(path, unit, v, (-(-(s + tiles) // WARPS), slabs), tiles, combine, 2 * tiles * d)


def csr(seg: torch.Tensor, num_segments: int):
    """The sorted path's index: the ids sorted stably, the edge each came
    from, and each segment's first position in that order (``num_segments
    + 1`` starts; ids outside ``[0, num_segments)`` lie outside
    ``[starts[0], starts[-1])``)."""
    ids, perm = torch.sort(seg, stable=True)
    starts = torch.empty(num_segments + 1, dtype=torch.int32, device=seg.device)
    launch("segment_sum", "repro_segsum_starts", seg,
           ids.data_ptr(), seg.shape[0], num_segments, starts.data_ptr())
    return ids, perm, starts


def run(msg: torch.Tensor, seg: torch.Tensor, out: torch.Tensor, path: str) -> None:
    """Launch ``path`` of the kernel into ``out`` (checked inputs)."""
    e, d = msg.shape
    s = out.shape[0]
    if path == "scan":
        ids, perm, starts, ws = seg, None, None, None
    else:
        ids, perm, starts = csr(seg, s)
        ws = torch.empty(2 * (-(-e // CHUNK)) * d, dtype=torch.float32, device=msg.device)
    launch(
        "segment_sum", "repro_segsum", msg,
        msg.data_ptr(), ids.data_ptr(), None if perm is None else perm.data_ptr(),
        None if starts is None else starts.data_ptr(), None if ws is None else ws.data_ptr(),
        out.data_ptr(), e, d, s, DTYPE_CODES[msg.dtype],
    )


def segment_sum_forward(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The forward alone (no autograd record)."""
    if on_cpu(msg, seg):
        return segment_sum_ref(msg, seg, num_segments)
    require("segment_sum", msg, DTYPE_CODES, 2, "msg")
    require("segment_sum", seg, torch.int32, 1, "seg")
    if seg.shape[0] != msg.shape[0]:
        raise ValueError(f"segment_sum: seg {tuple(seg.shape)} does not match msg {tuple(msg.shape)}")
    if num_segments < 0:
        raise ValueError(f"segment_sum: num_segments={num_segments} < 0")
    out = msg.new_empty((num_segments, msg.shape[1]))
    if out.numel():
        run(msg, seg, out, "scan" if msg.shape[0] <= SCAN_MAX_EDGES else "sorted")
        segment_sum.launches += 1
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
    """Sum the rows of ``msg`` (E, D) f32, bf16 or f16 into ``num_segments``
    rows by ``seg`` (E,) int32; ids outside ``[0, num_segments)`` are
    dropped. Differentiable with respect to ``msg``."""
    return _SegmentSum.apply(msg, seg, int(num_segments))


#: launches of the CUDA kernel (one per call, whatever grids it takes)
#: since the count was last set to 0.
segment_sum.launches = 0
