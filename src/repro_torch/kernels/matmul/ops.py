"""Blocked matmul: the ``cuda`` tier of the engine's ``blocked_matmul``
dispatch op (core/kernels.py), over the hand-written kernel in
``csrc/matmul.cu``.

``blocked_matmul(x, y)`` launches the kernel for CUDA tensors and takes the
plain version (ref.py) for CPU tensors; ragged shapes are masked inside the
kernel, so no operand is padded. It is a ``torch.autograd.Function`` whose
backward stays in the same tier, as the paper's Fig. 4 RJP kernels:
``dX = g @ Yᵀ`` and ``dY = Xᵀ @ g`` are two more launches.

The kernel sums each entry in one order that depends on K alone: K is cut
into segments of ``SEG_LEN`` terms, each summed from 0 by one f32 fused
multiply-add per term in ascending K, and the segment sums are added in
ascending order (ref.matmul_in_kernel_order writes it out). Two paths keep
that order (``plan``): a product of at most ``SKINNY_ROWS`` rows (decode,
the head, the logistic regression's dθ) is split over K, one block per
(segment, 64-column slab), into partials that a second grid adds in order;
a taller one runs 128×128 tiles (128×64 for n ≤ 64) that carry the
running total, or, when it has too few tiles to fill the card, is split
over K in the same way.
So a row's result is the same bits at m = 2 as among 2,050 rows, and a call
repeats its bits.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..common import launch, on_cpu, require
from .ref import SEG_LEN, matmul_ref

#: m up to this takes the split-K path (kSkinnyRows)
SKINNY_ROWS = 16
#: the tiled path's block rows (kTM), its block columns (Tile<2>::kN; Tile<1>
#: for n ≤ NARROW_N, kNarrowN) and the skinny path's column slab (kSN)
TILE_M, TILE_N, NARROW_N, SLAB_N = 128, 128, 64, 64
#: a tiled product of fewer tiles than this (and more than one segment) is
#: split over its segments too, while the partials fit SPLIT_MAX_BYTES
#: (kSplitTiles, kSplitMaxBytes)
SPLIT_TILES, SPLIT_MAX_BYTES = 264, 256 << 20
#: more segments than this are summed by 32 lanes per entry (kReduceLongChain)
REDUCE_LONG_CHAIN = 64
#: CUDA's limit on gridDim.x and on gridDim.y and z
GRID_X_MAX, GRID_Y_MAX = 2**31 - 1, 65535


def segments(k: int) -> List[Tuple[int, int]]:
    """The K-segments ``[start, stop)`` of a product of depth ``k``, in the
    order their sums are added: they tile [0, k) and depend on k alone."""
    return [(s, min(s + SEG_LEN, k)) for s in range(0, k, SEG_LEN)]


@dataclass(frozen=True)
class Plan:
    """What one call launches for an (m, k) @ (k, n) product."""

    path: str                    #: "tiled" or "skinny"
    n_segments: int              #: ceil(k / SEG_LEN)
    split: bool                  #: one block per segment, partials summed in order
    grid: Tuple[int, int, int]   #: the product kernel's grid; (0, 1, 1) if none runs
    reduce_blocks: int           #: blocks of the ordered sum of partials; 0 if none
    workspace: int               #: f32 partials the wrapper allocates


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int) -> Plan:
    """The launch for an (m, k) @ (k, n) product, as ``repro_matmul_f32``
    makes it; raises for a shape the kernel cannot take."""
    if min(m, k, n) < 0 or max(m, k, n) >= 2**31:
        raise ValueError(f"blocked_matmul: extents {(m, n, k)} outside the kernel's int32 range")
    n_seg = -(-k // SEG_LEN)
    if m > SKINNY_ROWS:
        gx, gy = -(-m // TILE_M), -(-n // (TILE_N // 2 if n <= NARROW_N else TILE_N))
        split = (n_seg > 1 and gx * gy < SPLIT_TILES and n_seg <= GRID_Y_MAX
                 and n_seg * m * n * 4 <= SPLIT_MAX_BYTES)
        path, grid = "tiled", (gx, gy, n_seg if split else 1)
    else:
        gy = -(-n // SLAB_N)
        split = n_seg != 1  # one segment writes c directly; none, the sum writes zeros
        path, grid = "skinny", (n_seg, gy, 1)
    if grid[0] > GRID_X_MAX or grid[1] > GRID_Y_MAX:
        raise ValueError(f"blocked_matmul: ({m}x{k})@({k}x{n}) needs grid {grid}, beyond "
                         f"CUDA's ({GRID_X_MAX}, {GRID_Y_MAX})")
    lanes = 32 if n_seg > REDUCE_LONG_CHAIN else 1
    reduce_blocks = -(-(m * n * lanes) // 256) if split else 0
    workspace = n_seg * m * n if split else 0
    return Plan(path, n_seg, split, grid, reduce_blocks, workspace)


def _launch(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor, p: Plan) -> None:
    m, k = x.shape
    n = y.shape[1]
    ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.workspace else None
    launch(
        "blocked_matmul", "repro_matmul_f32", x,
        x.data_ptr(), y.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        p.workspace * 4, m, n, k,
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
    p = plan(m, k, n)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        _launch(x, y, out, p)
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
    """``x @ y`` for ``x`` (M, K) and ``y`` (K, N) f32, f32-accurate.
    Differentiable with respect to both operands."""
    return _BlockedMatmul.apply(x, y)


#: launches of the CUDA kernel (one per product, whatever grids it takes)
#: since the count was last set to 0.
blocked_matmul.launches = 0
