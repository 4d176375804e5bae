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
``CONTRACT`` (core/kernels.py's vocabulary) models both paths' launches for
the static certifier (analysis/kernelcheck.py), the sanitizer tier and the
card's launch record; ``routing`` checks, on concrete ids, where the sorted
path's chunk sums go.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...core.kernels import AccumModel, BlockModel, GridModel, KernelContract, VjpPair
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
#: threads of every segment-sum block (kThreads; repro_segsum_starts' 256 too)
THREADS = 32 * WARPS


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


# -- contract ----------------------------------------------------------------

ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _grid_model(info: Dict[str, Any], aligned: bool = True, **concrete: Any):
    """The launches of ``plan``'s path, in the plan's units (a row of D
    elements is ``width`` units):

    - scan: one launch; a block per (WARPS output rows, column slab) reads
      the ids THREADS at a time, the window loop being the innermost grid
      axis (an f32 accumulator per warp, stored once after the last window);
    - sorted: the starts (a thread per segment, S + 1 of them); the chunk
      sums, a warp per chunk slot — slot s < S is segment s's chunk 0, slot
      S + t the chunk that begins in tile t — over a (S + T, width) array
      of chunk sums; the in-order combine, a warp per tile, reading them and
      writing a (T, D) array of combined rows. Which slot goes to an output
      row and which to the workspace depends on the ids: ``routing``."""
    e, d, s = int(info["nnz"]), int(info["dim"]), int(info["num_segments"])
    if d == 0 or s == 0:
        return None  # repro_segsum returns before any launch
    eb = ELEM_BYTES.get(info["dtype"], 4)
    p = plan(e, d, s, eb, aligned)
    width = d // p.unit
    slab = 32 * p.per_lane
    kind = f".{p.unit * eb}"
    block = (THREADS, 1, 1)
    if p.path == "scan":
        windows = -(-e // THREADS)
        inputs = () if e == 0 else (
            BlockModel("seg", (e,), (THREADS,), lambda i, j, k: (k,)),
            BlockModel("msg", (e, width), (THREADS, slab), lambda i, j, k: (k, j)),
        )
        return GridModel(
            grid=p.grid + (max(windows, 1),),
            inputs=inputs,
            output=BlockModel("out", (s, width), (WARPS, slab), lambda i, j, k: (i, j)),
            accumulator=AccumModel(axis=2, init_at=0, store="last"),
            kernel="segsum_scan" + kind, block=block, loops=1,
        )
    t = p.tiles
    starts = GridModel(
        grid=(-(-(s + 1) // THREADS),),
        inputs=(BlockModel("ids", (e,), (e,), lambda i: (0,)),),
        output=BlockModel("starts", (s + 1,), (THREADS,), lambda i: (i,)),
        kernel="segsum_starts.0", block=block,
    )
    chunks = GridModel(
        grid=p.grid,
        inputs=(
            BlockModel("starts", (s + 1,), (s + 1,), lambda i, j: (0,)),
            BlockModel("ids", (e,), (e,), lambda i, j: (0,)),
            BlockModel("perm", (e,), (e,), lambda i, j: (0,)),
            BlockModel("msg", (e, width), (e, slab), lambda i, j: (0, j)),
        ),
        output=BlockModel("chunk_sums", (s + t, width), (WARPS, slab), lambda i, j: (i, j)),
        kernel="segsum_chunk" + kind, block=block,
    )
    cx, cy = p.combine_grid
    reps = -(-d // (32 * cy))  # the combine's column loop: d += 32·gridDim.y
    groups = -(-d // 32)
    combine = GridModel(
        grid=(cx, cy, reps),
        inputs=(
            BlockModel("starts", (s + 1,), (s + 1,), lambda i, j, r: (0,)),
            BlockModel("chunk_sums", (s + t, width), (s + t, width), lambda i, j, r: (0, 0)),
        ),
        output=BlockModel(
            "combined", (t, d), (WARPS, 32),
            lambda i, j, r: (i, j + cy * r) if j + cy * r < groups else None,
        ),
        kernel="segsum_combine.0", block=block, loops=1,
    )
    return (starts, chunks, combine)


def routing(seg, num_segments: int) -> Dict[str, np.ndarray]:
    """Where the sorted path's writes go for these ids, as the kernels
    decide it from the sorted ids and the starts: for each output row, how
    many warps write it; for each workspace row, how many warps write it
    and how many reads of the combine it serves (2·T rows, T = ceil(E /
    CHUNK))."""
    ids = np.sort(np.asarray(torch.as_tensor(seg).detach().cpu(), np.int64), kind="stable")
    e, s = ids.shape[0], int(num_segments)
    t = -(-e // CHUNK)
    starts = np.searchsorted(ids, np.arange(s + 1), side="left")
    st, en = starts[:-1], starts[1:]
    long_ = en - st > CHUNK
    out = np.zeros(s, np.int64)
    ws_written = np.zeros(2 * t, np.int64)
    ws_read = np.zeros(2 * t, np.int64)
    out[~long_] += 1                                     # chunk 0 of a short segment
    np.add.at(ws_written, 2 * (st[long_] // CHUNK) + 1, 1)  # chunk 0 of a long one
    # the chunk c >= 1 that begins in tile u, as tile_head finds it
    u = np.arange(t)
    p = u * CHUNK
    sp = ids[np.minimum(p, e - 1)] if e else np.zeros(0, np.int64)
    ok = (sp >= 0) & (sp < s)
    sp_safe = np.where(ok, sp, 0)
    hst, hen = starts[sp_safe], starts[np.minimum(sp_safe + 1, s)]
    c = np.where(ok, (p - hst + CHUNK - 1) // CHUNK, 0)
    at = hst + c * CHUNK
    head = ok & (hst != p) & (at < hen) & (at < p + CHUNK)
    ws_written[2 * u[head]] += 1
    # the combine: the warp of the tile where chunk 1 begins writes the row
    first = head & (c == 1)
    np.add.at(out, sp[first], 1)
    for seg_s, a, b in zip(sp[first], hst[first], hen[first]):
        chunks = -(-(b - a) // CHUNK)
        ats = a + np.arange(chunks) * CHUNK
        np.add.at(ws_read, 2 * (ats // CHUNK) + (np.arange(chunks) == 0), 1)
    return {"out": out, "ws_written": ws_written, "ws_read": ws_read}


def _routing_check(info: Dict[str, Any], seg=None, **concrete: Any) -> List[Tuple[str, str]]:
    """On concrete ids of a sorted-path site: every output row written by
    exactly one warp (``grid-race`` / ``grid-uncovered``), no workspace row
    written twice (``grid-race``), every workspace row the combine reads
    written exactly once (``uninit-accumulator``)."""
    e, d, s = int(info["nnz"]), int(info["dim"]), int(info["num_segments"])
    if seg is None or d == 0 or s == 0 or e <= SCAN_MAX_EDGES:
        return []
    r = routing(seg, s)
    viols = []
    if (r["out"] > 1).any():
        row = int(np.argmax(r["out"] > 1))
        viols.append(("grid-race", f"sorted path: output row {row} written {int(r['out'][row])}x"))
    if (r["out"] == 0).any():
        row = int(np.argmax(r["out"] == 0))
        viols.append(("grid-uncovered", f"sorted path: output row {row} never written"))
    if (r["ws_written"] > 1).any():
        row = int(np.argmax(r["ws_written"] > 1))
        viols.append(("grid-race", f"sorted path: workspace row {row} written "
                                   f"{int(r['ws_written'][row])}x"))
    bad = (r["ws_read"] > 0) & (r["ws_written"] != 1)
    if bad.any():
        row = int(np.argmax(bad))
        viols.append(("uninit-accumulator", f"sorted path: workspace row {row} read by the "
                                            f"combine but written {int(r['ws_written'][row])}x"))
    return viols


def _vjp_info(info: Dict[str, Any]) -> Dict[str, Any]:
    # dmsg = g[seg] — the gather dispatch op (zero rows for invalid ids)
    return {
        "rows": info["nnz"],
        "num_rows": info["num_segments"],
        "dim": info["dim"],
        "dtype": info["dtype"],
    }


#: the statically checkable contract of this package (proven by
#: analysis.kernelcheck, cross-checked by the sanitizer tier, held to the
#: launch record on the card).
CONTRACT = KernelContract(
    op="segment_sum",
    dtypes="floating",
    accum_dtype="float32",
    masking=(
        "segment ids outside [0, num_segments) (COO_PAD_KEY among them) "
        "match no output row: the scan path skips them, the sorted path "
        "sorts them outside [starts[0], starts[S])",
        "the last row block and the last column slab are ragged: a warp "
        "skips rows s >= S and units c >= width (no padding in memory)",
        "sorted path: chunk slot s < S goes to output row s when segment s "
        "has at most CHUNK terms, else to workspace row 2*(starts[s] // "
        "CHUNK) + 1; slot S + t to workspace row 2t; the combine warp of "
        "the tile where a long segment's chunk 1 begins writes its output "
        "row (``routing`` checks this on concrete ids)",
        "D = 0 or S = 0 returns before any launch",
    ),
    vjp="same-tier gather_join of the cotangent at seg (zero rows for invalid ids)",
    vjp_pairs=(VjpPair("gather_join", _vjp_info),),
    grid_model=_grid_model,
    concrete_check=_routing_check,
)
