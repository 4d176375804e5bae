"""Blocked matmul: the ``cuda`` tier of the engine's ``blocked_matmul``
dispatch op (core/kernels.py), over the hand-written kernels in
``csrc/matmul.cu``: ``repro_matmul_f32`` (f32 fused multiply-adds on the
CUDA cores) and ``repro_matmul_bf16`` / ``repro_matmul_f16`` (the tensor
cores: ``wgmma`` fed by a TMA ring for the tiled products whose operands TMA
describes, a thread-block cluster per column slab for the skinny ones,
``mma.sync`` for the rest; an f32 sum rounded once to the operands' type,
as the TPU kernel's ``out_dtype = x.dtype``).

``blocked_matmul(x, y)`` launches the kernel for CUDA tensors and takes the
plain version (ref.py) for CPU tensors; ragged shapes are masked inside the
kernel, so no operand is padded. It is a ``torch.autograd.Function`` whose
backward stays in the same tier, as the paper's Fig. 4 RJP kernels:
``dX = g @ Yᵀ`` and ``dY = Xᵀ @ g`` are two more launches.

The kernel sums each entry in one order that depends on K alone: K is cut
into segments of ``SEG_LEN`` terms, each summed from 0 in ascending K (f32:
one fused multiply-add per term, ref.matmul_in_kernel_order writes it out;
16-bit: one k16 tensor-core step per 16 terms, ``wgmma`` or ``mma``, which
round alike), and the segment sums are added in ascending order in f32. Two
paths keep that order (``plan`` for f32, ``plan16`` for 16 bits, which
differ in the split rule and the skinny cluster kernel): a product of at
most ``SKINNY_ROWS`` rows (decode, the head, the logistic regression's dθ)
is split over K, one block per (segment, 64-column slab), into partials
that a second grid adds in order — at 16 bits on operands TMA describes,
one launch instead, the cluster's blocks splitting K and folding their
segment sums in order through each other's shared memory
(``skinny_plan``); a taller one runs 128×128 tiles (128×64 for n ≤ 64) that carry the
running total, or, when it has too few tiles to fill the card
(``SPLIT_TILES``; at 16 bits ``SPLIT_TILES_16``), is split over K in the
same way.
So a row's result is the same bits at m = 2 as among 2,050 rows, and a call
repeats its bits. ``CONTRACT`` (core/kernels.py's vocabulary) models each
path's launches for the static certifier (analysis/kernelcheck.py), the
sanitizer tier and the card's launch record.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from ...core.kernels import AccumModel, BlockModel, GridModel, Interval, KernelContract, VjpPair
from .. import build
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
#: the 16-bit plan's split rule (kSplitTiles16): against the tensor cores'
#: rate, the partials' 8·S·m·n bytes and a split block's own fill and drain
#: pay below about 28 tiles (csrc/matmul.cu)
SPLIT_TILES_16 = 28
#: more segments than this are summed by 32 lanes per entry (kReduceLongChain)
REDUCE_LONG_CHAIN = 64
#: CUDA's limit on gridDim.x and on gridDim.y and z
GRID_X_MAX, GRID_Y_MAX = 2**31 - 1, 65535
#: threads of a tiled block (kTThreads, kHThreads), a skinny block
#: (kSThreads, kHSThreads) and a block of the ordered sum (kReduceThreads)
TILED_THREADS, SKINNY_THREADS, REDUCE_THREADS = 256, 128, 256
#: threads of a block of the wgmma kernel (kWThreads): a producer warpgroup
#: and two consumers
WGMMA_THREADS = 384
#: the skinny cluster kernel (csrc/matmul.cu): threads of a block (kKThreads:
#: four consumer warps and a producer warp), the most blocks a cluster
#: (kKMaxCluster), its slab widths (kKSlabWide, kKSlabNarrow), its ring's
#: depth (kKStages) of 64-term stages (kKBK) that carry a's 2 KB m16 box
#: (kKABytes) beside b's
CLUSTER_THREADS, MAX_CLUSTER = 160, 8
SLAB_WIDE, SLAB_NARROW, STAGES = 128, 64, 3
STAGE_K, A_BOX_BYTES = 64, 2048
#: the card the skinny rule is set for (kSMs, kBlockSmemMax): an H100's SMs
#: and the shared memory a block may take
SMS, BLOCK_SMEM_MAX = 132, 232448
#: the 16-bit dtypes (the tensor-core kernels and their plan)
DTYPES_16 = (torch.bfloat16, torch.float16)
#: the C entry point for each operand dtype
ENTRY = {
    torch.float32: "repro_matmul_f32",
    torch.bfloat16: "repro_matmul_bf16",
    torch.float16: "repro_matmul_f16",
}
#: the launch record's kernel names, f32 and 16-bit (csrc/launch_record.h);
#: a 16-bit tiled product whose operands TMA describes runs ``WGMMA_KIND``
_KINDS = {
    False: ("matmul_tiled", "matmul_skinny", "matmul_reduce"),
    True: ("matmul_tiled_mma", "matmul_skinny_mma", "matmul_reduce16"),
}
WGMMA_KIND = "matmul_tiled_wgmma"
#: a 16-bit skinny product whose operands TMA describes runs this
CLUSTER_KIND = "matmul_skinny_tma"


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
    workspace: int               #: f32 partials the wrapper allocates (every dtype)
    cluster: int = 0             #: blocks a cluster on the skinny cluster kernel; 0 if another
    slab: int = SLAB_N           #: the skinny path's column slab
    smem: int = 0                #: the skinny cluster kernel's shared memory a block


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int) -> Plan:
    """The launch for an (m, k) @ (k, n) f32 product, as
    ``repro_matmul_f32`` makes it; raises for a shape the kernel cannot
    take."""
    return _plan(m, k, n, SPLIT_TILES)


@functools.lru_cache(maxsize=1024)
def plan16(m: int, k: int, n: int, aligned: bool = True) -> Plan:
    """The launch for an (m, k) @ (k, n) bf16 or f16 product, as
    ``repro_matmul_bf16``/``_f16`` make it: a skinny product whose operands
    TMA describes (``aligned``: both bases 16-byte aligned) on the cluster
    kernel (``skinny_plan``: one launch, no workspace); otherwise ``plan``'s
    paths, tiles and workspace, a tiled product split over its segments
    below ``SPLIT_TILES_16`` tiles."""
    if 0 < m <= SKINNY_ROWS and tma_describes(k, n, aligned):
        sp = skinny_plan(m, k, n)
        if sp is not None:
            return sp
    return _plan(m, k, n, SPLIT_TILES_16)


def plan_for(m: int, k: int, n: int, dtype: torch.dtype, aligned: bool = True) -> Plan:
    """``plan16`` for a 16-bit dtype (one cached plan a shape and
    alignment), else ``plan``."""
    if dtype not in DTYPES_16:
        return plan(m, k, n)
    return plan16(m, k, n) if aligned else plan16(m, k, n, False)


def run_of(segment_count: int, cluster: int, rank: int) -> Tuple[int, int]:
    """The segments ``[start, stop)`` that block ``rank`` of a cluster sums
    (``r·S/C`` to ``(r+1)·S/C``): the ranks tile ``segments(k)`` in order,
    their runs differing by one segment at most."""
    return rank * segment_count // cluster, (rank + 1) * segment_count // cluster


def cluster_smem(m: int, segment_count: int, cluster: int, slab: int) -> int:
    """A cluster block's shared memory (``skinny_smem``): its ring of
    STAGES stages with two mbarriers each, the f32 sums of its longest run
    (m rows of the slab), and 1 KB to align the ring to the swizzle's
    period."""
    run = -(-segment_count // cluster)
    return STAGES * (A_BOX_BYTES + STAGE_K * slab * 2 + 16) + run * m * slab * 4 + 1024


def skinny_plan(m: int, k: int, n: int, cluster: int = 0, slab: int = 0):
    """The skinny cluster kernel's launch for an (m, k) @ (k, n) 16-bit
    product, m ≤ SKINNY_ROWS (``make_skinny_plan``), with its cluster and
    slab forced where not 0; None when it fits neither a block's
    shared memory nor CUDA's grid. The rule (csrc/matmul.cu's note): the
    wide slab unless 8-block clusters of wide slabs stay short of one block
    an SM; the cluster that brings slabs × C nearest to SMS, raised until a
    block's sums fit, at most MAX_CLUSTER and the segments."""
    n_seg = -(-k // SEG_LEN)
    cmax = max(1, min(MAX_CLUSTER, n_seg))
    width = slab or (SLAB_WIDE if -(-n // SLAB_WIDE) * MAX_CLUSTER >= SMS else SLAB_NARROW)
    slabs = -(-n // width)
    if slabs > GRID_Y_MAX or cluster > cmax:
        return None
    first = cluster or max(1, min(cmax, (2 * SMS + slabs) // (2 * slabs)))
    for c in range(first, (cluster or cmax) + 1):
        smem = cluster_smem(m, n_seg, c, width)
        if smem <= BLOCK_SMEM_MAX:
            return Plan("skinny", n_seg, False, (c, slabs, 1), 0, 0, c, width, smem)
    return None


def tma_describes(k: int, n: int, aligned: bool = True) -> bool:
    """Whether a 16-bit tiled product's operands are ones TMA can load (K
    and N multiples of 8 values, both bases 16-byte aligned, or K = 0 and
    nothing to load): the wgmma kernel's operands; the others take the
    ``mma.sync`` kernel."""
    return k == 0 or (k % 8 == 0 and n % 8 == 0 and aligned)


def _plan(m: int, k: int, n: int, split_tiles: int) -> Plan:
    if min(m, k, n) < 0 or max(m, k, n) >= 2**31:
        raise ValueError(f"blocked_matmul: extents {(m, n, k)} outside the kernel's int32 range")
    n_seg = -(-k // SEG_LEN)
    if m > SKINNY_ROWS:
        gx, gy = -(-m // TILE_M), -(-n // (TILE_N // 2 if n <= NARROW_N else TILE_N))
        split = (n_seg > 1 and gx * gy < split_tiles and n_seg <= GRID_Y_MAX
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


def _launch(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor, p: Plan, entry: str,
            *extra: int) -> None:
    m, k = x.shape
    n = y.shape[1]
    ws = None
    if p.workspace:
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device)
        blocked_matmul.workspaces += 1
    launch(
        "blocked_matmul", entry, x,
        x.data_ptr(), y.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        p.workspace * 4, m, n, k, *extra,
    )
    blocked_matmul.launches += 1


def blocked_matmul_forward(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The forward alone (no autograd record)."""
    if on_cpu(x, y):
        return matmul_ref(x, y)
    require("blocked_matmul", x, tuple(ENTRY), 2, "x")
    require("blocked_matmul", y, tuple(ENTRY), 2, "y")
    if x.dtype != y.dtype:
        raise TypeError(f"blocked_matmul: x is {x.dtype} and y {y.dtype}; the kernel takes "
                        "one dtype")
    m, k = x.shape
    if y.shape[0] != k:
        raise ValueError(f"blocked_matmul: shapes {tuple(x.shape)} @ {tuple(y.shape)} do not chain")
    n = y.shape[1]
    p = plan_for(m, k, n, x.dtype, x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        _launch(x, y, out, p, ENTRY[x.dtype])
    return out


def blocked_matmul_split(x: torch.Tensor, y: torch.Tensor, split: bool) -> torch.Tensor:
    """The bf16 product of a tiled shape whose plan could take either
    schedule (m > SKINNY_ROWS, more than one segment, partials within
    SPLIT_MAX_BYTES), split over its segments or not as ``split`` says
    rather than as ``plan16`` says: what checks the 16-bit split rule on the
    card (``repro_matmul_bf16_split``). CUDA tensors only."""
    require("blocked_matmul", x, torch.bfloat16, 2, "x")
    require("blocked_matmul", y, torch.bfloat16, 2, "y")
    m, k = x.shape
    n = y.shape[1]
    if y.shape[0] != k or not x.is_cuda:
        raise ValueError(f"blocked_matmul_split: {tuple(x.shape)} @ {tuple(y.shape)} on {x.device}")
    planned = plan16(m, k, n)
    either = _plan(m, k, n, GRID_X_MAX)
    if planned.path != "tiled" or not either.split:
        raise ValueError(f"blocked_matmul_split: ({m}x{k})@({k}x{n}) cannot take both schedules")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _launch(x, y, out, either if split else dataclasses.replace(
        either, split=False, grid=either.grid[:2] + (1,), reduce_blocks=0, workspace=0),
        "repro_matmul_bf16_split", int(split))
    return out


def blocked_matmul_skinny(x: torch.Tensor, y: torch.Tensor, cluster: int, slab: int) -> torch.Tensor:
    """The bf16 product of a skinny shape the cluster kernel takes (m ≤
    SKINNY_ROWS, operands TMA describes) with its cluster and slab set
    rather than planned: what checks the skinny rule on the card
    (``repro_matmul_bf16_skinny``; every choice sums in the one order, so
    each gives the same bits). CUDA tensors only."""
    require("blocked_matmul", x, torch.bfloat16, 2, "x")
    require("blocked_matmul", y, torch.bfloat16, 2, "y")
    m, k = x.shape
    n = y.shape[1]
    p = skinny_plan(m, k, n, cluster, slab) if 0 < m <= SKINNY_ROWS else None
    if (y.shape[0] != k or not x.is_cuda or p is None or not n
            or not tma_describes(k, n, x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)):
        raise ValueError(f"blocked_matmul_skinny: ({m}x{k})@({k}x{n}) on {x.device} cannot take "
                         f"cluster {cluster}, slab {slab}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    launch("blocked_matmul", "repro_matmul_bf16_skinny", x, x.data_ptr(), y.data_ptr(),
           out.data_ptr(), m, n, k, cluster, slab)
    blocked_matmul.launches += 1
    return out


def skinny_occupancy(m: int, k: int, n: int, cluster: int = 0, slab: int = 0) -> Dict[str, int]:
    """The C plan of a skinny 16-bit product on aligned bases (its cluster
    and slab forced where not 0) and ``cudaOccupancyMaxActiveClusters`` for
    that launch on the current device: ``cluster``, ``slab``, ``slabs``,
    ``smem`` (bytes a block) and ``active_clusters``. Card only."""
    out = (ctypes.c_longlong * 5)()
    code = build.library().repro_matmul16_skinny_plan(m, n, k, cluster, slab, out)
    if code:
        build.check(code, "blocked_matmul")
    return dict(zip(("cluster", "slab", "slabs", "smem", "active_clusters"), out))


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
        # the reference's dtypes: dx.astype(x.dtype), dy.astype(y.dtype)
        if ctx.needs_input_grad[0]:
            dx = blocked_matmul_forward(g, y.t().contiguous()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = blocked_matmul_forward(x.t().contiguous(), g).to(y.dtype)
        return dx, dy


def blocked_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` for ``x`` (M, K) and ``y`` (K, N) of one dtype (f32,
    bf16 or f16 on the card), summed in f32 and returned in that dtype.
    Differentiable with respect to both operands."""
    return _BlockedMatmul.apply(x, y)


#: launches of the CUDA kernel (one per product, whatever grids it takes)
#: since the count was last set to 0.
blocked_matmul.launches = 0
#: workspaces of f32 partials the wrapper allocated (one per split product)
#: since the count was last set to 0.
blocked_matmul.workspaces = 0


# -- contract ----------------------------------------------------------------


def _reduce_model(m: int, n: int, p: Plan, name: str = "matmul_reduce") -> GridModel:
    """The ordered sum of the partials: ``lanes`` threads per entry of the
    (m·n,) output, in order over its segments; a block's entries are
    consecutive, so it reads the partials of an interval of rows."""
    lanes = 32 if p.n_segments > REDUCE_LONG_CHAIN else 1
    per = REDUCE_THREADS // lanes
    nseg = p.n_segments

    def ws_map(b):
        return (0, Interval(b * per // n, min(((b + 1) * per - 1) // n, m - 1)), 0)

    inputs = () if nseg == 0 else (BlockModel("ws", (nseg, m, n), (nseg, 1, n), ws_map),)
    return GridModel(
        grid=(p.reduce_blocks,),
        inputs=inputs,
        output=BlockModel("out", (m * n,), (per,), lambda b: (b,)),
        kernel=f"{name}.{lanes}", block=(REDUCE_THREADS, 1, 1),
    )


def _cluster_model(m: int, k: int, n: int, p: Plan) -> GridModel:
    """The skinny cluster kernel's one launch: grid (C, slabs), cluster (C,
    1, 1). Block r of slab j reads a's rows and b's slab over its run of
    segments (``run_of``; an Interval of SEG_LEN blocks) and, after the
    fold over the cluster's shared memory, stores its share of the slab's
    8-column groups (``r·G/C`` to ``(r+1)·G/C``, G = slab / 8): the model's
    third axis walks those groups inside the block, each group's tile
    stored by the one rank that owns it (None elsewhere: the guard), a
    group past n by none. K = 0 reads nothing and stores zeros."""
    c, width = p.cluster, p.slab
    groups = width // 8
    tiles = -(-n // 8)

    def run(r):
        lo, hi = run_of(p.n_segments, c, r)
        return Interval(lo, hi - 1)

    def out_map(r, j, g):
        mine = r * groups // c <= g < (r + 1) * groups // c
        return (0, j * groups + g) if mine and j * groups + g < tiles else None

    x = BlockModel("x", (m, k), (SKINNY_ROWS, SEG_LEN), lambda r, j, g: (0, run(r)))
    y = BlockModel("y", (k, n), (SEG_LEN, width), lambda r, j, g: (run(r), j))
    return GridModel(
        grid=p.grid[:2] + (groups,),
        inputs=() if k == 0 else (x, y),
        output=BlockModel("out", (m, n), (SKINNY_ROWS, 8), out_map),
        kernel=f"{CLUSTER_KIND}.{width}", block=(CLUSTER_THREADS, 1, 1), loops=1,
        cluster=(c, 1, 1),
    )


def _grid_model(info: Dict[str, Any], **concrete: Any):
    """The launches ``repro_matmul_f32`` makes for ``plan``'s path, and
    ``repro_matmul_bf16``/``_f16`` for ``plan16``'s (the same grids and
    workspace, the tensor-core kernels' names, the ordered sum's 16-bit
    store; a tiled product whose operands TMA describes on the wgmma
    kernel's 384 threads, ``concrete["aligned"]`` saying whether both bases
    are 16-byte aligned, as they are unless stated):

    - tiled, not split: a block per (TILE_M rows, tile columns), its loop
      over K's segments the innermost grid axis (the running total in
      shared memory or registers, stored once after the last segment);
    - tiled, split: a block per (tile, segment) writing its segment's
      partial into the (segments, m, n) workspace, then the ordered sum;
    - skinny at 16 bits on operands TMA describes: one cluster launch
      (``_cluster_model``), no workspace;
    - skinny otherwise: a block per (segment, SLAB_N columns) over all m ≤
      SKINNY_ROWS rows, into the workspace and the ordered sum — or, for
      one segment, into the output directly; for K = 0 only the ordered
      sum runs, writing zeros."""
    m, k, n = int(info["m"]), int(info["k"]), int(info["n"])
    if m == 0 or n == 0:
        return None  # the entry point returns before any launch
    wide = info.get("dtype") in DTYPES_16
    aligned = concrete.get("aligned", True)
    p = plan_for(m, k, n, info.get("dtype"), aligned)
    nseg = p.n_segments
    tiled, skinny, reduce = _KINDS[wide]
    if p.cluster:
        return _cluster_model(m, k, n, p)
    if p.path == "tiled":
        tn = TILE_N // 2 if n <= NARROW_N else TILE_N
        block = (TILED_THREADS, 1, 1)
        if wide and tma_describes(k, n, aligned):
            tiled, block = WGMMA_KIND, (WGMMA_THREADS, 1, 1)
        kind = f"{tiled}.{tn}"
        x = BlockModel("x", (m, k), (TILE_M, SEG_LEN), lambda i, j, s: (i, s))
        y = BlockModel("y", (k, n), (SEG_LEN, tn), lambda i, j, s: (s, j))
        if not p.split:
            return GridModel(
                grid=p.grid[:2] + (max(nseg, 1),),
                inputs=() if k == 0 else (x, y),
                output=BlockModel("out", (m, n), (TILE_M, tn), lambda i, j, s: (i, j)),
                accumulator=AccumModel(axis=2, init_at=0, store="last"),
                kernel=kind, block=block, loops=1,
            )
        product = GridModel(
            grid=p.grid,
            inputs=(x, y),
            output=BlockModel("ws", (nseg, m, n), (1, TILE_M, tn), lambda i, j, s: (s, i, j)),
            kernel=kind, block=block,
        )
        return (product, _reduce_model(m, n, p, reduce))
    block = (SKINNY_THREADS, 1, 1)
    x = BlockModel("x", (m, k), (SKINNY_ROWS, SEG_LEN), lambda s, j: (0, s))
    y = BlockModel("y", (k, n), (SEG_LEN, SLAB_N), lambda s, j: (s, j))
    if not p.split:
        return GridModel(
            grid=p.grid[:2],
            inputs=(x, y),
            output=BlockModel("out", (m, n), (SKINNY_ROWS, SLAB_N), lambda s, j: (0, j)),
            kernel=f"{skinny}.0", block=block,
        )
    if nseg == 0:
        return (_reduce_model(m, n, p, reduce),)
    product = GridModel(
        grid=p.grid[:2],
        inputs=(x, y),
        output=BlockModel("ws", (nseg, m, n), (1, SKINNY_ROWS, SLAB_N), lambda s, j: (s, 0, j)),
        kernel=f"{skinny}.0", block=block,
    )
    return (product, _reduce_model(m, n, p, reduce))


def _vjp_dx_info(info: Dict[str, Any]) -> Dict[str, Any]:
    # dX = g @ Yᵀ: (m, n) @ (n, k)
    return {"m": info["m"], "k": info["n"], "n": info["k"], "dtype": info["dtype"]}


def _vjp_dy_info(info: Dict[str, Any]) -> Dict[str, Any]:
    # dY = Xᵀ @ g: (k, m) @ (m, n)
    return {"m": info["k"], "k": info["m"], "n": info["n"], "dtype": info["dtype"]}


#: the statically checkable contract of this package (proven by
#: analysis.kernelcheck, cross-checked by the sanitizer tier, held to the
#: launch record on the card).
CONTRACT = KernelContract(
    op="blocked_matmul",
    dtypes="floating",
    accum_dtype="float32",
    masking=(
        "no operand is padded: the copies into shared memory (cp.async, "
        "or TMA's zero fill in the wgmma kernel) zero-fill the ragged "
        "edges of a and b, and a thread stores only rows < m and columns < n",
        "a warp (in the wgmma kernel a consumer warpgroup) whose rows or "
        "columns lie wholly outside c skips the arithmetic; the workspace "
        "holds ceil(k / SEG_LEN) * m * n f32 partials, each written by one block",
        "m = 0 or n = 0 returns before any launch",
    ),
    vjp="two same-tier blocked matmuls: dX = g @ Yᵀ, dY = Xᵀ @ g (Fig. 4)",
    vjp_pairs=(
        VjpPair("blocked_matmul", _vjp_dx_info),
        VjpPair("blocked_matmul", _vjp_dy_info),
    ),
    grid_model=_grid_model,
)
