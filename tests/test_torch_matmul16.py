"""The 16-bit blocked_matmul's plan and launch contract, on the CPU.

``repro_matmul_bf16``/``_f16`` (src/repro_torch/kernels/csrc/matmul.cu) run
only on the card (tests/test_torch_cuda.py, chip_smoke.py phases 22 and 29).
Here: ``ops.plan16``, the 16-bit plan, at the sites its split rule was set
on and at deepseek-coder-33b's decode sites; that it differs from the f32
plan in the split rule and the skinny cluster kernel alone and that its
constants are the kernel's; which kernel takes a shape (``wgmma`` fed by TMA
where TMA can describe a tiled product's operands, the cluster kernel where
it can describe a skinny one's, ``mma.sync`` otherwise); how the cluster's
ranks split K; the contract's models of those launches at every 16-bit site
chip_smoke.py checks, race- and bounds-clean; the sanitizer tier on them;
and the plain 16-bit product against the JAX package's Pallas kernel
(interpret mode) at shapes the 16-bit plan splits over K.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.ops import blocked_matmul as jax_blocked_matmul
from repro_torch.core import kernels as K
from repro_torch.kernels import blocked_matmul
from repro_torch.kernels.matmul import ops
from repro_torch.kernels.matmul.ref import matmul_ref

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "src/repro_torch/kernels/csrc/matmul.cu").read_text()
RECORD_H = (ROOT / "src/repro_torch/kernels/csrc/launch_record.h").read_text()
DTYPES = [torch.bfloat16, torch.float16]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sites16():
    """Phase 22's 16-bit product sites: the zoo's weight shapes at 29.1's
    rows, and its edges."""
    cs = _chip_smoke()
    return sorted({(m, k, n) for (k, n) in cs.matmul16_sites() for m in cs.MATMUL16_M}
                  | set(cs.MATMUL16_EDGES))


SITES16 = _sites16()


def _model(m, k, n, dtype, **concrete):
    return K.kernel_contract("blocked_matmul").grid_model(
        {"m": m, "k": k, "n": n, "dtype": dtype}, **concrete)


# (m, k, n): (grid, split, workspace) — deepseek-coder-33b's q/o, k/v and
# down projections at a 512-token prefill, a square product, a narrower
# projection and 29.1's split row-bits shape
SPLIT_RULE = {
    (512, 7168, 7168): ((4, 56, 1), False, 0),
    (512, 7168, 1024): ((4, 8, 1), False, 0),
    (512, 19200, 7168): ((4, 56, 1), False, 0),
    (4096, 4096, 4096): ((32, 32, 1), False, 0),
    (512, 7168, 512): ((4, 4, 14), True, 14 * 512 * 512),
    (2050, 7168, 128): ((17, 1, 14), True, 14 * 2050 * 128),
}


@pytest.mark.parametrize("m,k,n", list(SPLIT_RULE), ids=str)
def test_the_16_bit_split_rule_at_the_named_sites(m, k, n):
    grid, split, workspace = SPLIT_RULE[(m, k, n)]
    p = ops.plan16(m, k, n)
    assert (p.path, p.grid, p.split, p.workspace) == ("tiled", grid, split, workspace)
    assert p.n_segments == math.ceil(k / ops.SEG_LEN)
    assert (grid[0] * grid[1] < ops.SPLIT_TILES_16) == split
    # the f32 plan splits every one of them but the 1,024-tile square and
    # the down projection, whose partials (557.8 MB) exceed SPLIT_MAX_BYTES
    assert ops.plan(m, k, n).split == ((m, k, n) not in {(4096, 4096, 4096), (512, 19200, 7168)})


@pytest.mark.parametrize("m,k,n", SITES16, ids=str)
def test_plan16_is_the_f32_plan_but_for_its_split_rule(m, k, n):
    """The 16-bit plan is the f32 one but for the tiled split rule and,
    where TMA describes a skinny product's operands, the cluster kernel's
    one launch with no workspace; unaligned bases keep the f32 plan's
    skinny path (the mma.sync kernel and the ordered sum)."""
    p16, p32 = ops.plan16(m, k, n), ops.plan(m, k, n)
    assert (p16.path, p16.n_segments) == (p32.path, p32.n_segments)
    if p16.path == "skinny":
        # K = 0 loads nothing, so its bases need no alignment
        assert ops.plan16(m, k, n, aligned=False) == (p16 if k == 0 else p32)
        if p16.cluster:
            assert ops.tma_describes(k, n)
            assert p16 == ops.skinny_plan(m, k, n)
            assert (p16.split, p16.workspace, p16.reduce_blocks) == (False, 0, 0)
            assert p16.grid == (p16.cluster, -(-n // p16.slab), 1)
        else:
            assert p16 == p32
    else:
        assert p16.grid[:2] == p32.grid[:2] and p16.cluster == 0
        tiles = p16.grid[0] * p16.grid[1]
        assert p16.split == (p16.n_segments > 1 and tiles < ops.SPLIT_TILES_16
                             and p16.n_segments * m * n * 4 <= ops.SPLIT_MAX_BYTES)
        assert p16.grid[2] == (p16.n_segments if p16.split else 1)
        assert p16.workspace == (p16.n_segments * m * n if p16.split else 0)
    for dtype in DTYPES:
        assert ops.plan_for(m, k, n, dtype) is p16
    assert ops.plan_for(m, k, n, torch.float32) is p32


@pytest.mark.parametrize("name,value", [
    ("kSplitTiles16", ops.SPLIT_TILES_16), ("kWThreads", ops.WGMMA_THREADS), ("kWTM", ops.TILE_M),
    ("kHThreads", ops.TILED_THREADS), ("kHSThreads", ops.SKINNY_THREADS), ("kSplitTiles", ops.SPLIT_TILES),
    ("kKWarps", ops.CLUSTER_THREADS // 32 - 1), ("kKMaxCluster", ops.MAX_CLUSTER),
    ("kKSlabWide", ops.SLAB_WIDE), ("kKSlabNarrow", ops.SLAB_NARROW),
    ("kKStages", ops.STAGES), ("kKBK", ops.STAGE_K),
    ("kSkinnyRows", ops.A_BOX_BYTES // (2 * ops.STAGE_K)), ("kSMs", ops.SMS),
    ("kBlockSmemMax", ops.BLOCK_SMEM_MAX),
])
def test_the_16_bit_plan_constants_are_the_kernels(name, value):
    found = re.search(rf"\b{name} = (\d+)", SRC)
    assert found and int(found.group(1)) == value
    # the entry point plans with the 16-bit rule, the f32 one with its own
    assert "make_plan(m, n, k, kSplitTiles16, p)" in SRC
    assert "make_plan(m, n, k, kSplitTiles, p)" in SRC
    # a block of the cluster kernel: four consumer warps and a producer; a's
    # box is m16 by one stage of terms
    assert "kKThreads = 32 * (kKWarps + 1)" in SRC and ops.CLUSTER_THREADS == 160
    assert "kKABytes = kSkinnyRows * kKBK * 2" in SRC and ops.SKINNY_ROWS == 16


# (m, k, n, aligned): (cluster, slab, grid) of the cluster kernel, or None
# where the mma.sync kernel and the ordered sum take it — deepseek-coder-33b's
# decode sites (q/o, k/v, gate/up, down, the head; q/o at m = 16) and the edges
SKINNY_PLAN = {
    (1, 7168, 7168, True): (2, 128, (2, 56, 1)),
    (1, 7168, 1024, True): (8, 64, (8, 16, 1)),
    (1, 7168, 19200, True): (1, 128, (1, 150, 1)),
    (1, 19200, 7168, True): (2, 128, (2, 56, 1)),
    (1, 7168, 32256, True): (1, 128, (1, 252, 1)),
    (16, 7168, 7168, True): (2, 128, (2, 56, 1)),
    (5, 0, 3, True): (1, 64, (1, 1, 1)),         # K = 0: zeros, one launch
    (2, 512, 200, True): (1, 64, (1, 4, 1)),     # one segment: 0 + seg
    (2, 64, 8, True): (1, 64, (1, 1, 1)),
    (16, 19200, 2048, True): (4, 64, (4, 32, 1)),   # 38 segments
    (16, 53248, 16384, True): (5, 128, (5, 128, 1)),  # raised from 1 until a run's sums fit
    (16, 4096, 4099, True): None,                # N not a multiple of 8
    (2, 515, 200, True): None,                   # K not a multiple of 8
    (1, 7168, 7168, False): None,                # a base 2 bytes into its storage
    (16, 300_000, 64, True): None,               # no run of sums fits shared memory
}


@pytest.mark.parametrize("m,k,n,aligned", list(SKINNY_PLAN), ids=str)
def test_the_16_bit_skinny_plan_at_the_decode_sites_and_edges(m, k, n, aligned):
    """plan16's skinny branch: one cluster launch of grid (C, slabs), no
    workspace and no ordered sum, where TMA describes the operands and a
    block's sums fit; else the f32 plan's split-K path. The f32 plan does
    not change."""
    want = SKINNY_PLAN[(m, k, n, aligned)]
    p = ops.plan16(m, k, n, aligned)
    p32 = ops.plan(m, k, n)
    assert p32.path == "skinny" and p32.cluster == 0 and p32.grid == (p32.n_segments, -(-n // 64), 1)
    assert p.n_segments == p32.n_segments == -(-k // ops.SEG_LEN)
    if want is None:
        assert p == p32 and p.split == (p.n_segments != 1)
        return
    cluster, slab, grid = want
    assert (p.cluster, p.slab, p.grid) == (cluster, slab, grid)
    assert (p.split, p.workspace, p.reduce_blocks) == (False, 0, 0)
    assert 1 <= p.cluster <= min(ops.MAX_CLUSTER, max(1, p.n_segments))
    assert p.smem == ops.cluster_smem(m, p.n_segments, p.cluster, p.slab) <= ops.BLOCK_SMEM_MAX


@pytest.mark.parametrize("segments,cluster", [(1, 1), (14, 2), (14, 8), (38, 2), (38, 7), (104, 1),
                                              (9, 8), (3, 3)])
def test_the_ranks_of_a_cluster_split_the_segments_once_in_order(segments, cluster):
    """Block r of a cluster sums segments [r·S/C, (r+1)·S/C): the runs
    tile ``segments(k)`` once each, in order, none empty, differing by one
    at most, and the fold's owner of each segment is the one whose run
    holds it."""
    k = segments * ops.SEG_LEN - 5
    segs = ops.segments(k)
    runs = [ops.run_of(segments, cluster, r) for r in range(cluster)]
    assert [s for lo, hi in runs for s in range(lo, hi)] == list(range(len(segs)))
    assert all(hi > lo for lo, hi in runs)
    assert max(hi - lo for lo, hi in runs) - min(hi - lo for lo, hi in runs) <= 1
    assert max(hi - lo for lo, hi in runs) == -(-segments // cluster)


def test_the_launch_record_codes_are_the_headers():
    """kernels/common.py names each code of csrc/launch_record.h's
    KernelCode, and reads as many ints a launch as the record keeps (its
    cluster's dimensions last)."""
    from repro_torch.kernels import common

    codes = {int(v): re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
             for name, v in re.findall(r"\bk(\w+) = (\d+),", RECORD_H)}
    assert codes == common.KERNEL_NAMES
    assert common.KERNEL_NAMES[14] == ops.CLUSTER_KIND
    found = re.search(r"kLaunchInts = (\d+)", RECORD_H)
    assert found and int(found.group(1)) == common._LAUNCH_INTS == 11


def test_a_cluster_beyond_the_portable_size_is_refused():
    """The contract's launch limits: a cluster of more than 8 blocks, or one
    whose size does not divide the grid, is no launch the kernel makes."""
    import dataclasses

    good = _model(1, 7168, 7168, torch.bfloat16)
    assert good.cluster == (2, 1, 1) and K.simulate_grid(good) == []
    assert K.model_launches(good) == ((f"{ops.CLUSTER_KIND}.128", (2, 56, 1), (160, 1, 1), (2, 1, 1)),)
    for cluster in ((16, 1, 1), (3, 1, 1)):
        bad = dataclasses.replace(good, cluster=cluster)
        assert [kind for kind, _ in K.simulate_grid(bad)] == ["launch-limit"]
    # nor does the plan take a cluster of more blocks than segments
    assert ops.skinny_plan(1, 1024, 64, cluster=2) is not None
    assert ops.skinny_plan(1, 1024, 64, cluster=3) is None


# (m, k, n, aligned): the tiled kernel that takes it
KERNEL_CHOICE = [
    (512, 7168, 7168, True, "matmul_tiled_wgmma"),
    (300, 4096, 72, True, "matmul_tiled_wgmma"),
    (40, 0, 16, True, "matmul_tiled_wgmma"),      # K = 0: nothing to load, zeros stored
    (33, 8, 16, True, "matmul_tiled_wgmma"),
    (130, 1000, 77, True, "matmul_tiled_mma"),    # N not a multiple of 8
    (17, 20, 13, True, "matmul_tiled_mma"),       # K and N not multiples of 8
    (129, 33, 264, True, "matmul_tiled_mma"),     # K not a multiple of 8
    (200, 1040, 72, False, "matmul_tiled_mma"),   # a base 2 bytes into its storage
    (64, 64, 64, False, "matmul_tiled_mma"),
]


@pytest.mark.parametrize("m,k,n,aligned,kind", KERNEL_CHOICE, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_kernel_for_shapes_tma_cannot_describe(m, k, n, aligned, kind, dtype):
    assert ops.tma_describes(k, n, aligned) == (kind == "matmul_tiled_wgmma")
    model = _model(m, k, n, dtype, aligned=aligned)
    got = K.model_launches(model)
    p = ops.plan16(m, k, n)
    tn = 64 if n <= 64 else 128
    threads = ops.WGMMA_THREADS if kind == "matmul_tiled_wgmma" else ops.TILED_THREADS
    assert got[0] == (f"{kind}.{tn}", p.grid, (threads, 1, 1))
    assert len(got) == 1 + int(p.split)
    assert K.simulate_grid(model) == []
    # the f32 product of the same shape keeps its own kernel
    assert K.model_launches(_model(m, k, n, torch.float32))[0][0].startswith("matmul_tiled.")


@pytest.mark.parametrize("m,k,n", SITES16, ids=str)
def test_every_16_bit_site_of_phase_22_is_modelled_clean(m, k, n):
    """Phase 22 holds the card's launch record at these sites to these
    models: each is the 16-bit plan's launch on the kernel the shape takes,
    and simulates without a race, an uncovered tile or a read of an
    unwritten partial."""
    p = ops.plan16(m, k, n)
    for dtype in DTYPES:
        model = _model(m, k, n, dtype)
        got = K.model_launches(model)
        names = [g[0].split(".")[0] for g in got]
        if p.path == "tiled":
            want = "matmul_tiled_wgmma" if ops.tma_describes(k, n) else "matmul_tiled_mma"
            assert names[0] == want and got[0][1] == p.grid
        elif p.cluster:
            # one launch, no workspace: every zoo site at m <= 16
            assert names == [ops.CLUSTER_KIND] and got[0][1] == p.grid
            assert got[0][3:] == (() if p.cluster == 1 else ((p.cluster, 1, 1),))
        elif k:
            assert names[0] == "matmul_skinny_mma"
        assert names.count("matmul_reduce16") == int(p.split)
        assert K.simulate_grid(model) == []
    if m <= ops.SKINNY_ROWS and (k, n) in _chip_smoke().matmul16_sites():
        assert p.cluster


@pytest.mark.parametrize("m,k,n,offset", [(300, 4096, 72, 0), (130, 1000, 77, 0),
                                          (200, 1040, 72, 1), (512, 1024, 256, 0),
                                          (3, 1040, 72, 0), (3, 1040, 72, 1), (16, 0, 8, 0)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_sanitizer_tier_replays_the_16_bit_models(m, k, n, offset, dtype):
    """The sanitizer tier models each call (its bases' alignment too) and
    computes through the plain version."""
    rng = np.random.default_rng(m + k + n)
    xs = torch.tensor(rng.normal(size=m * k + offset).astype(np.float32)).to(dtype)
    ys = torch.tensor(rng.normal(size=k * n + offset).astype(np.float32)).to(dtype)
    x, y = xs[offset:].view(m, k), ys[offset:].view(k, n)
    table = K.make_table("sanitizer", backend="cuda")
    impl = K.resolve_impl("blocked_matmul", {"m": m, "k": k, "n": n, "dtype": dtype}, table)
    assert impl.tier == "sanitizer"
    assert torch.equal(impl.fn(x, y), matmul_ref(x, y))


@pytest.mark.parametrize("m,k,n", [(130, 1040, 72), (40, 1536, 136), (17, 600, 24),
                                   (1, 1040, 72), (16, 1536, 136), (3, 600, 24)], ids=str)
def test_the_plain_16_bit_product_matches_jax_where_the_plan_splits(m, k, n):
    """The plain version the CPU takes (the f32 sum rounded once to bf16)
    against the JAX package's Pallas kernel in interpret mode, at shapes
    the 16-bit plan splits over their segments (into partials, or over a
    cluster's ranks): within one bf16 ulp plus 2·K·u₃₂·Σ|x||y| (two f32
    sums of the same exact products)."""
    p = ops.plan16(m, k, n)
    assert p.split or p.cluster > 1
    rng = np.random.default_rng(7 * m + k + n)
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32), jnp.bfloat16)
    y = jnp.asarray((rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32), jnp.bfloat16)
    want = np.asarray(jax_blocked_matmul(x, y, interpret=True).astype(jnp.float32), np.float64)
    xf, yf = (np.asarray(a.astype(jnp.float32)) for a in (x, y))
    tx, ty = (torch.tensor(a).to(torch.bfloat16) for a in (xf, yf))
    got = blocked_matmul(tx, ty)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -133))) - 7)
    limit = ulp + 2 * k * 2.0 ** -24 * (np.abs(xf.astype(np.float64)) @ np.abs(yf.astype(np.float64)))
    assert np.all(np.abs(got - want) <= limit)
