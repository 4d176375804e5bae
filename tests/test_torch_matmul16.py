"""The 16-bit blocked_matmul's plan and launch contract, on the CPU.

``repro_matmul_bf16``/``_f16`` (src/repro_torch/kernels/csrc/matmul.cu) run
only on the card (tests/test_torch_cuda.py, chip_smoke.py phases 22 and 29).
Here: ``ops.plan16``, the 16-bit plan, at the sites its split rule was set
on; that it differs from the f32 plan in the split rule alone and that its
constants are the kernel's; which tiled kernel takes a shape (``wgmma`` fed
by TMA where TMA can describe the operands, ``mma.sync`` otherwise); the
contract's models of those launches at every 16-bit site chip_smoke.py
checks, race- and bounds-clean; the sanitizer tier on them; and the plain
16-bit product against the JAX package's Pallas kernel (interpret mode) at
shapes the 16-bit plan splits.
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
    p16, p32 = ops.plan16(m, k, n), ops.plan(m, k, n)
    assert (p16.path, p16.n_segments, p16.grid[:2]) == (p32.path, p32.n_segments, p32.grid[:2])
    if p16.path == "skinny":
        assert p16 == p32
    else:
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
])
def test_the_16_bit_plan_constants_are_the_kernels(name, value):
    found = re.search(rf"\b{name} = (\d+)", SRC)
    assert found and int(found.group(1)) == value
    # the entry point plans with the 16-bit rule, the f32 one with its own
    assert "make_plan(m, n, k, kSplitTiles16, p)" in SRC
    assert "make_plan(m, n, k, kSplitTiles, p)" in SRC


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
        elif k:
            assert names[0] == "matmul_skinny_mma"
        assert names.count("matmul_reduce16") == int(p.split)
        assert K.simulate_grid(model) == []


@pytest.mark.parametrize("m,k,n,offset", [(300, 4096, 72, 0), (130, 1000, 77, 0),
                                          (200, 1040, 72, 1), (512, 1024, 256, 0)])
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


@pytest.mark.parametrize("m,k,n", [(130, 1040, 72), (40, 1536, 136), (17, 600, 24)], ids=str)
def test_the_plain_16_bit_product_matches_jax_where_the_plan_splits(m, k, n):
    """The plain version the CPU takes (the f32 sum rounded once to bf16)
    against the JAX package's Pallas kernel in interpret mode, at shapes
    the 16-bit plan splits over their segments: within one bf16 ulp plus
    2·K·u₃₂·Σ|x||y| (two f32 sums of the same exact products)."""
    assert ops.plan16(m, k, n).split
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
