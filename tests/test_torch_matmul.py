"""blocked_matmul's launch plan and its summation order, on the CPU.

The CUDA kernel (src/repro_torch/kernels/csrc/matmul.cu) runs only on the
card, where tests/test_torch_cuda.py and chip_smoke.py hold it to its plain
version. Here: the wrapper's pure-Python plan at every shape chip_smoke.py
checks (path, K-segments, grids), that the plan's constants are the
kernel's, that the kernel's summation order written out in PyTorch stays
within the f32 rounding walk of the exact product, and that the wrapper
matches the JAX package's kernel (interpret mode) on the CPU.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.ops import blocked_matmul as jax_blocked_matmul
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import blocked_matmul
from repro_torch.kernels.matmul import ops
from repro_torch.kernels.matmul.ref import matmul_in_kernel_order

ROOT = Path(__file__).resolve().parents[1]
U = 2.0 ** -24


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _chip_smoke_shapes():
    cs = _chip_smoke()
    cases = [(m, k, n) for m, k, n, _ in cs.matmul_cases(get_config(cs.LM_ARCH))]
    # phase 6 also times the RJP products and the logistic regression's two
    # sites, which phase 2 lists already
    return sorted(set(cases) | {(m, k, n) for m, k, n, _ in cs.RJP_SHAPES})


SHAPES = _chip_smoke_shapes()


@pytest.mark.parametrize("m,k,n", SHAPES, ids=lambda v: str(v))
def test_plan_at_every_chip_smoke_shape(m, k, n):
    p = ops.plan(m, k, n)
    segs = ops.segments(k)
    # the segments tile [0, K) in ascending order, with no gap or overlap,
    # all SEG_LEN long but the last
    assert p.n_segments == len(segs)
    assert [a for a, _ in segs] == list(range(0, k, ops.SEG_LEN))
    assert all(b == a2 for (_, b), (a2, _) in zip(segs, segs[1:]))
    assert (segs[-1][1] if segs else 0) == k
    assert all(b - a == ops.SEG_LEN for a, b in segs[:-1])
    assert all(0 < b - a <= ops.SEG_LEN for a, b in segs)
    # they depend on K alone: the other path cuts K the same way
    other = ops.plan(ops.SKINNY_ROWS + 1 if m <= ops.SKINNY_ROWS else 2, k, n)
    assert other.n_segments == p.n_segments
    # the grid stays within CUDA's limits and covers the output; a split
    # product has one partial per segment and sums them in one more grid
    gx, gy, gz = p.grid
    assert 0 <= gx <= ops.GRID_X_MAX and 0 <= gy <= ops.GRID_Y_MAX and 1 <= gz <= ops.GRID_Y_MAX
    assert p.workspace == (len(segs) * m * n if p.split else 0)
    lanes = 32 if len(segs) > ops.REDUCE_LONG_CHAIN else 1
    assert p.reduce_blocks == (math.ceil(m * n * lanes / 256) if p.split else 0)
    if m <= ops.SKINNY_ROWS:
        assert p.path == "skinny" and p.split == (len(segs) != 1)
        assert (gx, gy, gz) == (len(segs), math.ceil(n / ops.SLAB_N), 1)
    else:
        assert p.path == "tiled"
        assert gx * ops.TILE_M >= m > (gx - 1) * ops.TILE_M
        tile_n = ops.TILE_N // 2 if n <= ops.NARROW_N else ops.TILE_N
        assert gy * tile_n >= n > (gy - 1) * tile_n
        assert gz == (len(segs) if p.split else 1)
        if p.split:
            assert len(segs) > 1 and gx * gy < ops.SPLIT_TILES
            assert p.workspace * 4 <= ops.SPLIT_MAX_BYTES


def test_plan_splits_the_main_paths_products_as_designed():
    # decode in_proj and x_proj, the logistic regression's dθ: split-K
    assert ops.plan(2, 4096, 16384).grid == (8, 256, 1)
    assert ops.plan(2, 8192, 288).grid == (16, 5, 1)
    p = ops.plan(1, 1 << 20, 64)
    assert p.grid == (2048, 1, 1) and p.workspace * 4 == 512 * 1024
    # the prefill's in_proj fills the card with tiles; its x_proj (48 tiles)
    # and the RJP weight gradients (2 tiles) are split over their segments
    assert ops.plan(2048, 4096, 16384) == ops.Plan("tiled", 8, False, (16, 128, 1), 0, 0)
    assert ops.plan(2048, 8192, 288).grid == (16, 3, 16)
    assert ops.plan(128, 169343, 256).grid == (1, 2, 331)
    # one segment: no partials, whatever the path
    assert not ops.plan(2, 256, 8192).split and not ops.plan(2048, 256, 8192).split
    # partials beyond SPLIT_MAX_BYTES keep the tiled product whole
    assert not ops.plan(1000, 1 << 22, 100).split


def test_plan_raises_for_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="grid"):
        ops.plan(2, 8, ops.GRID_Y_MAX * ops.SLAB_N + 1)
    with pytest.raises(ValueError, match="grid"):
        ops.plan(100, 8, ops.GRID_Y_MAX * ops.TILE_N + 1)
    with pytest.raises(ValueError, match="int32"):
        ops.plan(2, 2**31, 4)
    assert ops.plan(100, 8, ops.GRID_Y_MAX * ops.TILE_N).grid[1] == ops.GRID_Y_MAX
    # n ≤ 64 takes the 64-column tile
    assert ops.plan(169343, 256, 40).grid == (1323, 1, 1)
    assert ops.plan(100, 8, 65).grid[1] == 1 and ops.plan(100, 8, 64).grid[1] == 1


@pytest.mark.parametrize("name,value", [
    ("kSegLen", ops.SEG_LEN), ("kSkinnyRows", ops.SKINNY_ROWS), ("kTM", ops.TILE_M),
    ("kNarrowN", ops.NARROW_N), ("kSN", ops.SLAB_N), ("kReduceThreads", 256),
    ("kSplitTiles", ops.SPLIT_TILES), ("kReduceLongChain", ops.REDUCE_LONG_CHAIN),
])
def test_plan_constants_are_the_kernels(name, value):
    src = (ROOT / "src/repro_torch/kernels/csrc/matmul.cu").read_text()
    found = re.search(rf"\b{name} = (\d+)", src)
    assert found and int(found.group(1)) == value
    assert re.search(r"kSplitMaxBytes = (\d+)LL << (\d+)", src).groups() == ("256", "20")
    assert re.search(r"kN = (\d+) \* CG", src).group(1) == str(ops.TILE_N // 2)


@pytest.mark.parametrize("k", [1, 3, 256, 8192])
def test_kernel_order_within_the_f32_rounding_walk(k):
    """The kernel's summation order (fused multiply-adds in ascending K
    within segments of 512, segment sums added in order) lies within
    8·√K·u·sqrt(x²@y²) of the exact product: the limit chip_smoke.py holds
    the kernel to against cuBLAS's f32 product. The limit fails a sum that
    loses one segment."""
    rng = np.random.default_rng(k)
    x = torch.tensor(rng.normal(size=(9, k)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(k, 7)).astype(np.float32))
    got = matmul_in_kernel_order(x, y).double()
    exact = x.double() @ y.double()
    limit = 8 * math.sqrt(k) * U * ((x.double() ** 2) @ (y.double() ** 2)).sqrt()
    assert bool(((got - exact).abs() <= limit).all())
    if k > ops.SEG_LEN:
        lost = got - x[:, :ops.SEG_LEN].double() @ y[:ops.SEG_LEN].double()
        assert bool(((lost - exact).abs() > limit).all())


def test_kernel_order_rounds_a_single_term_once():
    """At K = 1 the sum is fma(x, y, 0): the product rounded once, within
    u·|xy| of exact, where the 8·u·|xy| limit leaves no room for an
    operand split that keeps fewer than 24 bits (3xTF32's hi + lo keep 22)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(16, 1)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(1, 288)).astype(np.float32))
    assert torch.equal(matmul_in_kernel_order(x, y), (x.double() @ y.double()).float())


def test_kernel_order_rows_do_not_depend_on_the_batch():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(20, 700)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(700, 5)).astype(np.float32))
    assert torch.equal(matmul_in_kernel_order(x, y)[3:5], matmul_in_kernel_order(x[3:5], y))


@pytest.mark.parametrize("m,k,n", [(1, 513, 40), (2, 1, 288), (16, 512, 1), (17, 511, 40),
                                   (33, 3, 288), (15, 1030, 7)])
def test_wrapper_matches_jax_at_the_crossover(m, k, n):
    """Forward and both gradients against the JAX package's Pallas kernel
    in interpret mode; y and the cotangent carry fan-in scales (as a
    weight's initializer does), so every result is of order 1."""
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    cot = (rng.normal(size=(m, n)) * max(m, n) ** -0.5).astype(np.float32)

    def jax_loss(a, b):
        out = jax_blocked_matmul(a, b, interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), (jgx, jgy) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    )
    kernels.reset_launch_counts()
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    got = blocked_matmul(tx, ty)
    got.backward(torch.tensor(cot))
    assert kernels.launch_counts()["blocked_matmul"] == 0  # CPU: the plain version
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=1e-5, rtol=0)
