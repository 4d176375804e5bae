"""gather_rows's launch plan and its working types, on the CPU.

The CUDA kernel (src/repro_torch/kernels/csrc/gather.cu) runs only on the
card, where tests/test_torch_cuda.py and chip_smoke.py hold it to its plain
version bit for bit. Here: the wrapper's pure-Python plan, whose grid must
cover every (row, column) of the output exactly once at every shape
chip_smoke.py uses; that the plan's constants are the kernel's; and the
wrapper in f32, bf16 and f16 against the JAX package's gather (its Pallas
kernel in interpret mode), exactly: a gather moves bits.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather.ops import gather_rows as jax_gather_rows
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import gather_rows
from repro_torch.kernels.gather import ops

ROOT = Path(__file__).resolve().parents[1]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()
SHAPES = sorted({(e, d) for e, _, d, _ in CHIP_SMOKE.gather_shapes(get_config(CHIP_SMOKE.LM_ARCH))})


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


def _covered(p, e):
    """(rows, units) the kernel's threads write, as csrc/gather.cu indexes
    them: row e0 + slot + k·slots of row group bx, unit c0 + lane + v·lanes
    of slab by; each counted once per thread that writes it."""
    gx, gy = p.grid
    bx, slot, k = np.meshgrid(np.arange(gx), np.arange(p.slots), np.arange(p.rows_per_thread),
                              indexing="ij")
    rows = (bx * p.slots * p.rows_per_thread + slot + k * p.slots).ravel()
    by, lane, v = np.meshgrid(np.arange(gy), np.arange(p.lanes), np.arange(p.per_lane), indexing="ij")
    units = (by * p.lanes * p.per_lane + lane + v * p.lanes).ravel()
    return rows[rows < e], units[units < p.width]


@pytest.mark.parametrize("e,d", SHAPES, ids=str)
@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_row_and_column_once(e, d, elem_bytes, aligned):
    p = ops.plan(e, d, elem_bytes, aligned)
    assert p.unit * p.width == d * elem_bytes
    assert p.unit == (16 if aligned and d * elem_bytes % 16 == 0 else elem_bytes)
    assert p.lanes * p.slots == ops.THREADS
    # a thread has 8 units in flight, or as many as a narrow row allows
    assert p.per_lane * p.rows_per_thread == 8
    # the output is the product of its rows and its units: each map is one
    # to one onto the rows and units there are, so every (row, column) is
    # written once
    rows, units = _covered(p, e)
    assert np.array_equal(np.sort(rows), np.arange(e))
    assert np.array_equal(np.sort(units), np.arange(p.width))
    assert p.grid[1] <= 65535 and p.grid[0] < 2 ** 31


def test_plan_splits_wide_rows_across_blocks():
    # the prefill embedding: 2,048 rows of 16 KB fill the card with blocks
    p = ops.plan(2048, 4096, 4)
    assert (p.lanes, p.per_lane, p.rows_per_thread) == (32, 4, 2)
    assert p.grid == (128, 8) and p.grid[0] * p.grid[1] >= 132
    # the GCN's 128 and 256 features: a warp per row, 8 and 4 rows a thread
    assert (ops.plan(1_335_586, 128).per_lane, ops.plan(1_335_586, 128).rows_per_thread) == (1, 8)
    assert (ops.plan(1_335_586, 256).per_lane, ops.plan(1_335_586, 256).rows_per_thread) == (2, 4)
    # narrow rows share a warp: 4-byte elements of 3 columns
    assert ops.plan(9, 3, 4).lanes == 4


def test_plan_constants_are_the_kernels():
    src = (ROOT / "src/repro_torch/kernels/csrc/gather.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == str(ops.THREADS)
    assert "if (width >= 128) return launch_shape<U, 4, 2>" in src
    assert "if (width >= 64) return launch_shape<U, 2, 4>" in src
    assert "launch_shape<U, 1, 8>" in src
    assert "__stcs(" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("e,n,d", [(300, 50, 16), (9, 7, 3), (2, 11, 64), (0, 5, 8)])
def test_gather_matches_jax_in_its_working_type(dtype, e, n, d):
    rng = np.random.default_rng(e + n + d)
    table = rng.normal(size=(n, d)).astype(np.float32)
    rows = rng.integers(0, n, size=e).astype(np.int32)
    if e >= 3:
        rows[:3] = [-1, n, n + 4]
    cot = rng.normal(size=(e, d)).astype(np.float32)
    jt = jnp.asarray(table).astype(JNP[dtype])

    def jax_loss(t):
        out = jax_gather_rows(t, jnp.asarray(rows), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(cot)), out

    (_, want), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(jt)
    tt = torch.tensor(table).to(dtype).requires_grad_(True)
    got = gather_rows(tt, torch.tensor(rows))
    assert got.dtype == dtype and got.shape == (e, d)
    # the gather moves bits: exact
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want).astype(np.float32))
    # the backward is the segment sum of the cotangent, in f32 rounded once
    got.backward(torch.tensor(cot).to(dtype))
    np.testing.assert_allclose(tt.grad.float().numpy(), np.asarray(jgrad).astype(np.float32),
                               rtol=2 * {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
                                         torch.float16: 2.0 ** -11}[dtype], atol=1e-5)
