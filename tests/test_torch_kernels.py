"""The port's kernel wrappers (repro_torch.kernels) against the JAX
package's kernel ops, forward and backward.

On the CPU each wrapper takes its plain version; the JAX ops run their
Pallas kernels in interpret mode, as the JAX package's own tests run them.
Inputs are made with numpy from a seed and pinned to float32 on both sides
(other test modules flip JAX's x64 switch at import). The CUDA kernels
themselves are held against their plain versions in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather.ops import gather_rows as jax_gather_rows
from repro.kernels.matmul.ops import blocked_matmul as jax_blocked_matmul
from repro.kernels.segsum.ops import segment_sum as jax_segment_sum
from repro.kernels.segsum.ref import segment_sum_ref as jax_segment_sum_ref
from repro_torch import kernels
from repro_torch.kernels import blocked_matmul, gather_rows, segment_sum
from repro_torch.kernels.gather.ref import gather_rows_ref
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.segsum.ref import segment_sum_ref

ATOL = 1e-5


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _ids(rng, e, n):
    """Row/segment ids with the padding id -1 and out-of-range ids mixed in."""
    ids = rng.integers(0, max(n, 1), size=e).astype(np.int32)
    if e >= 3:
        ids[0] = -1
        ids[1] = n
        ids[2] = n + 7
    return ids


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    assert kernels.launch_counts() == {
        "segment_sum": 0, "gather_join": 0, "blocked_matmul": 0, "ssm_scan": 0,
    }, "no CUDA kernel may launch for CPU tensors"


# ---------------------------------------------------------------------------
# segment_sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "e,d,s", [(37, 5, 11), (600, 16, 130), (9, 1, 4), (5, 3, 1), (0, 4, 6)]
)
def test_segment_sum_matches_jax(e, d, s):
    rng = np.random.default_rng(e * 31 + d)
    msg = _f32(rng, e, d)
    seg = _ids(rng, e, s)
    cot = _f32(rng, s, d)

    def jax_loss(m):
        if e == 0:
            # the Pallas kernel takes no empty edge list (the compiler's
            # zero-nnz guard never sends one): its plain version stands in
            out = jax_segment_sum_ref(m, jnp.asarray(seg), s)
        else:
            out = jax_segment_sum(m, jnp.asarray(seg), s, interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(msg, jnp.float32)
    )
    tm = torch.tensor(msg, requires_grad=True)
    got = segment_sum(tm, torch.tensor(seg), s)
    got.backward(torch.tensor(cot))
    assert got.shape == (s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgrad), atol=ATOL)


# ---------------------------------------------------------------------------
# gather_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "e,n,d", [(29, 7, 6), (300, 50, 16), (8, 5, 1), (6, 4, 3), (0, 5, 4)]
)
def test_gather_rows_matches_jax(e, n, d):
    rng = np.random.default_rng(e * 17 + n)
    table = _f32(rng, n, d)
    rows = _ids(rng, e, n)
    cot = _f32(rng, e, d)

    def jax_loss(t):
        out = jax_gather_rows(t, jnp.asarray(rows), interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(table, jnp.float32)
    )
    tt = torch.tensor(table, requires_grad=True)
    got = gather_rows(tt, torch.tensor(rows))
    got.backward(torch.tensor(cot))
    assert got.shape == (e, d)
    # a gather moves bits: exact
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), atol=ATOL)


# ---------------------------------------------------------------------------
# blocked_matmul
# ---------------------------------------------------------------------------


U32 = 2.0 ** -24  # unit roundoff of f32


def _dot_bound(a, b):
    """The f64 product ``a @ b`` and, per entry, the f32 dot-product bound
    k·u·Σ|a||b| (k the summed length, u = 2⁻²⁴): any f32 sum of those k
    products, in any order, lies within it of the exact sum."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a @ b, a.shape[1] * U32 * (np.abs(a) @ np.abs(b))


def _within(got, exact, bound):
    return bool((np.abs(np.asarray(got, np.float64) - exact) <= bound).all())


def _hold(got, want, a, b):
    """The port's result and the JAX package's, each against the f64
    product within the f32 dot-product bound, so that neither side's check
    depends on the order its machine's BLAS sums in; the two then agree
    within twice the bound. A result with one term dropped (the last of
    the k) must fail the bound."""
    exact, bound = _dot_bound(a, b)
    assert _within(got, exact, bound), np.abs(got - exact).max()
    assert _within(want, exact, bound), np.abs(want - exact).max()
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dropped = (exact - a64[:, -1:] @ b64[-1:, :]).astype(np.float32)
    assert not _within(dropped, exact, bound), "the bound passes a dropped term"


@pytest.mark.parametrize(
    "m,k,n", [(5, 3, 1), (67, 33, 65), (130, 40, 7), (1, 129, 1), (64, 64, 64)]
)
def test_blocked_matmul_matches_jax(m, k, n):
    """Forward x·y and both gradients, g·yᵀ and xᵀ·g, each held to the f32
    dot-product bound of its own summed length (k, n and m). A fixed
    ``atol`` failed here at (130, 40, 7): dY sums 130 terms to entries near
    36, where 1e-5 is 2.6 ulp, and both sides lie about 1e-5 from the exact
    sum, each well inside its bound."""
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    x, y = _f32(rng, m, k), _f32(rng, k, n)
    cot = _f32(rng, m, n)

    def jax_loss(a, b):
        out = jax_blocked_matmul(a, b, interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), (jgx, jgy) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    )
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    got = blocked_matmul(tx, ty)
    got.backward(torch.tensor(cot))
    _hold(got.detach().numpy(), np.asarray(want), x, y)
    _hold(tx.grad.numpy(), np.asarray(jgx), cot, y.T)
    _hold(ty.grad.numpy(), np.asarray(jgy), x.T, cot)


def test_wrappers_reject_mixed_devices():
    t = torch.zeros(3, 2)
    rows = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        gather_rows(t, rows)
