"""The port's selective scan (``repro_torch.kernels.ssm_scan`` and
``models/ssm.py::selective_scan``) against the JAX package's.

On the CPU the port's wrapper takes its plain version (a time loop); the
JAX op runs its Pallas kernel in interpret mode, ``ssm_scan(a, b, 32, 8,
True, True)``, as ``tests/test_ssm_scan_kernel.py`` runs it. Inputs are made
with numpy from a seed and pinned to float32 or bfloat16 on both sides
(other test modules flip JAX's x64 switch at import). The CUDA kernel is
held against its plain version in ``test_torch_cuda.py``.

Tolerances:
- f32 scan: 1e-5 absolute and relative. Both sides run the same recurrence
  in the same order with an f32 state; they may differ only where one side
  fuses ``a·h + b`` into one FMA, a rounding of 2⁻²⁴ per step on values of
  order 1, which the decay a ≤ 1 keeps from growing.
- bf16 scan: 2⁻⁷ relative (one bf16 rounding) plus 1e-6 absolute: the f32
  states agree as above, but where a state lies near a bf16 rounding
  boundary the two stored values may land one bf16 step apart.
- VJP: 1e-4 relative, 1e-5 absolute, the JAX package's own bound for its
  custom VJP against AD of its oracle: the gradient is a second scan over
  tanh' of the first, so it carries both scans' roundings.
- selective_scan: 1e-5, as the f32 scan; the two parallel prefixes pair the
  steps in other trees (Hillis–Steele here, jax.lax.associative_scan's
  odd/even recursion there), so they agree to rounding, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan import ssm_scan_ref as jax_ssm_scan_ref
from repro.models.ssm import selective_scan as jax_selective_scan
from repro_torch import kernels
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.ssm import selective_scan

F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6


def _inputs(shape, seed):
    """A decay a ∈ [0.3, 1) and an input b ~ N(0, 1), as f32 numpy."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    return a, b


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert kernels.launch_counts()["ssm_scan"] == 0, "no CUDA kernel may launch for CPU tensors"


# The shapes of tests/test_ssm_scan_kernel.py, then shapes whose S and C the
# JAX wrapper's 32×8 tiles do not divide (it shrinks them, down to 1×1), a
# single step, and a zero-length sequence.
SHAPES = [
    (1, 32, 8, 4), (2, 128, 16, 16), (3, 64, 24, 8),
    (1, 48, 6, 4), (2, 33, 7, 3), (1, 1, 5, 16),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_matches_jax_pallas_kernel(shape, dtype):
    a, b = _inputs(shape, seed=sum(shape))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_ssm_scan(jnp.asarray(a, jdt), jnp.asarray(b, jdt), 32, 8, True, True)
    got = ssm_scan(torch.tensor(a).to(tdt), torch.tensor(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    if dtype == "float32":
        rtol, atol = F32_TOL, F32_TOL
    else:
        rtol, atol = BF16_RTOL, BF16_ATOL
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol
    )


def test_ssm_scan_matches_jax_oracle_at_a_long_ragged_shape():
    """S = 257 (prime after a power of two) and C·N = 5·3: the JAX wrapper
    shrinks its tiles to 1×1 here, so the oracle (the associative scan) is
    the cheaper reference."""
    a, b = _inputs((2, 257, 5, 3), seed=11)
    want = jax_ssm_scan_ref(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    got = ssm_scan(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_empty_sequence_gives_an_empty_scan():
    a = torch.zeros((2, 0, 3, 4))
    assert tuple(ssm_scan(a, a).shape) == (2, 0, 3, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reverse_walk_is_the_time_flipped_scan(dtype):
    a, b = _inputs((2, 19, 3, 5), seed=3)
    a, b = torch.tensor(a).to(dtype), torch.tensor(b).to(dtype)
    got = scan_ops.ssm_scan_forward(a, b, reverse=True)
    want = ssm_scan_ref(a.flip(1), b.flip(1)).flip(1)
    assert torch.equal(got, want)


def test_ssm_scan_vjp_matches_jax_grad():
    a, b = _inputs((1, 32, 8, 4), seed=5)

    def loss_jax(a, b):
        return jnp.sum(jnp.tanh(jax_ssm_scan(a, b, 16, 8, True, True)))

    ja, jb = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    torch.tanh(ssm_scan(ta, tb)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)


def test_ssm_scan_vjp_matches_autograd_of_the_plain_loop():
    """The custom backward (a reverse scan) against torch autograd through
    the plain version's time loop, in bf16 too (gradients in bf16, so one
    bf16 rounding apart at most, on values of order 1)."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)):
        a, b = _inputs((2, 24, 3, 4), seed=9)
        grads = []
        for fn in (ssm_scan, ssm_scan_ref):
            ta = torch.tensor(a).to(dtype).requires_grad_(True)
            tb = torch.tensor(b).to(dtype).requires_grad_(True)
            torch.tanh(fn(ta, tb).float()).sum().backward()
            grads.append((ta.grad.float(), tb.grad.float()))
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    a = torch.zeros((1, 4, 2, 2))
    with pytest.raises(TypeError):
        scan_ops._check(a.half(), a.half())
    with pytest.raises(TypeError):
        scan_ops._check(a.double(), a.double())
    with pytest.raises(ValueError):
        scan_ops._check(a.transpose(2, 3), a.transpose(2, 3))
    with pytest.raises(ValueError):
        scan_ops._check(a, a.bfloat16())
    with pytest.raises(ValueError):
        scan_ops._check(a[0], a[0])


@pytest.mark.parametrize("chunk", [0, 8, 16, 100])
def test_selective_scan_matches_jax(chunk):
    a, b = _inputs((2, 48, 6, 4), seed=chunk + 1)
    want = jax_selective_scan(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), chunk)
    got = selective_scan(torch.tensor(a), torch.tensor(b), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
