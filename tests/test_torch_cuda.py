"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where there is no CUDA device:
the kernels are built by nvcc at first use and run only on the card. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import kernels
from repro_torch.data import synthetic_graph
from repro_torch.kernels import blocked_matmul, gather_rows, segment_sum
from repro_torch.kernels.gather.ref import gather_rows_ref
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.segsum.ref import segment_sum_ref
from repro_torch.relational import gcn_conv, rel_linear

# The GCN step at this size: losses and gradients of order 1 at most, from
# f32 sums of a few dozen terms taken in other orders by the two tiers
ATOL = RTOL = 1e-5


def _assert_within_sum_bound(got, want, n, magnitude):
    """Two f32 sums of the same ``n`` terms in different orders (atomics,
    cuBLAS's blocking) each lie within γ_n·Σ|term| of the exact sum, so they
    differ by at most 2·γ_n·``magnitude``, γ_n = n·u/(1 − n·u), u = 2⁻²⁴."""
    u = 2.0 ** -24
    gamma = n * u / (1 - n * u)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 2 * gamma * magnitude.double()).all()), float(err.max())


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,d", [(1000, 97, 128), (13, 5, 3), (0, 5, 4), (9, 4, 1)])
def test_cuda_kernels_match_plain_versions(cuda_device, e, n, d):
    rng = np.random.default_rng(e + n + d)
    table = torch.tensor(_f32(rng, n, d), device=cuda_device)
    rows = torch.tensor(_ids(rng, e, n), device=cuda_device)
    msg = torch.tensor(_f32(rng, e, d), device=cuda_device)
    kernels.reset_launch_counts()
    assert torch.equal(gather_rows(table, rows), gather_rows_ref(table, rows))
    _assert_within_sum_bound(
        segment_sum(msg, rows, n), segment_sum_ref(msg, rows, n), max(e, 1),
        segment_sum_ref(msg.abs(), rows, n),
    )
    x = torch.tensor(_f32(rng, n, d), device=cuda_device)
    y = torch.tensor(_f32(rng, d, 7), device=cuda_device)
    _assert_within_sum_bound(blocked_matmul(x, y), matmul_ref(x, y), d, x.abs() @ y.abs())
    launched = kernels.launch_counts()
    assert launched["blocked_matmul"] == 1
    assert launched["gather_join"] == launched["segment_sum"] == (1 if e else 0)
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(4, 4, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        blocked_matmul(x, x)
    y = torch.zeros(4, 8, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        blocked_matmul(y, y)
    rows = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(torch.zeros(4, 4, device=cuda_device), rows)


@pytest.mark.cuda
def test_gcn_step_on_the_cuda_tier_matches_the_torch_tier(cuda_device):
    g = synthetic_graph(64, 256, 8, 4, seed=0)
    keys = torch.tensor(g["edge_keys"], device=cuda_device)
    w = torch.tensor(g["edge_w"], device=cuda_device)
    x = torch.tensor(g["x"], device=cuda_device)
    y = torch.tensor(g["y"], device=cuda_device).long()
    rng = np.random.default_rng(0)
    params = {"w1": _f32(rng, 8, 16) * 8 ** -0.5, "w2": _f32(rng, 16, 4) * 16 ** -0.5}

    def step(dispatch):
        p = {k: torch.tensor(v, device=cuda_device, requires_grad=True) for k, v in params.items()}
        with repro_torch.Database(dispatch=dispatch).activate():
            h = torch.relu(rel_linear(gcn_conv(x, keys, w), p["w1"]))
            logits = rel_linear(gcn_conv(h, keys, w), p["w2"])
            loss = torch.nn.functional.cross_entropy(logits, y)
            loss.backward()
        return loss.detach(), {k: v.grad for k, v in p.items()}

    kernels.reset_launch_counts()
    loss, grads = step(None)
    launched = kernels.launch_counts()
    assert all(n > 0 for n in launched.values()), launched
    kernels.reset_launch_counts()
    t_loss, t_grads = step("torch")
    assert sum(kernels.launch_counts().values()) == 0
    torch.testing.assert_close(loss, t_loss, atol=ATOL, rtol=RTOL)
    for k in params:
        torch.testing.assert_close(grads[k], t_grads[k], atol=ATOL, rtol=RTOL)
