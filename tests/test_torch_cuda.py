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
    assert launched["gather_join"] == (1 if e else 0)
    # the segment sum writes every output row itself, zeros too: it
    # launches whenever the output is not empty
    assert launched["segment_sum"] == 1
    kernels.reset_launch_counts()


def _rounding_walk(x, y):
    """Per entry of x @ y, √K·u·sqrt(Σ x²y²): the size of the rounding walk
    of an f32 sum of its K products (u = 2⁻²⁴)."""
    return x.shape[1] ** 0.5 * 2.0 ** -24 * ((x.double() ** 2) @ (y.double() ** 2)).sqrt()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 40, 288])
@pytest.mark.parametrize("k", [1, 3, 511, 512, 513, 8192])
@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 33])
def test_cuda_matmul_across_the_path_crossover(cuda_device, m, k, n):
    """Both paths (split-K at m ≤ 16, tiles above) and both copy widths
    (16-byte when K or N is a multiple of 4, 4-byte otherwise) stay within
    8 rounding walks of cuBLAS's f32 product."""
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward

    rng = np.random.default_rng(m * 100_003 + k * 7 + n)
    x = torch.tensor(_f32(rng, m, k), device=cuda_device)
    y = torch.tensor(_f32(rng, k, n), device=cuda_device)
    kernels.reset_launch_counts()
    got = blocked_matmul_forward(x, y)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["blocked_matmul"] == 1
    err = (got.double() - matmul_ref(x, y).double()).abs()
    assert bool((err <= 8 * _rounding_walk(x, y)).all()), float(err.max())
    kernels.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 4096, 700), (2048, 8192, 288), (170, 128, 256),
                                   (40, 1000, 130), (129, 513, 3)])
def test_cuda_matmul_rows_do_not_depend_on_the_batch(cuda_device, m, k, n):
    """Rows of the tiled product equal, bit for bit, the split-K product of
    those rows alone: one summation order per entry, whatever m is."""
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward

    rng = np.random.default_rng(m + k + n)
    x = torch.tensor(_f32(rng, m, k), device=cuda_device)
    y = torch.tensor(_f32(rng, k, n), device=cuda_device)
    big = blocked_matmul_forward(x, y)
    for rows in (slice(0, 2), slice(0, 16), slice(m - 3, m), slice(m // 2, m // 2 + 1)):
        small = blocked_matmul_forward(x[rows].contiguous(), y)
        assert torch.equal(big[rows], small), rows
    kernels.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2, 1100, 37), (40, 1100, 37), (3, 1, 5), (130, 96, 129)])
def test_cuda_matmul_sums_in_its_stated_order(cuda_device, m, k, n):
    """Both paths give the bits of ref.matmul_in_kernel_order: fused
    multiply-adds in ascending K within segments of 512, the segment sums
    added in order."""
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward
    from repro_torch.kernels.matmul.ref import matmul_in_kernel_order

    rng = np.random.default_rng(m + k)
    x, y = _f32(rng, m, k), _f32(rng, k, n)
    got = blocked_matmul_forward(torch.tensor(x, device=cuda_device),
                                 torch.tensor(y, device=cuda_device))
    assert torch.equal(got.cpu(), matmul_in_kernel_order(torch.tensor(x), torch.tensor(y)))
    kernels.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2, 4096, 16384), (1, 1 << 20, 64), (300, 4096, 700)])
def test_cuda_matmul_repeats_its_bits(cuda_device, m, k, n):
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward

    rng = np.random.default_rng(k)
    x = torch.tensor(_f32(rng, m, k), device=cuda_device)
    y = torch.tensor(_f32(rng, k, n), device=cuda_device)
    assert torch.equal(blocked_matmul_forward(x, y), blocked_matmul_forward(x, y))
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


def _planted_ids(rng, e, s, hot):
    """Random ids over S with ``hot`` of them in segment S // 3 (past the
    kernel's chunk of 256 terms when hot > 256), only even ids elsewhere
    (half the segments empty), and padding ids mixed in."""
    seg = 2 * rng.integers(0, max(s // 2, 1), size=e)
    seg[rng.permutation(e)[:hot]] = s // 3
    if e >= 3:
        seg[rng.permutation(e)[:3]] = [-1, s, s + 5]
    return torch.tensor(seg, dtype=torch.int32)


SEGSUM_CASES = [
    # (E, S, D): the scan path (E <= 4,096), then the sorted path
    (9, 7, 3, 0), (2, 2, 4096, 0), (2048, 2048, 4096, 0), (3000, 50, 128, 1000),
    (4096, 300, 130, 0), (4097, 300, 256, 0), (20_000, 1000, 256, 5000),
    (60_000, 7000, 128, 300), (30_000, 40, 8, 12_000), (5000, 1, 1, 5000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("e,s,d,hot", SEGSUM_CASES, ids=str)
def test_cuda_segment_sum_sums_in_its_stated_order(cuda_device, e, s, d, hot, dtype):
    """Both paths give the bits of ref.segment_sum_in_kernel_order (chunks
    of 256 terms in ascending edge order, chunk sums added in order), call
    after call, and each path gives the other's bits."""
    from repro_torch.kernels.segsum.ops import run, segment_sum_forward
    from repro_torch.kernels.segsum.ref import segment_sum_in_kernel_order

    rng = np.random.default_rng(e + s + d)
    seg = _planted_ids(rng, e, s, hot).to(cuda_device)
    msg = torch.tensor(_f32(rng, e, d), device=cuda_device).to(dtype)
    kernels.reset_launch_counts()
    got = segment_sum_forward(msg, seg, s)
    assert kernels.launch_counts()["segment_sum"] == 1
    want = segment_sum_in_kernel_order(msg, seg, s)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(segment_sum_forward(msg, seg, s), got)
    for path in ("scan", "sorted"):
        out = torch.empty_like(got)
        run(msg, seg, out, path)
        assert torch.equal(out, got), path
    kernels.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("e,n,d", [(2, 65_024, 4096), (2048, 65_024, 4096), (50_000, 3000, 128),
                                   (20_000, 3000, 256), (9, 7, 3), (9, 7, 130), (3, 5, 1)])
def test_cuda_gather_is_exact_in_every_working_type(cuda_device, e, n, d, dtype):
    rng = np.random.default_rng(e + d)
    table = torch.tensor(_f32(rng, n, d), device=cuda_device).to(dtype)
    rows = torch.tensor(_ids(rng, e, n), device=cuda_device)
    assert torch.equal(gather_rows(table, rows), gather_rows_ref(table, rows))
    # a table that is not 16-byte aligned takes the element-wise copy
    shifted = table.reshape(-1)[1:1 + (n - 1) * d].reshape(n - 1, d) if d % 8 == 0 else table
    assert torch.equal(gather_rows(shifted, rows), gather_rows_ref(shifted, rows))
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_segment_sum_refuses_what_the_kernel_does_not_take(cuda_device):
    msg = torch.zeros(4, 3, dtype=torch.float64, device=cuda_device)
    seg = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        segment_sum(msg, seg, 2)
    with pytest.raises(TypeError, match="int32"):
        segment_sum(msg.float(), seg.long(), 2)
    with pytest.raises(ValueError, match="does not match"):
        segment_sum(msg.float(), seg[:3], 2)


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
    gcn_kernels = ("segment_sum", "gather_join", "blocked_matmul")
    assert all(launched[op] > 0 for op in gcn_kernels), launched
    kernels.reset_launch_counts()
    t_loss, t_grads = step("torch")
    assert sum(kernels.launch_counts().values()) == 0
    torch.testing.assert_close(loss, t_loss, atol=ATOL, rtol=RTOL)
    for k in params:
        torch.testing.assert_close(grads[k], t_grads[k], atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# ssm_scan and the falcon-mamba serving path
# ---------------------------------------------------------------------------


def _decay_and_input(rng, shape):
    a = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    return a, rng.normal(size=shape).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 24, 16), (1, 1, 8, 16), (3, 37, 5, 3), (2, 0, 4, 4)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_ssm_scan_matches_its_plain_version(cuda_device, shape, dtype, reverse):
    """The kernel rounds a_t·h and then + b_t separately, as the plain loop
    does, with the same f32 state: the two agree bit for bit."""
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_forward
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    a, b = _decay_and_input(np.random.default_rng(sum(shape)), shape)
    a = torch.tensor(a, device=cuda_device).to(dtype)
    b = torch.tensor(b, device=cuda_device).to(dtype)
    kernels.reset_launch_counts()
    got = ssm_scan_forward(a, b, reverse=reverse)
    want = ssm_scan_ref(a, b, reverse=reverse)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert kernels.launch_counts()["ssm_scan"] == (1 if a.numel() else 0)
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_ssm_scan_backward_matches_autograd_of_its_plain_version(cuda_device):
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    a, b = _decay_and_input(np.random.default_rng(7), (2, 40, 6, 4))
    grads = []
    for fn in (ssm_scan, ssm_scan_ref):
        ta = torch.tensor(a, device=cuda_device, requires_grad=True)
        tb = torch.tensor(b, device=cuda_device, requires_grad=True)
        torch.tanh(fn(ta, tb)).sum().backward()
        grads.append((ta.grad, tb.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_ssm_scan_refuses_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels import ssm_scan

    x = torch.zeros(1, 4, 2, 2, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        ssm_scan(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(x.transpose(2, 3), x.transpose(2, 3))


@pytest.mark.cuda
def test_reduced_falcon_mamba_serves_through_the_kernels(cuda_device):
    """Prefill and two greedy decode steps of the reduced falcon-mamba on
    the card: ssm_scan launches once per layer in the prefill and never in
    decode; the logits agree with the torch tier running the plain parallel
    prefix (1e-4: the products take other f32 orders over K ≤ 512 terms,
    through two layers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import make_decode_step, make_prefill_step

    cfg = get_config("falcon-mamba-7b").reduced(ssm_pallas=True)
    model = build_model(cfg, seed=0)
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 16)),
                          dtype=torch.int32, device=cuda_device)
    kernels.reset_launch_counts()
    with repro_torch.Database().activate():
        logits, caches = make_prefill_step(model, 16)({"tokens": tokens})
        assert kernels.launch_counts()["ssm_scan"] == cfg.n_layers
        for step in range(2):
            token = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            logits, caches = make_decode_step(model)(token, caches, 16 + step)
        assert kernels.launch_counts()["ssm_scan"] == cfg.n_layers
    kernels.reset_launch_counts()
    model.cfg = dataclasses.replace(cfg, ssm_pallas=False)
    with repro_torch.Database(dispatch="torch").activate():
        t_logits, _ = make_prefill_step(model, 16)({"tokens": tokens})
    model.cfg = cfg
    assert sum(kernels.launch_counts().values()) == 0
    with repro_torch.Database().activate():
        logits, _ = make_prefill_step(model, 16)({"tokens": tokens})
    torch.testing.assert_close(logits, t_logits, atol=1e-4, rtol=1e-4)
    kernels.reset_launch_counts()
