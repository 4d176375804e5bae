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


# ---------------------------------------------------------------------------
# The SQL front door, NNMF and KGE on the card
# ---------------------------------------------------------------------------

# (E, S): the KGE step's segment sums — forward by position (E = S), the
# table gradient of h/t ids (1,024 into 20,000 and into 200 relations,
# scan path) and of the negatives (204,800 into 20,000, sorted path)
KGE_SEGSUM = [(1024, 1024), (1024, 200), (1024, 20_000), (204_800, 20_000), (204_800, 204_800)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [50, 100])
@pytest.mark.parametrize("e,s", KGE_SEGSUM, ids=str)
def test_cuda_kge_widths_sum_in_the_stated_order_and_gather_exactly(cuda_device, e, s, d):
    """At the KGE widths (a D = 50 row is 200 bytes, not a multiple of 16,
    and takes the narrow units) the segment sum gives the bits of its
    stated order within 2·γ_n·Σ|msg| of index_add_, and the gather copies
    rows exactly."""
    from repro_torch.kernels.segsum.ref import segment_sum_in_kernel_order

    rng = np.random.default_rng(e + s + d)
    ids = np.arange(e) if e == s else rng.integers(0, s, size=e)
    seg = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
    msg = torch.tensor(_f32(rng, e, d), device=cuda_device)
    kernels.reset_launch_counts()
    got = segment_sum(msg, seg, s)
    assert torch.equal(got, segment_sum_in_kernel_order(msg, seg, s))
    terms = torch.bincount(seg.long(), minlength=s).double()[:, None]
    u = 2.0 ** -24
    bound = 2 * terms * u / (1 - terms * u) * segment_sum_ref(msg.abs().double(), seg, s)
    assert bool(((got.double() - segment_sum_ref(msg, seg, s).double()).abs() <= bound).all())
    table = torch.tensor(_f32(rng, s, d), device=cuda_device)
    assert torch.equal(gather_rows(table, seg), gather_rows_ref(table, seg))
    launched = kernels.launch_counts()
    assert launched["segment_sum"] == 1 and launched["gather_join"] == 1
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_rel_matmul_blocked_matches_the_torch_tier(cuda_device):
    from repro_torch.relational import rel_matmul_blocked

    rng = np.random.default_rng(0)
    x = torch.tensor(_f32(rng, 3, 2, 64, 256), device=cuda_device)
    w = torch.tensor(_f32(rng, 2, 4, 256, 32), device=cuda_device)
    g = torch.tensor(_f32(rng, 3, 4, 64, 32), device=cuda_device)
    out = {}
    for dispatch in (None, "torch"):
        kernels.reset_launch_counts()
        tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        with repro_torch.Database(dispatch=dispatch).activate():
            y = rel_matmul_blocked(tx, tw)
            (y * g).sum().backward()
        out[dispatch] = (y.detach(), tx.grad, tw.grad, kernels.launch_counts()["blocked_matmul"])
    y, gx, gw, launched = out[None]
    assert launched == 1 and out["torch"][3] == 0
    fx = x.permute(0, 2, 1, 3).reshape(192, 512)
    fw = w.permute(0, 2, 1, 3).reshape(512, 128)
    err = (y.permute(0, 2, 1, 3).reshape(192, 128).double() - (fx @ fw).double()).abs()
    assert bool((err <= 8 * _rounding_walk(fx, fw)).all())
    torch.testing.assert_close(gx, out["torch"][1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gw, out["torch"][2], atol=1e-4, rtol=1e-5)
    kernels.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["transe", "transr"])
def test_cuda_kge_step_matches_the_plain_path(cuda_device, algo):
    """One TransE/TransR step at a small size: the relational path on the
    kernels against table[ids], within 1e-5 (loss) and 1e-6 (gradients of
    rows summed from a few terms of order 0.05)."""
    from repro_torch.examples import kge

    batch = kge.make_batch(np.random.default_rng(0), n_ent=2000, n_rel=20, batch=128, neg=16,
                           device=cuda_device)
    params = kge.make_params(algo, 50, n_ent=2000, n_rel=20, device=cuda_device)
    kernels.reset_launch_counts()
    with repro_torch.Database().activate():
        _, loss, grads = kge.make_step(algo, kge.rel_embed)(params, *batch)
    launched = kernels.launch_counts()
    assert launched["gather_join"] > 0 and launched["segment_sum"] > 0
    _, p_loss, p_grads = kge.make_step(algo, kge.plain_embed)(params, *batch)
    torch.testing.assert_close(loss, p_loss, atol=0, rtol=1e-5)
    for k in params:
        torch.testing.assert_close(grads[k], p_grads[k], atol=1e-6, rtol=1e-5)
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_sql_logreg_equals_the_fra_query_bit_for_bit(cuda_device):
    """The quickstart's SQL and the same query built in FRA run the same
    kernels on the same data: equal losses and gradients, bit for bit."""
    from repro_torch.core import fra
    from repro_torch.core.kernels import ADD, LOGISTIC, MUL, XENT
    from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj, project_key
    from repro_torch.examples import quickstart

    mm = fra.Agg(project_key(0), ADD, fra.Join(eq_pred((1, 0)), jproj(L(0), L(1)), MUL,
                                               fra.const("Rx", 2), fra.scan("theta", 1)))
    pred = fra.Select(TRUE, identity_key(1), LOGISTIC, mm)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Join(eq_pred((0, 0)), jproj(L(0)), XENT, pred, fra.const("Ry", 1)))
    X, y = quickstart.make_data(4096, 64, device=cuda_device)
    runs = []
    for make in (lambda db: db.query(fra.Query(loss, inputs=("theta",))),
                 lambda db: db.sql(quickstart.LOGREG_SQL, wrt=("theta",))):
        db = repro_torch.Database()
        quickstart.load(db, X, y)
        handle = make(db)
        kernels.reset_launch_counts()
        losses, theta = quickstart.train(db, handle, 5)
        assert kernels.launch_counts()["blocked_matmul"] == 10
        assert handle.lower_count == 1 and not handle.check().errors
        runs.append((handle.query.pretty(), losses, theta))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][2], runs[1][2])
    kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# out-of-core chunk waves: the store's copy stream and a streamed GCN step
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_chunkstore_fetch_on_the_copy_stream_returns_the_host_bits(cuda_device):
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.relation import CooRelation, DenseRelation

    rng = np.random.default_rng(11)
    dense = DenseRelation(torch.tensor(_f32(rng, 300, 7, 5)), 2)
    coo = CooRelation(torch.tensor(_ids(rng, 1000, 50).reshape(500, 2)),
                      torch.tensor(_f32(rng, 500, 3)), (50, 50))
    store = ChunkStore(cuda_device)
    for name, rel, axis in (("D", dense, 1), ("C", coo, 0)):
        mani = store.spill(name, rel, 3, axis=axis)
        for w in range(mani.num_chunks):
            host = store.host_chunk(name, w)
            host_t = [host.data] if name == "D" else [host.keys, host.values]
            assert all(t.is_pinned() for t in host_t)
            f = store.fetch(name, w)
            assert f.event is not None and store._copy_stream != torch.cuda.current_stream()
            got = f.wait()
            got_t = [got.data] if name == "D" else [got.keys, got.values]
            assert all(g.device.type == "cuda" for g in got_t)
            assert all(torch.equal(g.cpu(), h) for g, h in zip(got_t, host_t))
    assert store.stats["fetched_chunks"] == 6
    assert store.stats["fetched_bytes"] == store.stats["spilled_bytes"]


@pytest.mark.cuda
def test_a_fetched_tensor_is_not_reused_while_a_wave_reads_it(cuda_device):
    """The wave's stream is held up (``torch.cuda._sleep``) before it reads
    a fetched chunk; the Python reference is dropped and the next chunk is
    fetched at once. Its copy must not land in the first chunk's memory
    while the wave still has to read it."""
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.relation import DenseRelation

    rows = 1 << 22  # 16 MiB chunks
    data = torch.arange(2 * rows, dtype=torch.float32).reshape(2 * rows, 1)
    store = ChunkStore(cuda_device)
    store.spill("A", DenseRelation(data, 1), 2)
    f = store.fetch("A", 0)
    first = f.wait()
    torch.cuda._sleep(200_000_000)  # ≈ 0.1 s of the current stream
    read = first.data * 1.0          # the wave's read, queued behind the sleep
    del f, first
    second = store.fetch("A", 1).wait()
    torch.cuda.synchronize()
    assert torch.equal(read.cpu(), data[:rows])
    assert torch.equal(second.data.cpu(), data[rows:])


def _gcn_loss_query(n):
    """mean over nodes of Σ_d conv², conv = Σ_dst w · Node[src] (the
    query of tests/test_oocore.py)."""
    from repro_torch.core import fra
    from repro_torch.core.kernels import ADD, MUL, SQUARE, SUM_CHUNK, scale_kernel
    from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj

    conv = fra.Agg(identity_key(1), ADD, fra.Join(eq_pred((0, 0)), jproj(L(1)), MUL,
                                                  fra.scan("Edge", 2), fra.scan("Node", 1)))
    sq = fra.Select(TRUE, identity_key(1), SQUARE, conv)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Select(TRUE, identity_key(1), SUM_CHUNK, sq))
    return fra.Query(fra.Select(TRUE, identity_key(0), scale_kernel(1.0 / n), loss),
                     inputs=("Edge", "Node"))


@pytest.mark.cuda
def test_streamed_gcn_step_on_the_card_equals_the_incore_step(cuda_device):
    """Node features outweigh the edges, so the port streams Edge in
    owner-aligned waves, on the cuda tier. The loss agrees within 1e-5
    relative; dNode adds the waves' partials, so each entry is an f32 sum
    of its K terms and at most ``waves`` zeros in another order than the
    in-core sum: they agree within 2·γ_{K+waves}·Σ|terms|; dEdge is
    computed row by row."""
    from repro_torch.core.engine import StreamedCompiled
    from repro_torch.core.planner import _rel_bytes
    from repro_torch.relational.gcn import partitioned_edges

    g = synthetic_graph(3000, 24_000, 16, 4, seed=0)
    n = 3000
    edge = partitioned_edges(g["edge_keys"], g["edge_w"], n, 1)
    budget = _rel_bytes(edge) / 4 + 3000 * 16 * 4
    results = {}
    for label, kw in (("incore", {}), ("streamed", {"memory_budget": budget})):
        db = repro_torch.Database(**kw)
        db.put("Edge", edge)
        db.put("Node", torch.tensor(g["x"]), keys=("node",))
        h = db.query(_gcn_loss_query(n))
        kernels.reset_launch_counts()
        out, grads = h.step(wrt=("Edge", "Node"))
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        assert launched["segment_sum"] > 0 and launched["gather_join"] > 0, launched
        assert set(h.resolutions.values()) == {"cuda"}, h.resolutions
        results[label] = (h, out, grads)
    h, out, grads = results["streamed"]
    _, out0, grads0 = results["incore"]
    assert isinstance(h.last, StreamedCompiled) and h.last.plan.stream == "Edge"
    assert h.last.plan.owner_aligned and h.last.num_waves >= 4
    loss, loss0 = float(out.data), float(out0.data)
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    assert grads["Edge"].values.device.type == "cpu"  # wave rows merge on the host
    assert torch.equal(grads["Edge"].keys, edge.keys)
    torch.testing.assert_close(grads["Edge"].values, grads0["Edge"].values.cpu(), atol=ATOL, rtol=RTOL)
    # dNode: terms w_e · dconv[dst_e] summed by src, dconv = (2/n)·conv
    keys, w, x = edge.keys.long().to(cuda_device), edge.values.double().to(cuda_device), \
        torch.tensor(g["x"], device=cuda_device).double()
    live = keys[:, 0] >= 0
    src, dst, w = keys[live, 0], keys[live, 1], w[live]
    conv = torch.zeros(n, 16, dtype=torch.float64, device=cuda_device).index_add_(0, dst, w[:, None] * x[src])
    terms = w[:, None] * (2.0 / n) * conv[dst]
    k = torch.bincount(src, minlength=n).double()[:, None] + h.last.num_waves
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    limit = 2 * gamma * torch.zeros_like(conv).index_add_(0, src, terms.abs())
    err = (grads["Node"].data.double() - grads0["Node"].data.double()).abs()
    assert bool((err <= limit).all()), float((err / limit.clamp_min(1e-300)).max())


@pytest.mark.cuda
def test_a_streamed_relation_moves_to_the_host_and_back_for_an_incore_step(cuda_device):
    """Edge fits the budget on its own, so ``put`` keeps it on the card; a
    step that streams it moves the catalog's copy to the host (the device
    then holds Node and one wave), and a later step of a query that holds
    Edge in core moves it back, with the in-core session's result."""
    from repro_torch.core import fra
    from repro_torch.core.engine import StreamedCompiled
    from repro_torch.core.kernels import ADD, SUM_CHUNK
    from repro_torch.core.keys import EMPTY_KEY, TRUE, identity_key
    from repro_torch.core.planner import _rel_bytes
    from repro_torch.relational.gcn import partitioned_edges

    g = synthetic_graph(3000, 24_000, 16, 4, seed=1)
    edge = partitioned_edges(g["edge_keys"], g["edge_w"], 3000, 1)
    node_bytes = 3000 * 16 * 4
    budget = _rel_bytes(edge) + node_bytes / 2  # Edge fits, Edge + Node does not
    # Σ of the edge weights: Edge alone, under the budget, in core
    total = fra.Query(fra.Agg(EMPTY_KEY, ADD, fra.Select(TRUE, identity_key(2), SUM_CHUNK,
                                                         fra.scan("Edge", 2))), inputs=("Edge",))
    dbs = {}
    for label, kw in (("incore", {}), ("budget", {"memory_budget": budget})):
        db = dbs[label] = repro_torch.Database(**kw)
        db.put("Edge", edge)
        db.put("Node", torch.tensor(g["x"]), keys=("node",))
    db = dbs["budget"]
    assert db.get("Edge").keys.device.type == "cuda"
    h = db.query(_gcn_loss_query(3000))
    out, _ = h.step(wrt=("Edge", "Node"))
    assert isinstance(h.last, StreamedCompiled) and h.last.plan.stream == "Edge"
    assert db.get("Edge").keys.device.type == "cpu" and db.get("Node").data.device.type == "cuda"
    again, _ = h.step(wrt=("Edge", "Node"))
    assert torch.equal(out.data, again.data)
    q = db.query(total)
    got = q.forward()
    want = dbs["incore"].query(total).forward()
    assert not isinstance(q.last, StreamedCompiled)
    assert db.get("Edge").keys.device.type == "cuda" and got.data.device.type == "cuda"
    assert torch.equal(got.data, want.data)


# ---------------------------------------------------------------------------
# The OLMoE family on the card
# ---------------------------------------------------------------------------


def _lm_sites(db):
    """(program, key, tier) of every dispatch site that rel_linear's and
    rel_embed's programs lowered under ``db``'s table."""
    from repro_torch.core.engine import engine_for
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog

    out = []
    for label, (prog, *_) in (("rel_linear", _linear_prog()), ("rel_embed", _embed_prog())):
        for part, program in (("forward", prog.forward), *prog.grads.items()):
            for low in engine_for(program).lowerings:
                if low.dispatch == db.dispatch:
                    out += [(f"{label}.{part}", s.key, s.tier) for s in low.resolutions.sites]
    return out


@pytest.mark.cuda
def test_olmoe_serving_and_training_resolve_every_site_to_cuda(cuda_device):
    """A prefill, a decode step and a train step of the reduced olmoe on the
    card: every rel_linear/rel_embed site resolves to the cuda tier, and
    the three kernels launch in each (the MoE's dispatch and combine run
    gather_join and segment_sum)."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import build_model
    from repro_torch.serving import make_decode_step, make_prefill_step
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg, seed=0)
    db = repro_torch.Database(dispatch={"segment_sum": "cuda", "gather_join": "cuda",
                                        "blocked_matmul": "cuda"})
    batch = next(synthetic_lm_batches(cfg, 2, 40, seed=0))
    for run in ("prefill", "decode", "train"):
        kernels.reset_launch_counts()
        with db.activate():
            if run == "prefill":
                logits, caches = make_prefill_step(model, 41)({"tokens": batch["tokens"]})
            elif run == "decode":
                token = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                make_decode_step(model)(token, caches, 40)
            else:
                state = init_train_state(model)
                make_train_step(model, donate=True)(state.params, state.opt_state, batch)
        launched = kernels.launch_counts()
        assert all(launched[op] > 0 for op in ("blocked_matmul", "gather_join", "segment_sum")), (run, launched)
    sites = _lm_sites(db)
    assert sites and all(tier == "cuda" for _, _, tier in sites), sites
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_reduced_olmoe_prefill_on_the_card_matches_the_cpu_run(cuda_device):
    """The same weights prefilled on the card (the CUDA kernels) and on the
    CPU (their plain versions): logits within 1e-5 (products over K ≤ 512
    in other f32 orders, through two layers; the same experts chosen)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import make_prefill_step

    cfg = get_config("olmoe-1b-7b").reduced()
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, seed=1)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 40)), dtype=torch.int32)
    with repro_torch.Database(device="cpu").activate():
        want, want_caches = make_prefill_step(cpu, 48)({"tokens": tokens})
    with repro_torch.Database().activate():
        got, caches = make_prefill_step(card, 48)({"tokens": tokens.to(cuda_device)})
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    kv, want_kv = caches[0]["scan"][1]["0:moe"]["kv"], want_caches[0]["scan"][1]["0:moe"]["kv"]
    torch.testing.assert_close(kv["k"].cpu(), want_kv["k"], atol=1e-5, rtol=1e-5)
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_olmoe_gradients_with_remat_equal_those_without_on_the_card(cuda_device):
    """The cuda tier sums in fixed orders (blocked_matmul, segment_sum,
    gather_rows, the MoE's routing on the last two), so a rematerialized
    backward gives the plain backward's gradients bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import build_model
    from repro_torch.train.losses import lm_loss

    cfg = get_config("olmoe-1b-7b").reduced()
    batch = next(synthetic_lm_batches(cfg, 2, 40, seed=3))
    base = build_model(cfg, seed=0)
    grads = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat), seed=1)
        model.load_state_dict(base.state_dict())
        with repro_torch.Database().activate():
            logits, aux = model.train_logits(batch)
            total = lm_loss(logits, batch["labels"]) + 0.01 * aux
        names, params = zip(*model.named_parameters())
        grads[remat] = dict(zip(names, torch.autograd.grad(total, params)))
    assert all(torch.equal(grads[False][k], grads[True][k]) for k in grads[False])
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_reduced_olmoe_endpoint_on_the_card_coalesces_and_matches_solo_serving(cuda_device):
    """Four concurrent requests through ``db.endpoint`` on the card, after
    ``warmup``: one coalesced batch, no step built or first-called under
    traffic, the three kernels launched, and each completion equal to the
    request served alone through ``make_prefill_step``/``make_decode_step``
    — or, where the two first differ, the solo run's top-2 logits there a
    near tie within ``chip_smoke.ENDPOINT_TIE_LIMIT`` of the largest logit
    (its estimate is for 16 layers at full width; two narrow layers round
    less). A planted compaction that swaps two slots' cache rows must fail
    that check, as in phase 12: the budgets leave two requests with six and
    more tokens to decode on the swapped rows."""
    import asyncio
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import make_decode_step, make_prefill_step, service

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg, seed=0)
    db = repro_torch.Database(max_cache_entries=16)
    db.register_model("olmoe", model, dict(model.named_parameters()))
    ep = db.endpoint("olmoe", cache_len=32, buckets=[(1, 16), (2, 16), (4, 16)])
    ep.warmup()
    warm = db.counters()["serve"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=16) for _ in range(4)]
    budgets = [12, 5, 11, 4]

    async def burst():
        return await asyncio.gather(*[ep.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)])

    kernels.reset_launch_counts()
    outs = asyncio.run(burst())
    launched = kernels.launch_counts()
    c = db.counters()["serve"]
    assert c["batches"] == 1 and c["batched_requests"] == 4 and c["completed"] == 4
    assert c["decode"]["rebuckets"] >= 1
    for phase in ("prefill", "decode"):
        assert c[phase]["compiles"] == warm[phase]["compiles"]
    assert c["decode"]["traces"] == warm["decode"]["traces"]
    assert all(launched[op] > 0 for op in ("blocked_matmul", "gather_join", "segment_sum")), launched
    prefill, decode = make_prefill_step(model, 32, db=db), make_decode_step(model, db=db)
    oracles = []
    for p, n in zip(prompts, budgets):
        logits, caches = prefill({"tokens": torch.tensor(p, dtype=torch.int32, device=cuda_device)[None]})
        solo, gaps = [], []
        for step in range(n):
            lg = logits[0, -1]
            top = lg.topk(2).values
            gaps.append(float((top[0] - top[1]) / lg.abs().max()))
            solo.append(int(lg.argmax()))
            if step + 1 < n:
                logits, caches = decode(torch.tensor([[solo[-1]]], dtype=torch.int32, device=cuda_device),
                                        caches, 16 + step)
        oracles.append((solo, gaps))
    _, bad = cs.hold_to_oracle(outs, oracles, cs.ENDPOINT_TIE_LIMIT)
    assert not bad, bad

    real_take = service._take_cache_batch

    def swapped(caches, idx, bucket_b):
        idx = list(idx)
        if len(idx) > 1:
            idx[0], idx[1] = idx[1], idx[0]
        return real_take(caches, idx, bucket_b)

    service._take_cache_batch = swapped
    try:
        faulty = asyncio.run(burst())
    finally:
        service._take_cache_batch = real_take
    assert cs.hold_to_oracle(faulty, oracles, cs.ENDPOINT_TIE_LIMIT)[1], "the check passes swapped cache rows"
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_windowed_prefill_and_decode_on_the_card_match_the_cpu_run(cuda_device):
    """gemma3 reduced (window 16, attn_chunk 16): a 40-token prefill (the
    window crossing the chunked path's blocks) and three decode steps
    through the right-aligned window caches, on the card and on the CPU
    from the same weights: logits and caches within 1e-5 of the logits'
    and caches' largest entries (products over K ≤ 512 in other f32
    orders, through 8 layers)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import make_decode_step, make_prefill_step
    from repro_torch.serving.serve import map_cache

    cfg = get_config("gemma3-4b").reduced(n_layers=8)
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, seed=1)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 40)), dtype=torch.int32)

    def close(got, want):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, atol=1e-5 * scale, rtol=1e-5)

    runs = {}
    for name, model, db, dev in (("cpu", cpu, repro_torch.Database(device="cpu"), "cpu"),
                                 ("cuda", card, repro_torch.Database(), cuda_device)):
        prefill, decode = make_prefill_step(model, 44, db=db), make_decode_step(model, db=db)
        logits, caches = prefill({"tokens": tokens.to(dev)})
        out = [logits]
        token = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
        for step in range(3):
            logits, caches = decode(token, caches, 40 + step)
            out.append(logits)
        leaves = []
        map_cache(leaves.append, caches)
        runs[name] = (out, leaves)
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        close(got, want)
    assert {t.shape[1] for t in runs["cuda"][1]} == {16, 44}
    for got, want in zip(runs["cuda"][1], runs["cpu"][1]):
        close(got, want)
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_tied_head_train_step_embed_gradient_matches_the_torch_tier(cuda_device):
    """gemma2 reduced: the tied table's gradient (the head's einsum dW plus
    rel_embed's segment-sum table gradient) on the cuda tier against the
    torch tier, on the card, within 1e-5 of its largest entry; every
    kernel launched on the cuda tier and none on the torch tier."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import build_model
    from repro_torch.train.losses import lm_loss

    cfg = get_config("gemma2-9b").reduced()
    model = build_model(cfg, seed=0)
    batch = next(synthetic_lm_batches(cfg, 2, 40, seed=3))
    grads = {}
    for dispatch in ("cuda", "torch"):
        kernels.reset_launch_counts()
        with repro_torch.Database(dispatch=dispatch).activate():
            logits, _ = model.train_logits(batch)
            loss = lm_loss(logits, batch["labels"])
            grads[dispatch], = torch.autograd.grad(loss, [model.embed])
        launched = kernels.launch_counts()
        if dispatch == "cuda":
            assert all(launched[op] > 0 for op in ("blocked_matmul", "gather_join", "segment_sum")), launched
        else:
            assert not sum(launched.values()), launched
    scale = float(grads["torch"].abs().max())
    torch.testing.assert_close(grads["cuda"], grads["torch"], atol=1e-5 * scale, rtol=1e-5)
    kernels.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-small", "qwen2-vl-72b"])
def test_zoo_prefill_and_decode_on_the_card_match_the_cpu_run(cuda_device, arch):
    """deepseek-v3 (3 layers: the stage boundary, MLA's latent cache),
    whisper (the encoder's output fed to every decode step) and qwen2-vl
    (the patches before the prompt, decode at seq + vis) reduced: a
    prefill of 20 tokens and three decode steps on the card and on the CPU
    from the same weights, logits and caches within 1e-5 of their largest
    entries (products over K ≤ 2,048 in other f32 orders, the MoE's experts
    chosen alike); every kernel launched on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.models import build_model
    from repro_torch.serving import make_decode_step, make_encode_step, make_prefill_step
    from repro_torch.serving.serve import map_cache

    cfg = get_config(arch).reduced(**({"n_layers": 3} if arch.startswith("deepseek") else {}))
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, seed=1)
    card.load_state_dict(cpu.state_dict())
    batch = batch_for(cfg, 2, 20, np.random.default_rng(0), device="cpu")
    batch.pop("labels")
    runs = {}
    for name, model, db, dev in (("cpu", cpu, repro_torch.Database(device="cpu"), "cpu"),
                                 ("cuda", card, repro_torch.Database(), cuda_device)):
        kernels.reset_launch_counts()
        b = {k: v.to(dev) for k, v in batch.items()}
        logits, caches = make_prefill_step(model, 20 + cfg.vis_seq + 3, db=db)(b)
        enc = make_encode_step(model, db=db)(b["frames"]) if cfg.encoder_layers else None
        out, decode = [logits], make_decode_step(model, db=db)
        token = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
        for step in range(3):
            logits, caches = decode(token, caches, 20 + cfg.vis_seq + step, enc_out=enc)
            out.append(logits)
        leaves = []
        map_cache(leaves.append, caches)
        runs[name] = (out, leaves, kernels.launch_counts())
    assert all(runs["cuda"][2][op] > 0 for op in ("blocked_matmul", "gather_join", "segment_sum"))
    for got, want in zip(runs["cuda"][0] + runs["cuda"][1], runs["cpu"][0] + runs["cpu"][1]):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, atol=1e-5 * scale, rtol=1e-5)
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_launch_record_equals_each_contracts_model(cuda_device):
    """One shape per kernel path: the C entry points' launch record (kernel,
    gridDim, blockDim of each launch of the last call) equals the launches
    of the kernel's contract model, built from its ``plan()``; a model one
    column slab short does not."""
    import dataclasses

    from repro_torch.analysis.kernelcheck import launch_mismatch
    from repro_torch.core import kernels as K
    from repro_torch.kernels.common import last_launches
    from repro_torch.kernels.gather.ops import gather_rows_forward
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward
    from repro_torch.kernels.segsum.ops import segment_sum_forward
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_forward

    dev, f32 = cuda_device, torch.float32
    for e, d, s in ((3000, 96, 500), (20_000, 256, 5000), (20_000, 50, 3)):  # scan; sorted
        msg = torch.randn(e, d, device=dev)
        seg = torch.arange(e, device=dev, dtype=torch.int32) % s
        segment_sum_forward(msg, seg, s)
        info = {"nnz": e, "dim": d, "num_segments": s, "dtype": f32}
        assert launch_mismatch("segment_sum", info, last_launches()) is None
    for e, n, d in ((50_000, 3000, 128), (1024, 20_000, 50), (2, 65_024, 4096)):  # 16-byte; element
        table = torch.randn(n, d, device=dev)
        gather_rows_forward(table, torch.arange(e, device=dev, dtype=torch.int32) % n)
        info = {"rows": e, "num_rows": n, "dim": d, "dtype": f32}
        record = last_launches()
        assert launch_mismatch("gather_join", info, record) is None
        good = K.kernel_contract("gather_join").grid_model(info)
        if good.grid[1] > 1:
            short = dataclasses.replace(good, grid=(good.grid[0], good.grid[1] - 1))
            assert launch_mismatch("gather_join", info, record, model=short) is not None
    for m, k, n in ((300, 4096, 700), (100, 2000, 300), (2, 4096, 14_576), (4, 40_000, 8), (3, 0, 4)):
        blocked_matmul_forward(torch.randn(m, k, device=dev), torch.randn(k, n, device=dev))
        info = {"m": m, "k": k, "n": n, "dtype": f32}
        assert launch_mismatch("blocked_matmul", info, last_launches()) is None
    for reverse in (False, True):
        a = torch.rand(2, 64, 24, 16, device=dev)
        ssm_scan_forward(a, torch.randn_like(a), reverse)
        info = {"batch": 2, "seq": 64, "channels": 24, "state": 16, "dtype": f32, "reverse": reverse}
        assert launch_mismatch("ssm_scan", info, last_launches()) is None
