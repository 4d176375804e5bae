#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   GCN slice's shapes and at edge cases, within a stated tolerance;
3. train the two-layer GCN of examples/gcn_train.py full-graph at
   ogbn-arxiv size (169,343 nodes, 1,166,243 edges + self loops, 128
   features, 40 classes, hidden 256) for 5 Adam steps through
   ``repro_torch.Database()``, check that every dispatch site ran the CUDA
   kernels, that the loss falls, and that step 1 agrees with the plain
   ``torch`` tier;
4. step the FRA logistic regression (paper §2.3, 1,048,576 × 64) through
   ``Database.query(...).step()``;
5. time each kernel at the shapes of one GCN step beside its plain
   version, one PyTorch library call and the card's bound.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is one JSON object with a record per kernel, and the line
before that the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit):
#: device-memory rate and f32 rate on the CUDA cores (no tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
U32 = 2.0 ** -24  # unit roundoff of f32

# ogbn-arxiv at its published size (benchmarks/gcn.py "arxiv-mini"); the
# generator adds one self loop per node
NODES, EDGES, FEAT, CLASSES, HIDDEN = 169_343, 1_166_243, 128, 40, 256
GCN_STEPS, GCN_LR = 5, 0.05
LOGREG_ROWS, LOGREG_COLS, LOGREG_STEPS = 1_048_576, 64, 10
DEVICE = "cuda"
#: the products of one GCN step that the compiler leaves to torch.einsum,
#: as the reference leaves them to jnp.einsum: the RJP queries of
#: rel_linear, dX = g·Wᵀ and dW = Xᵀ·g, as (m, k, n, what)
RJP_SHAPES = (
    (FEAT, NODES, HIDDEN, "layer-1 dW = Xᵀ·g"),
    (HIDDEN, NODES, CLASSES, "layer-2 dW = Xᵀ·g"),
    (NODES, HIDDEN, FEAT, "layer-1 dX = g·Wᵀ"),
    (NODES, CLASSES, HIDDEN, "layer-2 dX = g·Wᵀ"),
)
#: limits in multiples of rounding_walk(): a kernel's product against its
#: plain version, and a weight gradient of the cuda tier against the torch
#: tier's
MATMUL_LIMIT, GRAD_LIMIT = 8, 2


def log(*parts) -> None:
    print(*parts, flush=True)


def gamma(n):
    """γ_n = n·u / (1 − n·u): the rounding-error factor of an f32 sum of n
    terms (a tensor of n's or a number)."""
    return n * U32 / (1 - n * U32)


def rounding_walk(x, y):
    """Per entry of ``x @ y`` (f64 result), √K·u·sqrt(Σ_k x²y²): the size
    of the rounding error of an f32 sum of its K products. Each partial sum
    is rounded once, and the partial sums of random-sign terms grow like a
    random walk, so the error's standard deviation is about 0.4 of this.
    Unlike the worst case γ_K·Σ|x||y|, it stays far below the entries
    themselves at long K, so a product that misses any part of K fails."""
    return math.sqrt(x.shape[1]) * U32 * ((x.double() ** 2) @ (y.double() ** 2)).sqrt()


def excess(err, limit) -> float:
    """The largest err/limit over the entries (0 for none); an entry whose
    limit is 0 must have no error."""
    if not err.numel():
        return 0.0
    return float((err / limit.clamp_min(1e-300)).max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, kern, graph, dev):
    from repro_torch.kernels.gather.ref import gather_rows_ref
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.segsum.ref import segment_sum_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"segment_sum": 0.0, "gather_join": 0.0, "blocked_matmul": 0.0}

    def gather_case(n, rows, d, what):
        table = torch.randn(n, d, device=dev, generator=gen)
        got, want = kern.gather_rows(table, rows), gather_rows_ref(table, rows)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        log(f"  gather_rows {what}: E={rows.numel()} N={n} D={d} exact={ok} max_abs_err={err:.3e}")
        if not ok:
            raise AssertionError(f"gather_rows differs from its plain version ({what})")
        errs["gather_join"] = max(errs["gather_join"], err)

    def segsum_case(s, seg, d, what):
        # both results are f32 sums of the same terms in different orders
        # (the kernel's atomics, index_add_'s): each lies within
        # γ_{n_s}·Σ|msg| of the exact sum of segment s, n_s its term count
        msg = torch.randn(seg.numel(), d, device=dev, generator=gen)
        got, want = kern.segment_sum(msg, seg, s), segment_sum_ref(msg, seg, s)
        valid = seg[(seg >= 0) & (seg < s)].long()
        terms = torch.bincount(valid, minlength=s).double()[:, None]
        bound = 2 * gamma(terms) * segment_sum_ref(msg.abs().double(), seg, s) + 1e-30
        err = (got.double() - want.double()).abs()
        worst = float((err / bound).max()) if err.numel() else 0.0
        log(f"  segment_sum {what}: E={seg.numel()} S={s} D={d} "
            f"max_abs_err={float(err.max()) if err.numel() else 0.0:.3e} "
            f"err/bound={worst:.3e} (bound 2·γ_n·Σ|msg| per segment)")
        if worst > 1.0:
            raise AssertionError(f"segment_sum outside its tolerance ({what})")
        if err.numel():
            errs["segment_sum"] = max(errs["segment_sum"], float(err.max()))

    def matmul_case(m, k, n, what):
        # f32 dot products of length k in two orders (the kernel's
        # sequential fmaf, cuBLAS's blocking): each differs from the exact
        # product by a few rounding walks, so they differ from each other
        # by at most MATMUL_LIMIT of them
        x = torch.randn(m, k, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        got, want = kern.blocked_matmul(x, y), matmul_ref(x, y)
        limit = MATMUL_LIMIT * rounding_walk(x, y)
        exact = x.double() @ y.double()
        err = (got.double() - want.double()).abs()
        worst = excess(err, limit)
        log(f"  blocked_matmul {what}: ({m}x{k})@({k}x{n}) "
            f"max_abs_err={float(err.max()) if err.numel() else 0.0:.3e} "
            f"err/limit={worst:.3e} (limit {MATMUL_LIMIT}·√K·u·sqrt(x²@y²) per entry); "
            f"vs f64, err/limit: kernel {excess((got.double() - exact).abs(), limit):.3e} "
            f"plain {excess((want.double() - exact).abs(), limit):.3e}")
        if worst > 1.0:
            raise AssertionError(f"blocked_matmul outside its tolerance ({what})")
        if err.numel():
            errs["blocked_matmul"] = max(errs["blocked_matmul"], float(err.max()))
        if k >= 1 << 16:
            # the limit must fail a wrong product at this K: plant two faults
            tile = slice(k // 2, k // 2 + 16)  # one of the kernel's K-tiles
            for fault, bad in (("zeros", torch.zeros_like(got)),
                               ("one K-tile dropped", got - x[:, tile] @ y[tile, :])):
                seen = excess((bad.double() - want.double()).abs(), limit)
                log(f"    planted fault ({fault}): err/limit={seen:.3e}, must exceed 1")
                if seen <= 1.0:
                    raise AssertionError(f"the blocked_matmul limit passes a wrong product ({what})")

    src, dst = graph["src"], graph["dst"]
    for d in (FEAT, HIDDEN):
        gather_case(NODES, src, d, "slice (rows = edge src)")
        gather_case(NODES, dst, d, "slice (rows = edge dst)")
        segsum_case(NODES, dst, d, "slice (seg = edge dst)")
        segsum_case(NODES, src, d, "slice (seg = edge src)")
    # edge cases: empty, padding and out-of-range ids, narrow rows
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    odd = torch.tensor([3, -1, 0, 7, 9, 2, -5, 4, 4], dtype=torch.int32, device=dev)
    for d in (1, 3, 4, 130):
        gather_case(7, odd, d, "edge ids -1/>=N")
        segsum_case(7, odd, d, "edge ids -1/>=S")
        gather_case(5, empty, d, "E=0")
        segsum_case(5, empty, d, "E=0")
    for m, k, n, what in (
        (NODES, FEAT, HIDDEN, "layer-1 forward"),
        (NODES, HIDDEN, CLASSES, "layer-2 forward"),
        *RJP_SHAPES,  # off the main path; long K, ragged K
        (67, 33, 65, "ragged"), (5, 3, 1, "ragged"), (1, 1, 1, "ragged"),
        (3, 0, 4, "K=0"),
        (LOGREG_ROWS, LOGREG_COLS, 1, "logreg forward"),
        (1, LOGREG_ROWS, LOGREG_COLS, "logreg dθ"),
    ):
        matmul_case(m, k, n, what)
    return errs


# ---------------------------------------------------------------------------
# Phase 3: the GCN at ogbn-arxiv size
# ---------------------------------------------------------------------------


def op_sites(table):
    """Every dispatch site the relational ops lowered under ``table``:
    (program, key, op, tier, info) — each lowering runs once per step."""
    from repro_torch.core.engine import engine_for
    from repro_torch.relational.gcn import _gcn_prog
    from repro_torch.relational.linear import _linear_prog

    out = []
    for label, (prog, _) in (("gcn_conv", _gcn_prog()), ("rel_matmul", _linear_prog())):
        for part, program in (("forward", prog.forward), *prog.grads.items()):
            for low in engine_for(program).lowerings:
                if low.dispatch == table:
                    for s in low.resolutions.sites:
                        out.append((f"{label}.{part}", s.key, s.op, s.tier, s.info_dict()))
    return out


def run_gcn(torch, repro_torch, data, params0, dispatch):
    from repro_torch.optim import adam_init, adam_update
    from repro_torch.relational import gcn_conv, rel_linear

    x, keys, w, y = data["x"], data["keys"], data["w"], data["y"]

    def loss_fn(p):
        """The loss, and per weight the (input, output) of its layer."""
        h0 = gcn_conv(x, keys, w)                 # join-agg message passing
        z1 = rel_linear(h0, p["w1"])
        h1 = gcn_conv(torch.relu(z1), keys, w)
        z2 = rel_linear(h1, p["w2"])
        logp = torch.log_softmax(z2, dim=1)
        return -logp.gather(1, y[:, None]).mean(), {"w1": (h0, z1), "w2": (h1, z2)}

    db = repro_torch.Database(dispatch=dispatch)
    params = dict(params0)
    opt = adam_init(params)
    losses, secs, first = [], [], None
    with db.activate():
        for step in range(GCN_STEPS):
            torch.cuda.synchronize()
            if step == 1:  # steady state: lowering and step-1 checks behind
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, layers = loss_fn(p)
            if step == 0:
                for _, z in layers.values():
                    z.retain_grad()
            loss.backward()
            grads = {k: v.grad for k, v in p.items()}
            params, opt = adam_update(params, grads, opt, lr=GCN_LR)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.detach()))
            if step == 0:
                # the weight gradient is Xᵀ·G summed over the nodes; keep X,
                # Z and G = ∂loss/∂Z of each layer for the tolerance, on the
                # host so that they stay out of the peak-memory reading
                first = {
                    "loss": losses[0],
                    "grads": {k: g.detach().clone() for k, g in grads.items()},
                    "layers": {k: (a.detach().cpu(), z.detach().cpu(), z.grad.cpu())
                               for k, (a, z) in layers.items()},
                }
    return db, losses, secs, first, torch.cuda.max_memory_allocated()


def gcn_data(torch, np, repro_torch, dev):
    """The ogbn-arxiv-size graph, its labels and the initial weights, made
    from seeds: the generator of examples/gcn_train.py, on the card."""
    from repro_torch.data import synthetic_graph
    from repro_torch.relational import gcn_conv

    t0 = time.perf_counter()
    g = synthetic_graph(NODES, EDGES, FEAT, CLASSES, seed=0)
    keys = torch.as_tensor(g["edge_keys"], device=dev)
    w = torch.as_tensor(g["edge_w"], device=dev)
    x = torch.as_tensor(g["x"], device=dev)
    log(f"  graph: |V|={NODES} |E|={keys.shape[0]} feat={FEAT} classes={CLASSES} "
        f"hidden={HIDDEN} (made in {time.perf_counter() - t0:.1f} s)")
    # learnable labels as in examples/gcn_train.py: argmax of a 2-hop
    # smoothed random projection of the features
    rng = np.random.default_rng(0)
    proj = torch.as_tensor(rng.normal(size=(FEAT, CLASSES)).astype(np.float32), device=dev)
    with repro_torch.Database().activate():
        smooth = gcn_conv(gcn_conv(x, keys, w), keys, w)
    y = torch.argmax(smooth @ proj, dim=1)
    params0 = {
        "w1": torch.as_tensor(rng.normal(size=(FEAT, HIDDEN)).astype(np.float32), device=dev)
        * FEAT ** -0.5,
        "w2": torch.as_tensor(rng.normal(size=(HIDDEN, CLASSES)).astype(np.float32), device=dev)
        * HIDDEN ** -0.5,
    }
    data = {"x": x, "keys": keys, "w": w, "y": y}
    graph = {"src": keys[:, 0].contiguous(), "dst": keys[:, 1].contiguous()}
    return data, params0, graph


def gcn_phase(torch, repro_torch, kern, data, params0):
    # the main path: default dispatch on the card (cuda tier, torch fallback)
    kern.reset_launch_counts()
    db, losses, secs, first, peak = run_gcn(torch, repro_torch, data, params0, None)
    launches = kern.launch_counts()
    sites = op_sites(db.dispatch)
    log(f"  dispatch table: {db.dispatch.describe()}")
    for prog, key, op, tier, _ in sites:
        log(f"    {prog}: {key} -> {tier}")
    bad = [(p, k, t) for p, k, _, t, _ in sites if t != "cuda"]
    if not sites or bad:
        raise AssertionError(f"dispatch sites not on the cuda tier: {bad or 'none recorded'}")
    for op, n in launches.items():
        log(f"  launches of {op}: {n} in {GCN_STEPS} steps ({n / GCN_STEPS:g} per step)")
        if n <= 0:
            raise AssertionError(f"{op}: its CUDA kernel never launched on the main path")
    log(f"  cuda tier losses: {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")

    # the same step on the plain torch tier, on the card
    kern.reset_launch_counts()
    _, t_losses, t_secs, t_first, t_peak = run_gcn(torch, repro_torch, data, params0, "torch")
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    log(f"  torch tier losses: {t_losses}")
    # step 1: same arithmetic, f32 sums in other orders (atomics vs
    # index_add_, CUDA-core tiles vs cuBLAS). The loss: within 1e-5
    # relative. Each weight gradient Xᵀ·G sums K = |V| terms, and both
    # tiers take that product with torch.einsum; X and G differ between
    # the tiers by a few roundings per entry, which moves the sum by far
    # less than one rounding walk of K terms. One difference is not
    # rounding: where a pre-relu value Z lies within rounding of 0, the
    # tiers' relu masks differ, and the term of that entry of G is in one
    # tier's sum and not in the other's. The check takes those terms out
    # of the difference exactly and holds the rest to the rounding limit
    dloss = abs(first["loss"] - t_first["loss"]) / abs(t_first["loss"])
    log(f"  step 1 loss: cuda {first['loss']!r} torch {t_first['loss']!r} rel diff {dloss:.3e} (tol 1e-5)")
    if dloss > 1e-5:
        raise AssertionError("step-1 loss differs between the cuda and torch tiers")
    dev = first["grads"]["w1"].device
    for k, relu_after in (("w1", True), ("w2", False)):
        g, t_g = first["grads"][k].double(), t_first["grads"][k].double()
        x, z, dz = (t.to(dev).double() for t in t_first["layers"][k])
        _, c_z, c_dz = (t.to(dev).double() for t in first["layers"][k])
        limit = GRAD_LIMIT * rounding_walk(x.t(), dz)
        diff = g - t_g
        flips = 0
        if relu_after:
            flip = (z > 0) != (c_z > 0)
            flips = int(flip.sum())
            diff = diff - x.t() @ (flip * (c_dz - dz))
        worst = excess(diff.abs(), limit)
        log(f"  step 1 grad {k}: max|cuda - torch| = {float((g - t_g).abs().max()):.3e}, "
            f"max|g| = {float(t_g.abs().max()):.3e}, {flips} relu-mask flips; without "
            f"their terms, err/limit = {worst:.3e} (limit {GRAD_LIMIT}·√K·u·sqrt(X²ᵀG²) "
            f"per entry, K = {NODES})")
        if worst > 1.0:
            raise AssertionError(f"step-1 gradient {k} differs between the tiers")
        # the limit must fail a wrong gradient: drop the term of one node
        i = int(((x.abs().sum(1)) * (c_dz.abs().sum(1))).argmax())
        seen = excess((diff - x[i, :, None] * c_dz[i, None, :]).abs(), limit)
        log(f"    planted fault (node {i}'s term dropped): err/limit={seen:.3e}, must exceed 1")
        if seen <= 1.0:
            raise AssertionError(f"the step-1 gradient limit passes a wrong gradient ({k})")
    ms = statistics.median(secs[1:]) * 1e3
    t_ms = statistics.median(t_secs[1:]) * 1e3
    log(f"  GCN step (median of steps 2-{GCN_STEPS}): cuda tier {ms:.2f} ms, torch tier {t_ms:.2f} ms")
    log(f"  GCN step 1 (lowering included): cuda tier {secs[0] * 1e3:.1f} ms, torch tier {t_secs[0] * 1e3:.1f} ms")
    log(f"  peak device memory over steps 2-{GCN_STEPS}: cuda tier {peak} bytes "
        f"({peak / 2**30:.2f} GiB), torch tier {t_peak} bytes ({t_peak / 2**30:.2f} GiB)")
    return launches, sites


# ---------------------------------------------------------------------------
# Phase 4: the front door — FRA logreg through Database.query(...).step()
# ---------------------------------------------------------------------------


def logreg_phase(torch, repro_torch, kern, dev):
    from repro_torch.core import fra
    from repro_torch.core.kernels import ADD, LOGISTIC, MUL, XENT
    from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj, project_key

    mm = fra.Agg(
        project_key(0), ADD,
        fra.Join(eq_pred((1, 0)), jproj(L(0), L(1)), MUL, fra.const("Rx", 2), fra.scan("theta", 1)),
    )
    pred = fra.Select(TRUE, identity_key(1), LOGISTIC, mm)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Join(eq_pred((0, 0)), jproj(L(0)), XENT, pred, fra.const("Ry", 1)))
    query = fra.Query(loss, inputs=("theta",))

    gen = torch.Generator(device=dev).manual_seed(2)
    X = torch.randn(LOGREG_ROWS, LOGREG_COLS, device=dev, generator=gen)
    truth = torch.randn(LOGREG_COLS, device=dev, generator=gen)
    noise = 0.5 * torch.randn(LOGREG_ROWS, device=dev, generator=gen)
    y = ((X @ truth + noise) > 0).float()
    db = repro_torch.Database()
    db.put("Rx", X, keys=("row", "col"))
    db.put("Ry", y, keys=("row",))
    db.put("theta", torch.zeros(LOGREG_COLS, device=dev), keys=("col",))
    handle = db.query(query)
    lr = 1.0 / LOGREG_ROWS  # the loss is a sum over rows
    theta = torch.zeros(LOGREG_COLS, device=dev)
    kern.reset_launch_counts()
    losses, secs = [], []
    for _ in range(LOGREG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, grads = handle.step()
        theta = theta - lr * grads["theta"].data
        db.put("theta", theta, keys=("col",))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out.data))
    launches = kern.launch_counts()
    log(f"  losses: {losses}")
    log(f"  resolutions: {handle.resolutions}")
    log(f"  lowerings: {handle.lower_count}; blocked_matmul launches: {launches['blocked_matmul']}")
    log(f"  step (median of steps 2-{LOGREG_STEPS}): {statistics.median(secs[1:]) * 1e3:.2f} ms; "
        f"step 1: {secs[0] * 1e3:.1f} ms")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"logreg loss did not fall: {losses}")
    if handle.lower_count != 1:
        raise AssertionError(f"{handle.lower_count} lowerings for one signature")
    mm_tiers = [t for k, t in handle.resolutions.items() if k.startswith("blocked_matmul")]
    if not mm_tiers or set(mm_tiers) != {"cuda"} or launches["blocked_matmul"] <= 0:
        raise AssertionError(f"blocked_matmul did not run on the cuda tier: {handle.resolutions}")


# ---------------------------------------------------------------------------
# Phase 5: timings at the shapes of one GCN step
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_phase(torch, kern, graph, sites, launches, errs, dev):
    from repro_torch.kernels.gather.ops import gather_rows_forward
    from repro_torch.kernels.gather.ref import gather_rows_ref
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.segsum.ops import segment_sum_forward
    from repro_torch.kernels.segsum.ref import segment_sum_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    src, dst = graph["src"], graph["dst"]
    rows_seen = int(torch.unique(src).numel())
    per_op = {op: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0, "shapes": []}
              for op in ("segment_sum", "gather_join", "blocked_matmul")}
    for prog, key, op, _, info in sites:
        if op == "gather_join":
            e, n, d = info["rows"], info["num_rows"], info["dim"]
            table = torch.randn(n, d, device=dev, generator=gen)
            rows = src[:e]
            k_ms = time_ms(torch, lambda: gather_rows_forward(table, rows))
            p_ms = time_ms(torch, lambda: gather_rows_ref(table, rows))
            l_ms = time_ms(torch, lambda: torch.index_select(table, 0, rows))
            # the table rows these ids touch, read once; ids; the output
            nbytes, flops = rows_seen * d * 4 + e * 4 + e * d * 4, 0
        elif op == "segment_sum":
            e, d, s = info["nnz"], info["dim"], info["num_segments"]
            msg = torch.randn(e, d, device=dev, generator=gen)
            seg = dst[:e]
            out = torch.zeros(s, d, device=dev)
            k_ms = time_ms(torch, lambda: segment_sum_forward(msg, seg, s))
            p_ms = time_ms(torch, lambda: segment_sum_ref(msg, seg, s))
            l_ms = time_ms(torch, lambda: out.zero_().index_add_(0, seg, msg))
            nbytes, flops = e * d * 4 + e * 4 + s * d * 4, e * d
        else:
            m, k, n = info["m"], info["k"], info["n"]
            x = torch.randn(m, k, device=dev, generator=gen)
            y = torch.randn(k, n, device=dev, generator=gen)
            k_ms = time_ms(torch, lambda: blocked_matmul_forward(x, y))
            p_ms = time_ms(torch, lambda: matmul_ref(x, y))
            l_ms = time_ms(torch, lambda: torch.matmul(x, y))
            nbytes, flops = (m * k + k * n + m * n) * 4, 2 * m * n * k
        b_ms, by = bound(nbytes, flops)
        log(f"  {prog} {key}: kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"library {l_ms:.4f} ms  bound {b_ms:.4f} ms ({by}: {nbytes} B, {flops} FLOP)")
        acc = per_op[op]
        acc["ms"] += k_ms
        acc["plain_ms"] += p_ms
        acc["library_ms"] += l_ms
        acc["bound_ms"] += b_ms
        acc["bytes_ms" if by == "bytes" else "ops_ms"] += b_ms
        acc["shapes"].append(key)

    meta = {
        "segment_sum": ("cuda", "src/repro_torch/kernels/csrc/segsum.cu",
                        "src/repro/kernels/segsum/segsum.py:30"),
        "gather_join": ("cuda", "src/repro_torch/kernels/csrc/gather.cu",
                        "src/repro/kernels/gather/gather.py:25"),
        "blocked_matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                           "src/repro/kernels/matmul/matmul.py:21"),
    }
    records = []
    for op, acc in per_op.items():
        route, source, replaces = meta[op]
        records.append({
            "name": op,
            "route": route,
            "source": source,
            "replaces": replaces,
            "launches": launches[op],
            "launches_per_step": launches[op] / GCN_STEPS,
            "max_abs_err": errs[op],
            "ms": acc["ms"],
            "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"],
            "bound_by": "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations",
            "library_ms": acc["library_ms"],
            "per": (f"launches: over the {GCN_STEPS} GCN steps of phase 3; ms, plain_ms, "
                    "bound_ms, library_ms: summed over the sites of one GCN step"),
            "sites": acc["shapes"],
        })

    # the RJP products the compiler leaves to torch.einsum: the kernel's
    # time at their shapes beside torch.matmul's, printed only
    for m, k, n, what in RJP_SHAPES:
        x = torch.randn(m, k, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        k_ms = time_ms(torch, lambda: blocked_matmul_forward(x, y))
        l_ms = time_ms(torch, lambda: torch.matmul(x, y))
        b_ms, by = bound((m * k + k * n + m * n) * 4, 2 * m * n * k)
        log(f"  off the main path, {what} ({m}x{k})@({k}x{n}): kernel {k_ms:.4f} ms  "
            f"library {l_ms:.4f} ms  bound {b_ms:.4f} ms ({by})")
    return records


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import numpy as np

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.kernels import build

    # a reference states its precision: f32 products in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 1: build the kernels")
    build.library()
    log(f"  built {build.last_build['path']} in {build.last_build['seconds']:.2f} s")
    for line in str(build.last_build["log"]).splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  " + line.strip())

    data, params0, graph = gcn_data(torch, np, repro_torch, dev)

    log("phase 2: each kernel against its plain version on the card")
    errs = check_kernels(torch, kern, graph, dev)

    log("phase 3: GCN training at ogbn-arxiv size")
    launches, sites = gcn_phase(torch, repro_torch, kern, data, params0)

    log("phase 4: FRA logistic regression through Database.query(...).step()")
    logreg_phase(torch, repro_torch, kern, dev)

    log("phase 5: timings at the shapes of one GCN step")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    records = timing_phase(torch, kern, graph, sites, launches, errs, dev)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
