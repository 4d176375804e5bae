"""The paper's NNMF (Fig. 2) and KGE (Fig. 3) workloads in the port against
the JAX package's: ``rel_matmul_blocked`` forward and gradients, SGD with
and without momentum, and three SGD steps of NNMF (n = d = 512), TransE-L2
and TransR (500 entities, batch 64, 8 negatives, d = 50 and 100) through
``repro_torch.examples.{nnmf,kge}`` against the reference's workload
functions in ``benchmarks/{nnmf,kge}.py``. Inputs come from numpy with a
seed; JAX arrays are pinned to float32 and int32 (other test modules flip
JAX's x64 switch at import)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.optim import sgd_init as jsgd_init
from repro.optim import sgd_update as jsgd_update
from repro.relational import rel_embed as jrel_embed
from repro.relational.linear import rel_matmul_blocked as jrel_matmul_blocked

import repro_torch
from repro_torch.examples import kge, nnmf
from repro_torch.optim import sgd_init, sgd_update
from repro_torch.relational import rel_matmul_blocked

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmarks import kge as jkge  # noqa: E402  (the reference workloads)
from benchmarks import nnmf as jnnmf  # noqa: E402

ATOL = 1e-5


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("grid", [(1, 1, 1, 8, 8, 8), (2, 3, 2, 4, 5, 6), (3, 1, 4, 16, 8, 4)], ids=str)
def test_rel_matmul_blocked_matches_the_reference(grid):
    bi, bk, bj, bm, bkk, bn = grid
    rng = np.random.default_rng(sum(grid))
    x, w = _f32(rng, bi, bk, bm, bkk), _f32(rng, bk, bj, bkk, bn)
    g = _f32(rng, bi, bj, bm, bn)

    def jloss(x, w):
        return jnp.sum(jrel_matmul_blocked(x, w) * jnp.asarray(g, jnp.float32))

    jx, jw = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
    jout = jrel_matmul_blocked(jx, jw)
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jx, jw)

    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    with repro_torch.Database(device="cpu").activate():
        tout = rel_matmul_blocked(tx, tw)
        (tout * torch.tensor(g)).sum().backward()
    assert tuple(tout.shape) == (bi, bj, bm, bn)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=ATOL)


def test_rel_matmul_blocked_is_one_blocked_matmul_site():
    from repro_torch.core.engine import engine_for
    from repro_torch.relational.linear import _blocked_prog

    rng = np.random.default_rng(1)
    x, w = torch.tensor(_f32(rng, 2, 2, 4, 4)), torch.tensor(_f32(rng, 2, 3, 4, 5))
    db = repro_torch.Database(device="cpu", dispatch="ref")
    with db.activate():
        rel_matmul_blocked(x, w)
    (low,) = [lw for lw in engine_for(_blocked_prog()[0].forward).lowerings if lw.dispatch == db.dispatch]
    (site,) = low.resolutions.sites
    assert (site.op, site.tier) == ("blocked_matmul", "ref")
    assert site.info_dict()["m"] == 8 and site.info_dict()["k"] == 8 and site.info_dict()["n"] == 15


# The same arithmetic in both packages (f32 step, cast back to the
# parameter's dtype); XLA may contract p − lr·g into one fused
# multiply-add, which rounds once where PyTorch rounds twice: one f32
# rounding of the step, before the cast.
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_update_matches_the_reference(momentum, dtype):
    rng = np.random.default_rng(int(momentum * 10) + len(dtype))
    params = {"a": _f32(rng, 5, 7), "b": _f32(rng, 11)}
    jp = {k: jnp.asarray(v, jnp.float32).astype(dtype) for k, v in params.items()}
    tp = {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in params.items()}
    jstate, tstate = jsgd_init(jp, momentum), sgd_init(tp, momentum)
    assert set(tstate) == set(jstate)
    for step in range(3):
        grads = {k: _f32(rng, *v.shape) for k, v in params.items()}
        jp, jstate = jsgd_update(jp, {k: jnp.asarray(g, jnp.float32).astype(dtype) for k, g in grads.items()},
                                 jstate, lr=0.05, momentum=momentum)
        tp, tstate = sgd_update(tp, {k: torch.tensor(g).to(getattr(torch, dtype)) for k, g in grads.items()},
                                tstate, lr=0.05, momentum=momentum)
        for k in params:
            assert tp[k].dtype == getattr(torch, dtype)
            want = np.asarray(jp[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            ulp = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
            np.testing.assert_allclose(got, want, rtol=ulp, atol=1e-7, err_msg=f"step {step} {k}")
        if momentum:
            for k in params:
                np.testing.assert_allclose(tstate["mom"][k].numpy(), np.asarray(jstate["mom"][k]),
                                           rtol=2.0 ** -23, atol=1e-7)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# NNMF at n = d = 512: the reference's loss (benchmarks/nnmf.py) in JAX,
# repro_torch.examples.nnmf in the port, the same padded factors
# ---------------------------------------------------------------------------

NNMF_N = NNMF_D = 512


def _jax_nnmf_step(a, lr):
    ab = jnnmf._to_blocks(a)

    def ra_loss(params):
        wb = jnnmf._to_blocks(jax.nn.relu(params["w"]))
        hb = jnnmf._to_blocks(jax.nn.relu(params["h"]))
        pred = jrel_matmul_blocked(wb, hb)
        return 0.5 * jnp.sum((pred - ab) ** 2)

    def step(params):
        loss, g = jax.value_and_grad(ra_loss)(params)
        params, _ = jsgd_update(params, g, {}, lr=lr)
        return params, loss, g

    return step


@pytest.mark.parametrize("path", ["relational", "plain"])
def test_nnmf_steps_match_the_reference(path):
    assert nnmf.BLOCK == jnnmf.BLOCK
    rng = np.random.default_rng(0)
    n, d, rank = NNMF_N, NNMF_D, nnmf.RANK
    a = rng.uniform(size=(n, d)).astype(np.float32)
    pad = nnmf.BLOCK - rank
    w0 = np.pad(rng.uniform(size=(n, rank)).astype(np.float32) * 0.1, ((0, 0), (0, pad)))
    h0 = np.pad(rng.uniform(size=(rank, d)).astype(np.float32) * 0.1, ((0, pad), (0, 0)))
    lr = nnmf.learning_rate(n, d)
    assert lr == 0.1 / (n * d)

    jstep = _jax_nnmf_step(jnp.asarray(a, jnp.float32), lr)
    tstep = nnmf.make_step(nnmf.ra_loss if path == "relational" else nnmf.plain_loss,
                           torch.tensor(a), lr)
    jp = {"w": jnp.asarray(w0, jnp.float32), "h": jnp.asarray(h0, jnp.float32)}
    tp = {"w": torch.tensor(w0), "h": torch.tensor(h0)}
    losses = []
    with repro_torch.Database(device="cpu").activate():
        for _ in range(3):
            jp, jl, jg = jstep(jp)
            tp, tl, tg = tstep(tp)
            # the loss sums n·d = 262,144 squares in f32; gradient entries
            # are f32 sums of 512 terms: both packages agree to far below
            # 1e-5 of their scale
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
            for k in ("w", "h"):
                assert _max_rel(tg[k].numpy(), np.asarray(jg[k])) < 1e-5, k
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7)
                # the rank padding stays zero, with zero gradient
                pad_part = tg[k][:, rank:] if k == "w" else tg[k][rank:]
                assert not bool(pad_part.any())
            losses.append(float(tl))
    assert losses[2] < losses[0]


def test_nnmf_problem_shapes_and_blocks():
    a, params = nnmf.make_problem(512, 768, device="cpu")
    assert tuple(a.shape) == (512, 768)
    assert tuple(params["w"].shape) == (512, nnmf.BLOCK) and tuple(params["h"].shape) == (nnmf.BLOCK, 768)
    assert not bool(params["w"][:, nnmf.RANK:].any()) and not bool(params["h"][nnmf.RANK:].any())
    b = nnmf.to_blocks(a)
    assert tuple(b.shape) == (2, 3, 256, 256)
    assert torch.equal(b[1, 2], a[256:512, 512:768])
    np.testing.assert_array_equal(np.asarray(jnnmf._to_blocks(jnp.asarray(a.numpy()))), b.numpy())


# ---------------------------------------------------------------------------
# KGE at 500 entities, batch 64, 8 negatives: the reference's losses
# (benchmarks/kge.py, at this batch) in JAX, repro_torch.examples.kge in the
# port, the same tables and batch
# ---------------------------------------------------------------------------

N_ENT, N_REL, BATCH, NEG = 500, 20, 64, 8


@pytest.fixture
def reference_kge_batch(monkeypatch):
    """The reference's loss functions read the batch shape from module
    constants: set them to this test's."""
    monkeypatch.setattr(jkge, "BATCH", BATCH)
    monkeypatch.setattr(jkge, "NEG", NEG)
    monkeypatch.setattr(jkge, "N_ENT", N_ENT)
    monkeypatch.setattr(jkge, "N_REL", N_REL)


@pytest.mark.parametrize("path", ["relational", "plain"])
@pytest.mark.parametrize("dim", [50, 100])
@pytest.mark.parametrize("algo", ["transe", "transr"])
def test_kge_steps_match_the_reference(reference_kge_batch, algo, dim, path):
    # the batch: the reference's _batch and the port's make_batch draw the
    # same ids from the same numpy generator
    jbatch = jkge._batch(np.random.default_rng(0))
    tbatch = kge.make_batch(np.random.default_rng(0), n_ent=N_ENT, n_rel=N_REL, batch=BATCH, neg=NEG,
                            device="cpu")
    for jb, tb in zip(jbatch, tbatch):
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        assert tb.dtype == torch.int32
    jbatch = tuple(jnp.asarray(np.asarray(b), jnp.int32) for b in jbatch)

    rng = np.random.default_rng(dim)
    params = {"ent": _f32(rng, N_ENT, dim, scale=0.05), "rel": _f32(rng, N_REL, dim, scale=0.05)}
    if algo == "transr":
        params["proj"] = _f32(rng, N_REL, dim, dim, scale=0.05)
    jloss = (jkge._transe_loss if algo == "transe" else jkge._transr_loss)(jrel_embed)

    def jstep(p):
        loss, g = jax.value_and_grad(jloss)(p, *jbatch)
        p, _ = jsgd_update(p, g, {}, lr=kge.LR)
        return p, loss, g

    tstep = kge.make_step(algo, kge.rel_embed if path == "relational" else kge.plain_embed)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    losses = []
    with repro_torch.Database(device="cpu").activate():
        for _ in range(3):
            jp, jl, jg = jstep(jp)
            tp, tl, tg = tstep(tp, *tbatch)
            # losses are means of 512 hinge terms of order 1; gradient rows
            # are f32 sums of a few terms per id: both within 1e-5 of scale
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
            for k in params:
                assert _max_rel(tg[k].numpy(), np.asarray(jg[k])) < 1e-5, k
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=ATOL)
            losses.append(float(tl))
    assert all(np.isfinite(losses)) and losses[2] < losses[0]


def test_kge_relational_and_plain_paths_agree_on_the_kernels_tier():
    """Through the kernels' plain versions (the tier a CUDA tensor would
    launch), the relational step gives the plain path's loss and table
    gradients: the gathers copy rows, and the scatter sums the same terms
    in another order."""
    batch = kge.make_batch(np.random.default_rng(1), n_ent=N_ENT, n_rel=N_REL, batch=BATCH, neg=NEG,
                           device="cpu")
    params = kge.make_params("transe", 50, n_ent=N_ENT, n_rel=N_REL, device="cpu")
    with repro_torch.Database(device="cpu", dispatch="ref").activate():
        _, rl, rg = kge.make_step("transe", kge.rel_embed)(params, *batch)
    _, pl, pg = kge.make_step("transe", kge.plain_embed)(params, *batch)
    np.testing.assert_allclose(float(rl), float(pl), rtol=1e-6)
    for k in ("ent", "rel"):
        np.testing.assert_allclose(rg[k].numpy(), pg[k].numpy(), atol=1e-6)


def test_examples_run_on_the_cpu(capsys):
    nnmf.main(["--device", "cpu", "--n", "512", "--d", "256"])
    kge.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "relational step 4" in out and "transr d=100 plain step 4" in out


def test_a_step_frees_its_tensors_without_the_cycle_collector():
    """The compiler's walk leaves no reference cycle: an NNMF step's
    environment and intermediates (on the card, tensors of n² entries) are
    freed when the step ends, not at the cycle collector's next pass."""
    import gc

    a, params = nnmf.make_problem(512, 512, device="cpu")
    step = nnmf.make_step(nnmf.ra_loss, a, nnmf.learning_rate(512, 512))
    with repro_torch.Database(device="cpu").activate():
        step(params)  # lowers
        gc.collect()
        gc.disable()
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            params, loss, grads = step(params)
            del loss, grads
            gc.collect()
            held = [o for o in gc.garbage
                    if isinstance(o, torch.Tensor)
                    or getattr(o, "__qualname__", "").startswith("_execute_graph.")]
        finally:
            gc.set_debug(0)
            gc.garbage.clear()
            gc.enable()
    assert not held, held[:5]
