"""The SSM family's hybrid, zamba2-7b, in the JAX package and in the port:
the Mamba-2 block (its selective scan with a per-head decay, prefill and
decode), the kinds ``mamba2`` and ``mamba2_attn``, the one shared
attention+MLP block reused at every ``mamba2_attn`` layer, and the whole
model reduced to 7 layers (one superblock of 5 ``mamba2`` + 1
``mamba2_attn``, then a tail layer; d_model 256, 8 SSM heads of 64, state
64, 4 attention heads over 2 KV heads, vocab 512, ``ssm_pallas=True``),
from the same weights (the JAX init, carried across by
``repro_torch.convert.lm_params``) and the same tokens (numpy, seeded).

The JAX side runs under ``repro.Database(dispatch="interpret")``, which
reaches the Pallas kernels (matmul, gather, segment sum, and the scan,
whose wrapper picks interpret mode off the TPU) in interpret mode; the
port's under ``repro_torch.Database(device="cpu")``, where every kernel
wrapper takes its plain version.

Tolerance: 1e-5 absolute and relative, as in ``tests/test_torch_lm.py``:
the products sum at most 512 f32 terms in other orders on the two sides,
and the scan runs the same recurrence in the same order. The logits of the
whole model (7 layers) and a block's output are held otherwise: both f32
sides to an f64 oracle (the port under ``torch_lm_parity.F64``) within
``depth_bound`` — L·(√n + √S)·u·max|logit| for L layers, the longest f32
sum n = 512 (``out_proj`` over d_inner, the MLP's down projection) and the
scan's S steps — with a dropped scan step planted, which that bound must
catch. At 7 layers the two f32 sides lie about 60 u·max|logit| from the
oracle and from each other, at the edge of a fixed 1e-5, where the CPU
that runs the test decided whether it passed. Gradients are
held to 1e-5 of their tensor's largest entry (``_close_grad``): each entry
sums a term per token (32 here) in another order on each side; so is the
carried SSM state, a sum over the steps (``_close_state`` says why). The shared
block's gradient sums one contribution per ``mamba2_attn`` layer, in
another order than JAX's, on top; with one such layer here it is held to
the same bound (``test_train_logits_gradients_match_jax`` says more).
"""

import asyncio
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.blocks import block_apply as jax_block_apply
from repro.models.blocks import shared_attn_init as jax_shared_attn_init
from repro.models.ssm import mamba2_apply as jax_mamba2_apply
from repro.models.ssm import selective_scan as jax_selective_scan
from repro.serving.serve import init_cache as jax_init_cache
from repro.serving.serve import make_decode_step as jax_make_decode_step
from repro.serving.serve import make_prefill_step as jax_make_prefill_step
from repro.train import lm_loss as jax_lm_loss
from repro_torch import convert, kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models.blocks import block_apply, block_init, shared_attn_init
from repro_torch.models.model import Stage, stages_of
from repro_torch.models.ssm import mamba2_apply, selective_scan
from repro_torch.serving import init_cache, make_decode_step, make_prefill_step
from repro_torch.serving.serve import map_cache
from repro_torch.train import lm_loss
from torch_lm_parity import F64, depth_bound, f64_model, hold_to_oracle, oracle_gap

TOL = 1e-5
#: the longest f32 sum of a layer: out_proj over d_inner = 512 terms (the
#: shared MLP's down projection sums d_ff = 512 too)
LONGEST_SUM = 512
ARCH = "zamba2-7b"
LAYERS = 7
BATCH, SEQ, DECODE_STEPS = 2, 16, 3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _configs(**kw):
    kw = dict(ssm_pallas=True, n_layers=LAYERS, **kw)
    return get_config(ARCH).reduced(**kw), jax_get_config(ARCH).reduced(**kw)


@pytest.fixture(scope="module")
def lm():
    """(reference model, its params as numpy, port model with those params)."""
    cfg, jcfg = _configs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    params = _np(jmodel.init(jax.random.PRNGKey(0)))
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), params)
    return jmodel, params, model


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, size=(BATCH, SEQ)).astype(np.int32)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


@contextlib.contextmanager
def _dropped_scan_step():
    """A planted fault: every ``ssm_scan`` drops its last step's input
    (b at the last step is 0)."""
    from repro_torch.models import ssm

    scan = ssm.ssm_scan

    def dropped(a, b):
        b = b.clone()
        b[:, -1] = 0
        return scan(a, b)

    ssm.ssm_scan = dropped
    try:
        yield
    finally:
        ssm.ssm_scan = scan


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=TOL, atol=atol,
    )


def _close_grad(got, want):
    want = np.asarray(want, np.float32)
    _close(got, want, atol=TOL * max(1.0, float(np.abs(want).max())))


def _leaves(tree):
    out = []
    map_cache(lambda t: out.append(t), tree)
    return out


def _flat_cache(tree, prefix=""):
    """A cache tree as {"a.0.b": tensor}, the keys of ``_flat_ref``."""
    if isinstance(tree, (dict, list)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            out.update(_flat_cache(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _close_state(got, want, key):
    """A cache leaf: the SSM state (``key == "ssm"``) as a gradient is held
    (``_close_grad``), every other leaf within TOL. Each state entry sums
    dt·B·x over every step so far, terms of up to the tensor's own size
    (states reach 24 here), each carrying the products' other rounding;
    where they cancel to a small entry its absolute error stays that of the
    large terms, ≈ 1e-6 of the tensor's largest entry, which 1e-5 of it
    bounds, while 1e-5 of the entry itself does not."""
    (_close_grad if key == "ssm" else _close)(got, want)


def _close_tree(got, want):
    """Port caches against the reference's, unstacked into the port's
    layout by ``convert.lm_caches``: the same keys, shapes and dtypes."""

    def walk(g, w, key=None):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                walk(g[k], w[k], k)
        elif isinstance(w, list):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                walk(gi, wi)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            _close_state(g, w.numpy(), key)

    walk(got, convert.lm_caches(_np(want), "cpu"))


def _hold_tree(got, want, oracle, scan_len):
    """Port caches and the reference's (as ``_close_tree`` lays them out),
    each leaf held to the f64 run's leaf within ``depth_bound`` of the
    whole depth: the layers' K/V and states sit at most LAYERS deep."""

    def walk(g, w, o):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w) == sorted(o)
            for k in w:
                walk(g[k], w[k], o[k])
        elif isinstance(w, list):
            assert len(g) == len(w) == len(o)
            for gi, wi, oi in zip(g, w, o):
                walk(gi, wi, oi)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape == o.shape
            if o.abs().max() > 0:
                hold_to_oracle(g, w, o, depth_bound(o, LAYERS, LONGEST_SUM, scan_len))

    walk(got, convert.lm_caches(_np(want), "cpu"), oracle)


def _flat_ref(tree):
    return {
        ".".join(str(getattr(k, "key", getattr(k, "idx", "?"))) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _port_name(ref_name):
    """A reference leaf's path (scan leaves stacked over repeats) as the
    port's parameter name of repeat 0."""
    parts = ref_name.split(".")
    if parts[:1] == ["stages"] and parts[2] == "scan":
        parts.insert(3, "0")
    return ".".join(parts)


# ---------------------------------------------------------------------------
# The configuration and its stages
# ---------------------------------------------------------------------------


def test_zamba2_config_equals_the_reference_field_by_field():
    assert ARCH in ARCH_IDS
    want = dataclasses.asdict(jax_get_config(ARCH))
    got = dataclasses.asdict(get_config(ARCH))
    assert list(got) == list(want) and got == want


def test_stages_run_13_superblocks_and_a_tail_of_3():
    """81 layers: 13 repeats of (5 mamba2 + 1 mamba2_attn), then 3 mamba2;
    the reduced 7: one repeat and a tail of 1."""
    pattern = ("mamba2",) * 5 + ("mamba2_attn",)
    assert stages_of(get_config(ARCH)) == [Stage(pattern, 13, ("mamba2",) * 3)]
    cfg, _ = _configs()
    assert stages_of(cfg) == [Stage(pattern, 1, ("mamba2",))]


def test_parameter_count_matches_the_reference(lm):
    jmodel, params, model = lm
    want = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == want
    full = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full)) == 6_751_130_832


def test_the_model_holds_one_shared_block_and_a_tail_layer(lm):
    _, params, model = lm
    assert model.has_shared and len(model.stages[0]["scan"]) == 1
    assert len(model.stages[0]["tail"]) == 1
    assert sorted(model.stages[0]["scan"][0].keys()) == sorted(params["stages"][0]["scan"])
    falcon = build_model(get_config("falcon-mamba-7b").reduced(), device="cpu")
    assert not falcon.has_shared and not hasattr(falcon, "shared_attn")


def test_shared_attn_init_has_the_references_names_and_shapes(lm):
    cfg, jcfg = lm[2].cfg, lm[0].cfg
    want = _flat_ref(jax_shared_attn_init(jax.random.PRNGKey(0), jcfg))
    got = dict(shared_attn_init(torch.Generator().manual_seed(0), cfg).named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(got[k].dtype == torch.float32 for k in got)


@pytest.mark.parametrize("kind", ["mamba2", "mamba2_attn"])
def test_block_init_builds_the_references_names_and_shapes(lm, kind):
    from repro.models.blocks import block_init as jax_block_init

    cfg, jcfg = lm[2].cfg, lm[0].cfg
    want = _flat_ref(jax_block_init(jax.random.PRNGKey(0), kind, jcfg))
    got = dict(block_init(torch.Generator().manual_seed(0), kind, cfg).named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------------------
# The selective scan with a per-head decay, and mamba2_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8])
def test_selective_scan_broadcast_decay_matches_jax(chunk):
    """Mamba-2's decay (B, S, H, 1, 1) against (B, S, H, N, P) inputs: the
    port of tests/test_ssm_scan.py::test_selective_scan_broadcast_decay,
    held to the reference's own ``selective_scan``."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0.3, 1.0, size=(2, 32, 3, 1, 1)).astype(np.float32)
    b = rng.normal(size=(2, 32, 3, 4, 5)).astype(np.float32)
    want = jax_selective_scan(jnp.asarray(a), jnp.asarray(b), chunk)
    got = selective_scan(torch.tensor(a), torch.tensor(b), chunk)
    assert tuple(got.shape) == b.shape
    _close(got, want)


def _mamba2_inputs(cfg, with_state, seed=5):
    rng = np.random.default_rng(seed)
    c = cfg.ssm_expand * cfg.d_model
    x = rng.normal(size=(BATCH, 1 if with_state else SEQ, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        nh = c // cfg.ssm_head_dim
        state = {"conv": rng.normal(size=(BATCH, cfg.conv_width - 1, c + 2 * cfg.ssm_state)).astype(np.float32),
                 "ssm": rng.normal(size=(BATCH, nh, cfg.ssm_state, cfg.ssm_head_dim)).astype(np.float32)}
    return x, state


@pytest.mark.parametrize("with_state, use_pallas", [(False, True), (False, False), (True, True)],
                         ids=["prefill-kernel", "prefill-parallel-prefix", "decode"])
def test_mamba2_apply_matches_jax(lm, with_state, use_pallas):
    """The block's SSM half: prefill through the scan kernel (the decay
    broadcast to each head's N·P lanes) or the parallel prefix, and one
    decode step from a carried (conv window, state)."""
    jmodel, params, model = lm
    cfg = model.cfg
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["scan"]["0:mamba2"]["ssm"])
    p = model.stages[0]["scan"][0]["0:mamba2"]["ssm"]
    x, state = _mamba2_inputs(cfg, with_state)
    kw = dict(head_dim=cfg.ssm_head_dim, state_dim=cfg.ssm_state, use_pallas=use_pallas)
    with repro.Database(dispatch="interpret").activate():
        jy, jst = jax_mamba2_apply(_jax(jp), jnp.asarray(x),
                                   state=None if state is None else _jax(state), **kw)
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        y, st = mamba2_apply(p, torch.tensor(x),
                             state=None if state is None else {k: torch.tensor(v) for k, v in state.items()},
                             **kw)
    _close(y, jy)
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == jst[k].shape
        _close(st[k], jst[k])
    # the cache entry is a copy, not a view of the scan's whole (B,S,H,N,P) output
    assert st["ssm"]._base is None


def test_mamba2_apply_gradients_match_jax(lm):
    """The kernel path under autograd: the scan's reverse walk, and the
    broadcast decay's gradient summed over each head's lanes."""
    jmodel, params, model = lm
    cfg = model.cfg
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["scan"]["1:mamba2"]["ssm"])
    x, _ = _mamba2_inputs(cfg, False, seed=6)
    g = np.random.default_rng(7).normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    kw = dict(head_dim=cfg.ssm_head_dim, state_dim=cfg.ssm_state, use_pallas=True)

    def jloss(p, x):
        return jnp.sum(jax_mamba2_apply(p, x, **kw)[0] * g)

    with repro.Database(dispatch="interpret").activate():
        jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_jax(jp), jnp.asarray(x))
    p = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    with repro_torch.Database(device="cpu").activate():
        (mamba2_apply(p, tx, **kw)[0] * torch.tensor(g)).sum().backward()
    _close_grad(tx.grad, jgx)
    assert sorted(p) == sorted(jgp)
    for k in p:
        _close_grad(p[k].grad, jgp[k])


# ---------------------------------------------------------------------------
# The block kinds
# ---------------------------------------------------------------------------


def _ctx(pkg, cfg, mode, shared, length=None, cache_len=None):
    arr = jnp.asarray if pkg is jnp else torch.tensor
    ctx = {"cfg": cfg, "mode": mode, "shared": shared}
    if mode == "decode":
        ctx["positions"] = arr(np.full((BATCH, 1), length, np.int32))
        ctx["length"] = length if pkg is torch else jnp.asarray(length, jnp.int32)
    else:
        ctx["positions"] = arr(np.broadcast_to(np.arange(SEQ, dtype=np.int32), (BATCH, SEQ)).copy())
        ctx["cache"] = None
        ctx["cache_len"] = cache_len
    return ctx


@pytest.mark.parametrize("kind", ["mamba2", "mamba2_attn"])
def test_block_apply_matches_jax_in_prefill_then_decode(lm, kind):
    """A block's prefill (its cache: the Mamba-2 state, and for
    ``mamba2_attn`` the shared block's K/V padded to the cache length),
    then one decode step from that cache."""
    jmodel, params, model = lm
    cfg = model.cfg
    key = f"{5 if kind == 'mamba2_attn' else 2}:{kind}"
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["scan"][key])
    p = model.stages[0]["scan"][0][key]
    jshared, shared = _jax(params["shared_attn"]), model.shared_attn
    x = np.random.default_rng(8).normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    x1 = np.random.default_rng(9).normal(size=(BATCH, 1, cfg.d_model)).astype(np.float32)
    cache_len = SEQ + 4
    with repro.Database(dispatch="interpret").activate():
        jy, jc, _ = jax_block_apply(_jax(jp), kind, jnp.asarray(x),
                                    _ctx(jnp, lm[0].cfg, "prefill", jshared, cache_len=cache_len))
        jctx = _ctx(jnp, lm[0].cfg, "decode", jshared, length=SEQ)
        jctx["cache"] = jc
        jy1, jc1, _ = jax_block_apply(_jax(jp), kind, jnp.asarray(x1), jctx)
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        y, c, aux = block_apply(p, kind, torch.tensor(x), _ctx(torch, cfg, "prefill", shared, cache_len=cache_len))
        ctx = _ctx(torch, cfg, "decode", shared, length=SEQ)
        ctx["cache"] = c
        y1, c1, _ = block_apply(p, kind, torch.tensor(x1), ctx)
    assert float(aux) == 0.0
    assert sorted(c) == sorted(jc) == (["shared_kv", "ssm2"] if kind == "mamba2_attn" else ["ssm2"])
    # the outputs against the block's f64 oracle (one layer; the prefill's
    # scan runs SEQ steps, the decode step one more)
    m64 = f64_model(model)
    with repro_torch.Database(device="cpu").activate(), torch.no_grad(), F64():
        p64, shared64 = m64.stages[0]["scan"][0][key], m64.shared_attn
        o, c64, _ = block_apply(p64, kind, torch.tensor(x, dtype=torch.float64),
                                _ctx(torch, cfg, "prefill", shared64, cache_len=cache_len))
        ctx64 = _ctx(torch, cfg, "decode", shared64, length=SEQ)
        ctx64["cache"] = c64
        o1, _, _ = block_apply(p64, kind, torch.tensor(x1, dtype=torch.float64), ctx64)
    hold_to_oracle(y, jy, o, depth_bound(o, 1, LONGEST_SUM, SEQ))
    hold_to_oracle(y1, jy1, o1, depth_bound(o1, 1, LONGEST_SUM, SEQ + 1))
    for got, want in ((c, jc), (c1, jc1)):
        g, w = _flat_cache(got), _flat_ref(want)
        assert {k: tuple(t.shape) for k, t in g.items()} == {k: t.shape for k, t in w.items()}
        for k in w:
            _close_state(g[k], w[k], k.split(".")[-1])


# ---------------------------------------------------------------------------
# The whole model: train_logits and its gradients, prefill, greedy decode
# ---------------------------------------------------------------------------


def test_train_logits_match_jax(lm, tokens):
    jmodel, params, model = lm
    with repro.Database(dispatch="interpret").activate():
        jlogits, _ = jmodel.train_logits(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        logits, aux = model.train_logits({"tokens": torch.tensor(tokens)})
        with F64():
            oracle, _ = f64_model(model).train_logits({"tokens": torch.tensor(tokens)})
        with _dropped_scan_step():
            dropped, _ = model.train_logits({"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (BATCH, SEQ, 512) and float(aux) == 0.0
    assert oracle.dtype == torch.float64
    bound = depth_bound(oracle, LAYERS, LONGEST_SUM, SEQ)
    hold_to_oracle(logits, jlogits, oracle, bound)
    assert oracle_gap(dropped, oracle) > bound, "the bound passes a dropped scan step"


@pytest.fixture(scope="module")
def grads(lm, tokens):
    """The train loss's gradient of every parameter, in both packages."""
    jmodel, params, model = lm
    labels = np.random.default_rng(10).integers(0, 512, size=(BATCH, SEQ)).astype(np.int32)

    def jloss(p):
        logits, _ = jmodel.train_logits(p, {"tokens": jnp.asarray(tokens)})
        return jax_lm_loss(logits, jnp.asarray(labels))

    with repro.Database(dispatch="interpret").activate():
        jg = _flat_ref(jax.grad(jloss)(_jax(params)))
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
    with repro_torch.Database(device="cpu").activate():
        logits, _ = model.train_logits({"tokens": torch.tensor(tokens)}, leaves)
        loss = lm_loss(logits, torch.tensor(labels))
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return got, jg


@pytest.mark.parametrize("part", ["shared_attn", "stages", "embed"])
def test_train_logits_gradients_match_jax(grads, part):
    """Every parameter's gradient, by part: the shared block's (one
    ``mamba2_attn`` layer uses it here, so its gradient has one
    contribution and the same bound as every other tensor's; at 81 layers
    it sums 13, in another order than JAX does, and the bound would grow
    with √13 of the sum's size), the layers', and the embedding's and
    head's. Each reference scan leaf is repeat 0 of the port's."""
    got, jg = grads
    want = {k: v for k, v in jg.items() if k.startswith(part) or (part == "embed" and "." not in k)}
    assert want
    for k, w in want.items():
        name = _port_name(k) if part == "stages" else k
        if part == "stages" and "scan" in k:
            w = w[0]
        assert tuple(got[name].shape) == w.shape, k
        _close_grad(got[name], w)
    assert len(got) == len(jg)


def test_remat_policies_give_the_gradients_of_no_remat_bit_for_bit(lm, tokens):
    """``remat`` with the "nothing" and the "dots" policy recompute the
    superblock (the shared block inside it) in the backward; both give the
    gradients without remat, bit for bit, the shared block's included."""
    _, params, model = lm
    cfg = model.cfg
    labels = torch.tensor(np.random.default_rng(11).integers(0, 512, size=(BATCH, SEQ)).astype(np.int32))
    got = {}
    try:
        for policy in (None, "nothing", "dots"):
            model.cfg = dataclasses.replace(cfg, remat=policy is not None, remat_policy=policy or "nothing")
            leaves = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
            with repro_torch.Database(device="cpu").activate():
                logits, _ = model.train_logits({"tokens": torch.tensor(tokens)}, leaves)
                loss = lm_loss(logits, labels)
            got[policy] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    finally:
        model.cfg = cfg
    for policy in ("nothing", "dots"):
        assert all(torch.equal(got[policy][k], got[None][k]) for k in got[None]), policy
    assert any(k.startswith("shared_attn") for k in got[None])


def test_prefill_and_greedy_decode_match_jax(lm, tokens):
    jmodel, params, model = lm
    cache_len = SEQ + DECODE_STEPS
    jprefill, jdecode = jax_make_prefill_step(jmodel, cache_len), jax_make_decode_step(jmodel)
    prefill, decode = make_prefill_step(model, cache_len), make_decode_step(model)
    db = repro_torch.Database(device="cpu")
    with repro.Database(dispatch="interpret").activate():
        jlogits, jcaches = jprefill(params, {"tokens": jnp.asarray(tokens)})
    m64 = f64_model(model)
    prefill64, decode64 = make_prefill_step(m64, cache_len), make_decode_step(m64)
    with db.activate():
        logits, caches = prefill({"tokens": torch.tensor(tokens)})
        with F64():
            oracle, caches64 = prefill64({"tokens": torch.tensor(tokens)})
        with _dropped_scan_step():
            dropped, _ = prefill({"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (BATCH, 1, 512) and not logits.requires_grad
    bound = depth_bound(oracle, LAYERS, LONGEST_SUM, SEQ)
    hold_to_oracle(logits, jlogits, oracle, bound)
    assert oracle_gap(dropped, oracle) > bound, "the bound passes a dropped scan step"
    _hold_tree(caches, jcaches, caches64, SEQ)
    assert tuple(caches[0]["scan"][0]["5:mamba2_attn"]["shared_kv"]["k"].shape) == (
        BATCH, cache_len, model.cfg.n_kv_heads, model.cfg.hd())
    for step in range(DECODE_STEPS):
        token = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), token[:, 0])
        length = jnp.asarray(SEQ + step, jnp.int32)
        with repro.Database(dispatch="interpret").activate():
            jlogits, jcaches = jdecode(params, jnp.asarray(token), jcaches, length)
        with db.activate():
            logits, caches = decode(torch.tensor(token), caches, SEQ + step)
            with F64():
                oracle, caches64 = decode64(torch.tensor(token), caches64, SEQ + step)
        hold_to_oracle(logits, jlogits, oracle, depth_bound(oracle, LAYERS, LONGEST_SUM, SEQ + step + 1))
        _hold_tree(caches, jcaches, caches64, SEQ + step + 1)


def test_init_cache_matches_the_reference_layout():
    cfg, jcfg = _configs()
    got = init_cache(cfg, BATCH, SEQ, device="cpu")
    _close_tree(got, jax_init_cache(jcfg, BATCH, SEQ))
    assert all(t.shape[0] == BATCH for t in _leaves(got))


def test_lm_params_and_lm_caches_carry_every_tensor_across(lm, tokens):
    """``lm_params`` fills every parameter, ``shared_attn`` included, with
    the reference's bits; ``lm_caches`` gives the ``ssm2``/``shared_kv``
    entries in the shapes the port's own prefill makes; a leaf of another
    shape is refused by name."""
    jmodel, params, model = lm
    named = dict(model.named_parameters())
    ref = _flat_ref(params)
    assert len(named) == sum(
        np.asarray(v).shape[0] if k.split(".")[2:3] == ["scan"] else 1 for k, v in ref.items())
    for k, v in ref.items():
        if k.split(".")[2:3] == ["scan"]:
            for r in range(v.shape[0]):
                parts = k.split(".")
                parts.insert(3, str(r))
                assert np.array_equal(named[".".join(parts)].detach().numpy(), v[r])
        else:
            assert np.array_equal(named[k].detach().numpy(), v), k
    with repro.Database(dispatch="interpret").activate():
        _, jcaches = jax_make_prefill_step(jmodel, SEQ)(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate():
        _, caches = make_prefill_step(model, SEQ)({"tokens": torch.tensor(tokens)})
    carried = convert.lm_caches(_np(jcaches), "cpu")
    def shapes(tree):
        return {k: (t.shape, t.dtype) for k, t in _flat_cache(tree).items()}

    assert shapes(carried) == shapes(caches)
    assert any(k.endswith("shared_kv.k") for k in shapes(caches))
    bad = dict(params, shared_attn=dict(params["shared_attn"], ln1=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="shared_attn.ln1"):
        convert.lm_params(build_model(model.cfg, device="cpu"), bad)


# ---------------------------------------------------------------------------
# The serving front door on the CPU
# ---------------------------------------------------------------------------


def test_endpoint_completions_equal_their_solo_runs(lm):
    """Three concurrent requests through ``db.endpoint``: one prefill at a
    padded bucket (3 rows in 4), decode at buckets 4, 2 and 1 with
    compaction, every cache leaf (Mamba-2 states, conv windows, the shared
    block's K/V) moved on its batch axis; each completion equals the
    request served alone through ``make_prefill_step``/``make_decode_step``."""
    model = lm[2]
    cache_len, budgets = SEQ + 4, [4, 2, 3]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, model.cfg.vocab, size=SEQ).astype(np.int32) for _ in budgets]
    db = repro_torch.Database(device="cpu")
    db.register_model("zamba2", model, {k: p.detach() for k, p in model.named_parameters()})
    ep = db.endpoint("zamba2", cache_len=cache_len, buckets=[(2, SEQ), (4, SEQ)])

    async def go():
        return await asyncio.gather(*[ep.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)])

    with db.activate():
        ep.warmup()
        outs = asyncio.run(go())
    c = db.counters()["serve"]
    assert c["batches"] == 1 and c["decode"]["rebuckets"] >= 1
    prefill, decode = make_prefill_step(model, cache_len, db=db), make_decode_step(model, db=db)
    for out, p, n in zip(outs, prompts, budgets):
        logits, caches = prefill({"tokens": torch.tensor(p)[None]})
        solo = [int(logits[0, -1].argmax())]
        for step in range(n - 1):
            logits, caches = decode(torch.tensor([[solo[-1]]], dtype=torch.int32), caches, SEQ + step)
            solo.append(int(logits[0, -1].argmax()))
        assert out.token_ids.tolist() == solo
