"""The slice as a whole: falcon-mamba-7b (reduced: 2 layers, d_model 256,
vocab 512, state 16, ``ssm_pallas=True``) in the JAX package and in the
port, from the same weights (the JAX init, carried across by
``repro_torch.convert.lm_params``) and the same tokens (numpy, seeded).

The JAX side runs under ``repro.Database(dispatch="interpret")``, which
reaches the Pallas kernels (matmul, gather, segment sum, and the selective
scan, whose wrapper picks interpret mode off the TPU) in interpret mode; the
port's under ``repro_torch.Database(device="cpu")``, where every kernel
wrapper takes its plain version.

Tolerance: 1e-5 absolute and relative throughout. The products sum at most
512 f32 terms, in other orders on the two sides; the scan runs the same
recurrence in the same order. Logits and states are of order 1–10, so the
two sides differ by a few f32 roundings of each, which stays below 1e-5
through the two layers and three decode steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.configs import get_config as jax_get_config
from repro.core.engine import RAEngine as JaxEngine
from repro.core.relation import CooRelation as JCoo
from repro.core.relation import DenseRelation as JDense
from repro.models import build_model as jax_build_model
from repro.models.ssm import mamba1_apply as jax_mamba1_apply
from repro.relational import rel_embed as jax_rel_embed
from repro.relational.embedding import _embed_prog as jax_embed_prog
from repro.serving.serve import init_cache as jax_init_cache
from repro.serving.serve import make_decode_step as jax_make_decode_step
from repro.serving.serve import make_prefill_step as jax_make_prefill_step
from repro_torch import convert, kernels
from repro_torch.configs import get_config
from repro_torch.core.engine import RAEngine, engine_for
from repro_torch.core.relation import DenseRelation as TDense
from repro_torch.models import build_model
from repro_torch.models.blocks import block_init
from repro_torch.models.ssm import mamba1_apply
from repro_torch.relational import rel_embed
from repro_torch.relational.embedding import _embed_prog
from repro_torch.relational.linear import _linear_prog
from repro_torch.serving import init_cache, make_decode_step, make_prefill_step

TOL = 1e-5
BATCH, SEQ, DECODE_STEPS = 2, 16, 3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def lm():
    """(reference model, its params as numpy, port model with those params)."""
    jcfg = jax_get_config("falcon-mamba-7b").reduced(ssm_pallas=True)
    cfg = get_config("falcon-mamba-7b").reduced(ssm_pallas=True)
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


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=TOL, atol=TOL,
    )


def _close_tree(got, want):
    """Port caches (a list per stage, one entry per repeat) against the
    reference's, unstacked into the same layout by ``convert.lm_caches``."""

    def walk(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                walk(g[k], w[k])
        elif isinstance(w, list):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                walk(gi, wi)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            _close(g, w.numpy())

    walk(got, convert.lm_caches(_np(want), "cpu"))


# ---------------------------------------------------------------------------
# rel_embed
# ---------------------------------------------------------------------------


def test_rel_embed_matches_jax_forward_and_backward():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    ids = rng.integers(0, 40, size=13).astype(np.int32)
    g = rng.normal(size=(13, 8)).astype(np.float32)
    with repro.Database(dispatch="interpret").activate():
        jout = jax_rel_embed(jnp.asarray(table), jnp.asarray(ids))
        jgrad = jax.grad(lambda t: jnp.sum(jax_rel_embed(t, jnp.asarray(ids)) * g))(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    with repro_torch.Database(device="cpu").activate():
        out = rel_embed(t, torch.tensor(ids))
        (out * torch.tensor(g)).sum().backward()
    _close(out, jout)
    _close(t.grad, jgrad)


def test_rel_embed_resolves_to_gather_and_segment_sum_as_the_reference():
    """The join of the token stream with the table lowers to a gather_join
    site and the Σ by position to a segment_sum site, in both packages; the
    gradient query to the mirrored pair (a gather of the seed by position,
    a segment sum into the table's rows)."""
    rng = np.random.default_rng(4)
    v, d, b = 30, 6, 9
    table = rng.normal(size=(v, d)).astype(np.float32)
    keys = np.stack([np.arange(b), rng.integers(0, v, size=b)], 1).astype(np.int32)
    seed = rng.normal(size=(b, d)).astype(np.float32)
    ones = np.ones((b,), np.float32)
    jprog, jscans, jconsts = jax_embed_prog()
    tprog, tscans, tconsts = _embed_prog()
    jenv = {"Ids": JCoo(jnp.asarray(keys), jnp.asarray(ones), (b, v)),
            "Table": JDense(jnp.asarray(table), 1)}
    tenv = {"Ids": convert.coo_relation(keys, ones, (b, v), "cpu"),
            "Table": convert.dense_relation(table, 1, "cpu")}
    jlow = JaxEngine(jprog.forward).lower(jenv, dispatch="ref")
    tlow = RAEngine(tprog.forward).lower(tenv, dispatch="ref")
    assert dict(tlow.resolutions) == dict(jlow.resolutions) == {
        f"gather_join[E={b},N={v},D={d}]": "ref",
        f"segment_sum[E={b},D={d},S={b}]": "ref",
    }
    _close(tlow.compile()(tenv).data, jlow.eager(jenv).data)
    for env, scans, consts, arr in ((jenv, jscans, jconsts, jnp.asarray),
                                    (tenv, tscans, tconsts, torch.tensor)):
        env[f"__fwd_{scans['Table']}"] = env["Table"]
        env[f"__fwd_{consts['Ids']}"] = env["Ids"]
        env["__seed"] = (JDense if env is jenv else TDense)(arr(seed), 1)
    jlow = JaxEngine(jprog.grads["Table"]).lower(jenv, dispatch="ref")
    tlow = RAEngine(tprog.grads["Table"]).lower(tenv, dispatch="ref")
    assert dict(tlow.resolutions) == dict(jlow.resolutions)
    assert sorted(k.split("[")[0] for k in tlow.resolutions) == ["gather_join", "segment_sum"]
    _close(tlow.compile()(tenv).data, jlow.eager(jenv).data)


# ---------------------------------------------------------------------------
# mamba1_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True], ids=["prefill", "decode"])
def test_mamba1_apply_matches_jax(lm, with_state):
    jmodel, params, model = lm
    cfg = model.cfg
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["scan"]["0:mamba1"]["ssm"])
    p = model.stages[0]["scan"][0]["0:mamba1"]["ssm"]
    rng = np.random.default_rng(5)
    c = cfg.ssm_expand * cfg.d_model
    x = rng.normal(size=(BATCH, 1 if with_state else SEQ, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.normal(size=(BATCH, cfg.conv_width - 1, c)).astype(np.float32),
                 "ssm": rng.normal(size=(BATCH, c, cfg.ssm_state)).astype(np.float32)}
    with repro.Database(dispatch="interpret").activate():
        jy, jst = jax_mamba1_apply(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
            state=None if state is None else jax.tree.map(jnp.asarray, state),
            use_pallas=True,
        )
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        y, st = mamba1_apply(
            p, torch.tensor(x),
            state=None if state is None else {k: torch.tensor(v) for k, v in state.items()},
            use_pallas=True,
        )
    _close(y, jy)
    for k in ("conv", "ssm"):
        _close(st[k], jst[k])


# ---------------------------------------------------------------------------
# The whole slice: train_logits, prefill, greedy decode
# ---------------------------------------------------------------------------


def test_train_logits_match_jax(lm, tokens):
    jmodel, params, model = lm
    with repro.Database(dispatch="interpret").activate():
        jlogits, _ = jmodel.train_logits(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        logits, aux = model.train_logits({"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (BATCH, SEQ, 512) and float(aux) == 0.0
    _close(logits, jlogits)


def test_prefill_and_greedy_decode_match_jax(lm, tokens):
    jmodel, params, model = lm
    jprefill, jdecode = jax_make_prefill_step(jmodel, SEQ), jax_make_decode_step(jmodel)
    prefill, decode = make_prefill_step(model, SEQ), make_decode_step(model)
    db = repro_torch.Database(device="cpu")
    with repro.Database(dispatch="interpret").activate():
        jlogits, jcaches = jprefill(params, {"tokens": jnp.asarray(tokens)})
    with db.activate():
        logits, caches = prefill({"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (BATCH, 1, 512) and not logits.requires_grad
    _close(logits, jlogits)
    _close_tree(caches, jcaches)
    for step in range(DECODE_STEPS):
        token = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), token[:, 0])
        length = jnp.asarray(SEQ + step, jnp.int32)
        with repro.Database(dispatch="interpret").activate():
            jlogits, jcaches = jdecode(params, jnp.asarray(token), jcaches, length)
        with db.activate():
            logits, caches = decode(torch.tensor(token), caches, SEQ + step)
        _close(logits, jlogits)
        _close_tree(caches, jcaches)


def test_serving_lowers_once_per_signature(lm, tokens):
    """Prefill then decode lower each projection once per (x, w) shape
    signature, and the embedding once per batch length: a second decode
    step, or a second request, lowers nothing."""
    _, _, model = lm
    cfg = model.cfg
    engines = [engine_for(_linear_prog()[0].forward), engine_for(_embed_prog()[0].forward)]
    db = repro_torch.Database(device="cpu", dispatch="ref")  # a table no other test uses
    prefill, decode = make_prefill_step(model, SEQ), make_decode_step(model)
    with db.activate():
        before = [e.lower_count for e in engines]
        for _ in range(2):
            logits, caches = prefill({"tokens": torch.tensor(tokens)})
            for step in range(DECODE_STEPS):
                token = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, caches = decode(token, caches, SEQ + step)
        lowered = [e.lower_count - b for e, b in zip(engines, before)]
    d, c, r = cfg.d_model, cfg.ssm_expand * cfg.d_model, max(1, cfg.d_model // 16)
    weights = [(d, 2 * c), (c, r + 2 * cfg.ssm_state), (r, c), (c, d)]
    # four projections at m = B·S (prefill) and at m = B (decode); the head
    # at m = B in both
    assert lowered == [2 * len(weights) + 1, 2]


def test_init_cache_matches_the_reference_layout():
    cfg = get_config("falcon-mamba-7b").reduced()
    jcfg = jax_get_config("falcon-mamba-7b").reduced()
    got = init_cache(cfg, BATCH, SEQ, device="cpu")
    _close_tree(got, jax_init_cache(jcfg, BATCH, SEQ))


def test_parameter_count_matches_the_reference(lm):
    jmodel, params, model = lm
    want = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == want
    full = jax.eval_shape(jax_build_model(jax_get_config("falcon-mamba-7b")).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full)) == 7_272_665_088


def test_entry_points_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("falcon-mamba-7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 4)


def test_unknown_block_kinds_raise():
    """Every kind of the reference builds; another raises ``ValueError``,
    as the reference's ``block_init`` / ``block_apply`` do."""
    gen = torch.Generator().manual_seed(0)
    for kind, arch in (("mla", "deepseek-v3-671b"), ("enc", "whisper-small"), ("dec", "whisper-small")):
        assert "attn" in block_init(gen, kind, get_config(arch).reduced())
    with pytest.raises(ValueError, match="unknown block kind"):
        block_init(gen, "conv", get_config("olmoe-1b-7b").reduced())
    with pytest.raises(ValueError, match="unknown block kind"):
        build_model(dataclasses.replace(get_config("falcon-mamba-7b").reduced(), pattern=("conv",)),
                    device="cpu")


@pytest.mark.parametrize("field, arch", [
    ("first_k_dense", "deepseek-v3-671b"), ("mla", "deepseek-v3-671b"),
    ("encoder_layers", "whisper-small"), ("mrope_sections", "qwen2-vl-72b"),
])
def test_configs_of_the_other_families_build_and_match_the_reference(field, arch):
    """A config that sets ``field`` (the family that has it, reduced)
    builds on the CPU and, with the reference's weights, gives the
    reference's train logits (a batch from ``batch_for``, with its frames or
    patches)."""
    from repro.data import batch_for as jax_batch_for
    from repro_torch.data import batch_for

    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    assert getattr(cfg, field)
    jmodel = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = convert.lm_params(build_model(cfg, device="cpu"), params)
    jbatch = jax_batch_for(jcfg, 2, 6, np.random.default_rng(0))
    batch = batch_for(cfg, 2, 6, np.random.default_rng(0), device="cpu")
    with repro.Database(dispatch="ref").activate():
        want, _ = jmodel.train_logits(params, jbatch)
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        got, _ = model.train_logits(batch)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()))
