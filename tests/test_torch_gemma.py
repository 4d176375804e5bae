"""The dense-attention families in the JAX package and in the port:
gemma's sliding-window ``local`` layers and full ``global`` ones, the
attention and final logit softcaps, tied embeddings and ``embed_scale``
(gemma2-9b, gemma3-4b), and the llama-architecture configs (llama3-405b,
deepseek-coder-33b).

Attention is held to the reference's functions directly: the window on
the dense path and on the chunked online-softmax path (its last block
padded), decode against a left-aligned cache with a window and against a
right-aligned window cache. The models run reduced (``reduced()``: d_model
256, 4 heads of 64 over 2 KV heads, d_ff 512, vocab 512, window 16,
attn_chunk 16; gemma2 its 4 layers, 2 local + 2 global; gemma3 8 layers,
one superblock of 5 local + 1 global and a tail of 2 local, so that the
tail runs too) from the same weights (the JAX init, carried across by
``repro_torch.convert.lm_params``) and the same tokens (numpy, seeded):
prompts of 40 tokens, past the window and past attn_chunk, so the window
crosses the chunked path's blocks and every local cache is right-aligned
and full.

The JAX side runs under ``repro.Database(dispatch=JAX_TIER)`` (the
Pallas kernels in interpret mode); the port's under
``repro_torch.Database(device="cpu")``, where every kernel wrapper takes its
plain version. Every JAX input is an explicit float32/int32 array.

Tolerances: 1e-5 absolute and relative (``TOL``) for f32 values, as in
``tests/test_torch_zamba2.py``: the products sum at most 512 f32 terms in
other orders on the two sides, and the softcaps' tanh is 1-Lipschitz.
Gradients are held to 1e-5 of their tensor's largest entry
(``_close_scaled``): each entry sums a term per token (80 here) in another
order on each side; the tied table's gradient sums two such parts, the
head's dW and ``rel_embed``'s table gradient, and is held to the same
bound. A parameter or Adam moment after one step: 1e-5 relative in the
2-norm (``STATE_TOL``, ``tests/test_torch_train.py`` says why); a bf16
moment entry within one bf16 rounding of the reference's (``_close_bf16``).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data import synthetic_lm_batches as jax_synthetic_lm_batches
from repro.models import build_model as jax_build_model
from repro.models.attention import attention as jax_attention
from repro.models.attention import decode_attention as jax_decode_attention
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro.serving.serve import init_cache as jax_init_cache
from repro.serving.serve import make_decode_step as jax_make_decode_step
from repro.serving.serve import make_prefill_step as jax_make_prefill_step
from repro.train import lm_loss as jax_lm_loss
from repro.train import make_train_step as jax_make_train_step
from repro_torch import convert, kernels
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.ckpt import _arrays
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.models import build_model
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.model import Stage, stages_of
from repro_torch.optim import adam_update
from repro_torch.serving import init_cache, make_decode_step, make_prefill_step
from repro_torch.serving.serve import map_cache
from repro_torch.train import init_train_state, lm_loss, make_train_step
from torch_lm_parity import F64, depth_bound, f64_model, hold_to_oracle, oracle_gap

TOL = 1e-5
STATE_TOL = 1e-5
GEMMAS = ("gemma2-9b", "gemma3-4b")
LLAMAS = ("llama3-405b", "deepseek-coder-33b")
#: layers of the reduced models: gemma3's 8 reach its tail (34 = 5 x 6 + 4)
LAYERS = {"gemma2-9b": 4, "gemma3-4b": 8, "llama3-405b": 2, "deepseek-coder-33b": 2}
BATCH, SEQ, DECODE_STEPS = 2, 40, 6
#: the reference's dispatch tier
JAX_TIER = "ref"


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _configs(arch, **kw):
    kw = dict(n_layers=LAYERS[arch], **kw)
    return get_config(arch).reduced(**kw), jax_get_config(arch).reduced(**kw)


def _lm(arch):
    """(reference model, its params as numpy, port model with those params)."""
    cfg, jcfg = _configs(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    params = _np(jmodel.init(jax.random.PRNGKey(0)))
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), params)
    return jmodel, params, model


@pytest.fixture(scope="module", params=GEMMAS)
def gemma(request):
    return _lm(request.param)


@pytest.fixture(scope="module")
def gemma3():
    return _lm("gemma3-4b")


@pytest.fixture(scope="module", params=LLAMAS)
def llama(request):
    return _lm(request.param)


def _tokens(vocab, seq=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(BATCH, seq)).astype(np.int32)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=TOL, atol=atol,
    )


def _close_scaled(got, want):
    """Within TOL of the tensor's largest entry (at least 1): each entry
    is an f32 sum whose rounding scales with its terms, not with the sum.
    Gradients sum a term per token; the tied head's logits sum d_model
    products of a unit-norm row with a table row of unit-variance entries
    (``embed_init``), so they reach ±20 and an entry near 0 keeps the
    rounding of the large ones."""
    want = np.asarray(want, np.float32)
    _close(got, want, atol=TOL * max(1.0, float(np.abs(want).max())))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close_bf16(got, want):
    """bf16 tensors: each entry within one bf16 rounding of the
    reference's. Both round f32 values that differ by a few f32 roundings
    (``STATE_TOL``) to bf16, so an entry near a rounding boundary may land
    one bf16 unit (at most 2^-7 of it) apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


def _flat_ref(tree, sep="."):
    return {
        sep.join(str(getattr(k, "key", getattr(k, "idx", "?"))) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _leaves(tree):
    out = []
    map_cache(lambda t: out.append(t), tree)
    return out


def _close_tree(got, want):
    """Port caches against the reference's, unstacked into the port's
    layout by ``convert.lm_caches``: the same keys, shapes and dtypes."""

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
# The configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", GEMMAS + LLAMAS)
def test_config_equals_the_reference_field_by_field(arch):
    assert arch in ARCH_IDS
    want = dataclasses.asdict(jax_get_config(arch))
    got = dataclasses.asdict(get_config(arch))
    assert list(got) == list(want) and got == want


def test_stages_of_the_published_depths():
    """gemma2: 21 x (local, global); gemma3: 5 x (5 local + 1 global) and a
    tail of 4 local; llama3: 126 x attn."""
    assert stages_of(get_config("gemma2-9b")) == [Stage(("local", "global"), 21)]
    pattern = ("local",) * 5 + ("global",)
    assert stages_of(get_config("gemma3-4b")) == [Stage(pattern, 5, ("local",) * 4)]
    assert stages_of(_configs("gemma3-4b")[0]) == [Stage(pattern, 1, ("local",) * 2)]
    assert stages_of(get_config("llama3-405b")) == [Stage(("attn",), 126)]


def _names_and_shapes_match(lm):
    """Every parameter of the reduced model under the reference's name (a
    stage's repeats stacked, the checkpoint's layout), in its shape."""
    _, params, model = lm
    want = {k: v.shape for k, v in _flat_ref(params, "/").items()}
    got = {k: v.shape for k, v in _arrays(dict(model.named_parameters()), "").items()}
    assert got == want
    assert ("out_embed" in got) == (not model.cfg.tie_embeddings)


def test_a_tied_model_has_the_references_parameters_and_no_out_embed(gemma):
    _names_and_shapes_match(gemma)
    assert not hasattr(gemma[2], "out_embed")


def test_an_untied_model_has_the_references_parameters(llama):
    _names_and_shapes_match(llama)


# ---------------------------------------------------------------------------
# Attention with a window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window, chunk, seq, cap", [
    (8, None, 24, 50.0),   # dense path, past the window
    (8, None, 24, None),
    (8, 16, 40, 50.0),     # chunked: 3 blocks, the last padded by 8
    (16, 16, 40, None),
    (5, 8, 21, 50.0),      # a window that is no multiple of the block
    (None, 16, 40, 50.0),  # no window, padded last block
])
def test_attention_with_a_window_matches_jax(window, chunk, seq, cap):
    rng = np.random.default_rng(seq + (window or 0))
    q = rng.normal(size=(2, seq, 4, 16)).astype(np.float32) * 2
    k = rng.normal(size=(2, seq, 2, 16)).astype(np.float32) * 2
    v = rng.normal(size=(2, seq, 2, 16)).astype(np.float32)
    pos = np.arange(seq, dtype=np.int32)
    kw = dict(window=window, logit_softcap=cap, chunk_size=chunk)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos), **kw)
    got = attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                    q_positions=torch.tensor(pos), k_positions=torch.tensor(pos), **kw)
    _close(got, want)
    if window is not None:
        # the window changes the result: the last query sees fewer keys
        full = attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         q_positions=torch.tensor(pos), k_positions=torch.tensor(pos),
                         logit_softcap=cap, chunk_size=chunk)
        assert not torch.allclose(full[:, -1], got[:, -1], atol=1e-3)


@pytest.mark.parametrize("align, length, window", [
    ("left", 20, 8),     # left-aligned cache of 24 slots, 20 valid, the last 8 kept
    ("left", 24, None),
    ("right", 10, None),  # right-aligned window cache of 16 slots, 10 valid
    ("right", 16, None),
])
def test_decode_attention_matches_jax(align, length, window):
    rng = np.random.default_rng(length)
    s = 24 if align == "left" else 16
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32) * 2
    ck = rng.normal(size=(2, s, 2, 16)).astype(np.float32) * 2
    cv = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    kw = dict(window=window, logit_softcap=50.0, align=align)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(length, jnp.int32), **kw)
    got = decode_attention(torch.tensor(q), torch.tensor(ck), torch.tensor(cv), length, **kw)
    _close(got, want)


@pytest.mark.parametrize("cache_len", [12, 40], ids=["below-window", "above-window"])
def test_init_cache_local_entries_match_the_reference(cache_len):
    """A local layer's cache is min(window, cache_len) wide (window 16), a
    global layer's cache_len."""
    cfg, jcfg = _configs("gemma3-4b")
    got = init_cache(cfg, BATCH, cache_len, device="cpu")
    _close_tree(got, jax_init_cache(jcfg, BATCH, cache_len))
    entry = got[0]["scan"][0]
    assert entry["0:local"]["kv"]["k"].shape[1] == min(16, cache_len)
    assert entry["5:global"]["kv"]["k"].shape[1] == cache_len
    assert got[0]["tail"][1]["kv"]["v"].shape[1] == min(16, cache_len)


# ---------------------------------------------------------------------------
# gemma2 and gemma3 reduced: logits, prefill and decode, gradients, Adam
# ---------------------------------------------------------------------------


def test_train_logits_match_jax(gemma):
    jmodel, params, model = gemma
    tokens = _tokens(model.cfg.vocab)
    with repro.Database(dispatch=JAX_TIER).activate():
        jlogits, _ = jax.jit(jmodel.train_logits)(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        logits, aux = model.train_logits({"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (BATCH, SEQ, model.cfg.vocab) and float(aux) == 0.0
    cap = model.cfg.final_softcap
    assert cap is None or float(logits.abs().max()) <= cap
    _close_scaled(logits, jlogits)


def test_embed_scale_rounds_sqrt_d_model_to_the_activations_dtype(gemma):
    """In bf16, √d_model is rounded to bf16 before the product (the
    reference's ``jnp.asarray(d_model**0.5, x.dtype)``): the scaled rows
    equal the reference's bit for bit."""
    jmodel, params, model = gemma
    cfg = dataclasses.replace(model.cfg, dtype="bfloat16")
    jm = jax_build_model(dataclasses.replace(jmodel.cfg, dtype="bfloat16"))
    table = np.asarray(params["embed"], np.float32)
    tokens = _tokens(cfg.vocab, seq=8)
    with repro.Database(dispatch=JAX_TIER).activate():
        want = jm._embed({"embed": jnp.asarray(table, jnp.bfloat16)}, jnp.asarray(tokens))
    port = build_model(dataclasses.replace(cfg, n_layers=len(cfg.pattern)), device="cpu")
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        got = port._embed({"embed": torch.tensor(table).to(torch.bfloat16)}, torch.tensor(tokens))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    unscaled = torch.tensor(table).to(torch.bfloat16)[torch.tensor(tokens).long()]
    assert not torch.equal(got, unscaled)


@pytest.mark.parametrize("prompt, cache_len", [(SEQ, SEQ + DECODE_STEPS), (8, 14)],
                         ids=["past-the-window", "cache-below-the-window"])
def test_prefill_and_greedy_decode_match_jax(gemma, prompt, cache_len):
    """Prefill, then greedy decode steps, every step's logits and every
    cache leaf against the reference's. Past the window (a 40-token
    prompt), the local caches are window-sized, right-aligned and full,
    and each step shifts them; with cache_len below the window (an
    8-token prompt, cache_len 14), the local cache is cache_len wide and
    right-aligned, its first slots empty until decode fills them."""
    jmodel, params, model = gemma
    tokens = _tokens(model.cfg.vocab, seq=prompt, seed=1)
    steps = cache_len - prompt
    jprefill, jdecode = jax_make_prefill_step(jmodel, cache_len), jax_make_decode_step(jmodel)
    prefill, decode = make_prefill_step(model, cache_len), make_decode_step(model)
    db = repro_torch.Database(device="cpu")
    with repro.Database(dispatch=JAX_TIER).activate():
        jlogits, jcaches = jprefill(params, {"tokens": jnp.asarray(tokens)})
    with db.activate():
        logits, caches = prefill({"tokens": torch.tensor(tokens)})
    _close_scaled(logits, jlogits)
    _close_tree(caches, jcaches)
    local = caches[0]["scan"][0]["0:local"]["kv"]["k"]
    assert local.shape[1] == min(model.cfg.window, cache_len)
    for step in range(steps):
        token = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), token[:, 0])
        with repro.Database(dispatch=JAX_TIER).activate():
            jlogits, jcaches = jdecode(params, jnp.asarray(token), jcaches,
                                       jnp.asarray(prompt + step, jnp.int32))
        with db.activate():
            logits, caches = decode(torch.tensor(token), caches, prompt + step)
        _close_scaled(logits, jlogits)
        _close_tree(caches, jcaches)


def test_decode_equals_a_longer_prefill(gemma3):
    """Decode through the window caches against a prefill over the prompt
    plus the fed token, in the port alone; a decode that ignores the
    window (local layers given full left-aligned caches, no window) does
    not."""
    _, _, model = gemma3
    cfg = model.cfg
    tokens = torch.tensor(_tokens(cfg.vocab, seed=2))
    db = repro_torch.Database(device="cpu")
    with db.activate():
        logits, caches = make_prefill_step(model, SEQ + 1)({"tokens": tokens})
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        step, _ = make_decode_step(model)(nxt, caches, SEQ)
        want, _ = make_prefill_step(model, SEQ + 1)({"tokens": torch.cat([tokens, nxt], 1)})
        _close_scaled(step, want)
        model.cfg = dataclasses.replace(cfg, window=None)
        try:
            _, wide = make_prefill_step(model, SEQ + 1)({"tokens": tokens})
            ignored, _ = make_decode_step(model)(nxt, wide, SEQ)
        finally:
            model.cfg = cfg
    assert float((ignored - want).abs().max()) > 1e-3


def _train(jmodel, params, model):
    """One train step from the same weights and batch, in both packages.

    The reference: its train loss and ``jax.grad`` of it (jitted), then
    ``adam_update`` with the moments in ``cfg.opt_state_dtype``. The port:
    its loss and gradients by autograd, the loss of one
    ``make_train_step`` step, and its ``adam_update`` on the reference's
    gradients (carried across by ``lm_params``), so that the update is
    held apart from the gradients (``test_train_gradients_match_jax`` holds
    those): at step 1 Adam moves an entry by lr·g/(|g| + eps), and a
    gradient entry near eps = 1e-8 passes its rounding on magnified."""
    cfg = model.cfg
    jbatch = next(jax_synthetic_lm_batches(jmodel.cfg, BATCH, SEQ, seed=0))
    dtype = jnp.dtype(jmodel.cfg.opt_state_dtype)

    def jloss(p):
        logits, aux = jmodel.train_logits(p, jbatch)
        return jax_lm_loss(logits, jbatch["labels"]) + 0.01 * aux

    with repro.Database(dispatch=JAX_TIER).activate():
        loss, jg = jax.jit(jax.value_and_grad(jloss))(_jax(params))
    jp, jo = jax_adam_update(_jax(params), jg, jax_adam_init(params, dtype=dtype),
                             lr=3e-4, grad_clip=1.0)
    batch = next(synthetic_lm_batches(cfg, BATCH, SEQ, seed=0, device="cpu"))
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
    with repro_torch.Database(device="cpu").activate():
        logits, aux = model.train_logits(batch, leaves)
        total = lm_loss(logits, batch["labels"]) + 0.01 * aux
    got = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    state = init_train_state(model)
    _, _, m = make_train_step(model, database=repro_torch.Database(device="cpu"))(
        {k: v.clone() for k, v in state.params.items()}, init_train_state(model).opt_state, batch)
    carried = dict(convert.lm_params(build_model(cfg, device="cpu"), _np(jg)).named_parameters())
    p, o = adam_update(state.params, {k: g.detach() for k, g in carried.items()}, state.opt_state,
                       lr=3e-4, grad_clip=1.0)
    return {"ref": (float(loss), _flat_ref(_np(jg)), _np(jp), _np(jo)),
            "port": (float(m["total"]), got, p, o)}


@pytest.fixture(scope="module")
def gemma_train(gemma):
    return _train(*gemma)


@pytest.mark.parametrize("part", ["embed", "stages", "ln_f"])
def test_train_gradients_match_jax(gemma_train, part):
    """Every parameter's gradient, by part: the tied table's (the head's
    dW plus the embedding's table gradient), the layers' (the softcaps'
    backward inside), the final norm's. Each reference scan leaf is
    repeat 0 of the port's."""
    (jloss, jg, _, _), (loss, got, _, _) = gemma_train["ref"], gemma_train["port"]
    np.testing.assert_allclose(loss, jloss, rtol=TOL, atol=TOL)
    want = {k: v for k, v in jg.items() if k.split(".")[0] == part}
    assert want
    seen = 0
    for k, w in want.items():
        parts = k.split(".")
        scan = parts[2:3] == ["scan"]
        for r in range(w.shape[0] if scan else 1):
            name = ".".join(parts[:3] + [str(r)] + parts[3:]) if scan else k
            assert tuple(got[name].shape) == (w[r] if scan else w).shape, name
            _close_scaled(got[name], w[r] if scan else w)
            seen += 1
    if part == "stages":
        assert seen + sum(k.split(".")[0] != part for k in jg) == len(got)


def test_the_tied_gradient_sums_the_head_and_the_embedding(gemma):
    """The tied table's gradient is the sum of its two uses: the same loss
    through a model with an untied head holding the same table gives
    ``embed``'s (the embedding's part) and ``out_embed``'s (the head's, as
    (d, V)); their sum equals the tied gradient."""
    _, params, model = gemma
    cfg = model.cfg
    tokens, labels = torch.tensor(_tokens(cfg.vocab, seed=5)), torch.tensor(_tokens(cfg.vocab, seed=6))
    untied = build_model(dataclasses.replace(cfg, tie_embeddings=False), device="cpu")
    with torch.no_grad():
        for name, p in untied.named_parameters():
            p.copy_(model.embed.T if name == "out_embed" else model.get_parameter(name))

    def grads(m):
        leaves = {k: v.detach().requires_grad_(True) for k, v in m.named_parameters()}
        with repro_torch.Database(device="cpu").activate():
            logits, _ = m.train_logits({"tokens": tokens}, leaves)
            loss = lm_loss(logits, labels)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    tied, split = grads(model), grads(untied)
    torch.testing.assert_close(tied["embed"], split["embed"] + split["out_embed"].T,
                               rtol=TOL, atol=TOL * float(tied["embed"].abs().max()))
    assert float(split["embed"].abs().max()) > 0 and float(split["out_embed"].abs().max()) > 0


def test_remat_policies_give_the_gradients_of_no_remat_bit_for_bit(gemma):
    """``remat`` under "nothing" and "dots": the window's mask and the
    softcaps recomputed in the backward, the tied head outside the
    superblocks; the gradients equal those without remat bit for bit."""
    _, _, model = gemma
    cfg = model.cfg
    tokens, labels = torch.tensor(_tokens(cfg.vocab, seed=7)), torch.tensor(_tokens(cfg.vocab, seed=8))
    got = {}
    try:
        for policy in (None, "nothing", "dots"):
            model.cfg = dataclasses.replace(cfg, remat=policy is not None, remat_policy=policy or "nothing")
            leaves = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
            with repro_torch.Database(device="cpu").activate():
                logits, _ = model.train_logits({"tokens": tokens}, leaves)
                loss = lm_loss(logits, labels)
            got[policy] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    finally:
        model.cfg = cfg
    for policy in ("nothing", "dots"):
        assert all(torch.equal(got[policy][k], got[None][k]) for k in got[None]), policy


@pytest.mark.parametrize("part", ["params", "mu", "nu"])
def test_adam_step_updates_every_tensor_as_jax(gemma_train, part):
    (_, _, jp, jo), (_, _, p, o) = gemma_train["ref"], gemma_train["port"]
    want = _flat_ref(jp if part == "params" else jo[part], "/")
    got = _arrays(p if part == "params" else o[part], "")
    assert sorted(got) == sorted(want) and "out_embed" not in want
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= STATE_TOL, (k, _rel(got[k], want[k]))
    if part == "params":
        assert int(o["step"]) == int(jo["step"]) == 1


# ---------------------------------------------------------------------------
# llama3 and deepseek-coder reduced
# ---------------------------------------------------------------------------


def test_llama_architecture_forward_and_decode_match_jax(llama):
    """A forward over the prompt, and a prefill plus two decode steps. The
    caches at the end (each layer's K and V, entries up to several units
    wide, unscaled) are held, both f32 sides, to the f64 run's within
    ``torch_lm_parity.depth_bound`` over the model's layers and the longest
    f32 sum (d_ff = 512); a fixed 1e-5 of each entry sat at the edge of f32
    rounding there (llama3's used 0.57 of it)."""
    jmodel, params, model = llama
    assert hasattr(model, "out_embed") and not model.cfg.tie_embeddings
    tokens = _tokens(model.cfg.vocab, seed=9)
    cache_len = SEQ + 2
    with repro.Database(dispatch=JAX_TIER).activate():
        jlogits, _ = jax.jit(jmodel.train_logits)(params, {"tokens": jnp.asarray(tokens)})
        jl, jc = jax_make_prefill_step(jmodel, cache_len)(params, {"tokens": jnp.asarray(tokens)})
    db = repro_torch.Database(device="cpu")
    with db.activate(), torch.no_grad():
        logits, _ = model.train_logits({"tokens": torch.tensor(tokens)})
    _close_scaled(logits, jlogits)
    with db.activate():
        pl, caches = make_prefill_step(model, cache_len)({"tokens": torch.tensor(tokens)})
    _close_scaled(pl, jl)
    m64 = f64_model(model)
    with db.activate(), F64():
        _, caches64 = make_prefill_step(m64, cache_len)({"tokens": torch.tensor(tokens)})
    jdecode, decode, decode64 = jax_make_decode_step(jmodel), make_decode_step(model), make_decode_step(m64)
    for step in range(2):
        token = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        with repro.Database(dispatch=JAX_TIER).activate():
            jl, jc = jdecode(params, jnp.asarray(token), jc, jnp.asarray(SEQ + step, jnp.int32))
        with db.activate():
            pl, caches = decode(torch.tensor(token), caches, SEQ + step)
            with F64():
                _, caches64 = decode64(torch.tensor(token), caches64, SEQ + step)
        _close_scaled(pl, jl)
    got, want = map_cache(lambda t: t, caches), convert.lm_caches(_np(jc), "cpu")
    for g, w, o in zip(_leaves(got), _leaves(want), _leaves(caches64)):
        assert g.dtype == w.dtype and g.shape == w.shape == o.shape
        bound = depth_bound(o, model.cfg.n_layers, model.cfg.d_ff)
        hold_to_oracle(g, w, o, bound)
        # planted: the leaf scaled by 1 + 1e-4, as one layer's output off
        # by that much would leave it, must fail
        assert oracle_gap(g * (1 + 1e-4), o) > bound, "the bound passes a 1e-4 error"


def test_adam_moments_in_opt_state_dtype_match_the_references(llama):
    """``opt_state_dtype``: llama3's "bfloat16", deepseek-coder's default
    f32. ``init_train_state`` makes the moments in it, and one step gives
    the reference's parameters (f32, within STATE_TOL) and moments (f32
    within STATE_TOL; bf16 each entry within one rounding)."""
    jmodel, params, model = llama
    dtype = getattr(torch, model.cfg.opt_state_dtype)
    assert dtype == (torch.bfloat16 if model.cfg.name == "llama3-405b" else torch.float32)
    run = _train(jmodel, params, model)
    (jloss, _, jp, jo), (loss, _, p, o) = run["ref"], run["port"]
    np.testing.assert_allclose(loss, jloss, rtol=TOL, atol=TOL)
    assert all(t.dtype == dtype for t in init_train_state(model).opt_state["nu"].values())
    for moment in ("mu", "nu"):
        assert all(t.dtype == dtype for t in o[moment].values())
        want = _flat_ref(jo[moment], "/")
        got = _arrays({k: v.float() for k, v in o[moment].items()}, "")
        assert sorted(got) == sorted(want)
        for k in want:
            assert want[k].dtype == jnp.dtype(model.cfg.opt_state_dtype)
            if dtype == torch.bfloat16:
                _close_bf16(got[k], want[k].astype(np.float32))
            else:
                assert _rel(got[k], want[k]) <= STATE_TOL, k
    want, got = _flat_ref(jp, "/"), _arrays(p, "")
    for k in want:
        assert _rel(got[k], want[k]) <= STATE_TOL, k


# ---------------------------------------------------------------------------
# Serving, conversion and checkpoints
# ---------------------------------------------------------------------------


def test_endpoint_completions_equal_their_solo_runs(gemma3):
    """Three concurrent requests of gemma3 through ``db.endpoint``: one
    prefill at a padded bucket (3 rows in 4), decode at buckets 4, 2 and 1
    with compaction, every cache leaf moved on its batch axis: the global
    layers' K/V of cache_len slots and the local layers' right-aligned
    window caches of 16; each completion equals the request served alone."""
    model = gemma3[2]
    cache_len, budgets = SEQ + 4, [4, 2, 3]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, model.cfg.vocab, size=SEQ).astype(np.int32) for _ in budgets]
    db = repro_torch.Database(device="cpu")
    db.register_model("gemma3", model, {k: p.detach() for k, p in model.named_parameters()})
    ep = db.endpoint("gemma3", cache_len=cache_len, buckets=[(2, SEQ), (4, SEQ)])

    async def go():
        return await asyncio.gather(*[ep.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)])

    with db.activate():
        ep.warmup()
        outs = asyncio.run(go())
    c = db.counters()["serve"]
    assert c["batches"] == 1 and c["decode"]["rebuckets"] >= 1
    prefill, decode = make_prefill_step(model, cache_len, db=db), make_decode_step(model, db=db)
    widths = set()
    for out, p, n in zip(outs, prompts, budgets):
        logits, caches = prefill({"tokens": torch.tensor(p)[None]})
        map_cache(lambda t: widths.add(t.shape[1]), caches)
        solo = [int(logits[0, -1].argmax())]
        for step in range(n - 1):
            logits, caches = decode(torch.tensor([[solo[-1]]], dtype=torch.int32), caches, SEQ + step)
            solo.append(int(logits[0, -1].argmax()))
        assert out.token_ids.tolist() == solo
    assert widths == {model.cfg.window, cache_len}


def test_lm_params_refuses_a_parameter_the_reference_tree_lacks(gemma):
    """An untied port model given a tied model's tree would keep a random
    ``out_embed``: ``lm_params`` names it and raises."""
    _, params, model = gemma
    untied = build_model(dataclasses.replace(model.cfg, tie_embeddings=False), device="cpu")
    with pytest.raises(ValueError, match="out_embed"):
        convert.lm_params(untied, params)
    with pytest.raises(AttributeError, match="out_embed"):
        convert.lm_params(build_model(model.cfg, device="cpu"), dict(params, out_embed=np.zeros(3)))


def test_lm_caches_carry_the_local_entries(gemma3):
    """The reference's prefill caches, through ``lm_caches``, in the shapes
    and dtypes of the port's own prefill: window-sized local entries."""
    jmodel, params, model = gemma3
    tokens = _tokens(model.cfg.vocab, seed=10)
    with repro.Database(dispatch=JAX_TIER).activate():
        _, jcaches = jax_make_prefill_step(jmodel, SEQ)(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate():
        _, caches = make_prefill_step(model, SEQ)({"tokens": torch.tensor(tokens)})
    shapes = []
    for tree in (convert.lm_caches(_np(jcaches), "cpu"), caches):
        got = []
        map_cache(lambda t: got.append((tuple(t.shape), t.dtype)), tree)
        shapes.append(got)
    assert shapes[0] == shapes[1]
    assert (BATCH, model.cfg.window, model.cfg.n_kv_heads, model.cfg.hd()) in [s for s, _ in shapes[1]]


def test_a_tied_reference_checkpoint_restores_in_the_port(gemma, tmp_path):
    jmodel, params, model = gemma
    opt = _np(jax_adam_init(params))
    opt["nu"] = jax.tree.map(lambda a: a + 2, opt["nu"])
    path = jax_save_checkpoint(str(tmp_path), 3, params, opt)
    with np.load(path) as data:
        assert "params/embed" in data and not any("out_embed" in k for k in data)
    state = init_train_state(build_model(model.cfg, device="cpu", seed=3))
    got_p, got_o = restore_checkpoint(path, state.params, state.opt_state)
    for tree, want in ((got_p, params), (got_o["nu"], opt["nu"])):
        flat, ref = _arrays(tree, ""), _flat_ref(want, "/")
        assert sorted(flat) == sorted(ref) and all(np.array_equal(flat[k], ref[k]) for k in ref)


def test_a_tied_port_checkpoint_restores_in_the_reference(gemma, tmp_path):
    jmodel, params, model = gemma
    state = init_train_state(model)
    path = save_checkpoint(str(tmp_path), 1, state.params, state.opt_state)
    with np.load(path) as data:
        assert not any("out_embed" in k for k in data)
    jp, jo = jax_restore_checkpoint(path, params, jax_adam_init(params))
    flat, ref = _flat_ref(jp, "/"), _arrays(state.params, "")
    assert sorted(flat) == sorted(ref) and all(np.array_equal(flat[k], ref[k]) for k in ref)


def test_bf16_moments_checkpoint_restores_in_the_port_from_either_file(tmp_path):
    """llama3's bf16 Adam moments: the reference writes them as 2-byte
    void entries (numpy cannot cast its bfloat16), the port writes the
    same entries, and the port restores the bits from either file (the
    reference's own restore cannot cast them: ROADMAP.md §3)."""
    jmodel, params, model = _lm("llama3-405b")
    opt = jax_adam_init(params, dtype=jnp.bfloat16)
    opt["mu"] = jax.tree.map(lambda a: (a + 0.3).astype(jnp.bfloat16), opt["mu"])
    want = {k: v.astype(np.float32) for k, v in _flat_ref(_np(opt["mu"]), "/").items()}
    state = init_train_state(model)
    assert all(t.dtype == torch.bfloat16 for t in state.opt_state["mu"].values())
    ref_path = jax_save_checkpoint(str(tmp_path / "ref"), 1, params, _np(opt))
    _, got_o = restore_checkpoint(ref_path, state.params, state.opt_state)
    got = _arrays({k: v.float() for k, v in got_o["mu"].items()}, "")
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    port_path = save_checkpoint(str(tmp_path / "port"), 1, state.params, got_o)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes() or not k.startswith("opt/mu"), k
    _, again = restore_checkpoint(port_path, state.params, state.opt_state)
    assert all(torch.equal(again["mu"][k], got_o["mu"][k]) for k in got_o["mu"])
