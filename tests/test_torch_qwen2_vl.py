"""qwen2-vl in the JAX package and in the port: M-RoPE (the rotary spectrum
split into t/h/w sections), the stubbed patch embeddings as a prefix of
the sequence (sliced off before the head), decode after the vision prefix
at ``length = seq + vis``, and the endpoint's ``make_batch`` adding the
patches.

The model runs reduced (``reduced()``: 2 layers, d_model 256, 4 heads of
64 over 2 KV heads, d_ff 512, vocab 512, vis_seq 8, attn_chunk 16; the
published sections (16, 24, 24) cut to the 32 frequency pairs of a 64-wide
head, as the reference cuts them). ``tests/torch_lm_parity.py`` says how
the two packages are fed and at which tolerances.

The reference's decode does not agree with a longer prefill (ROADMAP.md
§3): prefill places the text after the patches at positions grid, grid +
1, ... (grid = √vis, and 1 without patches), while decode rotates the new
token by ``length``, which the endpoint sets to seq + vis. The port
follows the reference, and ``test_decode_differs_from_a_longer_prefill_as_
in_the_reference`` shows the gap in both packages.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.serving.serve import make_decode_step as jax_make_decode_step
from repro.serving.serve import make_prefill_step as jax_make_prefill_step
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.common import apply_mrope
from repro_torch.serving import make_decode_step, make_prefill_step
from torch_lm_parity import (batch_pair, close, close_scaled, close_tree, gap, grads_match, lm,
                             port, ref)

ARCH = "qwen2-vl-72b"
BATCH, SEQ, DECODE_STEPS = 2, 20, 3


@pytest.fixture(scope="module")
def qwen():
    return lm(ARCH)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


def _inputs(cfg, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(BATCH, seq)).astype(np.int32)
    patches = rng.normal(size=(BATCH, cfg.vis_seq, cfg.d_model)).astype(np.float32)
    return tokens, patches


def test_config_equals_the_reference_field_by_field():
    assert ARCH in ARCH_IDS
    want = dataclasses.asdict(jax_get_config(ARCH))
    got = dataclasses.asdict(get_config(ARCH))
    assert list(got) == list(want) and got == want


@pytest.mark.parametrize("hd, sections", [
    (128, (16, 24, 24)),   # the published head: the sections cover its 64 pairs
    (64, (16, 24, 24)),    # the reduced head: cut to 32 pairs
    (64, (4, 4, 4)),       # short of 32 pairs: the last section extended
])
def test_apply_mrope_matches_jax_forward_and_gradient(hd, sections):
    rng = np.random.default_rng(hd + sum(sections))
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 3, 7)).astype(np.int32)
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    jg = jax.grad(lambda x: jnp.sum(jax_apply_mrope(x, jnp.asarray(pos), sections, 1e6) * w))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = apply_mrope(xt, torch.tensor(pos), sections, 1e6)
    close(got, want)
    (g,) = torch.autograd.grad((got * torch.tensor(w)).sum(), [xt])
    close(g, jg)
    # the three axes rotate their own sections: a change of the width
    # positions alone moves only the pairs of the last section (and, cut,
    # none of them where it lies past hd/2)
    moved = pos.copy()
    moved[:, 2] += 5
    other = apply_mrope(torch.tensor(x), torch.tensor(moved), sections, 1e6)
    diff = (other - got.detach()).abs().amax(dim=(0, 1, 2))[: hd // 2]
    first_w = min(sections[0] + sections[1], hd // 2)
    assert float(diff[:first_w].max()) == 0.0
    assert (float(diff[first_w:].min()) > 0) if first_w < hd // 2 else True


@pytest.mark.parametrize("vis", [0, 8, 6])
def test_positions_match_the_reference(qwen, vis):
    """(B, 3, S) t/h/w positions: patches on a round(√vis)-wide grid at t
    = 0, the text from grid on all three axes; a decode step at
    ``length``."""
    jmodel, _, model = qwen
    s = vis + 5
    close(model._positions(BATCH, s, vis=vis), jmodel._positions(BATCH, s, vis=vis))
    close(model._positions(BATCH, 1, length=s + 3),
          jmodel._positions(BATCH, 1, length=jnp.asarray(s + 3, jnp.int32)))


def test_train_logits_over_the_text_and_gradients_match_jax(qwen):
    """A batch with ``patches`` (B, 8, d_model) before the tokens: logits
    over the text positions only, the loss and every parameter's
    gradient."""
    jmodel, params, model = qwen
    jbatch, batch = batch_pair(jmodel.cfg, model.cfg, BATCH, SEQ)
    assert tuple(batch["patches"].shape) == (BATCH, model.cfg.vis_seq, model.cfg.d_model)
    with ref():
        jlogits, _ = jax.jit(jmodel.train_logits)(params, jbatch)
    with port(), torch.no_grad():
        logits, _ = model.train_logits(batch)
        plain, _ = model.train_logits({"tokens": batch["tokens"]})
    assert tuple(logits.shape) == (BATCH, SEQ, model.cfg.vocab)
    close_scaled(logits, jlogits)
    assert gap(plain, logits) > 1e-3
    grads_match(jmodel, params, model, jbatch, batch)


@pytest.mark.parametrize("with_patches", [True, False], ids=["patches", "text-only"])
def test_prefill_and_decode_after_the_vision_prefix_match_jax(qwen, with_patches):
    """Prefill over patches and tokens (caches of seq + vis positions
    written), then greedy decode steps at length = seq + vis + step, as
    the endpoint runs them: each step's logits and caches against the
    reference's."""
    jmodel, params, model = qwen
    tokens, patches = _inputs(model.cfg, seed=1)
    vis = model.cfg.vis_seq
    batch = {"tokens": tokens, **({"patches": patches} if with_patches else {})}
    cache_len = SEQ + vis + DECODE_STEPS
    jprefill, jdecode = jax_make_prefill_step(jmodel, cache_len), jax_make_decode_step(jmodel)
    prefill, decode = make_prefill_step(model, cache_len), make_decode_step(model)
    db = repro_torch.Database(device="cpu")
    with ref():
        jlogits, jcaches = jprefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with db.activate():
        logits, caches = prefill({k: torch.tensor(v) for k, v in batch.items()})
    close_scaled(logits, jlogits)
    close_tree(caches, jcaches)
    for step in range(DECODE_STEPS):
        token = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)[:, None]
        length = SEQ + vis + step
        with ref():
            jlogits, jcaches = jdecode(params, jnp.asarray(token), jcaches, jnp.asarray(length, jnp.int32))
        with db.activate():
            logits, caches = decode(torch.tensor(token), caches, length)
        close_scaled(logits, jlogits)
        close_tree(caches, jcaches)


@pytest.mark.parametrize("with_patches", [True, False], ids=["patches", "text-only"])
def test_decode_differs_from_a_longer_prefill_as_in_the_reference(qwen, with_patches):
    """The reference's quirk, in both packages: a decode step at length =
    seq + vis (the endpoint's) against a prefill over the prompt and the
    fed token differs by well over the decode limit of the other families
    (1e-4), and by the same amount in both packages."""
    jmodel, params, model = qwen
    tokens, patches = _inputs(model.cfg, seed=2)
    vis = model.cfg.vis_seq
    extra = {"patches": patches} if with_patches else {}
    cache_len = SEQ + vis + 1
    gaps = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            pre, dec = jax_make_prefill_step(jmodel, cache_len), jax_make_decode_step(jmodel)
            arr = jnp.asarray
            with ref():
                logits, caches = pre(params, {"tokens": arr(tokens), **{k: arr(v) for k, v in extra.items()}})
                nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1), np.int32)[:, None]
                step, _ = dec(params, arr(nxt), caches, jnp.asarray(SEQ + vis, jnp.int32))
                want, _ = pre(params, {"tokens": arr(np.concatenate([tokens, nxt], 1)),
                                       **{k: arr(v) for k, v in extra.items()}})
        else:
            pre, dec = make_prefill_step(model, cache_len), make_decode_step(model)
            t = torch.tensor
            with port():
                logits, caches = pre({"tokens": t(tokens), **{k: t(v) for k, v in extra.items()}})
                step, _ = dec(t(nxt), caches, SEQ + vis)
                want, _ = pre({"tokens": t(np.concatenate([tokens, nxt], 1)),
                               **{k: t(v) for k, v in extra.items()}})
        gaps.append(gap(step, want))
    assert gaps[0] > 1e-2 and gaps[1] > 1e-2
    np.testing.assert_allclose(gaps[1], gaps[0], rtol=1e-3)


def test_endpoint_with_make_batch_serves_each_request_as_alone(qwen):
    """Two concurrent requests through ``db.endpoint(make_batch=...)``, the
    patches added by make_batch (each request's drawn from a generator
    seeded by its first token): one prefill, decode at length seq + vis;
    each completion equals the request served alone."""
    model = qwen[2]
    cfg = model.cfg

    def make_batch(tokens):
        rows = [torch.randn(cfg.vis_seq, cfg.d_model, generator=torch.Generator().manual_seed(int(t)))
                for t in tokens[:, 0].tolist()]
        return {"tokens": tokens, "patches": torch.stack(rows)}

    budgets, cache_len = [4, 2], SEQ + cfg.vis_seq + 4
    rng = np.random.default_rng(7)
    prompts = [np.concatenate([[i + 3], rng.integers(0, cfg.vocab, size=SEQ - 1)]).astype(np.int32)
               for i in range(len(budgets))]
    db = repro_torch.Database(device="cpu")
    db.register_model("qwen", model, {k: p.detach() for k, p in model.named_parameters()})
    ep = db.endpoint("qwen", cache_len=cache_len, buckets=[(2, SEQ)], make_batch=make_batch)
    ep.warmup(batch_fn=lambda b, s: make_batch(torch.zeros((b, s), dtype=torch.int32)))

    async def go():
        return await asyncio.gather(*[ep.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)])

    outs = asyncio.run(go())
    assert db.counters()["serve"]["batches"] == 1
    prefill, decode = make_prefill_step(model, cache_len, db=db), make_decode_step(model, db=db)
    for out, p, n in zip(outs, prompts, budgets):
        logits, caches = prefill(make_batch(torch.tensor(p)[None]))
        solo = [int(logits[0, -1].argmax())]
        for step in range(n - 1):
            logits, caches = decode(torch.tensor([[solo[-1]]], dtype=torch.int32), caches,
                                    SEQ + cfg.vis_seq + step)
            solo.append(int(logits[0, -1].argmax()))
        assert out.token_ids.tolist() == solo
