"""whisper in the JAX package and in the port: the encoder over the stubbed
frame embeddings (bidirectional, no RoPE, LayerNorm with a bias, a gated
tanh-GELU MLP), the decoder's self-attention with RoPE and a cache, its
cross-attention to the encoder's output (recomputed from ``enc_out`` at
every step, no cache, not causal), tied embeddings, and the endpoint's
encoder path (``make_batch`` adds the frames; the encoder output is
padded and compacted with the decode slots).

The model runs reduced (``reduced()``: 2 encoder and 2 decoder layers,
d_model 256, 4 heads of 64 over 2 KV heads, d_ff 512, vocab 512, enc_seq
16, attn_chunk 16): decoder prompts of 20 tokens cross the chunked path.
``tests/torch_lm_parity.py`` says how the two packages are fed and at
which tolerances.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.configs import get_config as jax_get_config
from repro.models.blocks import block_apply as jax_block_apply
from repro.models.ffn import mlp_apply as jax_mlp_apply
from repro.optim import adam_init as jax_adam_init
from repro.serving.serve import init_cache as jax_init_cache
from repro.serving.serve import make_decode_step as jax_make_decode_step
from repro.serving.serve import make_prefill_step as jax_make_prefill_step
from repro_torch import kernels
from repro_torch.checkpoint import save_checkpoint
from repro_torch.checkpoint.ckpt import _arrays
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.blocks import block_apply
from repro_torch.models.common import gelu
from repro_torch.models.ffn import mlp_apply
from repro_torch.serving import init_cache, make_decode_step, make_encode_step, make_prefill_step
from repro_torch.train import init_train_state, lm_loss
from torch_lm_parity import (batch_pair, close, close_scaled, close_tree, configs, flat_ref, gap,
                             grads_match, lm, np_tree, port, ref)

ARCH = "whisper-small"
BATCH, SEQ, DECODE_STEPS = 2, 20, 3


@pytest.fixture(scope="module")
def whisper():
    return lm(ARCH)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


def _inputs(cfg, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(BATCH, seq)).astype(np.int32)
    frames = rng.normal(size=(BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return tokens, frames


def test_config_equals_the_reference_field_by_field():
    assert ARCH in ARCH_IDS
    want = dataclasses.asdict(jax_get_config(ARCH))
    got = dataclasses.asdict(get_config(ARCH))
    assert list(got) == list(want) and got == want


def test_parameters_have_the_references_names_and_shapes(whisper):
    """The encoder layers stacked on a leading axis (the checkpoint's
    layout, ``params/encoder/...``), its final LayerNorm, tied embeddings."""
    _, params, model = whisper
    want = {k: v.shape for k, v in flat_ref(params, "/").items()}
    got = {k: v.shape for k, v in _arrays(dict(model.named_parameters()), "").items()}
    assert got == want
    assert got["encoder/attn/wq"][0] == model.cfg.encoder_layers == len(model.encoder)
    assert "out_embed" not in got and "enc_ln_b" in got


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu``'s default is the tanh form; ``F.gelu``'s the exact
    erf form, which differs by up to ~1e-3."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    close(gelu(torch.tensor(x)), jax.nn.gelu(jnp.asarray(x)))
    exact = torch.nn.functional.gelu(torch.tensor(x))
    assert float((exact - gelu(torch.tensor(x))).abs().max()) > 1e-4


def test_gated_gelu_mlp_matches_jax(whisper):
    _, params, model = whisper
    jp = jax.tree.map(lambda a: a[0], params["encoder"]["mlp"])
    x = np.random.default_rng(1).normal(size=(BATCH, 5, model.cfg.d_model)).astype(np.float32)
    with ref():
        want = jax_mlp_apply(jp, jnp.asarray(x), activation=jax.nn.gelu)
    with port(), torch.no_grad():
        got = mlp_apply(model.encoder[0]["mlp"], torch.tensor(x), activation=gelu)
    close(got, want)


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_block_matches_jax_forward_and_gradient(whisper, kind):
    """One ``enc`` layer (bidirectional self-attention over 16 frames, no
    RoPE) or ``dec`` layer (causal self-attention over 20 positions with
    RoPE, past attn_chunk, then cross-attention to a random encoder output
    of 16 rows) in train mode: its output and the gradient of a random
    projection of it in every parameter, in x and in the encoder output."""
    _, params, model = whisper
    cfg, jcfg = model.cfg, configs(ARCH)[1]
    if kind == "enc":
        jp, tp, s = jax.tree.map(lambda a: a[0], params["encoder"]), model.encoder[0], cfg.enc_seq
    else:
        jp = jax.tree.map(lambda a: a[0], params["stages"][0]["scan"]["0:dec"])
        tp, s = model.stages[0]["scan"][0]["0:dec"], SEQ
    rng = np.random.default_rng(2)
    x = rng.normal(size=(BATCH, s, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(BATCH, s, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (BATCH, s)).copy()

    def jf(p, x, enc):
        ctx = {"cfg": jcfg, "mode": "train", "positions": jnp.asarray(pos), "cache": None,
               "enc_out": enc}
        y, _, _ = jax_block_apply(p, kind, x, ctx)
        return y

    with ref():
        jy = jf(jp, jnp.asarray(x), jnp.asarray(enc))
        jgp, jgx, jge = jax.grad(lambda p, x, e: jnp.sum(jf(p, x, e) * w), argnums=(0, 1, 2))(
            jp, jnp.asarray(x), jnp.asarray(enc))
    xt, et = torch.tensor(x, requires_grad=True), torch.tensor(enc, requires_grad=True)
    ctx = {"cfg": cfg, "mode": "train", "positions": torch.tensor(pos), "cache": None, "enc_out": et}
    with port():
        y, cache, _ = block_apply(tp, kind, xt, ctx)
    close(y, jy)
    assert cache == {}
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad((y * torch.tensor(w)).sum(), [tp.get_parameter(n) for n in names]
                                + [xt, et], allow_unused=True)
    want = flat_ref(jgp)
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        close_scaled(g, want[n])
    close_scaled(grads[-2], jgx)
    if kind == "dec":
        close_scaled(grads[-1], jge)
    else:
        assert grads[-1] is None


def test_train_logits_and_gradients_match_jax(whisper):
    """The train loss over a batch with ``frames`` and every parameter's
    gradient, the encoder's (reached through every decoder layer's
    cross-attention) and the tied table's among them."""
    jmodel, params, model = whisper
    jbatch, batch = batch_pair(jmodel.cfg, model.cfg, BATCH, SEQ)
    assert tuple(batch["frames"].shape) == (BATCH, model.cfg.enc_seq, model.cfg.d_model)
    with ref():
        jlogits, _ = jax.jit(jmodel.train_logits)(params, jbatch)
    with port(), torch.no_grad():
        logits, aux = model.train_logits(batch)
    close_scaled(logits, jlogits)
    assert float(aux) == 0.0
    got = grads_match(jmodel, params, model, jbatch, batch)
    for name in ("encoder.0.attn.wq", "encoder.1.mlp.wo", "enc_ln_s",
                 "stages.0.scan.1.0:dec.xattn.wk", "embed"):
        assert float(got[name].abs().max()) > 0, name


def test_init_cache_matches_the_reference():
    cfg, jcfg = configs(ARCH)
    got = init_cache(cfg, BATCH, SEQ, device="cpu")
    close_tree(got, jax_init_cache(jcfg, BATCH, SEQ))


def test_prefill_and_decode_with_enc_out_match_jax(whisper):
    """Prefill over tokens and frames (its self-attention caches), the
    encoder output, then greedy decode steps that cross-attend to it: each
    step's logits and caches against the reference's."""
    jmodel, params, model = whisper
    tokens, frames = _inputs(model.cfg, seed=3)
    cache_len = SEQ + DECODE_STEPS
    jprefill, jdecode = jax_make_prefill_step(jmodel, cache_len), jax_make_decode_step(jmodel)
    prefill, decode = make_prefill_step(model, cache_len), make_decode_step(model)
    db = repro_torch.Database(device="cpu")
    with ref():
        jbatch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
        jlogits, jcaches = jprefill(params, jbatch)
        jenc = jax.jit(jmodel._encode)(params, jnp.asarray(frames))
    with db.activate():
        logits, caches = prefill({"tokens": torch.tensor(tokens), "frames": torch.tensor(frames)})
        enc = make_encode_step(model)(torch.tensor(frames))
    close_scaled(logits, jlogits)
    close_tree(caches, jcaches)
    close(enc, jenc)
    for step in range(DECODE_STEPS):
        token = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)[:, None]
        with ref():
            jlogits, jcaches = jdecode(params, jnp.asarray(token), jcaches,
                                       jnp.asarray(SEQ + step, jnp.int32), jenc)
        with db.activate():
            logits, caches = decode(torch.tensor(token), caches, SEQ + step, enc_out=enc)
        close_scaled(logits, jlogits)
        close_tree(caches, jcaches)
    with pytest.raises(ValueError, match="enc_out"):
        decode(torch.tensor(token), caches, SEQ + DECODE_STEPS)


def test_decode_equals_a_longer_prefill_and_a_swapped_enc_out_does_not(whisper):
    """Decode of a fed token against the prefill's caches and the encoder
    output equals a prefill over the prompt and that token (within 1e-4 of
    the largest logit); the same step with the two requests' encoder rows
    swapped does not."""
    _, _, model = whisper
    tokens, frames = (torch.tensor(a) for a in _inputs(model.cfg, seed=4))
    db = repro_torch.Database(device="cpu")
    prefill, decode = make_prefill_step(model, SEQ + 1, db=db), make_decode_step(model, db=db)
    logits, caches = prefill({"tokens": tokens, "frames": frames})
    enc = make_encode_step(model, db=db)(frames)
    nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    step, _ = decode(nxt, caches, SEQ, enc_out=enc)
    want, _ = prefill({"tokens": torch.cat([tokens, nxt], 1), "frames": frames})
    assert gap(step, want) <= 1e-4
    swapped, _ = decode(nxt, caches, SEQ, enc_out=enc.flip(0))
    assert gap(swapped, want) > 1e-4


def test_remat_policies_give_the_gradients_of_no_remat_bit_for_bit(whisper):
    """``remat`` under "nothing" and "dots" recomputes each decoder layer
    (its cross-attention reading the encoder output from outside the
    checkpoint) and leaves the encoder alone; the gradients, the encoder's
    among them, equal those without remat bit for bit."""
    _, _, model = whisper
    cfg = model.cfg
    batch = batch_pair(configs(ARCH)[1], cfg, BATCH, SEQ, seed=5)[1]
    got = {}
    try:
        for policy in (None, "nothing", "dots"):
            model.cfg = dataclasses.replace(cfg, remat=policy is not None, remat_policy=policy or "nothing")
            leaves = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
            with port():
                logits, _ = model.train_logits(batch, leaves)
                loss = lm_loss(logits, batch["labels"])
            got[policy] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    finally:
        model.cfg = cfg
    for policy in ("nothing", "dots"):
        assert all(torch.equal(got[policy][k], got[None][k]) for k in got[None]), policy


def _frames_of(cfg):
    """make_batch's frames: each request's (enc_seq, d_model) from a
    generator seeded by its first token, so a request brings the same
    frames alone and in a batch."""

    def frames(tokens):
        rows = [torch.randn(cfg.enc_seq, cfg.d_model, generator=torch.Generator().manual_seed(int(t)))
                for t in tokens[:, 0].tolist()]
        return torch.stack(rows).to(tokens.device)

    return frames


def test_endpoint_with_make_batch_serves_each_request_as_alone(whisper):
    """Three concurrent requests through ``db.endpoint(make_batch=...)``:
    one prefill at a padded bucket (3 rows in 4), the encoder output over
    the batch's frames padded to decode bucket 4, then compacted with the
    slots to 2 and 1; each completion equals the request served alone
    (prefill, encoder, decode with its own enc_out). Warmup without
    ``batch_fn`` names the frames the model reads."""
    model = whisper[2]
    cfg = model.cfg
    frames_of = _frames_of(cfg)
    budgets, cache_len = [4, 2, 3], SEQ + 4
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=SEQ).astype(np.int32) for _ in budgets]
    prompts = [np.concatenate([[i * 7 + 1], p[1:]]).astype(np.int32) for i, p in enumerate(prompts)]
    db = repro_torch.Database(device="cpu")
    db.register_model("whisper", model, {k: p.detach() for k, p in model.named_parameters()})

    def make_batch(tokens):
        return {"tokens": tokens, "frames": frames_of(tokens)}

    ep = db.endpoint("whisper", cache_len=cache_len, buckets=[(2, SEQ), (4, SEQ)],
                     make_batch=make_batch)
    with pytest.raises(ValueError, match="frames"):
        ep.warmup()
    ep.warmup(batch_fn=lambda b, s: make_batch(torch.zeros((b, s), dtype=torch.int32)))

    async def go():
        return await asyncio.gather(*[ep.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)])

    outs = asyncio.run(go())
    c = db.counters()["serve"]
    assert c["batches"] == 1 and c["decode"]["rebuckets"] >= 1
    prefill, decode = make_prefill_step(model, cache_len, db=db), make_decode_step(model, db=db)
    encode = make_encode_step(model, db=db)
    solos = []
    for out, p, n in zip(outs, prompts, budgets):
        batch = make_batch(torch.tensor(p)[None])
        logits, caches = prefill(batch)
        enc = encode(batch["frames"])
        solo = [int(logits[0, -1].argmax())]
        for step in range(n - 1):
            logits, caches = decode(torch.tensor([[solo[-1]]], dtype=torch.int32), caches, SEQ + step,
                                    enc_out=enc)
            solo.append(int(logits[0, -1].argmax()))
        assert out.token_ids.tolist() == solo
        solos.append(solo)
    assert len({tuple(s) for s in solos}) == len(solos)


def test_a_port_checkpoint_restores_in_the_reference_with_the_encoder_stacked(whisper, tmp_path):
    _, params, model = whisper
    state = init_train_state(model)
    path = save_checkpoint(str(tmp_path), 1, state.params, state.opt_state)
    with np.load(path) as data:
        assert data["params/encoder/attn/wq"].shape[0] == model.cfg.encoder_layers
    jp, _ = jax_restore_checkpoint(path, params, jax_adam_init(params))
    flat, want = flat_ref(np_tree(jp), "/"), _arrays(state.params, "")
    assert sorted(flat) == sorted(want) and all(np.array_equal(flat[k], want[k]) for k in want)
