"""deepseek-v3 in the JAX package and in the port: multi-head latent
attention (MLA) with its compressed (c_kv, k_rope) cache and the absorbed
decode, a leading dense stage (``first_k_dense``) before the MoE stage, and
the shared expert.

The model runs reduced (``reduced(n_layers=3)``: d_model 256, 4 heads,
q_lora_rank 32, kv_lora_rank 32, rope/nope/v head dims 16/32/32, d_ff 512,
4 routed experts of 2,048 top-2 and one shared, vocab 512, attn_chunk 16),
so that the stages are (mla, 1) and (mla_moe, 2) and the stage boundary and
a scanned MoE stage of two repeats are crossed. ``tests/torch_lm_parity.py``
says how the two packages are fed and at which tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models.blocks import mla_apply as jax_mla_apply
from repro.serving.serve import init_cache as jax_init_cache
from repro.serving.serve import make_decode_step as jax_make_decode_step
from repro.serving.serve import make_prefill_step as jax_make_prefill_step
from repro_torch import kernels
from repro_torch.checkpoint.ckpt import _arrays
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import blocks
from repro_torch.models.blocks import mla_apply
from repro_torch.models.model import Stage, stages_of
from repro_torch.serving import init_cache, make_decode_step, make_prefill_step
from torch_lm_parity import (batch_pair, close, close_scaled, close_tree, configs, flat_ref, gap,
                             grads_match, lm, port, ref)

ARCH = "deepseek-v3-671b"
LAYERS = 3
BATCH, SEQ, DECODE_STEPS = 2, 20, 3


@pytest.fixture(scope="module")
def ds():
    return lm(ARCH, n_layers=LAYERS)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


def _tokens(vocab, seq=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(BATCH, seq)).astype(np.int32)


def test_config_equals_the_reference_field_by_field():
    assert ARCH in ARCH_IDS
    want = dataclasses.asdict(jax_get_config(ARCH))
    got = dataclasses.asdict(get_config(ARCH))
    assert list(got) == list(want) and got == want


def test_stages_of_the_published_and_reduced_depths():
    """61 layers: 3 dense MLA layers, then 58 MLA+MoE layers; reduced to 3
    layers: one dense, two MoE."""
    assert stages_of(get_config(ARCH)) == [Stage(("mla",), 3), Stage(("mla_moe",), 58)]
    assert stages_of(configs(ARCH, n_layers=LAYERS)[0]) == [Stage(("mla",), 1),
                                                            Stage(("mla_moe",), 2)]


def test_parameters_have_the_references_names_and_shapes(ds):
    _, params, model = ds
    want = {k: v.shape for k, v in flat_ref(params, "/").items()}
    got = {k: v.shape for k, v in _arrays(dict(model.named_parameters()), "").items()}
    assert got == want
    assert "stages/1/scan/0:mla_moe/moe/shared/wo" in got and "stages/0/scan/0:mla/mlp/wo" in got


def _mla_params(params, model, stage=0, kind="0:mla"):
    jp = jax.tree.map(lambda a: a[0], params["stages"][stage]["scan"][kind]["attn"])
    return jp, model.stages[stage]["scan"][0][kind]["attn"]


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_apply_matches_jax_forward_and_gradient(ds, mode):
    """One MLA sublayer over 20 positions (past attn_chunk 16: the chunked
    online-softmax path with v padded to dn + dr): its output and, in
    prefill, its (c, r) cache padded to cache_len; in train, the gradient
    of a random projection of the output in every parameter and in x."""
    _, params, model = ds
    cfg, jcfg = model.cfg, configs(ARCH, n_layers=LAYERS)[1]
    jp, tp = _mla_params(params, model)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (BATCH, SEQ)).copy()
    cap = SEQ + 4
    jctx = {"cfg": jcfg, "mode": mode, "positions": jnp.asarray(pos), "cache_len": cap}
    tctx = {"cfg": cfg, "mode": mode, "positions": torch.tensor(pos), "cache_len": cap}

    def jf(p, x):
        y, _ = jax_mla_apply(p, x, jctx)
        return jnp.sum(y * w)

    with ref():
        jy, jcache = jax_mla_apply(jp, jnp.asarray(x), jctx)
        jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    with port():
        y, cache = mla_apply(tp, xt, tctx)
    close(y, jy)
    if mode == "prefill":
        assert sorted(cache) == ["c", "r"]
        assert tuple(cache["c"].shape) == (BATCH, cap, cfg.kv_lora_rank)
        assert tuple(cache["r"].shape) == (BATCH, cap, cfg.rope_head_dim)
        for k in ("c", "r"):
            close(cache[k], jcache[k])
        return
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad((y * torch.tensor(w)).sum(), [tp[n] for n in names] + [xt])
    assert sorted(names) == sorted(jgp)
    for n, g in zip(names, grads):
        close_scaled(g, jgp[n])
    close_scaled(grads[-1], jgx)


def test_mla_absorbed_decode_matches_jax(ds):
    """One decode step in the latent space against a cache of random (c, r)
    rows, 9 of 16 valid: the new rows written at ``length``, the scores of
    q_nope absorbed through wk_b and of q_rope against the shared k_rope,
    the -2e38 mask beyond length + 1, the output through wv_b."""
    _, params, model = ds
    cfg, jcfg = model.cfg, configs(ARCH, n_layers=LAYERS)[1]
    jp, tp = _mla_params(params, model, 1, "0:mla_moe")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(BATCH, 1, cfg.d_model)).astype(np.float32)
    cc = rng.normal(size=(BATCH, 16, cfg.kv_lora_rank)).astype(np.float32)
    cr = rng.normal(size=(BATCH, 16, cfg.rope_head_dim)).astype(np.float32)
    length = 9
    pos = np.full((BATCH, 1), length, np.int32)
    jctx = {"cfg": jcfg, "mode": "decode", "positions": jnp.asarray(pos),
            "length": jnp.asarray(length, jnp.int32),
            "cache": {"c": jnp.asarray(cc), "r": jnp.asarray(cr)}}
    tctx = {"cfg": cfg, "mode": "decode", "positions": torch.tensor(pos), "length": length,
            "cache": {"c": torch.tensor(cc), "r": torch.tensor(cr)}}
    with ref():
        jy, jcache = jax_mla_apply(jp, jnp.asarray(x), jctx)
    with port(), torch.no_grad():
        y, cache = mla_apply(tp, torch.tensor(x), tctx)
    close(y, jy)
    for k in ("c", "r"):
        close(cache[k], jcache[k])
    assert not np.array_equal(cache["c"][:, length].numpy(), cc[:, length])
    assert np.array_equal(cache["c"][:, length + 1:].numpy(), cc[:, length + 1:])


def test_train_logits_and_gradients_match_jax_across_the_stage_boundary(ds):
    """The train loss (with the MoE's aux loss) and every parameter's
    gradient: the dense stage's MLP and the MoE stage's routed and shared
    experts, both MLA layers' low-rank projections and norms."""
    jmodel, params, model = ds
    jbatch, batch = batch_pair(jmodel.cfg, model.cfg, BATCH, SEQ)
    with ref():
        jlogits, jaux = jax.jit(jmodel.train_logits)(params, jbatch)
    with port(), torch.no_grad():
        logits, aux = model.train_logits(batch)
    close_scaled(logits, jlogits)
    close(aux, jaux)
    got = grads_match(jmodel, params, model, jbatch, batch)
    for name in ("stages.0.scan.0.0:mla.mlp.wo", "stages.1.scan.1.0:mla_moe.moe.wo",
                 "stages.1.scan.0.0:mla_moe.moe.shared.wi_gate", "stages.1.scan.1.0:mla_moe.attn.wk_b"):
        assert float(got[name].abs().max()) > 0, name


def test_init_cache_matches_the_reference():
    cfg, jcfg = configs(ARCH, n_layers=LAYERS)
    got = init_cache(cfg, BATCH, SEQ, device="cpu")
    close_tree(got, jax_init_cache(jcfg, BATCH, SEQ))
    assert sorted(got[1]["scan"][1]["0:mla_moe"]["kv"]) == ["c", "r"]


def test_prefill_caches_and_greedy_decode_match_jax(ds):
    """Prefill (its (c, r) caches of every layer against the reference's,
    carried by ``convert.lm_caches``), then greedy decode steps, each
    step's logits and caches."""
    jmodel, params, model = ds
    tokens = _tokens(model.cfg.vocab, seed=1)
    cache_len = SEQ + DECODE_STEPS
    jprefill, jdecode = jax_make_prefill_step(jmodel, cache_len), jax_make_decode_step(jmodel)
    prefill, decode = make_prefill_step(model, cache_len), make_decode_step(model)
    db = repro_torch.Database(device="cpu")
    with ref():
        jlogits, jcaches = jprefill(params, {"tokens": jnp.asarray(tokens)})
    with db.activate():
        logits, caches = prefill({"tokens": torch.tensor(tokens)})
    close_scaled(logits, jlogits)
    close_tree(caches, jcaches)
    for step in range(DECODE_STEPS):
        token = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), token[:, 0])
        with ref():
            jlogits, jcaches = jdecode(params, jnp.asarray(token), jcaches,
                                       jnp.asarray(SEQ + step, jnp.int32))
        with db.activate():
            logits, caches = decode(torch.tensor(token), caches, SEQ + step)
        close_scaled(logits, jlogits)
        close_tree(caches, jcaches)


@pytest.mark.parametrize("lost", ["c", "r"])
def test_decode_equals_a_longer_prefill_and_a_lost_latent_row_does_not(ds, lost, monkeypatch):
    """At capacity_factor = n_experts / top_k no token is dropped, so two
    absorbed decode steps equal prefills over the prompt and the fed
    tokens (within 1e-4 of the largest logit); a first step that drops its
    new ``c`` or ``r`` row from the cache (it attends to it, but leaves
    the cache as it found it) makes the second step differ."""
    _, _, model = ds
    cfg = model.cfg
    monkeypatch.setattr(model, "cfg", dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    tokens = torch.tensor(_tokens(cfg.vocab, seed=2))
    db = repro_torch.Database(device="cpu")
    prefill, decode = make_prefill_step(model, SEQ + 2, db=db), make_decode_step(model, db=db)
    logits, caches = prefill({"tokens": tokens})
    fed = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
    steps = []
    c = caches
    for i in range(2):
        lg, c = decode(fed[-1], c, SEQ + i)
        steps.append(lg)
        fed.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    for i in range(2):
        want, _ = prefill({"tokens": torch.cat([tokens] + fed[:i + 1], 1)})
        assert gap(steps[i], want) <= 1e-4
    real = blocks.mla_apply

    def dropping(p, x, ctx):
        y, cache = real(p, x, ctx)
        return y, dict(cache, **{lost: ctx["cache"][lost]})

    monkeypatch.setattr(blocks, "mla_apply", dropping)
    first, bad = decode(fed[0], caches, SEQ)
    monkeypatch.setattr(blocks, "mla_apply", real)
    assert torch.equal(first, steps[0])
    second, _ = decode(fed[1], bad, SEQ + 1)
    assert gap(second, want) > 1e-4
