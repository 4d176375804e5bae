"""The OLMoE family in the JAX package and in the port: attention (dense and
chunked online-softmax, decode through the cache), RoPE, the token-choice
MoE, the GQA sublayer with QK-norm, and the whole olmoe-1b-7b model
(reduced: 2 layers, d_model 256, 4 heads over 2 KV heads, 4 experts,
top-2, vocab 512, ``attn_chunk`` 16), from the same weights (the JAX init,
carried across by ``repro_torch.convert.lm_params``) and the same inputs
(numpy, seeded). The sequence has 40 tokens, not a multiple of 16, so the
chunked path pads its last KV block.

The JAX side runs under ``repro.Database(dispatch="interpret")``; the
port's under ``repro_torch.Database(device="cpu")``, where every kernel
wrapper takes its plain version.

Tolerance: 1e-5 absolute and relative throughout. The products sum at most
512 f32 terms, in other orders on the two sides, and the softmaxes,
norms and RoPE round the same operations once each; outputs and logits are
of order 1–10, so the sides differ by a few f32 roundings of each, which
stays below 1e-5 through the two layers and three decode steps. The MoE's
expert choice is compared exactly first: with the same choices, the rest
is sums of f32 terms as above.
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
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models import ffn as jax_ffn
from repro.models.blocks import gqa_apply as jax_gqa_apply
from repro.serving.serve import init_cache as jax_init_cache
from repro.serving.serve import make_decode_step as jax_make_decode_step
from repro.serving.serve import make_prefill_step as jax_make_prefill_step
from repro_torch import convert, kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.engine import engine_for
from repro_torch.models import attention, build_model, common, ffn
from repro_torch.models.blocks import block_init, gqa_apply
from repro_torch.relational.embedding import _embed_prog
from repro_torch.relational.linear import _linear_prog
from repro_torch.serving import init_cache, make_decode_step, make_prefill_step

TOL = 1e-5
BATCH, SEQ, DECODE_STEPS = 2, 40, 3
ARCH = "olmoe-1b-7b"


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def lm():
    """(reference model, its params as numpy, port model with those params)."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
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


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=TOL, atol=atol,
    )


def _close_grad(got, want):
    """A gradient: each entry sums a term per token (80 here) in another
    order on each side, and terms of the gradient's own size cancel, so
    the gap is held to 1e-5 of the tensor's largest entry."""
    want = np.asarray(want, np.float32)
    _close(got, want, atol=TOL * max(1.0, float(np.abs(want).max())))


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


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------


def test_olmoe_config_equals_the_reference_field_by_field():
    assert ARCH in ARCH_IDS
    want = dataclasses.asdict(jax_get_config(ARCH))
    got = dataclasses.asdict(get_config(ARCH))
    assert list(got) == list(want)
    for field, value in want.items():
        assert got[field] == value, field


# ---------------------------------------------------------------------------
# RoPE and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = _normal(rng, BATCH, SEQ, 4, 64)
    pos = np.stack([np.arange(SEQ), np.arange(SEQ) + 7]).astype(np.int32)
    _close(common.rope_freqs(64, theta), jax_common.rope_freqs(64, theta))
    _close(common.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("chunk", [None, 16, 64], ids=["dense", "chunked-padded", "chunk>Sk"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_attention_matches_jax(chunk, causal):
    rng = np.random.default_rng(2)
    q, k, v = _normal(rng, BATCH, SEQ, 4, 64), _normal(rng, BATCH, SEQ, 2, 64), _normal(rng, BATCH, SEQ, 2, 64)
    pos = np.arange(SEQ, dtype=np.int32)
    want = jax_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(pos),
        k_positions=jnp.asarray(pos), causal=causal, chunk_size=chunk)
    got = attention.attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), q_positions=torch.tensor(pos),
        k_positions=torch.tensor(pos), causal=causal, chunk_size=chunk)
    _close(got, want)


def test_chunked_attention_equals_dense_attention():
    """The online-softmax recurrence over 3 blocks (the last padded) gives
    the dense path's result, to f32 rounding."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(_normal(rng, BATCH, SEQ, 4, 64)) for _ in range(3))
    pos = torch.arange(SEQ)
    dense = attention.attention(q, k, v, q_positions=pos, k_positions=pos)
    chunked = attention.attention(q, k, v, q_positions=pos, k_positions=pos, chunk_size=16)
    _close(chunked, dense)


@pytest.mark.parametrize("length", [1, 17, SEQ])
def test_cache_update_and_decode_attention_match_jax(length):
    rng = np.random.default_rng(4)
    ck, cv = _normal(rng, BATCH, SEQ + 8, 2, 64), _normal(rng, BATCH, SEQ + 8, 2, 64)
    kn, vn, q = _normal(rng, BATCH, 1, 2, 64), _normal(rng, BATCH, 1, 2, 64), _normal(rng, BATCH, 1, 4, 64)
    jk, jv = jax_attention.cache_update(jnp.asarray(ck), jnp.asarray(cv), jnp.int32(length),
                                        jnp.asarray(kn), jnp.asarray(vn))
    given = torch.tensor(ck)
    tk, tv = attention.cache_update(given, torch.tensor(cv), length, torch.tensor(kn), torch.tensor(vn))
    assert np.array_equal(tk.numpy(), np.asarray(jk)) and np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(given.numpy(), ck)  # the caller's cache is kept
    want = jax_attention.decode_attention(jnp.asarray(q), jk, jv, jnp.int32(length + 1))
    got = attention.decode_attention(torch.tensor(q), tk, tv, length + 1)
    _close(got, want)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_params(lm):
    _, params, model = lm
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["scan"]["0:moe"]["moe"])
    return jp, model.stages[0]["scan"][0]["0:moe"]["moe"]


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25], ids=["published", "overflowing"])
def test_moe_dispatch_chooses_the_references_experts_and_drops(lm, capacity_factor):
    """Per group (a batch row): the same sorted assignments, slots, tokens,
    keep flags and buffer rows as the reference's ``_dispatch_group``; at
    capacity factor 0.25 (5 slots per expert for 80 assignments) experts
    overflow, and the same assignments are dropped."""
    cfg = lm[2].cfg
    jp, p = _moe_params(lm)
    x = _normal(np.random.default_rng(5), BATCH, SEQ, cfg.d_model)
    e = cfg.n_experts
    capacity = max(int(capacity_factor * SEQ * cfg.top_k / e), cfg.top_k)
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        xe, (dest, st, sg, keep), aux = ffn._dispatch_group(
            torch.tensor(x), p["router"], top_k=cfg.top_k, capacity=capacity, e=e)
    dropped = 0
    for row in range(BATCH):
        jxe, (jdest, jst, jsg, jkeep), jaux = jax_ffn._dispatch_group(
            jnp.asarray(x[row]), jnp.asarray(jp["router"]), top_k=cfg.top_k, capacity=capacity, e=e)
        assert np.array_equal(keep[row].numpy(), np.asarray(jkeep))
        assert np.array_equal(dest[row].numpy(), np.asarray(jdest))
        assert np.array_equal(st[row].numpy(), np.asarray(jst))
        _close(sg[row], jsg)
        _close(xe[row], jxe)
        _close(aux[row], jaux)
        dropped += int((~keep[row]).sum())
    assert (dropped > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25], ids=["published", "overflowing"])
def test_moe_apply_matches_jax_forward_and_backward(lm, capacity_factor):
    cfg = lm[2].cfg
    jp, p = _moe_params(lm)
    rng = np.random.default_rng(6)
    x, g = _normal(rng, BATCH, SEQ, cfg.d_model), _normal(rng, BATCH, SEQ, cfg.d_model)

    def jloss(params, xx):
        out, aux = jax_ffn.moe_apply(params, xx, top_k=cfg.top_k, capacity_factor=capacity_factor)
        return jnp.sum(out * g) + aux, (out, aux)

    with repro.Database(dispatch="interpret").activate():
        (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            _jax(jp), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    with repro_torch.Database(device="cpu").activate():
        out, aux = ffn.moe_apply(p, xt, top_k=cfg.top_k, capacity_factor=capacity_factor)
        names = ("router", "wi_gate", "wi_up", "wo")
        grads = torch.autograd.grad((out * torch.tensor(g)).sum() + aux, [xt] + [p[n] for n in names])
    _close(out, jout)
    _close(aux, jaux)
    _close_grad(grads[0], jgx)
    for n, gr in zip(names, grads[1:]):
        _close_grad(gr, jgp[n])


def test_moe_shard_experts_is_value_neutral():
    """The port's counterpart of tests/test_integration_extra.py's
    ``test_moe_shard_experts_flag_neutral_on_values``: the flag pins the
    expert buffers' layout on a mesh, and on one device the logits are
    bit-identical with it on and off."""
    cfg = get_config(ARCH).reduced()
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)), dtype=torch.int32)
    outs = []
    for flag in (False, True):
        model = build_model(dataclasses.replace(cfg, moe_shard_experts=flag), device="cpu", seed=7)
        with repro_torch.Database(device="cpu").activate():
            outs.append(model.train_logits({"tokens": tokens})[0].detach())
    assert torch.equal(outs[0], outs[1])


def test_moe_on_a_mesh_outside_the_slice_raises():
    """deepseek-v3's MLA+MoE layers are placed on a (data × model) mesh
    since slice 16, but a pod axis is still outside the slice: the
    placement refuses it, naming the roadmap, before any rank is asked."""
    from repro_torch.launch.sharding import Placement

    with pytest.raises(NotImplementedError, match="a pod axis") as err:
        Placement(get_config("deepseek-v3-671b").reduced(), {"pod": 2, "data": 1, "model": 2})
    assert "ROADMAP.md" in str(err.value) and "block kind" not in str(err.value)


def test_mlp_apply_matches_jax(lm):
    cfg = lm[2].cfg
    rng = np.random.default_rng(7)
    jp = {k: _normal(rng, *s) / np.sqrt(s[0]).astype(np.float32)
          for k, s in (("wi_gate", (cfg.d_model, 64)), ("wi_up", (cfg.d_model, 64)), ("wo", (64, cfg.d_model)))}
    x = _normal(rng, BATCH, SEQ, cfg.d_model)
    with repro.Database(dispatch="interpret").activate():
        want = jax_ffn.mlp_apply(_jax(jp), jnp.asarray(x))
    with repro_torch.Database(device="cpu").activate():
        got = ffn.mlp_apply({k: torch.tensor(v) for k, v in jp.items()}, torch.tensor(x))
    _close(got, want)


# ---------------------------------------------------------------------------
# The GQA sublayer: QK-norm, RoPE, train / prefill / decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_gqa_apply_matches_jax(lm, mode):
    jmodel, params, model = lm
    cfg, jcfg = model.cfg, jmodel.cfg
    assert cfg.qk_norm and cfg.n_heads // cfg.n_kv_heads == 2
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["scan"]["0:moe"]["attn"])
    jp = {k: v + 0.1 * np.arange(v.size, dtype=np.float32).reshape(v.shape) / v.size
          if k.endswith("norm") else v for k, v in jp.items()}  # non-zero QK-norm scales
    p = {k: torch.tensor(v) for k, v in jp.items()}
    rng = np.random.default_rng(8)
    s = 1 if mode == "decode" else SEQ
    x = _normal(rng, BATCH, s, cfg.d_model)
    ctx = {"mode": mode, "cache_len": SEQ + 8}
    length = SEQ - 3
    if mode == "decode":
        cache = {"k": _normal(rng, BATCH, SEQ + 8, cfg.n_kv_heads, cfg.hd()),
                 "v": _normal(rng, BATCH, SEQ + 8, cfg.n_kv_heads, cfg.hd())}
        pos = np.full((BATCH, 1), length, np.int32)
    else:
        cache, pos = None, np.broadcast_to(np.arange(s, dtype=np.int32), (BATCH, s))
    with repro.Database(dispatch="interpret").activate():
        jy, jcache = jax_gqa_apply(_jax(jp), jnp.asarray(x), dict(
            ctx, cfg=jcfg, positions=jnp.asarray(pos), length=jnp.int32(length),
            cache=None if cache is None else _jax(cache)))
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        y, tcache = gqa_apply(p, torch.tensor(x), dict(
            ctx, cfg=cfg, positions=torch.tensor(pos), length=length,
            cache=None if cache is None else {k: torch.tensor(v) for k, v in cache.items()}))
    _close(y, jy)
    assert (tcache is None) == (jcache is None) == (mode == "train")
    if jcache is not None:
        for k in ("k", "v"):
            _close(tcache[k], jcache[k])


# ---------------------------------------------------------------------------
# The whole model: train_logits, prefill, greedy decode
# ---------------------------------------------------------------------------


def test_train_logits_and_aux_match_jax(lm, tokens):
    jmodel, params, model = lm
    with repro.Database(dispatch="interpret").activate():
        jlogits, jaux = jmodel.train_logits(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        logits, aux = model.train_logits({"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (BATCH, SEQ, 512) and float(jaux) > 0
    _close(logits, jlogits)
    _close(aux, jaux)


def test_train_logits_on_a_params_dict_equal_the_modules(lm, tokens):
    """The functional form the trainer uses: a name → tensor dict of the
    module's own tensors gives the module's logits bit for bit."""
    _, _, model = lm
    batch = {"tokens": torch.tensor(tokens)}
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        want, want_aux = model.train_logits(batch)
        got, aux = model.train_logits(batch, {k: p.detach() for k, p in model.named_parameters()})
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


def test_prefill_and_greedy_decode_match_jax(lm, tokens):
    jmodel, params, model = lm
    cache_len = SEQ + DECODE_STEPS
    jprefill, jdecode = jax_make_prefill_step(jmodel, cache_len), jax_make_decode_step(jmodel)
    prefill, decode = make_prefill_step(model, cache_len), make_decode_step(model)
    db = repro_torch.Database(device="cpu")
    with repro.Database(dispatch="interpret").activate():
        jlogits, jcaches = jprefill(params, {"tokens": jnp.asarray(tokens)})
    with db.activate():
        logits, caches = prefill({"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (BATCH, 1, 512) and not logits.requires_grad
    assert tuple(caches[0]["scan"][0]["0:moe"]["kv"]["k"].shape) == (BATCH, cache_len, 2, 64)
    _close(logits, jlogits)
    _close_tree(caches, jcaches)
    for step in range(DECODE_STEPS):
        token = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), token[:, 0])
        length = SEQ + step
        with repro.Database(dispatch="interpret").activate():
            jlogits, jcaches = jdecode(params, jnp.asarray(token), jcaches, jnp.int32(length))
        with db.activate():
            logits, caches = decode(torch.tensor(token), caches, length)
        _close(logits, jlogits)
        _close_tree(caches, jcaches)


def test_serving_lowers_once_per_signature(lm, tokens):
    """A request (prefill, 3 decode steps) lowers each projection once per
    (x, w) signature and the embedding once per batch length; a second
    request lowers nothing. The MoE's sites are no engine lowerings."""
    _, _, model = lm
    cfg = model.cfg
    engines = [engine_for(_linear_prog()[0].forward), engine_for(_embed_prog()[0].forward)]
    # a table no other test uses: the engines' lowerings are cached per
    # table, and the falcon-mamba test shares the head's and embedding's
    # shapes
    db = repro_torch.Database(device="cpu", dispatch={"blocked_matmul": "ref", "gather_join": "ref"})
    prefill, decode = make_prefill_step(model, SEQ + DECODE_STEPS), make_decode_step(model)
    with db.activate():
        before = [e.lower_count for e in engines]
        for _ in range(2):
            logits, caches = prefill({"tokens": torch.tensor(tokens)})
            for step in range(DECODE_STEPS):
                token = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, caches = decode(token, caches, SEQ + step)
        lowered = [e.lower_count - b for e, b in zip(engines, before)]
    # wq and wo are (256, 256), wk and wv (256, 128): two signatures at
    # m = B·S (prefill) and two at m = B (decode); the head at m = B
    assert cfg.n_heads * cfg.hd() == cfg.d_model
    assert lowered == [2 * 2 + 1, 2]


def test_init_cache_matches_the_reference_layout():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    got = init_cache(cfg, BATCH, SEQ, device="cpu")
    _close_tree(got, jax_init_cache(jcfg, BATCH, SEQ))


def test_parameter_count_matches_the_reference(lm):
    jmodel, params, model = lm
    want = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == want
    full = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full)) == 6_919_100_416


def test_entry_points_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 4)


def test_block_init_builds_attn_and_moe_as_the_reference(lm):
    """Kind ``attn`` (dense MLP) and ``moe``: the reference's parameter
    names and shapes."""
    cfg, jcfg = lm[2].cfg, lm[0].cfg
    from repro.models.blocks import block_init as jax_block_init

    for kind in ("attn", "moe"):
        want = jax.tree_util.tree_flatten_with_path(jax_block_init(jax.random.PRNGKey(0), kind, jcfg))[0]
        got = dict(block_init(torch.Generator().manual_seed(0), kind, cfg).named_parameters())
        want = {".".join(str(k.key) for k in path): tuple(v.shape) for path, v in want}
        assert {k: tuple(v.shape) for k, v in got.items()} == want


def test_a_dense_attention_model_matches_jax(tokens):
    """Kind ``attn`` (GQA attention and the gated MLP) in a whole model:
    the reduced config with pattern ("attn",)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), pattern=("attn",))
    cfg = dataclasses.replace(get_config(ARCH).reduced(), pattern=("attn",))
    jmodel = jax_build_model(jcfg)
    params = _np(jmodel.init(jax.random.PRNGKey(1)))
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), params)
    with repro.Database(dispatch="interpret").activate():
        jlogits, jaux = jmodel.train_logits(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        logits, aux = model.train_logits({"tokens": torch.tensor(tokens)})
    assert float(aux) == float(jaux) == 0.0
    _close(logits, jlogits)
