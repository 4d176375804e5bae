"""Layer blocks. This slice of the port builds the kinds

  attn         — GQA decoder layer (full attention + gated MLP)
  moe          — GQA attention + token-choice MoE   (olmoe)
  mamba1       — the Mamba-1 SSM block              (falcon-mamba)
  mamba2       — the Mamba-2 SSM block              (zamba2)
  mamba2_attn  — Mamba-2, then the shared attention+MLP block (zamba2)

and raises ``NotImplementedError`` for the reference's other kinds: local /
global (gemma's sliding-window pattern), mla / mla_moe (deepseek-v3) and
enc / dec (whisper), which wait for ROADMAP.md queue 1, item 6.4.

Every block's apply has signature  (params, x, ctx) -> (x, cache_entry, aux)
where ctx = {mode: train|prefill|decode, positions, cache (entry or None),
length, cache_len, cfg, shared} and aux the block's auxiliary loss (the
MoE's load-balance loss; 0 for the other kinds). ``shared`` is zamba2's one
shared attention+MLP parameter set (``shared_attn_init``), reused at every
``mamba2_attn`` layer; each such layer keeps its own K/V cache of it
(``shared_kv``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.relational import rel_linear

from .attention import attention, cache_update, decode_attention
from .common import ParamTree, apply_rope, dense_init, rms_norm
from .ffn import mlp_apply, mlp_init, moe_apply, moe_init
from .ssm import mamba1_apply, mamba1_init, mamba2_apply, mamba2_init

Ctx = Dict[str, Any]

#: the block kinds this slice builds
KINDS = ("attn", "moe", "mamba1", "mamba2", "mamba2_attn")


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: the port builds {', '.join(KINDS)} "
        "(ROADMAP.md, queue 1, item 6.4: local/global, mla, enc/dec)"
    )


# ---------------------------------------------------------------------------
# GQA attention sublayer
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg) -> ParamTree:
    hd = cfg.hd()
    dt = _dt(cfg)
    parts = {
        "wq": dense_init(gen, (cfg.d_model, cfg.n_heads * hd), dtype=dt),
        "wk": dense_init(gen, (cfg.d_model, cfg.n_kv_heads * hd), dtype=dt),
        "wv": dense_init(gen, (cfg.d_model, cfg.n_kv_heads * hd), dtype=dt),
        "wo": dense_init(gen, (cfg.n_heads * hd, cfg.d_model), dtype=dt),
    }
    if cfg.qk_norm:
        parts["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
        parts["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
    return ParamTree(**parts)


def gqa_apply(p, x: torch.Tensor, ctx: Ctx):
    """The attention sublayer: q/k/v/o through ``rel_linear``, QK-norm and
    RoPE, then full causal attention (train, prefill; the prefill's cache
    padded to ``ctx["cache_len"]``) or one step against the cache
    (decode). Returns (y, new cache entry or None). The reference's
    sliding window (gemma's ``local`` layers, a right-aligned window
    cache) and cross-attention (whisper) wait for their slices (ROADMAP.md,
    queue 1, item 6.4)."""
    cfg = ctx["cfg"]
    hd = cfg.hd()
    b, s, _ = x.shape
    mode = ctx["mode"]

    q = rel_linear(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = rel_linear(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = rel_linear(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    q = apply_rope(q, ctx["positions"], cfg.rope_theta)
    k = apply_rope(k, ctx["positions"], cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        ck, cv, length = ctx["cache"]["k"], ctx["cache"]["v"], ctx["length"]
        ck, cv = cache_update(ck, cv, length, k, v)
        out = decode_attention(q, ck, cv, length + 1, logit_softcap=cfg.logit_softcap)
        new_cache = {"k": ck, "v": cv}
    else:
        qpos = torch.arange(s, device=x.device)
        out = attention(
            q, k, v,
            q_positions=qpos, k_positions=qpos,
            logit_softcap=cfg.logit_softcap, chunk_size=cfg.attn_chunk,
        )
        if mode == "prefill":
            pad = ctx["cache_len"] - s
            new_cache = {
                "k": F.pad(k, (0, 0, 0, 0, 0, pad)).to(_dt(cfg)),
                "v": F.pad(v, (0, 0, 0, 0, 0, pad)).to(_dt(cfg)),
            }
    y = rel_linear(out.reshape(b, s, cfg.n_heads * hd), p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# Full layer blocks
# ---------------------------------------------------------------------------


def _ffn_dims(cfg, kind: str) -> int:
    if kind in ("moe", "mla_moe"):
        return cfg.d_expert_ff or cfg.d_ff
    return cfg.d_ff


def block_init(gen: torch.Generator, kind: str, cfg) -> ParamTree:
    """A block's parameters, made on ``gen``'s device."""
    dt = _dt(cfg)
    dev = gen.device
    if kind in ("attn", "moe"):
        parts = {
            "ln1": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
            "attn": gqa_init(gen, cfg),
            "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        }
        if kind == "moe":
            parts["moe"] = moe_init(
                gen, cfg.d_model, _ffn_dims(cfg, kind), cfg.n_experts,
                cfg.n_shared_experts, dtype=dt,
            )
        else:
            parts["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt)
        return ParamTree(**parts)
    if kind == "mamba1":
        return ParamTree(
            ln=torch.zeros((cfg.d_model,), dtype=dt, device=dev),
            ssm=mamba1_init(
                gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                cfg.conv_width, dtype=dt,
            ),
        )
    if kind in ("mamba2", "mamba2_attn"):
        return ParamTree(
            ln=torch.zeros((cfg.d_model,), dtype=dt, device=dev),
            ssm=mamba2_init(
                gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                n_heads=(cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim,
                head_dim=cfg.ssm_head_dim, conv_width=cfg.conv_width, dtype=dt,
            ),
        )
    raise _not_ported(kind)


def shared_attn_init(gen: torch.Generator, cfg) -> ParamTree:
    """zamba2's shared attention+MLP block: ONE parameter set reused at
    every ``mamba2_attn`` layer (the reference's simplification of the
    published model's two alternating shared blocks with LoRA; ROADMAP.md
    §3)."""
    dt = _dt(cfg)
    dev = gen.device
    return ParamTree(
        ln1=torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        attn=gqa_init(gen, cfg),
        ln2=torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt),
    )


def block_apply(p, kind: str, x, ctx: Ctx):
    cfg = ctx["cfg"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = {}

    if kind in ("attn", "moe"):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        actx = dict(ctx)
        actx["cache"] = ctx["cache"]["kv"] if ctx.get("cache") else None
        a, kv = gqa_apply(p["attn"], h, actx)
        x = x + a
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            f, aux = moe_apply(
                p["moe"], h, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor,
                shard_experts=cfg.moe_shard_experts,
            )
        else:
            f = mlp_apply(p["mlp"], h)
        x = x + f
        if kv is not None:
            cache["kv"] = kv
        return x, cache, aux

    if kind == "mamba1":
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y, st = mamba1_apply(
            p["ssm"], h,
            state=ctx["cache"]["ssm1"] if ctx.get("cache") else None,
            chunk=cfg.ssm_chunk, scan_dtype=getattr(torch, cfg.ssm_scan_dtype),
            use_pallas=cfg.ssm_pallas,
        )
        cache["ssm1"] = st
        return x + y, cache, aux

    if kind in ("mamba2", "mamba2_attn"):
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y, st = mamba2_apply(
            p["ssm"], h,
            head_dim=cfg.ssm_head_dim, state_dim=cfg.ssm_state,
            state=ctx["cache"]["ssm2"] if ctx.get("cache") else None,
            chunk=cfg.ssm_chunk, scan_dtype=getattr(torch, cfg.ssm_scan_dtype),
            use_pallas=cfg.ssm_pallas,
        )
        cache["ssm2"] = st
        x = x + y
        if kind == "mamba2_attn":
            sp = ctx["shared"]
            sctx = dict(ctx)
            sctx["cache"] = ctx["cache"]["shared_kv"] if ctx.get("cache") else None
            h = rms_norm(x, sp["ln1"], cfg.norm_eps)
            a, kv = gqa_apply(sp["attn"], h, sctx)
            x = x + a
            x = x + mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps))
            if kv is not None:
                cache["shared_kv"] = kv
        return x, cache, aux

    raise _not_ported(kind)
