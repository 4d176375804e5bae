"""Layer blocks for every architecture family of the reference.

Kinds:
  attn         — GQA decoder layer (full attention + gated MLP)
  local        — the same with a sliding window (gemma), whose cache is
                 window-sized and right-aligned
  global       — the same with full attention (gemma's other layers)
  moe          — GQA attention + token-choice MoE   (olmoe)
  mla / mla_moe — multi-head latent attention ± MoE (deepseek-v3)
  mamba1       — the Mamba-1 SSM block              (falcon-mamba)
  mamba2       — the Mamba-2 SSM block              (zamba2)
  mamba2_attn  — Mamba-2, then the shared attention+MLP block (zamba2)
  enc / dec    — whisper's encoder and decoder layers (LayerNorm with a
                 bias, tanh-GELU MLP; the decoder cross-attends to the
                 encoder's output)

Every block's apply has signature  (params, x, ctx) -> (x, cache_entry, aux)
where ctx = {mode: train|prefill|decode, positions, cache (entry or None),
length, cache_len, cfg, shared, enc_out} and aux the block's auxiliary loss
(the MoE's load-balance loss; 0 for the other kinds). ``shared`` is
zamba2's one shared attention+MLP parameter set (``shared_attn_init``),
reused at every ``mamba2_attn`` layer; each such layer keeps its own K/V
cache of it (``shared_kv``). ``enc_out`` is whisper's encoder output, which
every ``dec`` layer's cross-attention reads. With ``cfg.mrope_sections``
(qwen2-vl) the positions are (B, 3, S) t/h/w triplets and attention rotates
by M-RoPE.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.relational import rel_linear

from .attention import NEG_INF, attention, cache_update, decode_attention
from .common import (ParamTree, apply_mrope, apply_rope, dense_init, einsum, gelu, layer_norm,
                     rms_norm)
from .ffn import mlp_apply, mlp_init, moe_apply, moe_init
from .ssm import mamba1_apply, mamba1_init, mamba2_apply, mamba2_init

Ctx = Dict[str, Any]

#: the block kinds
KINDS = ("attn", "local", "global", "moe", "mla", "mla_moe", "mamba1", "mamba2", "mamba2_attn",
         "enc", "dec")


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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


def gqa_apply(
    p,
    x: torch.Tensor,
    ctx: Ctx,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    rope: bool = True,
    kv_source: Optional[torch.Tensor] = None,
):
    """The attention sublayer: q/k/v/o through ``rel_linear``, QK-norm and
    RoPE (M-RoPE with ``cfg.mrope_sections``), then attention (train,
    prefill) or one step against the cache (decode). Returns (y, new cache
    entry or None).

    A prefill pads its K/V to ``ctx["cache_len"]``. With ``window`` (a
    ``local`` layer) the cache is window-sized and right-aligned instead:
    ``min(cache_len, window)`` slots holding the last keys, left-padded. A
    decode step against a cache no wider than the window shifts it left
    by one and appends (O(window) per step, as the reference); against a
    wider one it writes at ``length`` and masks by the window.
    ``causal=False, rope=False`` is whisper's encoder self-attention.
    ``kv_source`` is cross-attention (whisper's decoder): K/V are computed
    from it at every call, in every mode, unrotated and unmasked, and no
    cache is kept."""
    cfg = ctx["cfg"]
    hd = cfg.hd()
    b, s, _ = x.shape
    mode = ctx["mode"]

    q = rel_linear(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    src = kv_source if kv_source is not None else x
    k = rel_linear(src, p["wk"]).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    v = rel_linear(src, p["wv"]).reshape(b, src.shape[1], cfg.n_kv_heads, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if rope and kv_source is None:
        pos = ctx["positions"]
        if cfg.mrope_sections:
            q = apply_mrope(q, pos, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, pos, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)

    new_cache = None
    if kv_source is not None:
        out = attention(
            q, k, v,
            q_positions=torch.arange(s, device=x.device),
            k_positions=torch.arange(src.shape[1], device=x.device), causal=False,
            logit_softcap=cfg.logit_softcap, chunk_size=cfg.attn_chunk,
        )
    elif mode == "decode":
        ck, cv, length = ctx["cache"]["k"], ctx["cache"]["v"], ctx["length"]
        if window is not None and ck.shape[1] <= window:
            ck = torch.cat([ck[:, 1:], k.to(ck.dtype)], dim=1)
            cv = torch.cat([cv[:, 1:], v.to(cv.dtype)], dim=1)
            out = decode_attention(q, ck, cv, min(length + 1, ck.shape[1]),
                                   logit_softcap=cfg.logit_softcap, align="right")
        else:
            ck, cv = cache_update(ck, cv, length, k, v)
            out = decode_attention(q, ck, cv, length + 1, window=window,
                                   logit_softcap=cfg.logit_softcap)
        new_cache = {"k": ck, "v": cv}
    else:
        qpos = torch.arange(s, device=x.device)
        out = attention(
            q, k, v,
            q_positions=qpos, k_positions=qpos, causal=causal, window=window,
            logit_softcap=cfg.logit_softcap, chunk_size=cfg.attn_chunk,
        )
        if mode == "prefill":
            cap = ctx["cache_len"]
            if window is not None:
                capw = min(cap, window)
                keep = min(s, capw)
                pad = (0, 0, 0, 0, capw - keep, 0)
                kk, vv = k[:, s - keep:], v[:, s - keep:]
            else:
                pad = (0, 0, 0, 0, 0, cap - s)
                kk, vv = k, v
            new_cache = {"k": F.pad(kk, pad).to(_dt(cfg)), "v": F.pad(vv, pad).to(_dt(cfg))}
    y = rel_linear(out.reshape(b, s, cfg.n_heads * hd), p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA attention sublayer (deepseek-v3, arXiv:2412.19437)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg) -> ParamTree:
    dt = _dt(cfg)
    dev = gen.device
    qh = cfg.nope_head_dim + cfg.rope_head_dim
    return ParamTree(
        wq_a=dense_init(gen, (cfg.d_model, cfg.q_lora_rank), dtype=dt),
        q_norm=torch.zeros((cfg.q_lora_rank,), dtype=dt, device=dev),
        wq_b=dense_init(gen, (cfg.q_lora_rank, cfg.n_heads * qh), dtype=dt),
        wkv_a=dense_init(gen, (cfg.d_model, cfg.kv_lora_rank + cfg.rope_head_dim), dtype=dt),
        kv_norm=torch.zeros((cfg.kv_lora_rank,), dtype=dt, device=dev),
        wk_b=dense_init(gen, (cfg.kv_lora_rank, cfg.n_heads * cfg.nope_head_dim), dtype=dt),
        wv_b=dense_init(gen, (cfg.kv_lora_rank, cfg.n_heads * cfg.v_head_dim), dtype=dt),
        wo=dense_init(gen, (cfg.n_heads * cfg.v_head_dim, cfg.d_model), dtype=dt),
    )


def mla_apply(p, x, ctx):
    """MLA: queries, keys and values through low-rank compressions; the
    decode cache holds only (c_kv, k_rope) per position (``{"c": (B, T,
    kv_lora_rank), "r": (B, T, rope_head_dim)}``), and decode runs in the
    latent space with the up-projections absorbed, in f32.

    ``wq_a``, ``wq_b``, ``wkv_a`` and ``wo`` go through ``rel_linear``;
    the up-projections ``wk_b``/``wv_b`` are einsums (``common.einsum``),
    as the reference's ``jnp.einsum``. A prefill pads v to the query's
    head dim dn + dr for the shared attention and slices it back."""
    cfg = ctx["cfg"]
    b, s, _ = x.shape
    h, dn, dr, dv, dc = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    mode = ctx["mode"]
    pos = ctx["positions"]

    q = rel_linear(rms_norm(rel_linear(x, p["wq_a"]), p["q_norm"], cfg.norm_eps), p["wq_b"])
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    kv = rel_linear(x, p["wkv_a"])
    c_kv, k_rope = kv[..., :dc], kv[..., dc:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)   # (B,S,1,dr)

    wk_b = p["wk_b"].reshape(dc, h, dn)
    wv_b = p["wv_b"].reshape(dc, h, dv)
    scale = (dn + dr) ** -0.5

    new_cache = None
    if mode == "decode":
        cc, cr, length = ctx["cache"]["c"], ctx["cache"]["r"], ctx["length"]
        idx = torch.as_tensor(length, dtype=torch.long, device=x.device).reshape(1)
        cc = cc.index_copy(1, idx, c_kv.to(cc.dtype))
        cr = cr.index_copy(1, idx, k_rope[:, :, 0, :].to(cr.dtype))
        new_cache = {"c": cc, "r": cr}
        # absorbed decode: score = (q_nope·W_k c) + (q_rope·k_rope)
        q_lat = einsum("bshd,chd->bshc", q_nope, wk_b)                  # (B,1,H,dc)
        sc = einsum("bshc,btc->bhst", q_lat.float(), cc.float())
        sc = sc + einsum("bshd,btd->bhst", q_rope.float(), cr.float())
        sc = sc * scale
        ok = torch.arange(cc.shape[1], device=x.device)[None, :] < (length + 1)
        sc = torch.where(ok[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
        w = torch.softmax(sc, dim=-1)
        o_lat = einsum("bhst,btc->bshc", w, cc.float())                # (B,1,H,dc)
        out = einsum("bshc,chd->bshd", o_lat, wv_b.float()).to(x.dtype)
    else:
        k_nope = einsum("btc,chd->bthd", c_kv, wk_b)
        v = einsum("btc,chd->bthd", c_kv, wv_b)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        qpos = torch.arange(s, device=x.device)
        out = attention(
            qfull, k, F.pad(v, (0, dn + dr - dv)),
            q_positions=qpos, k_positions=qpos, causal=True,
            chunk_size=cfg.attn_chunk, scale=scale,
        )[..., :dv]
        if mode == "prefill":
            pad = (0, 0, 0, ctx["cache_len"] - s)
            new_cache = {"c": F.pad(c_kv, pad).to(_dt(cfg)),
                         "r": F.pad(k_rope[:, :, 0, :], pad).to(_dt(cfg))}
    y = rel_linear(out.reshape(b, s, h * dv), p["wo"])
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
    if kind in ("attn", "local", "global", "moe", "mla", "mla_moe"):
        parts = {
            "ln1": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
            "attn": mla_init(gen, cfg) if kind.startswith("mla") else gqa_init(gen, cfg),
            "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        }
        if kind in ("moe", "mla_moe"):
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
    if kind in ("enc", "dec"):
        def ln():
            return (torch.ones((cfg.d_model,), dtype=dt, device=dev),
                    torch.zeros((cfg.d_model,), dtype=dt, device=dev))

        parts = dict(zip(("ln1_s", "ln1_b"), ln()), attn=gqa_init(gen, cfg))
        if kind == "dec":
            parts.update(zip(("lnx_s", "lnx_b"), ln()), xattn=gqa_init(gen, cfg))
        parts.update(zip(("ln2_s", "ln2_b"), ln()), mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt))
        return ParamTree(**parts)
    raise ValueError(f"unknown block kind {kind}")


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

    if kind in ("attn", "local", "global", "moe", "mla", "mla_moe"):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        actx = dict(ctx)
        actx["cache"] = ctx["cache"]["kv"] if ctx.get("cache") else None
        if kind.startswith("mla"):
            a, kv = mla_apply(p["attn"], h, actx)
        else:
            a, kv = gqa_apply(p["attn"], h, actx, window=cfg.window if kind == "local" else None)
        x = x + a
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind in ("moe", "mla_moe"):
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

    if kind == "enc":
        h = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
        a, _ = gqa_apply(p["attn"], h, ctx, causal=False, rope=False)
        x = x + a
        h = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h, activation=gelu), cache, aux

    if kind == "dec":
        sctx = dict(ctx)
        sctx["cache"] = ctx["cache"]["kv"] if ctx.get("cache") else None
        h = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
        a, kv = gqa_apply(p["attn"], h, sctx)
        x = x + a
        h = layer_norm(x, p["lnx_s"], p["lnx_b"], cfg.norm_eps)
        a, _ = gqa_apply(p["xattn"], h, ctx, kv_source=ctx["enc_out"], rope=False)
        x = x + a
        h = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, activation=gelu)
        if kv is not None:
            cache["kv"] = kv
        return x, cache, aux

    raise ValueError(f"unknown block kind {kind}")
