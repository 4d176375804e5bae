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
    cache is kept.

    On a mesh (``ctx["place"]``) the projections are column-parallel over
    the model ranks where their width divides, ``wo`` row-parallel, its
    partial sums added over the ranks: where q, k and v split on head
    boundaries each rank attends over its own heads (and caches its KV
    heads), else the split projections are gathered whole first and every
    rank attends over all heads (never over part of a head). A
    cross-attention computes its K/V from the whole ``kv_source`` on the
    rank's heads."""
    cfg = ctx["cfg"]
    hd = cfg.hd()
    b, s, _ = x.shape
    mode = ctx["mode"]
    place = ctx.get("place")
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    if place is None:
        q = rel_linear(x, p["wq"])
        src = kv_source if kv_source is not None else x
        k = rel_linear(src, p["wk"])
        v = rel_linear(src, p["wv"])
        q_norm, k_norm = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
    else:
        src = kv_source if kv_source is not None else x
        q, k, v, hq, hkv, q_norm, k_norm = _tp_projections(p, x, cfg, place, kv_source)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, src.shape[1], hkv, hd)
    v = v.reshape(b, src.shape[1], hkv, hd)

    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)

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
    out = out.reshape(b, s, hq * hd)
    if place is None or not place.splits(cfg.n_heads * hd):
        return rel_linear(out, p["wo"]), new_cache
    if hq == cfg.n_heads:   # every head here: the rank's rows of wo take its slice
        out = place.scatter_to(out, -1)
    return place.reduce(rel_linear(out, p["wo"])), new_cache


def _tp_projections(p, x, cfg, place, kv_source=None):
    """q, k, v of the rank (flat, (B, S, width)), the heads they hold and
    the QK-norm scales to use: each projection whose width the model ranks
    split is computed on the rank's columns from ``copy_to(x)`` (its
    partial input gradient summed over the ranks) — k and v from
    ``kv_source`` where one is given (cross-attention: ``_kv_source``); on
    head boundaries the rank keeps its heads (and the norm scales, applied
    to those heads only, sum their gradients over the ranks), else each
    split projection is gathered whole."""
    hd = cfg.hd()
    names = ("wq", "wk", "wv")
    widths = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd, "wv": cfg.n_kv_heads * hd}
    split = {n: place.splits(w) for n, w in widths.items()}
    xs = place.copy_to(x) if any(split.values()) else x
    src, ss = x, xs
    if kv_source is not None:
        src = kv_source
        ss = _kv_source(place, kv_source) if split["wk"] or split["wv"] else kv_source
    q = rel_linear(xs if split["wq"] else x, p["wq"])
    k, v = (rel_linear(ss if split[n] else src, p[n]) for n in ("wk", "wv"))
    q_norm, k_norm = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
    if place.heads_local(cfg):
        m = place.size("model")
        if cfg.qk_norm:
            q_norm, k_norm = place.copy_to(q_norm), place.copy_to(k_norm)
        return q, k, v, cfg.n_heads // m, cfg.n_kv_heads // m, q_norm, k_norm
    q, k, v = (place.gather_from(t, -1) if split[n] else t
               for n, t in zip(names, (q, k, v)))
    return q, k, v, cfg.n_heads, cfg.n_kv_heads, q_norm, k_norm


def _kv_source(place, enc_out):
    """A cross-attention's K/V source as the rank's heads read it: whole on
    every rank, while each rank's heads give only part of its gradient,
    which ``copy_to`` sums over the model ranks backward."""
    return place.copy_to(enc_out)


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
    head dim dn + dr for the shared attention and slices it back.

    On a mesh whose model ranks split it (``ctx["place"]``), a rank runs
    its heads: ``wq_a`` makes its slice of the q latent, normalised with
    the Σx² summed over the ranks and its slice of ``q_norm``, then
    gathered whole for its columns of ``wq_b`` (``gather_summed``: every
    rank's use of the whole latent gives part of its gradient); ``wkv_a``
    and ``kv_norm`` are whole on every rank, and so are c_kv and k_rope
    and the latent cache, which every head reads (``_latent``); the
    rank's columns of ``wk_b``/``wv_b`` give its heads' k and v, and its
    rows of ``wo`` a partial sum added over the ranks."""
    cfg = ctx["cfg"]
    b, s, _ = x.shape
    h, dn, dr, dv, dc = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    mode = ctx["mode"]
    pos = ctx["positions"]
    place = ctx.get("place")
    split = place is not None and place.size("model") > 1

    if split:
        h //= place.size("model")
        ql = rel_linear(place.copy_to(x), p["wq_a"])
        ql = rms_norm(ql, place.scatter_to(p["q_norm"], 0), cfg.norm_eps,
                      sum_over=place.psum, width=cfg.q_lora_rank)
        q = rel_linear(place.gather_summed(ql, -1), p["wq_b"])
    else:
        q = rel_linear(rms_norm(rel_linear(x, p["wq_a"]), p["q_norm"], cfg.norm_eps), p["wq_b"])
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    kv = rel_linear(x, p["wkv_a"])
    c_kv, k_rope = kv[..., :dc], kv[..., dc:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)   # (B,S,1,dr)
    if split:
        c_kv, k_rope = _latent(place, c_kv, k_rope)

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
    return (place.reduce(y) if split else y), new_cache


def _latent(place, c_kv, k_rope):
    """c_kv and k_rope as a rank's heads read them: whole on every rank,
    from the replicated ``wkv_a`` and ``kv_norm``, while each rank's heads
    give only part of their gradient, which ``copy_to`` sums over the
    model ranks backward."""
    return place.copy_to(c_kv), place.copy_to(k_rope)


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
                place=ctx.get("place"), d_ff=_ffn_dims(cfg, kind) * cfg.n_shared_experts,
            )
        else:
            f = mlp_apply(p["mlp"], h, place=ctx.get("place"), d_ff=cfg.d_ff)
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
            use_pallas=cfg.ssm_pallas, place=ctx.get("place"),
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
            use_pallas=cfg.ssm_pallas, place=ctx.get("place"),
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
            x = x + mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps),
                              place=ctx.get("place"), d_ff=cfg.d_ff)
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
        x = x + mlp_apply(p["mlp"], h, activation=gelu, place=ctx.get("place"), d_ff=cfg.d_ff)
        if kv is not None:
            cache["kv"] = kv
        return x, cache, aux

    raise ValueError(f"unknown block kind {kind}")
