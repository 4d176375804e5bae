"""Attention: GQA with logit softcap, decode against a KV cache, and a
chunked (online-softmax) attention that never materializes the S×S score
matrix.

Plain PyTorch, as the reference computes these with ``jnp.einsum`` outside
any Pallas kernel (the training path's products through
``common.einsum``, whose outputs remat's "dots" policy keeps); the
projections around them (``models/blocks.py``) go through the relational
engine. ``scaled_dot_product_attention`` is not
used: it has no logit softcap, and its masking is not the reference's
additive ``NEG_INF`` bias, which the chunked path's recurrence relies on.
Sliding windows (gemma) and MLA (deepseek-v3) wait for their slices
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import einsum, softcap

NEG_INF = -2.0e38


_PAD_POS = -(10**9)  # sentinel position for padded KV slots


def _mask_bias(
    q_pos: torch.Tensor,   # (Sq,) absolute query positions
    k_pos: torch.Tensor,   # (Sk,)
    causal: bool,
) -> torch.Tensor:
    """(Sq, Sk) additive mask."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = dk > _PAD_POS // 2   # padded slots always masked
    if causal:
        ok = ok & (dk <= dq)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(
    q: torch.Tensor,       # (B, Sq, Hq, hd)
    k: torch.Tensor,       # (B, Sk, Hkv, hd)
    v: torch.Tensor,       # (B, Sk, Hkv, hd)
    *,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    causal: bool = True,
    logit_softcap: Optional[float] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention. With ``chunk_size`` set and Sk above it, keys/values
    are processed in blocks with an online softmax (the flash-attention
    recurrence) in a Python loop, the reference's ``lax.scan``:
    O(Sq·chunk) live memory instead of O(Sq·Sk). The last block is padded
    with KV slots at ``_PAD_POS``, which the mask always drops."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    assert hq % hkv == 0
    groups = hq // hkv
    scale = hd ** -0.5
    qf = (q * scale).float().reshape(b, sq, hkv, groups, hd)
    kf = k.float()
    vf = v.float()

    if chunk_size is None or sk <= chunk_size:
        logits = einsum("bqhgd,bkhd->bhgqk", qf, kf)
        logits = softcap(logits, logit_softcap)
        logits = logits + _mask_bias(q_positions, k_positions, causal)
        w = torch.softmax(logits, dim=-1)
        out = einsum("bhgqk,bkhd->bqhgd", w, vf)
        return out.reshape(b, sq, hq, hd).to(q.dtype)

    # --- chunked online-softmax path -------------------------------------
    pad = (-sk) % chunk_size
    if pad:
        kf = F.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = F.pad(vf, (0, 0, 0, 0, 0, pad))
        k_positions = F.pad(k_positions, (0, pad), value=_PAD_POS)
        sk += pad
    m = torch.full((b, hkv, groups, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, groups, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, groups, sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk_size):
        kb, vb = kf[:, c0:c0 + chunk_size], vf[:, c0:c0 + chunk_size]
        kp = k_positions[c0:c0 + chunk_size]
        logits = einsum("bqhgd,bkhd->bhgqk", qf, kb)
        logits = softcap(logits, logit_softcap)
        logits = logits + _mask_bias(q_positions, kp, causal)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # (b,hkv,g,sq,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


def cache_update(cache_k, cache_v, length, k_new, v_new):
    """Insert (B, 1, Hkv, hd) new entries at ``length``; returns new
    tensors, as the reference's ``dynamic_update_slice`` does (the caller's
    caches stay as they were)."""
    idx = torch.as_tensor(length, dtype=torch.long, device=cache_k.device).reshape(1)
    ck = cache_k.index_copy(1, idx, k_new.to(cache_k.dtype))
    cv = cache_v.index_copy(1, idx, v_new.to(cache_v.dtype))
    return ck, cv


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, hd)
    cache_k: torch.Tensor,  # (B, S, Hkv, hd) — S = full capacity
    cache_v: torch.Tensor,
    length,                 # number of valid positions (int or 0-d tensor)
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode against a cache whose first ``length`` slots are
    valid; the rest are masked. O(S) compute/memory."""
    b, _, hq, hd = q.shape
    _, s, hkv, _ = cache_k.shape
    groups = hq // hkv
    scale = hd ** -0.5
    qf = (q * scale).float().reshape(b, hkv, groups, hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, cache_k.float())
    logits = softcap(logits, logit_softcap)
    pos = torch.arange(s, device=q.device)
    ok = pos[None, :] < length
    logits = torch.where(ok[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, cache_v.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)
