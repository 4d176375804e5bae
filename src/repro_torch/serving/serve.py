"""Serving steps: batched prefill and single-token decode, on one device.

``make_prefill_step`` / ``make_decode_step`` wrap ``Model.prefill`` /
``Model.decode_step`` in ``torch.inference_mode()``: without it every
``autograd.Function`` on the path (``rel_linear``, ``rel_embed``,
``ssm_scan``) saves its inputs for a backward that never comes, and a
full-width prefill would hold each layer's (B,S,C,N) f32 tensors — 1 GiB
each at B·S = 2048 — for all 64 layers at once.

Attention layers carry a K/V cache of ``cache_len`` positions, written at
``length`` by each decode step, which then advances ``length`` by one as
the reference's caller does; SSM layers carry (conv window, state): O(1)
per step. The reference's
``BucketedPrefill`` and the async ``Endpoint`` need the session's
executable cache and model registry, and its mesh placement has no meaning
on one device; they wait for ROADMAP.md queue 1, item 7.
"""

from __future__ import annotations

import torch

from repro_torch.core.session import resolve_device
from repro_torch.models.model import Model, stages_of


def _attn_cache_entry(cfg, kind: str, batch: int, cache_len: int, device: torch.device):
    dt = getattr(torch, cfg.dtype)
    if kind in ("attn", "moe"):
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd())
        return {"kv": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}
    if kind == "mamba1":
        c = cfg.ssm_expand * cfg.d_model
        return {
            "ssm1": {
                "conv": torch.zeros(
                    (batch, cfg.conv_width - 1, c), dtype=dt, device=device
                ),
                "ssm": torch.zeros((batch, c, cfg.ssm_state), dtype=torch.float32, device=device),
            }
        }
    raise NotImplementedError(
        f"the cache of block kind {kind!r} is not ported yet: the port builds "
        "attn, moe and mamba1 (ROADMAP.md, queue 1, item 6.4: local/global, mla, "
        "mamba2, enc/dec)"
    )


def init_cache(cfg, batch: int, cache_len: int, device=None):
    """Zero-initialized caches in ``Model``'s layout, on ``device`` ("cuda"
    unless the caller passes another). ``cache_len`` sizes attention caches."""
    dev = resolve_device(device, owner="repro_torch.serving.init_cache")
    caches = []
    for st in stages_of(cfg):
        scan = [
            {f"{i}:{kind}": _attn_cache_entry(cfg, kind, batch, cache_len, dev) for i, kind in enumerate(st.pattern)}
            for _ in range(st.repeats)
        ]
        tail = [_attn_cache_entry(cfg, kind, batch, cache_len, dev) for kind in st.tail]
        caches.append({"scan": scan, "tail": tail})
    return caches


def make_prefill_step(model: Model, cache_len: int):
    """``prefill_step(batch) → (logits (B,1,V), caches)`` without autograd."""

    def prefill_step(batch):
        with torch.inference_mode():
            return model.prefill(batch, cache_len)

    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(token, caches, length) → (logits (B,1,V), caches)``
    without autograd."""

    def decode_step(token, caches, length):
        with torch.inference_mode():
            return model.decode_step(token, caches, length)

    return decode_step
