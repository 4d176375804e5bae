"""Layer blocks. This slice of the port builds the kind

  mamba1 — the Mamba-1 SSM block (falcon-mamba)

and raises ``NotImplementedError`` for the reference's other kinds (attn /
local / global / moe / mla / mla_moe / mamba2 / mamba2_attn / enc / dec),
which wait for ROADMAP.md queue 1, item 8.

Every block's apply has signature  (params, x, ctx) -> (x, cache_entry)
(the reference's third result, an auxiliary loss, is 0 for mamba1)
where ctx = {mode: train|prefill|decode, cache (entry or None), cfg}.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from .common import rms_norm
from .ssm import mamba1_apply, mamba1_init

Ctx = Dict[str, Any]


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: the port builds 'mamba1' only "
        "(ROADMAP.md, queue 1, item 8: the LM zoo)"
    )


class Block(nn.Module):
    """One layer's parameters, addressed like the reference's pytree:
    ``p["ln"]`` is a parameter, ``p["ssm"]["in_proj"]`` one of a sublayer's."""

    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            if isinstance(part, torch.Tensor):
                part = nn.Parameter(part)
            setattr(self, name, part)

    def __getitem__(self, name: str):
        return getattr(self, name)


def block_init(gen: torch.Generator, kind: str, cfg) -> Block:
    """A block's parameters, made on ``gen``'s device."""
    dt = _dt(cfg)
    if kind == "mamba1":
        return Block(
            ln=torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
            ssm=mamba1_init(
                gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                cfg.conv_width, dtype=dt,
            ),
        )
    raise _not_ported(kind)


def block_apply(p, kind: str, x, ctx: Ctx):
    cfg = ctx["cfg"]
    if kind == "mamba1":
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y, st = mamba1_apply(
            p["ssm"], h,
            state=ctx["cache"]["ssm1"] if ctx.get("cache") else None,
            chunk=cfg.ssm_chunk, scan_dtype=getattr(torch, cfg.ssm_scan_dtype),
            use_pallas=cfg.ssm_pallas,
        )
        return x + y, {"ssm1": st}

    raise _not_ported(kind)
