"""Shared model primitives: norms, activations, init.

The rope helpers of the reference's ``models/common.py`` wait for the
attention slice. Initializers draw from an explicit ``torch.Generator`` on
the target device, so a full-width model is made on the card and never on
the host first; the draws differ from ``jax.random``'s, so tests carry the
reference's weights across (``convert.lm_params``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator, shape: Sequence[int], in_axis: int = 0, dtype=torch.float32
) -> torch.Tensor:
    """Normal with std fan_in^-1/2, drawn in f32 on ``gen``'s device."""
    fan_in = shape[in_axis]
    w = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """Standard normal, drawn in f32 on ``gen``'s device."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32).to(dtype)
