"""State-space blocks: Mamba-1 (falcon-mamba). Mamba-2 (zamba2) waits for
the zamba2 slice (ROADMAP.md).

The selective scan is a linear recurrence h_t = a_t ⊙ h_{t-1} + b_t. With
``use_pallas`` (``ModelConfig.ssm_pallas``) it runs on the hand-written
CUDA kernel (``kernels/ssm_scan``): one pass over the (B,S,C,N) tensors.
Without it, ``selective_scan`` runs the parallel prefix in plain PyTorch,
as the reference runs ``jax.lax.associative_scan``. Decode keeps (conv
window, ssm state) as carried state and advances one step in O(1).

Arch-applicability: the recurrence is *not* a relational join-aggregate, so
the paper's auto-diff does not cover it — these blocks use PyTorch's
autograd for the scan itself, while their projections (in/x/dt/out) go
through the relational engine (``rel_linear``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.relational import rel_linear

from .common import dense_init


def _assoc_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 (time). a, b: (B, S, ...).
    Returns (cumulative a-product, h).

    Hillis–Steele parallel prefix: log₂S rounds, round d combines step t
    with step t − d by (a₁, b₁) ∘ (a₂, b₂) = (a₁a₂, a₂b₁ + b₂), the
    reference's combine. (jax.lax.associative_scan pairs the steps in
    another tree, so the two agree to f32 rounding, not bit for bit.)"""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def selective_scan(a, b, chunk: int = 0):
    """h_t = a_t ⊙ h_{t-1} + b_t along axis 1.

    ``chunk == 0`` runs one parallel prefix over the whole sequence.
    ``chunk > 0`` runs a sequential loop over S/chunk chunks carrying the
    boundary state, with the parallel prefix only within each chunk; the
    carry enters each chunk through the cumulative a-product the
    within-chunk prefix already computes."""
    s = a.shape[1]
    if not chunk or s <= chunk or s % chunk:
        return _assoc_scan(a, b)[1]
    nc = s // chunk
    a_c = a.reshape((a.shape[0], nc, chunk) + tuple(a.shape[2:]))
    b_c = b.reshape((b.shape[0], nc, chunk) + tuple(b.shape[2:]))
    h = torch.zeros(b.shape[:1] + b.shape[2:], dtype=b.dtype, device=b.device)
    hs = []
    for i in range(nc):
        pa, hl = _assoc_scan(a_c[:, i], b_c[:, i])
        hc = hl + pa * h[:, None]
        h = hc[:, -1]
        hs.append(hc)
    return torch.stack(hs, dim=1).reshape((b.shape[0], s) + tuple(b.shape[2:]))


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba, arXiv:2410.05355)
# ---------------------------------------------------------------------------


def mamba1_init(gen: torch.Generator, d_model: int, state: int = 16, expand: int = 2,
                conv_width: int = 4, dt_rank: Optional[int] = None,
                dtype=torch.float32) -> nn.ParameterDict:
    """The block's parameters, made on ``gen``'s device."""
    d_inner = expand * d_model
    dt_rank = dt_rank or max(1, d_model // 16)
    dev = gen.device
    a_log = torch.log(torch.arange(1, state + 1, dtype=torch.float32, device=dev))
    return nn.ParameterDict({
        "in_proj": dense_init(gen, (d_model, 2 * d_inner), dtype=dtype),
        "conv_w": dense_init(gen, (conv_width, d_inner), dtype=dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (d_inner, dt_rank + 2 * state), dtype=dtype),
        "dt_proj": dense_init(gen, (dt_rank, d_inner), dtype=dtype),
        "dt_bias": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "a_log": a_log.expand(d_inner, state).clone(),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, d_model), dtype=dtype),
    })


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """x: (B,S,C), w: (W,C) depthwise. With ``state`` (B,W-1,C) prepends the
    carried window (decode); returns (y, new_state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    # a copy, not a view: a cache entry must not keep the whole (B,S,C) xp alive
    new_state = xp[:, xp.shape[1] - (width - 1):, :].clone()
    return y + b[None, None, :], new_state


def mamba1_apply(
    p,
    x: torch.Tensor,                     # (B, S, D)
    *,
    state: Optional[dict] = None,        # decode: {"conv": (B,W-1,C), "ssm": (B,C,N)}
    chunk: int = 0,                      # sequential chunking of the scan
    scan_dtype=torch.float32,            # state dtype inside the scan
    use_pallas: bool = False,            # the single-pass scan kernel
) -> Tuple[torch.Tensor, dict]:
    n = p["a_log"].shape[1]

    xz = rel_linear(x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)

    dbl = rel_linear(xc, p["x_proj"])
    dt_rank = p["dt_proj"].shape[0]
    dt, bmat, cmat = torch.split(dbl, [dt_rank, n, n], dim=-1)
    dt = F.softplus(rel_linear(dt, p["dt_proj"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"])                               # (C, N)

    dt32 = dt.float()                                         # (B,S,C)
    da = torch.exp(dt32[..., None] * a[None, None])           # (B,S,C,N)
    db = dt32[..., None] * bmat.float()[:, :, None, :]        # (B,S,C,N)
    bx = db * xc.float()[..., None]
    del db  # each (B,S,C,N) f32 tensor is 1 GiB at the full-width prefill

    if state is None:
        # da/bx are exp/products computed in f32; the scan itself may run
        # in a narrower state dtype.
        if use_pallas:
            h = ssm_scan(da.to(scan_dtype), bx.to(scan_dtype))
        else:
            h = selective_scan(da.to(scan_dtype), bx.to(scan_dtype), chunk)   # (B,S,C,N)
        # a copy, not a view: the cache must not keep the whole h alive
        new_ssm = h[:, -1].to(torch.float32, copy=True)
    else:
        h = da[:, 0] * state["ssm"] + bx[:, 0]                 # (B,C,N)
        new_ssm = h
        h = h[:, None]
    del da, bx

    y = torch.einsum("bscn,bsn->bsc", h, cmat.to(h.dtype))
    y = y.float()
    y = y + p["d_skip"][None, None] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = rel_linear(y, p["out_proj"])
    return out, {"conv": new_conv, "ssm": new_ssm}
