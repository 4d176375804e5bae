"""State-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2).

The selective scan is a linear recurrence h_t = a_t ⊙ h_{t-1} + b_t. With
``use_pallas`` (``ModelConfig.ssm_pallas``) it runs on the hand-written
CUDA kernel (``kernels/ssm_scan``): one pass over the (B,S,C,N) tensors;
Mamba-2's per-head decay is broadcast to the head's N·P lanes first, as
the reference broadcasts it for its Pallas kernel. Without it,
``selective_scan`` runs the parallel prefix in plain PyTorch, as the
reference runs ``jax.lax.associative_scan``. Decode keeps (conv window,
ssm state) as carried state and advances one step in O(1).

On a mesh (``place=``, a ``launch.sharding.Placement``) the model ranks
split the channels: a ``mamba1`` rank owns channels [r·C/m, (r+1)·C/m)
of x and z (its ``in_proj`` shard is [x_r | z_r]), their conv, ``dt``
and state, and scans (B, S, C/m, N); ``x_proj``'s row-parallel output is
summed over the ranks forward and backward (``Placement.psum``). A
``mamba2`` rank owns heads [r·H/m, (r+1)·H/m), with their z, x and dt,
and a slice N/m of B and C (``in_proj`` [z_r | x_r | B_r | C_r | dt_r],
the conv over [x_r | B_r | C_r]); B and C are gathered whole after the
conv with a reduce-scattered gradient, the scan runs on (B, S, H/m, N·P),
and the gated RMSNorm sums Σy² over the ranks. ``out_proj`` is
row-parallel in both.

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

from .common import dense_init, einsum, rms_norm


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
    place=None,                          # a launch.sharding.Placement
) -> Tuple[torch.Tensor, dict]:
    """On a mesh whose model ranks split the channels, a rank runs its
    channels C/m (module docstring); the state it carries is theirs."""
    n = p["a_log"].shape[1]
    split = place is not None and place.size("model") > 1
    if split:
        x = place.copy_to(x)

    xz = rel_linear(x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)

    dbl = rel_linear(xc, p["x_proj"])
    if split:
        dbl = place.psum(dbl)
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
            # contiguous for the kernel: on a mesh a_log gathered over the
            # data ranks is a strided view, and da follows its layout
            h = ssm_scan(da.to(scan_dtype).contiguous(), bx.to(scan_dtype).contiguous())
        else:
            h = selective_scan(da.to(scan_dtype), bx.to(scan_dtype), chunk)   # (B,S,C,N)
        # a copy, not a view: the cache must not keep the whole h alive
        new_ssm = h[:, -1].to(torch.float32, copy=True)
    else:
        h = da[:, 0] * state["ssm"] + bx[:, 0]                 # (B,C,N)
        new_ssm = h
        h = h[:, None]
    del da, bx

    y = einsum("bscn,bsn->bsc", h, cmat.to(h.dtype))
    del h
    y = y.float()
    y = y + p["d_skip"][None, None] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = rel_linear(y, p["out_proj"])
    if split:
        out = place.reduce(out)
    return out, {"conv": new_conv, "ssm": new_ssm}


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2, arXiv:2411.15242)
# ---------------------------------------------------------------------------


def mamba2_init(gen: torch.Generator, d_model: int, state: int = 64, expand: int = 2,
                n_heads: Optional[int] = None, head_dim: int = 64,
                conv_width: int = 4, dtype=torch.float32) -> nn.ParameterDict:
    """The block's parameters, made on ``gen``'s device. ``in_proj`` emits
    [z, x, B, C, dt]."""
    d_inner = expand * d_model
    n_heads = n_heads or d_inner // head_dim
    d_xbc = d_inner + 2 * state
    dev = gen.device
    return nn.ParameterDict({
        "in_proj": dense_init(gen, (d_model, 2 * d_inner + 2 * state + n_heads), dtype=dtype),
        "conv_w": dense_init(gen, (conv_width, d_xbc), dtype=dtype),
        "conv_b": torch.zeros((d_xbc,), dtype=dtype, device=dev),
        "a_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (d_inner, d_model), dtype=dtype),
    })


def mamba2_apply(
    p,
    x: torch.Tensor,                     # (B, S, D)
    *,
    head_dim: int = 64,
    state_dim: int = 64,
    state: Optional[dict] = None,        # decode: {"conv": (B,W-1,d_inner+2N), "ssm": (B,H,N,P)}
    chunk: int = 0,
    scan_dtype=torch.float32,
    use_pallas: bool = False,
    place=None,                          # a launch.sharding.Placement
) -> Tuple[torch.Tensor, dict]:
    """On a mesh whose model ranks split the heads, a rank runs its heads
    H/m on the whole B and C (module docstring); the state it carries is
    theirs, and its conv window its x, B and C columns."""
    b, s, _ = x.shape
    nh = p["a_log"].shape[0]             # the rank's heads on a mesh
    d_inner = nh * head_dim
    split = place is not None and place.size("model") > 1
    m = place.size("model") if split else 1
    n = state_dim // m                   # the rank's columns of B and C
    if split:
        x = place.copy_to(x)

    zxbcdt = rel_linear(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, nh], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    if split:
        # every head reads all of B and C: the ranks' columns, gathered
        # once as [B_r | C_r] per rank
        bc = place.gather_summed(torch.cat([bmat, cmat], dim=-1), -1)
        bc = bc.reshape(b, s, m, 2, n)
        bmat, cmat = (bc[:, :, :, i].reshape(b, s, m * n) for i in (0, 1))
        n = state_dim

    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,S,H)
    a = -torch.exp(p["a_log"])                                  # (H,)
    da = torch.exp(dt * a[None, None])                          # (B,S,H)

    xh = xin.reshape(b, s, nh, head_dim).float()
    bx = (dt[..., None, None] * bmat.float()[:, :, None, :, None]
          * xh[..., None, :])                                   # (B,S,H,N,P)

    if state is None:
        if use_pallas:
            # the kernel takes a and b of one shape: the head's decay
            # broadcast to its N·P lanes, materialized (under autograd the
            # expand's backward sums ∂a over a head's lanes)
            lanes = (b, s, nh, n * head_dim)
            da_full = da[..., None].expand(lanes).to(scan_dtype).contiguous()
            h = ssm_scan(da_full, bx.reshape(lanes).to(scan_dtype)).reshape(bx.shape)
            del da_full
        else:
            h = selective_scan(da[..., None, None].to(scan_dtype), bx.to(scan_dtype), chunk)  # (B,S,H,N,P)
        # a copy, not a view: the cache must not keep the whole h alive
        new_ssm = h[:, -1].to(torch.float32, copy=True)
    else:
        h = da[:, 0, :, None, None] * state["ssm"] + bx[:, 0]   # (B,H,N,P)
        new_ssm = h
        h = h[:, None]
    del bx  # each (B,S,H,N,P) f32 tensor is 3.76 GB at zamba2's 2 x 1,024-token prefill

    y = einsum("bshnp,bsn->bshp", h, cmat.to(h.dtype))
    del h
    y = y.float()
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(b, s, d_inner).to(x.dtype)
    if not split:
        y = rms_norm(y * F.silu(z), p["norm_scale"])
        return rel_linear(y, p["out_proj"]), {"conv": new_conv, "ssm": new_ssm}
    # the gated norm spans all of d_inner: Σy² summed over the ranks, each
    # rank applying its columns' slice of the scale
    y = rms_norm(y * F.silu(z), place.scatter_to(p["norm_scale"], 0), sum_over=place.psum,
                 width=m * d_inner)
    out = place.reduce(rel_linear(y, p["out_proj"]))
    return out, {"conv": new_conv, "ssm": new_ssm}
