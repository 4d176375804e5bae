"""Shared model primitives: norms, activations, RoPE / M-RoPE, init, the
blocks' two-operand einsum, and the module that holds a layer's parameters.

Initializers draw from an explicit ``torch.Generator`` on the target
device, so a full-width model is made on the card and never on the host
first; the draws differ from ``jax.random``'s, so tests carry the
reference's weights across (``convert.lm_params``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import remat


class ParamTree(nn.Module):
    """Parameters addressed like the reference's pytree: ``p["ln1"]`` is a
    parameter, ``p["attn"]["wq"]`` one of a sublayer's, ``"shared" in p``
    asks for a part. A tensor part becomes a parameter (a parameter part
    is kept as it is); a module part (a ``ParamTree``, an
    ``nn.ParameterDict``) a submodule."""

    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            if isinstance(part, torch.Tensor) and not isinstance(part, nn.Parameter):
                part = nn.Parameter(part)
            setattr(self, name, part)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
             sum_over=None, width: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over the last dimension. Where ranks split that dimension,
    ``sum_over`` sums each rank's Σx² over them (forward and backward:
    every rank's output depends on the total) and ``width`` is the whole
    dimension's; without it the mean is taken locally."""
    dt = x.dtype
    x = x.float()
    if sum_over is None:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        var = sum_over(torch.sum(x * x, dim=-1, keepdim=True)) / width
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


class _Einsum(torch.autograd.Function):
    """``torch.einsum(eq, x, y)`` whose output is a product remat's "dots"
    policy keeps (``core/remat.py``), with its VJP written out: each
    operand's gradient is the einsum of the cotangent with the other
    operand. The same backward runs under every remat policy, so their
    gradients agree bit for bit."""

    @staticmethod
    def forward(ctx, eq, x, y):
        ctx.eq = eq
        ctx.save_for_backward(x, y)
        return remat.product(lambda: torch.einsum(eq, x, y),
                             ("einsum", eq, tuple(x.shape), tuple(y.shape)))

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        operands, out = ctx.eq.split("->")
        xs, ys = operands.split(",")
        gx = torch.einsum(f"{out},{ys}->{xs}", g, y) if ctx.needs_input_grad[1] else None
        gy = torch.einsum(f"{xs},{out}->{ys}", x, g) if ctx.needs_input_grad[2] else None
        return None, gx, gy


def einsum(eq: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A product of the blocks (attention's scores and values, the MoE's
    router and experts, the SSM readout): ``torch.einsum`` of two operands
    in explicit form ``"ab,bc->ac"``, each index of an operand also in the
    other operand or in the output."""
    return _Einsum.apply(eq, x, y)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,                # (B, S, H, hd)
    positions: torch.Tensor,        # (B, S) integer
    theta: float = 10000.0,
) -> torch.Tensor:
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)                 # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs          # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(
    x: torch.Tensor,                # (B, S, H, hd)
    positions: torch.Tensor,        # (B, 3, S) integer: t/h/w position triplets
    sections: Tuple[int, int, int],  # frequency pairs per axis
    theta: float = 1_000_000.0,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary spectrum's hd/2 frequency pairs
    split into three sections, rotated by the temporal, height and width
    positions [arXiv:2409.12191]. As the reference's ``jnp.repeat(...,
    total_repeat_length=hd // 2)``, sections summing past hd/2 are cut and
    ones short of it extended by the last section."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, device=x.device)                # (hd/2,)
    sec = torch.repeat_interleave(torch.arange(3, device=x.device),
                                  torch.tensor(sections, device=x.device))
    sec = torch.cat([sec, sec[-1:].expand(max(0, half - sec.numel()))])[:half]
    posf = positions.to(torch.float32)[:, sec, :]                 # (B, hd/2, S)
    ang = posf.transpose(1, 2) * freqs                            # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


class MetaGenerator:
    """What the initializers read of a generator (its ``device``) for a
    model built on the ``meta`` device, which has no ``torch.Generator``:
    shapes only, nothing drawn."""

    device = torch.device("meta")


#: while set (``keeping``), what the initializers keep of each leaf they
#: draw: a model drawn on a mesh keeps the rank's shard, so that no leaf is
#: held whole past its draw
_KEEP: contextvars.ContextVar[Optional[Callable[[torch.Tensor], torch.Tensor]]] = (
    contextvars.ContextVar("repro_torch_init_keep", default=None))


@contextlib.contextmanager
def keeping(keep: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, ``dense_init`` and ``embed_init`` return
    ``keep(leaf)`` of each leaf they draw (on ``meta``: they would draw),
    in draw order."""
    token = _KEEP.set(keep)
    try:
        yield
    finally:
        _KEEP.reset(token)


def _kept(w: torch.Tensor) -> torch.Tensor:
    keep = _KEEP.get()
    return w if keep is None else keep(w)


def dense_init(
    gen: torch.Generator, shape: Sequence[int], in_axis: int = 0, dtype=torch.float32
) -> torch.Tensor:
    """Normal with std fan_in^-1/2, drawn in f32 on ``gen``'s device (on
    ``meta``, an empty tensor of the shape: no draw)."""
    if gen.device.type == "meta":
        return _kept(torch.empty(tuple(shape), dtype=dtype, device="meta"))
    fan_in = shape[in_axis]
    w = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return _kept(w.mul_(fan_in ** -0.5).to(dtype))


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """Standard normal, drawn in f32 on ``gen``'s device (on ``meta``, an
    empty tensor of the shape)."""
    if gen.device.type == "meta":
        return _kept(torch.empty(tuple(shape), dtype=dtype, device="meta"))
    return _kept(torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32).to(dtype))
