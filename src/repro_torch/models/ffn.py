"""Feed-forward blocks: gated MLP and token-choice MoE.

The MoE dispatch is the relational view the paper takes of conditional
computation: routing is a token⋈expert join on the routed key, the combine
is the Σ. The layout is the reference's sort-by-expert + static capacity,
so every shape is static. Both halves run as dispatch sites of the ambient
session (``core.session.current()``): the dispatch is a ``gather_join`` of
token rows into expert slots, the combine a ``gather_join`` of expert
outputs into assignment rows and a ``segment_sum`` of those into token
order, on the CUDA kernels on the card. Each kernel's backward is the
other, so the layer's forward and backward sum in one fixed order: two
runs give the same bits, as the rest of the ``cuda`` tier does. The router
product and the expert products are plain ``torch.einsum``
(``common.einsum``), as the reference's are plain ``jnp``.

The reference's ``shard_experts`` hints place the expert buffers on a
mesh; they mean nothing on one device and raise until the multi-GPU slice
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import kernels, session
from repro_torch.relational import rel_linear

from .common import ParamTree, dense_init, einsum


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32) -> ParamTree:
    return ParamTree(
        wi_gate=dense_init(gen, (d_model, d_ff), dtype=dtype),
        wi_up=dense_init(gen, (d_model, d_ff), dtype=dtype),
        wo=dense_init(gen, (d_ff, d_model), dtype=dtype),
    )


def mlp_apply(p, x, activation=F.silu):
    """The gated MLP: ``activation(x·wi_gate) * (x·wi_up)``, then ``wo``
    (whisper passes ``common.gelu``)."""
    g = rel_linear(x, p["wi_gate"])
    u = rel_linear(x, p["wi_up"])
    return rel_linear(activation(g) * u, p["wo"])


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def moe_init(
    gen: torch.Generator,
    d_model: int,
    d_ff: int,
    n_experts: int,
    n_shared: int = 0,
    dtype=torch.float32,
) -> ParamTree:
    parts = {
        "router": dense_init(gen, (d_model, n_experts), dtype=torch.float32),
        "wi_gate": dense_init(gen, (n_experts, d_model, d_ff), in_axis=1, dtype=dtype),
        "wi_up": dense_init(gen, (n_experts, d_model, d_ff), in_axis=1, dtype=dtype),
        "wo": dense_init(gen, (n_experts, d_ff, d_model), in_axis=1, dtype=dtype),
    }
    if n_shared:
        parts["shared"] = mlp_init(gen, d_model, d_ff * n_shared, dtype=dtype)
    return ParamTree(**parts)


def _site(op: str, info: dict):
    """The implementation of ``op`` that the ambient session's dispatch
    table picks for a site with ``info``."""
    return kernels.resolve_impl(op, info, session.current().dispatch)


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (N, D) at ``rows`` (E,) int32, a zero row where
    the id is -1: a ``gather_join`` site. Differentiable in ``table``."""
    info = {"rows": rows.shape[0], "num_rows": table.shape[0], "dim": table.shape[1],
            "dtype": table.dtype}
    return _site("gather_join", info).fn(table.contiguous(), rows)


def segment_sum(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Σ of the rows of ``msg`` (E, D) by ``seg`` (E,) int32 into
    ``num_segments`` rows, in ascending row order: a ``segment_sum`` site.
    Differentiable in ``msg``."""
    info = {"nnz": msg.shape[0], "dim": msg.shape[1], "num_segments": num_segments,
            "dtype": msg.dtype}
    return _site("segment_sum", info).fn(msg.contiguous(), seg, num_segments)


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The experts of each token's ``k`` largest router probabilities, in
    descending order, ties to the lower expert (``lax.top_k``'s order;
    ``torch.topk`` states none)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def _dispatch_group(x, router, *, top_k, capacity, e):
    """Routing + dispatch for every token group (a batch row) at once:
    (B, T, D) → expert buffers (B, E, C, D).

    Per group, as the reference's ``_dispatch_group`` under ``vmap``: the
    router's top-k (``_top_k``), the assignments sorted stably by expert,
    each one's slot its rank within its expert, those at slot ≥ C dropped. A dropped assignment writes
    slot C−1 of its expert as the reference's scatter does, so an expert
    that overflows leaves slot C−1 empty (the reference on the CPU, whose
    scatter keeps the last write; its kept assignment there gets a zero
    row). Returns (xe, meta, aux), meta = (dest, st, sg, keep), each
    (B, T·k) in sorted order: the buffer slot, token, gate and keep flag
    of an assignment; aux the Switch-style load-balance loss per group."""
    b, t, d = x.shape
    logits = einsum("btd,de->bte", x.float(), router)          # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_idx = _top_k(probs, top_k)
    gate_vals = torch.gather(probs, -1, gate_idx)               # (B, T, k)

    # auxiliary load-balance loss (Switch-style)
    me = probs.mean(dim=1)                                       # (B, E)
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=1)
    aux = e * (me * ce).sum(dim=-1)                              # (B,)

    # Sort assignments by expert; position within expert = slot.
    flat_expert = gate_idx.reshape(b, -1)                        # (B, T·k)
    flat_token = torch.arange(t, device=x.device).repeat_interleave(top_k).expand(b, -1)
    flat_gate = gate_vals.reshape(b, -1)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    se = torch.gather(flat_expert, 1, order)
    st = torch.gather(flat_token, 1, order)
    sg = torch.gather(flat_gate, 1, order)
    counts = F.one_hot(se, e).sum(dim=1)                         # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts
    slot = torch.arange(se.shape[1], device=x.device) - torch.gather(starts, 1, se)
    keep = slot < capacity
    dest = se * capacity + torch.where(keep, slot, torch.full_like(slot, capacity - 1))

    # the slot each buffer row holds: the last assignment written there
    # (dest is ascending within a group)
    last = torch.ones_like(keep)
    last[:, :-1] = dest[:, 1:] != dest[:, :-1]
    group = torch.arange(b, device=x.device)[:, None]
    ids = torch.full((b, e * capacity), -1, dtype=torch.int32, device=x.device)
    src = torch.where(keep, group * t + st, torch.full_like(st, -1)).to(torch.int32)
    ids[group.expand_as(dest)[last], dest[last]] = src[last]
    xe = gather_rows(x.reshape(b * t, d), ids.reshape(-1))
    return xe.reshape(b, e, capacity, d), (dest, st, sg, keep), aux


def _combine_group(ye, meta, *, t, dtype):
    """Expert outputs (B, E·C, D) back to token order (B, T, D): each
    assignment's row of its slot times its gate (0 where dropped), summed
    into its token's row in sorted order, i.e. by ascending expert, the
    order of the reference's scatter-add."""
    dest, st, sg, keep = meta
    b, slots, d = ye.shape
    group = torch.arange(b, device=ye.device)[:, None]
    rows = torch.where(keep, group * slots + dest, torch.full_like(dest, -1))
    # the gate factor is f32 (softmax); the contributions stay in the
    # activation dtype, as the reference keeps them
    contrib = gather_rows(ye.reshape(b * slots, d), rows.reshape(-1).to(torch.int32))
    contrib = contrib * (sg * keep).reshape(-1, 1).to(ye.dtype)
    out = segment_sum(contrib.to(dtype), (group * t + st).reshape(-1).to(torch.int32), b * t)
    return out.reshape(b, t, d)


def moe_apply(
    p,
    x: torch.Tensor,               # (B, S, D)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    shard_experts: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with static per-group capacity
    ``max(int(capacity_factor·S·k/E), k)``.

    Groups = batch rows; tokens beyond an expert's capacity within their
    group are dropped (combine weight zero), later tokens first. Returns
    (out (B,S,D), aux: the load-balance loss, the mean over groups)."""
    if shard_experts:
        raise NotImplementedError(
            "moe_apply(shard_experts=True): expert-buffer placement on a mesh "
            "waits for multi-GPU planning (ROADMAP.md, queue 1, item 4)"
        )
    b, s, d = x.shape
    e = p["router"].shape[1]
    capacity = max(int(capacity_factor * s * top_k / e), top_k)

    xe, meta, aux = _dispatch_group(x, p["router"], top_k=top_k, capacity=capacity, e=e)
    aux = aux.mean()

    g = einsum("becd,edf->becf", xe, p["wi_gate"])
    u = einsum("becd,edf->becf", xe, p["wi_up"])
    ye = einsum("becf,efd->becd", F.silu(g) * u, p["wo"])
    ye = ye.reshape(b, e * capacity, d)

    out = _combine_group(ye, meta, t=s, dtype=x.dtype)

    if "shared" in p:
        out = out + mlp_apply(p["shared"], x).to(out.dtype)
    return out, aux
