"""Graph convolution as a relational join-aggregate (paper §1, §6).

  h'_dst = Σ_{(src,dst,w) ∈ Edge} w · h_src

Forward: Edge ⋈ Node (gather) + Σ-by-dst (segment sum). Backward — both
∂/∂h (the reversed-edge convolution) and ∂/∂w (per-edge h·g dot) — is the
RA-autodiff-generated query, compiled to gather + segment sum; on the card
both run on the CUDA kernels (kernels/gather, kernels/segsum).

``gcn_conv`` is a ``torch.autograd.Function`` stepping through the ambient
``Database`` session (``core.session.current()``): the program is built
once and lowered once per (graph size, feature dim) signature. The backward
runs in the session that ran the forward, kept on ``ctx``: autograd runs
the backward of CUDA tensors on a thread of its own, which does not see the
caller's ``Database.activate``. Gradients that autograd does not ask for
(e.g. of fixed edge weights) are skipped.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import fra, session
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.kernels import ADD, MUL
from repro_torch.core.keys import L, eq_pred, identity_key, jproj
from repro_torch.core.relation import CooRelation, DenseRelation


@functools.cache
def _gcn_prog():
    join = fra.Join(
        eq_pred((0, 0)),        # edge.src == node.id
        jproj(L(1)),            # output keyed by dst
        MUL,                    # w · h_src (scalar × chunk)
        fra.scan("Edge", 2),    # differentiable edge weights
        fra.scan("Node", 1),
    )
    q = fra.Query(fra.Agg(identity_key(1), ADD, join), inputs=("Edge", "Node"))
    prog = ra_autodiff(q)
    scans = {s.name: s.id for s in q.root.table_scans()}
    return prog, scans


class _GcnConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, edge_keys, edge_w):
        prog, _ = _gcn_prog()
        n = h.shape[0]
        env = {
            "Edge": CooRelation(edge_keys, edge_w, (n, n)),
            "Node": DenseRelation(h, 1),
        }
        ctx.save_for_backward(h, edge_keys, edge_w)
        ctx.db = session.current()
        return ctx.db.execute(prog.forward, env).data

    @staticmethod
    def backward(ctx, g):
        h, edge_keys, edge_w = ctx.saved_tensors
        prog, scans = _gcn_prog()
        n = h.shape[0]
        edge = CooRelation(edge_keys, edge_w, (n, n))
        node = DenseRelation(h, 1)
        env = {
            "Edge": edge,
            "Node": node,
            f"__fwd_{scans['Edge']}": edge,
            f"__fwd_{scans['Node']}": node,
            "__seed": DenseRelation(g.contiguous(), 1),
        }
        db = ctx.db
        dnode = dedge = None
        if ctx.needs_input_grad[0]:
            dnode = db.execute(prog.grads["Node"], env).data
        if ctx.needs_input_grad[2]:
            dedge = db.execute(prog.grads["Edge"], env).values
        return dnode, None, dedge


def gcn_conv(h: torch.Tensor, edge_keys: torch.Tensor, edge_w: torch.Tensor) -> torch.Tensor:
    """h: (N, D); edge_keys: (E, 2) int32 ⟨src, dst⟩; edge_w: (E,)."""
    return _GcnConv.apply(h, edge_keys, edge_w)
