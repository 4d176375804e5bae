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
caller's ``Database.activate``. Under a session with a mesh
(``Database(mesh=...)``) the forward and both gradient queries run planned
and placed on the mesh — each rank on its shards, e.g. the edge relation's
nnz rows split over the data axes — and ``ctx`` keeps the forward's mesh
too, so the backward runs on the mesh its forward ran on. Gradients that
autograd does not ask for (e.g. of fixed edge weights) are skipped.

``partitioned_edges`` pre-sorts edges by dst (the owner partition): a
budgeted session (``Database(memory_budget=...)``) then cuts an edge
relation into waves at owner-run starts, so no Σ-by-dst segment straddles
two waves; with ``num_shards`` the data-axis size of a mesh, its padded rows
split evenly over the data ranks, each holding a run of whole dst owners.
``gcn_conv(..., owner_dim=1)`` tells the planner that its edges lie so:
the Σ-by-dst scatter is then priced as owner-local (``EDGE_CUT_LOCAL``, or
from the catalog's statistics of a relation of the same name, "Edge", put
with ``db.put``), which is what makes a mesh plan shard the edges' nnz
rows where the node features are the larger relation.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import fra, session
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.kernels import ADD, MUL
from repro_torch.core.keys import L, eq_pred, identity_key, jproj
from repro_torch.core.relation import CooRelation, DenseRelation, owner_partition


def partitioned_edges(
    edge_keys, edge_w, n_nodes: int, num_shards: int
) -> CooRelation:
    """Edge relation in the owner-partitioned nnz layout: rows sorted by
    dst (key column 1 — the Σ-by-dst segment key) and padded to a
    ``num_shards`` multiple (``num_shards=1`` pads nothing and needs no
    mesh). Returns the CooRelation to train with — its row order is the
    order edge-weight gradients come back in. Tensors stay on the device
    of ``edge_keys`` (numpy arrays become CPU tensors)."""
    rel = CooRelation(
        torch.as_tensor(edge_keys).to(torch.int32),
        torch.as_tensor(edge_w),
        (n_nodes, n_nodes),
    )
    return owner_partition(rel, num_shards, dim=1)


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
    def forward(ctx, h, edge_keys, edge_w, owner_dim):
        prog, _ = _gcn_prog()
        n = h.shape[0]
        env = {
            "Edge": CooRelation(edge_keys, edge_w, (n, n), owner_dim),
            "Node": DenseRelation(h, 1),
        }
        ctx.owner_dim = owner_dim
        ctx.save_for_backward(h, edge_keys, edge_w)
        ctx.db = session.current()
        ctx.mesh = ctx.db._step_mesh()
        return ctx.db.execute(prog.forward, env, mesh=ctx.mesh).data

    @staticmethod
    def backward(ctx, g):
        h, edge_keys, edge_w = ctx.saved_tensors
        prog, scans = _gcn_prog()
        n = h.shape[0]
        edge = CooRelation(edge_keys, edge_w, (n, n), ctx.owner_dim)
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
            dnode = db.execute(prog.grads["Node"], env, mesh=ctx.mesh).data
        if ctx.needs_input_grad[2]:
            dedge = db.execute(prog.grads["Edge"], env, mesh=ctx.mesh).values
        return dnode, None, dedge, None


def gcn_conv(
    h: torch.Tensor, edge_keys: torch.Tensor, edge_w: torch.Tensor, owner_dim=None
) -> torch.Tensor:
    """h: (N, D); edge_keys: (E, 2) int32 ⟨src, dst⟩; edge_w: (E,).
    ``owner_dim=1``: the edges are sorted by dst, as ``partitioned_edges``
    lays them out (module docstring)."""
    return _GcnConv.apply(h, edge_keys, edge_w, owner_dim)
