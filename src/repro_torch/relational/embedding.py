"""Embedding lookup as a relational join (gather ≡ key-equality join).

The token stream is a COO relation keyed ⟨position, token-id⟩ with value 1
(the relational one-hot); joining it with the embedding table on
token-id == table-key and aggregating by position is the gather. The
compiler lowers the join to a ``gather_join`` site and the Σ by position to
a ``segment_sum`` site — the CUDA kernels on the card. The RA-generated
backward is the mirrored join: scatter-add of output cotangents into table
rows — the classic embedding gradient, derived by Algorithm 2 rather than
written by hand.

``rel_embed`` is a ``torch.autograd.Function``: both directions step
through the ambient ``Database`` session (``core.session.current()``),
lowered once per (batch, vocab, dim) signature. The backward runs in the
session that ran the forward, kept on ``ctx``, as in ``relational/linear.py``:
autograd runs the backward of CUDA tensors on a thread of its own, which
does not see the caller's ``Database.activate``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import fra, session
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.kernels import ADD, MUL
from repro_torch.core.keys import L, eq_pred, jproj, project_key
from repro_torch.core.relation import CooRelation, DenseRelation


@functools.cache
def _embed_prog():
    join = fra.Join(
        eq_pred((1, 0)),        # ids.token == table.row
        jproj(L(0)),            # keyed by position
        MUL,                    # 1.0 × table row
        fra.const("Ids", 2),
        fra.scan("Table", 1),
    )
    q = fra.Query(fra.Agg(project_key(0), ADD, join), inputs=("Table",))
    prog = ra_autodiff(q)
    scans = {s.name: s.id for s in q.root.table_scans()}
    consts = {c.ref: c.id for c in q.root.topo() if isinstance(c, fra.Const)}
    return prog, scans, consts


def _ids_relation(table: torch.Tensor, ids: torch.Tensor) -> CooRelation:
    """The token stream as the COO relation ⟨position, token-id⟩ ↦ 1."""
    b = ids.shape[0]
    pos = torch.arange(b, dtype=torch.int32, device=ids.device)
    keys = torch.stack([pos, ids.to(torch.int32)], dim=1)
    ones = torch.ones((b,), dtype=table.dtype, device=table.device)
    return CooRelation(keys, ones, (b, table.shape[0]))


class _RelEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        prog, _, _ = _embed_prog()
        env = {"Ids": _ids_relation(table, ids), "Table": DenseRelation(table, 1)}
        ctx.save_for_backward(table, ids)
        ctx.db = session.current()
        return ctx.db.execute(prog.forward, env).data

    @staticmethod
    def backward(ctx, g):
        table, ids = ctx.saved_tensors
        prog, scans, consts = _embed_prog()
        idrel = _ids_relation(table, ids)
        trel = DenseRelation(table, 1)
        env = {
            "Ids": idrel,
            "Table": trel,
            f"__fwd_{scans['Table']}": trel,
            f"__fwd_{consts['Ids']}": idrel,
            "__seed": DenseRelation(g.contiguous(), 1),
        }
        return ctx.db.execute(prog.grads["Table"], env).data, None


def rel_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (V, D); ids: (B,) integer → (B, D). Differentiable with
    respect to the table."""
    return _RelEmbed.apply(table, ids)
