"""Relational matmul / linear layer with RA-generated backward.

The weight and activation are arity-0 relations whose single tuple holds
the full tensor as its chunk — the degenerate 1×1 blocking of Appendix A.
The forward query is the Σ⋈(MatMul) join-aggregate, which the chunked
compiler lowers to a ``blocked_matmul`` dispatch site — the CUDA kernel on
the card. Auto-diff produces the Fig.-4 gradient queries (dX = g·Wᵀ,
dW = Xᵀ·g); their RJP chunk kernels lower to ``torch.einsum``, as the
reference's lower to ``jnp.einsum``. The gradient really is the compiled
output of Algorithm 2.

``rel_matmul_blocked`` is the multi-block variant over explicit chunk
grids (the layout of the paper's Fig. 1, used by the NNMF workload): a
(BI, BK) × (BK, BJ) Σ∘⋈ whose block axes the compiler flattens into the
same single ``blocked_matmul`` site.

Both are ``torch.autograd.Function``s: the forward runs the forward query
and the backward runs ``prog.grads[...]``, both through the ambient
``Database`` session (``core.session.current()``), whose device and
dispatch table they use. The backward runs in the session that ran the
forward, kept on ``ctx``: autograd runs the backward of CUDA tensors on a
thread of its own, which does not see the caller's ``Database.activate``;
``ctx`` keeps the forward's mesh too, so under ``Database(mesh=...)`` the
backward's queries are planned and placed on the mesh the forward ran on.
Programs are built once and lowered once per shape signature.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import fra, remat, session
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.kernels import ADD, MATMUL
from repro_torch.core.keys import L, R, eq_pred, jproj, project_key
from repro_torch.core.relation import DenseRelation


@functools.cache
def _linear_prog():
    """Arity-0 relational matmul: one tuple per relation, chunk = matrix."""
    join = fra.Join(
        eq_pred(),          # keys are both ⟨⟩: trivial match
        jproj(),
        MATMUL,
        fra.scan("X", 0),
        fra.scan("W", 0),
    )
    q = fra.Query(join, inputs=("X", "W"))
    prog = ra_autodiff(q)
    # Resolve the __fwd refs the gradient queries consume: for the optimized
    # matmul RJP these are exactly the forward operands themselves.
    scans = {s.name: s.id for s in q.root.table_scans()}
    return prog, scans


@functools.cache
def _blocked_prog():
    """Multi-block relational matmul over a (BI, BK) × (BK, BJ) grid."""
    join = fra.Join(
        eq_pred((1, 0)),
        jproj(L(0), L(1), R(1)),
        MATMUL,
        fra.scan("X", 2),
        fra.scan("W", 2),
    )
    q = fra.Query(fra.Agg(project_key(0, 2), ADD, join), inputs=("X", "W"))
    prog = ra_autodiff(q)
    scans = {s.name: s.id for s in q.root.table_scans()}
    return prog, scans


def _matmul_function(name: str, prog_fn, arity: int):
    """The ``torch.autograd.Function`` class ``name`` of a relational
    matmul program (``_linear_prog`` or ``_blocked_prog``) over relations of
    key arity ``arity``: the forward query forward, the RJP queries
    backward."""

    def forward(ctx, x, w):
        prog, _ = prog_fn()
        env = {"X": DenseRelation(x, arity), "W": DenseRelation(w, arity)}
        ctx.save_for_backward(x, w)
        ctx.db = session.current()
        ctx.mesh = ctx.db._step_mesh()
        # kept for, or handed back at, the recompute of remat "dots"
        return remat.product(lambda: ctx.db.execute(prog.forward, env, mesh=ctx.mesh).data,
                             (name, tuple(x.shape), tuple(w.shape)))

    def backward(ctx, g):
        x, w = ctx.saved_tensors
        prog, scans = prog_fn()
        env = {"X": DenseRelation(x, arity), "W": DenseRelation(w, arity)}
        # the __fwd refs the gradient queries consume: for the optimized
        # matmul RJP these are the forward operands themselves
        env.update({f"__fwd_{scans[n]}": env[n] for n in ("X", "W")})
        env["__seed"] = DenseRelation(g.contiguous(), arity)
        db = ctx.db
        out = []
        for n, needed in zip(("X", "W"), ctx.needs_input_grad):
            out.append(db.execute(prog.grads[n], env, mesh=ctx.mesh).data if needed else None)
        return tuple(out)

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(forward), "backward": staticmethod(backward)})


_RelMatmul = _matmul_function("_RelMatmul", _linear_prog, 0)
_RelMatmulBlocked = _matmul_function("_RelMatmulBlocked", _blocked_prog, 2)


def rel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) through the relational engine (arity-0 blocking)."""
    return _RelMatmul.apply(x, w)


def rel_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Linear layer over arbitrary leading batch dims: (..., k) @ (k, n)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    y = rel_matmul(x.reshape(-1, k), w)
    return y.reshape(*lead, w.shape[-1])


def rel_matmul_blocked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Blocked matmul over explicit chunk grids.

    x: (BI, BK, bm, bk), w: (BK, BJ, bk, bn) → (BI, BJ, bm, bn).
    This is the layout the paper's distributed engine stores (Fig. 1); the
    forward contracts both the block axis and the within-chunk axis in one
    ``blocked_matmul`` site.
    """
    return _RelMatmulBlocked.apply(x, w)
