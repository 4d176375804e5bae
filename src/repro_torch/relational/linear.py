"""Relational matmul / linear layer with RA-generated backward.

The weight and activation are arity-0 relations whose single tuple holds
the full tensor as its chunk — the degenerate 1×1 blocking of Appendix A.
The forward query is the Σ⋈(MatMul) join-aggregate, which the chunked
compiler lowers to a ``blocked_matmul`` dispatch site — the CUDA kernel on
the card. Auto-diff produces the Fig.-4 gradient queries (dX = g·Wᵀ,
dW = Xᵀ·g); their RJP chunk kernels lower to ``torch.einsum``, as the
reference's lower to ``jnp.einsum``. The gradient really is the compiled
output of Algorithm 2.

``rel_matmul`` is a ``torch.autograd.Function``: its forward runs the
forward query and its backward runs ``prog.grads[...]``, both through the
ambient ``Database`` session (``core.session.current()``), whose device and
dispatch table they use. The backward runs in the session that ran the
forward, kept on ``ctx``: autograd runs the backward of CUDA tensors on a
thread of its own, which does not see the caller's ``Database.activate``.
Programs are built once and lowered once per shape signature.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import fra, session
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.kernels import MATMUL
from repro_torch.core.keys import eq_pred, jproj
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


class _RelMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        prog, _ = _linear_prog()
        env = {"X": DenseRelation(x, 0), "W": DenseRelation(w, 0)}
        ctx.save_for_backward(x, w)
        ctx.db = session.current()
        return ctx.db.execute(prog.forward, env).data

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        prog, scans = _linear_prog()
        env = {"X": DenseRelation(x, 0), "W": DenseRelation(w, 0)}
        env.update({f"__fwd_{scans[n]}": env[n] for n in ("X", "W")})
        env["__seed"] = DenseRelation(g.contiguous(), 0)
        db = ctx.db
        out = []
        for name, needed in zip(("X", "W"), ctx.needs_input_grad):
            out.append(db.execute(prog.grads[name], env).data if needed else None)
        return tuple(out)


def rel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) through the relational engine (arity-0 blocking)."""
    return _RelMatmul.apply(x, w)


def rel_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Linear layer over arbitrary leading batch dims: (..., k) @ (k, n)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    y = rel_matmul(x.reshape(-1, k), w)
    return y.reshape(*lead, w.shape[-1])
