"""Adam/AdamW — paper §6 uses Adam for the GCN experiments. The same update
as the reference's ``optim/adam.py``, on a dict of tensors."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def adam_init(params: Params, dtype=torch.float32) -> Dict[str, object]:
    return {
        "mu": {k: torch.zeros(p.shape, dtype=dtype, device=p.device) for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=dtype, device=p.device) for k, p in params.items()},
        "step": 0,
    }


#: the elements of a leaf the update computes at once
_PIECE = 1 << 24


def _update(p, g, mu, nu, *, lr, b1, b2, eps, weight_decay, bc1, bc2, scale):
    """The new (parameter, first moment, second moment) of a leaf or a
    piece of one, in f32."""
    if scale is not None:
        g = g * scale.to(g.dtype)
    gf = g.float()
    m1 = b1 * mu.float() + (1 - b1) * gf
    v1 = b2 * nu.float() + (1 - b2) * gf * gf
    mh = m1 / bc1
    vh = v1 / bc2
    delta = mh / (torch.sqrt(vh) + eps)
    if weight_decay:
        delta = delta + weight_decay * p.float()
    return p.float() - lr * delta, m1, v1


@torch.no_grad()
def adam_update(
    params: Params,
    grads: Params,
    state: Dict[str, object],
    *,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
    donate: bool = False,
    grad_norm: Optional[Callable[[Params], torch.Tensor]] = None,
) -> Tuple[Params, Dict[str, object]]:
    """One Adam step; returns the new parameters and state.

    ``donate=False`` updates nothing in place. ``donate=True`` writes the
    new parameters and moments into the tensors of ``params`` and
    ``state`` (the reference's donated buffers) and returns those dicts:
    each parameter's new values are computed as without donation, then
    copied in, so the two give the same bits, and the peak holds one
    parameter's temporaries rather than a second copy of the whole
    state — one piece's, for a leaf of more than ``_PIECE`` elements (the
    update is elementwise: the pieces' values are the leaf's). ``grad_norm`` computes the global 2-norm that ``grad_clip``
    clips to (default: over ``grads``, which then hold the whole
    gradient); on a mesh, where each rank holds shards,
    ``Placement.grad_norm``. The update itself is elementwise, so on a
    mesh it runs on the rank's shards."""
    step = state["step"] + 1
    # the bias corrections in f32, as the reference computes them from its
    # int32 step counter (in f64, 1 - 0.999 differs from f32's by 1.3e-5)
    one = torch.ones((), dtype=torch.float32)
    bc1, bc2 = float(one - (one * b1) ** step), float(one - (one * b2) ** step)

    scale = None
    if grad_clip:
        if grad_norm is not None:
            gnorm = grad_norm(grads)
        else:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)

    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, bc1=bc1, bc2=bc2, scale=scale)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g, mu, nu = grads[k], state["mu"][k], state["nu"][k]
        n = p.numel()
        if n <= _PIECE or not all(t.is_contiguous() for t in (p, g, mu, nu)):
            new = _update(p, g, mu, nu, **kw)
            for out, old, val in zip((new_p, new_m, new_v), (p, mu, nu), new):
                out[k] = old.copy_(val) if donate else val.to(old.dtype)
            continue
        # a large leaf in pieces: the update is elementwise, so each piece's
        # values are the whole leaf's, and the temporaries are a piece's
        dst = (p, mu, nu) if donate else tuple(torch.empty_like(t) for t in (p, mu, nu))
        for i in range(0, n, _PIECE):
            def cut(t):
                return t.view(-1)[i:i + _PIECE]

            for d, val in zip(dst, _update(cut(p), cut(g), cut(mu), cut(nu), **kw)):
                cut(d).copy_(val)
        new_p[k], new_m[k], new_v[k] = dst
    if donate:
        state["step"] = step
        return params, state
    return new_p, {"mu": new_m, "nu": new_v, "step": step}
