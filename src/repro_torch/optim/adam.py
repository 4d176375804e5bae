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
    state. ``grad_norm`` computes the global 2-norm that ``grad_clip``
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

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.float()
        m1 = b1 * state["mu"][k].float() + (1 - b1) * gf
        v1 = b2 * state["nu"][k].float() + (1 - b2) * gf * gf
        mh = m1 / bc1
        vh = v1 / bc2
        delta = mh / (torch.sqrt(vh) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        for out, old, new in ((new_p, p, p.float() - lr * delta),
                              (new_m, state["mu"][k], m1), (new_v, state["nu"][k], v1)):
            out[k] = old.copy_(new) if donate else new.to(old.dtype)
        del g, gf, m1, v1, mh, vh, delta
    if donate:
        state["step"] = step
        return params, state
    return new_p, {"mu": new_m, "nu": new_v, "step": step}
