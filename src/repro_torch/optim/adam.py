"""Adam/AdamW — paper §6 uses Adam for the GCN experiments. The same update
as the reference's ``optim/adam.py``, on a dict of tensors."""

from __future__ import annotations

from typing import Dict, Tuple

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
) -> Tuple[Params, Dict[str, object]]:
    """One Adam step; returns new parameters and state (nothing is updated
    in place)."""
    step = state["step"] + 1

    if grad_clip:
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float()
        m1 = b1 * state["mu"][k].float() + (1 - b1) * gf
        v1 = b2 * state["nu"][k].float() + (1 - b2) * gf * gf
        mh = m1 / (1 - b1 ** step)
        vh = v1 / (1 - b2 ** step)
        delta = mh / (torch.sqrt(vh) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k] = m1.to(state["mu"][k].dtype)
        new_v[k] = v1.to(state["nu"][k].dtype)
    return new_p, {"mu": new_m, "nu": new_v, "step": step}
