"""SGD (paper Appendix B/C use SGD with η=0.1 / 0.5). The same update as
the reference's ``optim/sgd.py``, on a dict of tensors: the step in f32,
the result in the parameter's dtype."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def sgd_init(params: Params, momentum: float = 0.0, dtype=torch.float32) -> Dict[str, Params]:
    if momentum:
        return {"mom": {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
                        for k, p in params.items()}}
    return {}


@torch.no_grad()
def sgd_update(
    params: Params,
    grads: Params,
    state: Dict[str, Params],
    *,
    lr: float = 0.1,
    momentum: float = 0.0,
) -> Tuple[Params, Dict[str, Params]]:
    """One SGD step; returns new parameters and state (nothing is updated
    in place)."""
    if momentum:
        new_mom = {k: momentum * m + grads[k].to(m.dtype) for k, m in state["mom"].items()}
        new_p = {k: (p.float() - lr * new_mom[k].float()).to(p.dtype) for k, p in params.items()}
        return new_p, {"mom": new_mom}
    new_p = {k: (p.float() - lr * grads[k].float()).to(p.dtype) for k, p in params.items()}
    return new_p, state
