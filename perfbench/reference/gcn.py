"""The plain reference of the GCN cells, in plain PyTorch.

It imports nothing of the program under test: it works out for itself
whatever the program derives (the edge order by destination, the
gradients, Adam's update). Aggregations are ``index_add_`` over edge
chunks, products are ``torch.matmul`` with TF32 off, the backward and
Adam are written out.

``Precision("f64")`` is the oracle. ``Precision("tf32")`` is the control:
f32 storage whose every product takes its multiplicands rounded to TF32
(10 explicit mantissa bits, to nearest, ties away: what a TF32 tensor-core
product reads), the step below f32 that would tempt a later change.
``Precision("tf32-tc")`` is that step as the card takes it: f32 whose
matrix products run on the tensor cores with TF32 on (the elementwise
products stay f32).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

#: edges per chunk of an aggregation (4.3 GB of f64 temporaries at D = 256)
CHUNK = 1 << 21


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to TF32's 10 explicit mantissa bits, to nearest
    with ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("f64", "tf32", "tf32-tc"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A multiplicand as this precision's elementwise products read it."""
        t = t.to(self.dtype)
        return round_tf32(t) if self.name == "tf32" else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32-tc":
            with tf32(True):
                return a.to(self.dtype) @ b.to(self.dtype)
        with tf32(False):
            return self.q(a) @ self.q(b)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for the matrix products inside (restored after)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def aggregate(prec: Precision, h, out_idx, in_idx, w, n_out: int, chunk: int = CHUNK):
    """out[o] = sum over edges e with out_idx[e] = o of w[e] * h[in_idx[e]]."""
    out = torch.zeros(n_out, h.shape[1], dtype=prec.dtype, device=h.device)
    for e0 in range(0, w.shape[0], chunk):
        sl = slice(e0, e0 + chunk)
        out.index_add_(0, out_idx[sl], prec.q(w[sl])[:, None] * prec.q(h[in_idx[sl]]))
    return out


def train_steps(x, keys, w, y, params0: Dict[str, torch.Tensor], *, steps: int, lr: float,
                b1: float, b2: float, eps: float, prec: Precision,
                moments: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                done: int = 0) -> Dict[str, object]:
    """``steps`` full-batch Adam steps of the two-layer GCN

        h0 = A x;  z1 = h0 W1;  h1 = A relu(z1);  z2 = h1 W2
        loss = mean over nodes of -log softmax(z2)[y]

    with (A h)[dst] = sum of w * h[src] over the edges into dst, from the
    parameters ``params0`` and, where given, Adam's ``moments`` (``mu``,
    ``nu``) after ``done`` steps (else zero moments and no step done).
    Returns each step's loss, the first step's gradient by leaf, and each
    leaf's change after the steps."""
    dt = prec.dtype
    src, dst = keys[:, 0].long(), keys[:, 1].long()
    n = x.shape[0]
    h0 = aggregate(prec, x.to(dt), dst, src, w, n)
    params = {k: v.to(dt).clone() for k, v in params0.items()}
    if moments is None:
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
    else:
        mu = {k: v.to(dt).clone() for k, v in moments["mu"].items()}
        nu = {k: v.to(dt).clone() for k, v in moments["nu"].items()}
    onehot = torch.nn.functional.one_hot(y.long(), params["w2"].shape[1]).to(dt)
    losses: List[float] = []
    grad1 = None
    for t in range(done + 1, done + steps + 1):
        z1 = prec.mm(h0, params["w1"])
        a1 = torch.relu(z1)
        h1 = aggregate(prec, a1, dst, src, w, n)
        z2 = prec.mm(h1, params["w2"])
        logp = torch.log_softmax(z2, dim=1)
        losses.append(float(-(logp * onehot).sum() / n))
        dz2 = (torch.exp(logp) - onehot) / n
        dw2 = prec.mm(h1.t(), dz2)
        dh1 = prec.mm(dz2, params["w2"].t())
        da1 = aggregate(prec, dh1, src, dst, w, n)
        dz1 = da1 * (z1 > 0)
        dw1 = prec.mm(h0.t(), dz1)
        grads = {"w1": dw1, "w2": dw2}
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        for k, g in grads.items():
            mu[k] = b1 * mu[k] + (1 - b1) * g
            nu[k] = b2 * nu[k] + (1 - b2) * g * g
            mh = mu[k] / (1 - b1 ** t)
            vh = nu[k] / (1 - b2 ** t)
            params[k] = params[k] - lr * mh / (torch.sqrt(vh) + eps)
    change = {k: params[k] - params0[k].to(dt) for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}


def dst_order(keys) -> torch.Tensor:
    """The edges' order by destination, ties in edge order."""
    return torch.sort(keys[:, 1], stable=True).indices


def query_step(keys, w, x, prec: Precision, chunk: int = CHUNK) -> Dict[str, object]:
    """The GCN layer's gradient query: conv = A x (sum of w * x[src] by
    dst), loss = (sum of conv^2) / n; its loss, dNode = A^T dconv with
    dconv = 2 conv / n, and dEdge[e] = <x[src_e], dconv[dst_e]>, with
    dEdge in the edges' order by destination."""
    n = x.shape[0]
    src, dst = keys[:, 0].long(), keys[:, 1].long()
    conv = aggregate(prec, x, dst, src, w, n, chunk)
    loss = 0.0
    for r0 in range(0, n, chunk // 8):
        c = prec.q(conv[r0:r0 + chunk // 8])
        loss += float((c * c).sum())
    loss /= n
    dconv = conv.mul_(2.0 / n)
    del conv
    dnode = aggregate(prec, dconv, src, dst, w, n, chunk)
    order = dst_order(keys)
    dedge = torch.empty(order.shape[0], dtype=prec.dtype, device=x.device)
    for e0 in range(0, order.shape[0], chunk):
        o = order[e0:e0 + chunk]
        dedge[e0:e0 + o.shape[0]] = (prec.q(x[src[o]]) * prec.q(dconv[dst[o]])).sum(1)
    return {"loss": loss, "dnode": dnode, "dedge": dedge}
