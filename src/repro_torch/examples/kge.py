"""Knowledge-graph embedding: TransE-L2 and TransR (paper Appendix C,
Fig. 3), the workloads of the reference's ``benchmarks/kge.py``: a batch of
(head, relation, tail) triples with negative tails per positive, a margin
loss, SGD with η = 0.5. The relational path gathers the embeddings through
``rel_embed`` (a ``gather_join`` and a ``segment_sum`` site forward; the
RA-generated scatter-add backward), the plain path indexes ``table[ids]``.

The losses are the reference's, term for term, including TransE's
negative score, the square of the summed difference.

Run:  PYTHONPATH=src python -m repro_torch.examples.kge [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

import repro_torch
from repro_torch.optim import sgd_update
from repro_torch.relational import rel_embed

N_ENT = 20_000
N_REL = 200
BATCH = 1024
NEG = 200        # the paper's negatives per positive
LR = 0.5
DIMS = (50, 100)
STEPS = 5

Params = Dict[str, torch.Tensor]


def plain_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain path's lookup."""
    return table[ids]


def make_batch(rng: np.random.Generator, *, n_ent: int = N_ENT, n_rel: int = N_REL,
               batch: int = BATCH, neg: int = NEG, device="cuda"):
    """Uniform (h, r, t) ids and (batch, neg) negative tails, int32, drawn
    from numpy (the reference's ``_batch``: the same generator gives both
    packages the same batch)."""
    h = rng.integers(0, n_ent, batch)
    r = rng.integers(0, n_rel, batch)
    t = rng.integers(0, n_ent, batch)
    tneg = rng.integers(0, n_ent, (batch, neg))
    return tuple(torch.as_tensor(x.astype(np.int32), device=device) for x in (h, r, t, tneg))


def make_params(algo: str, dim: int, *, n_ent: int = N_ENT, n_rel: int = N_REL, seed: int = 0,
                device="cuda") -> Params:
    """Entity and relation tables (and TransR's per-relation projections),
    N(0, 0.05²), drawn from a generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "ent": torch.randn(n_ent, dim, generator=gen, device=device) * 0.05,
        "rel": torch.randn(n_rel, dim, generator=gen, device=device) * 0.05,
    }
    if algo == "transr":
        params["proj"] = torch.randn(n_rel, dim, dim, generator=gen, device=device) * 0.05
    return params


def transe_loss(embed_fn: Callable) -> Callable:
    def loss(params, h, r, t, tneg):
        eh = embed_fn(params["ent"], h)
        er = embed_fn(params["rel"], r)
        et = embed_fn(params["ent"], t)
        etn = embed_fn(params["ent"], tneg.reshape(-1)).reshape(*tneg.shape, -1)
        pos = torch.sum((eh + er - et) ** 2, dim=-1)
        neg = torch.sum((eh + er)[:, None, :] - etn, dim=-1) ** 2
        return torch.mean(torch.relu(1.0 + pos[:, None] - neg))

    return loss


def transr_loss(embed_fn: Callable) -> Callable:
    def loss(params, h, r, t, tneg):
        eh = embed_fn(params["ent"], h)
        er = embed_fn(params["rel"], r)
        et = embed_fn(params["ent"], t)
        mr = params["proj"][r]                      # (B, D, Dr)
        ph = torch.einsum("bd,bdr->br", eh, mr)
        pt = torch.einsum("bd,bdr->br", et, mr)
        etn = embed_fn(params["ent"], tneg.reshape(-1)).reshape(*tneg.shape, -1)
        ptn = torch.einsum("bnd,bdr->bnr", etn, mr)
        pos = torch.sum((ph + er - pt) ** 2, dim=-1)
        neg = torch.sum(((ph + er)[:, None, :] - ptn) ** 2, dim=-1)
        return torch.mean(torch.relu(1.0 + pos[:, None] - neg))

    return loss


LOSSES = {"transe": transe_loss, "transr": transr_loss}


def make_step(algo: str, embed_fn: Callable, lr: float = LR):
    """One SGD step: ``step(params, h, r, t, tneg) -> (new params, loss,
    gradients)``."""
    loss_fn = LOSSES[algo](embed_fn)

    def step(params: Params, *batch) -> Tuple[Params, torch.Tensor, Params]:
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, *batch)
        loss.backward()
        grads = {k: v.grad for k, v in p.items()}
        new, _ = sgd_update(params, grads, {}, lr=lr)
        return new, loss.detach(), grads

    return step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    db = repro_torch.Database(device=args.device)
    batch = make_batch(np.random.default_rng(0), device=db.device)
    for dim in DIMS:
        for algo in LOSSES:
            params0 = make_params(algo, dim, device=db.device)
            for name, embed_fn in (("relational", rel_embed), ("plain", plain_embed)):
                step = make_step(algo, embed_fn)
                p = params0
                with db.activate():
                    for i in range(STEPS):
                        t0 = time.perf_counter()
                        p, loss, _ = step(p, *batch)
                        loss = float(loss)  # waits for the device
                        print(f"{algo} d={dim} {name} step {i}: loss {loss:.6f}  "
                              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
