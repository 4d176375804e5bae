"""Non-negative matrix factorization (paper Appendix B, Fig. 2): the
workload of the reference's ``benchmarks/nnmf.py``.

A ≈ relu(W) · relu(H) under squared loss, SGD with η = 0.1/(n·d). The
relational path multiplies through ``rel_matmul_blocked`` over chunked
relations (256 × 256 blocks, the layout of Fig. 1), so the product is one
``blocked_matmul`` site and its gradient the RA-generated RJP queries; the
plain path is ``relu(W) @ relu(H)`` under PyTorch's autograd. The rank (32)
is padded with zeros to one block, as the reference pads it; relu keeps the
padding at zero and its gradient there is zero.

Run:  PYTHONPATH=src python -m repro_torch.examples.nnmf [--device cpu] [--n N] [--d D]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Tuple

import torch

import repro_torch
from repro_torch.optim import sgd_update
from repro_torch.relational import rel_matmul_blocked

BLOCK = 256
RANK = 32
STEPS = 5

Params = Dict[str, torch.Tensor]


def to_blocks(x: torch.Tensor) -> torch.Tensor:
    """(m, n) → (m/BLOCK, n/BLOCK, BLOCK, BLOCK), a view."""
    m, n = x.shape
    return x.reshape(m // BLOCK, BLOCK, n // BLOCK, BLOCK).permute(0, 2, 1, 3)


def make_problem(n: int, d: int, *, rank: int = RANK, seed: int = 0, device="cuda") -> Tuple[torch.Tensor, Params]:
    """A ~ U[0, 1) of (n, d), and W (n, BLOCK), H (BLOCK, d): U[0, 0.1) in
    the first ``rank`` columns / rows, zero padding after, drawn from a
    generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand(n, d, generator=gen, device=device)
    w0 = torch.rand(n, rank, generator=gen, device=device) * 0.1
    h0 = torch.rand(rank, d, generator=gen, device=device) * 0.1
    pad = BLOCK - rank  # the rank dim must tile; pad the factor matrices
    return a, {
        "w": torch.nn.functional.pad(w0, (0, pad)),
        "h": torch.nn.functional.pad(h0, (0, 0, 0, pad)),
    }


def ra_loss(params: Params, a: torch.Tensor) -> torch.Tensor:
    """0.5·Σ(rel_matmul_blocked(relu W, relu H) − A)², over blocks."""
    wb = to_blocks(torch.relu(params["w"]))
    hb = to_blocks(torch.relu(params["h"]))
    pred = rel_matmul_blocked(wb, hb)
    return 0.5 * torch.sum((pred - to_blocks(a)) ** 2)


def plain_loss(params: Params, a: torch.Tensor) -> torch.Tensor:
    """0.5·Σ(relu(W) @ relu(H) − A)²."""
    pred = torch.relu(params["w"]) @ torch.relu(params["h"])
    return 0.5 * torch.sum((pred - a) ** 2)


def make_step(loss_fn: Callable, a: torch.Tensor, lr: float):
    """One SGD step of ``loss_fn`` on A: ``step(params) -> (new params,
    loss, gradients)``."""

    def step(params: Params):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, a)
        loss.backward()
        grads = {k: v.grad for k, v in p.items()}
        new, _ = sgd_update(params, grads, {}, lr=lr)
        return new, loss.detach(), grads

    return step


def learning_rate(n: int, d: int) -> float:
    return 0.1 / (n * d)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--d", type=int, default=1024)
    args = ap.parse_args(argv)

    db = repro_torch.Database(device=args.device)
    a, params = make_problem(args.n, args.d, device=db.device)
    lr = learning_rate(args.n, args.d)
    for name, fn in (("relational", ra_loss), ("plain", plain_loss)):
        step = make_step(fn, a, lr)
        p = params
        with db.activate():
            for i in range(STEPS):
                t0 = time.perf_counter()
                p, loss, _ = step(p)
                loss = float(loss)  # waits for the device
                print(f"{name} step {i}: loss {loss:.6e}  {(time.perf_counter() - t0) * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
