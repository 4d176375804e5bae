"""Quickstart: the paper's §2.3 running example, end to end — "simply load
the data into relational tables, auto-diff the SQL, and begin training".

Everything goes through the one front door, ``repro_torch.Database``: load
the relations into the catalog (``db.put`` — schemas + tracked key-domain
statistics), compile the logistic-regression SQL against the catalog
(``db.sql``), check and explain it, and train on the handle's compiled
gradient step (``handle.step()`` — RA-autodiff + the staged engine
underneath). Prints the forward query plan, the generated gradient plan,
the kernel dispatch decisions and the training curve.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import torch

import repro_torch
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.sql import compile_sql

LOGREG_SQL = """
mm   := SELECT Rx.row, SUM(multiply(Rx.val, theta.val))
        FROM Rx, theta WHERE Rx.col = theta.col GROUP BY Rx.row;
pred := SELECT mm.row, logistic(mm.val) FROM mm;
SELECT SUM(xent(pred.val, Ry.val)) FROM pred, Ry WHERE pred.row = Ry.row
"""

SCHEMA = {"Rx": ("row", "col"), "theta": ("col",), "Ry": ("row",)}


def logreg_query():
    """F_Loss from paper §2.3, compiled from SQL (F_MatMul, F_Predict,
    F_Loss as stacked views) — standalone, for callers without a session."""
    return compile_sql(LOGREG_SQL, schema=SCHEMA, inputs=("theta",))


def make_data(n: int, m: int, *, seed: int = 0, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic separable data: X (n, m) normal, y = [X·w > 0] for a
    random w, drawn from a generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, m, generator=gen, device=device)
    w = torch.randn(m, generator=gen, device=device)
    return X, (X @ w > 0).float()


def load(db, X: torch.Tensor, y: torch.Tensor) -> None:
    """The catalog of the example: Rx (row, col), Ry (row) and a zero
    theta (col)."""
    db.put("Rx", X, keys=("row", "col"))
    db.put("Ry", y, keys=("row",))
    db.put("theta", torch.zeros(X.shape[1], dtype=X.dtype, device=X.device), keys=("col",))


def train(db, handle, steps: int, log=None) -> Tuple[List[float], torch.Tensor]:
    """``steps`` gradient steps of size 1/n on theta (the loss sums over
    the n rows of Rx), each through ``handle.step()``. Returns the loss of
    each step and the last theta; ``log(step, loss)`` is called after each
    step when given."""
    n = db.get("Rx").data.shape[0]
    losses: List[float] = []
    theta = db.get("theta").data
    for i in range(steps):
        loss, grads = handle.step()
        theta = db.get("theta").data - (1.0 / n) * grads["theta"].data
        db.put("theta", theta)   # refreshes the catalog entry + stats
        losses.append(float(loss.data))
        if log is not None:
            log(i, losses[-1])
    return losses, theta


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    steps = 50

    print("=== SQL input ===")
    print(LOGREG_SQL.strip())

    n, m = 4096, 64
    db = repro_torch.Database(device=args.device)
    X, y = make_data(n, m, device=db.device)

    def log(i, loss):
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}   loss {loss / n:.4f}")

    # The session: a catalog of named relations with schemas and tracked
    # key-domain statistics, refreshed on every put.
    load(db, X, y)
    print("\n=== catalog ===")
    for name in ("Rx", "Ry", "theta"):
        print(f"{name}: keys={db.schema(name)}  {db.stats(name)}")
    handle = db.sql(LOGREG_SQL, wrt=("theta",))
    print("\n=== compiled forward query (F_Loss, paper §2.3) ===")
    print(handle.query.pretty())
    print("\n=== RA-autodiff-generated gradient query (∂Q/∂theta) ===")
    print(ra_autodiff(handle.query).grads["theta"].pretty())
    report = handle.check()
    print(f"\n=== db.check: {len(report.errors)} error(s) ===")
    print(report.render() if report.diagnostics else "(no diagnostics)")
    print("\n=== db.explain ===")
    print(db.explain(handle.query))

    print("\n=== training (gradient = compiled gradient query) ===")
    lowered_before = handle.lower_count  # explain lowers the forward query once
    _, theta = train(db, handle, steps, log)

    # Kernel dispatch: each hot op was resolved against the registry at
    # lowering time — the CUDA kernels on the card, the torch lowering on
    # the CPU.
    print("\n=== kernel dispatch ===")
    for site, tier in sorted(handle.resolutions.items()):
        print(f"{site}  ->  {tier}")
    acc = float(((X @ theta > 0).float() == y).float().mean())
    print(f"\ntrain accuracy: {acc:.3f}")
    print(f"graph lowerings over {steps} steps: {handle.lower_count - lowered_before}")
    if not acc > 0.9:
        raise SystemExit(f"train accuracy {acc:.3f} is not above 0.9")


if __name__ == "__main__":
    main()
