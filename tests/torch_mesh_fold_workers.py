"""Rank programs of tests/test_torch_mesh_fold.py: each runs in a process of
a ``gloo`` group on the CPU (``repro_torch.launch.mesh.start_ranks``) and
imports no JAX.

``fold_checks`` commits a relation with both mesh axes on one of its dims
(a ``DTensor`` placed ``[Shard(0), Shard(0)]`` on the 2 × 2 mesh: its rows
cut over the ("data", "model") fold, rank (d, m) holding block 2·d + m) and
runs a step whose plan wants it otherwise, through the placed walk. It
returns the losses and gradients of the mesh step and of the mesh-less step
on the same data, the bytes the reshard counter booked, and what a
committed layout whose blocks are in the wrong order gives (the planted
fault: ``Shard(0)`` on the model axis outside the data axis, which is a
different layout of the same rows).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

import repro_torch
from repro_torch.launch.mesh import make_host_mesh

#: the SQL logistic regression of tests/torch_oocore_mesh_workers.py
ROWS, COLS = 64, 8
LOGREG_SQL = """
mm   := SELECT Rx.row, SUM(multiply(Rx.val, theta.val))
        FROM Rx, theta WHERE Rx.col = theta.col GROUP BY Rx.row;
pred := SELECT mm.row, logistic(mm.val) FROM mm;
SELECT SUM(xent(pred.val, Ry.val)) FROM pred, Ry WHERE pred.row = Ry.row
"""
WRT = ("theta", "Rx")


def logreg_data(n=ROWS, m=COLS, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    y = ((rng.uniform(size=n) > 0.5) * 0.98 + 0.01).astype(np.float32)
    theta = (rng.normal(size=m) * 0.1).astype(np.float32)
    return X, y, theta


def _leaves(out):
    loss, grads = out
    return {"loss": loss.data.detach().numpy().copy(),
            **{k: g.data.detach().numpy().copy() for k, g in sorted(grads.items())}}


def _session(mesh=None):
    X, y, theta = logreg_data()
    db = repro_torch.Database(device="cpu", mesh=mesh)
    db.put("Rx", torch.as_tensor(X), keys=("row", "col"))
    db.put("Ry", torch.as_tensor(y), keys=("row",))
    db.put("theta", torch.as_tensor(theta), keys=("col",))
    return db, X


def _folded(X, mesh, order):
    """Rx's rows cut over all four ranks: ``order`` "dm" puts rank (d, m)'s
    block at 2·d + m (the fold ("data", "model"), ``[Shard(0), Shard(0)]``),
    "md" at 2·m + d (what ``[Shard(0), Shard(0)]`` is not)."""
    from torch.distributed.tensor import DTensor, Shard

    d, m = (int(c) for c in mesh.get_coordinate())
    nd, nm = (int(s) for s in mesh.mesh.shape)
    block = d * nm + m if order == "dm" else m * nd + d
    per = ROWS // (nd * nm)
    local = torch.as_tensor(X).narrow(0, block * per, per).contiguous()
    return DTensor.from_local(local, mesh, [Shard(0), Shard(0)], run_check=False)


def fold_checks(rank: int):
    mesh = make_host_mesh(model=2, device_type="cpu")
    plain, _ = _session()
    want = _leaves(plain.sql(LOGREG_SQL, wrt=WRT).step())
    db, X = _session(mesh)
    h = db.sql(LOGREG_SQL, wrt=WRT)
    h.step()
    comp = h.last
    env = {n: db.get(n) for n in ("Rx", "Ry", "theta")}
    env["Rx"] = repro_torch.DenseRelation(_folded(X, mesh, "dm"), 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        before = comp.counters["reshard"]["bytes_moved"]
        got = _leaves(comp(env))
        moved = comp.counters["reshard"]["bytes_moved"] - before
        env["Rx"] = repro_torch.DenseRelation(_folded(X, mesh, "md"), 2)
        planted = _leaves(comp(env))
    return {"want": want, "got": got, "planted": planted, "moved": moved,
            "planned": tuple(comp.planned_spec("Rx") or ()), "rx_bytes": ROWS * COLS * 4}
