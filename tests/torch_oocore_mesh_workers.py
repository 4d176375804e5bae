"""Rank programs of tests/test_torch_oocore_mesh.py: each runs in a process
of a ``gloo`` group on the CPU (``repro_torch.launch.mesh.start_ranks``) and
imports no JAX. ``run_checks`` runs every check of the 4-rank module in one
start, ``one_rank`` the one-rank mesh against the mesh-less budgeted step;
both return plain numbers, tuples and numpy arrays, which the test module
holds to the reference.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

import repro_torch
from repro_torch.core import fra
from repro_torch.core.engine import ReshardWarning, StreamedCompiled
from repro_torch.core.kernels import ADD, MUL, SQUARE, SUM_CHUNK, scale_kernel
from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj
from repro_torch.core.planner import _rel_bytes
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.relational import partitioned_edges

#: the reference's acceptance gate (tests/test_oocore.py), its edges
#: owner-partitioned and padded to a multiple of SHARDS rows
N, E, D, SHARDS = 200, 4000, 16, 8
#: the SQL logistic regression (tests/test_oocore.py's), Rx streamed with Ry
ROWS, COLS = 64, 8
LOGREG_SQL = """
mm   := SELECT Rx.row, SUM(multiply(Rx.val, theta.val))
        FROM Rx, theta WHERE Rx.col = theta.col GROUP BY Rx.row;
pred := SELECT mm.row, logistic(mm.val) FROM mm;
SELECT SUM(xent(pred.val, Ry.val)) FROM pred, Ry WHERE pred.row = Ry.row
"""
#: the host meshes of the checks, by model-axis size: 4 × 1 and 2 × 2
MODELS = (1, 2)


def gcn_data(n=N, e=E, d=D, seed=1):
    """The gate's graph and node features from ``seed``, in numpy (int32
    keys, float32 weights and features)."""
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return keys, w, x


def logreg_data(n=ROWS, m=COLS, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    y = ((rng.uniform(size=n) > 0.5) * 0.98 + 0.01).astype(np.float32)
    theta = (rng.normal(size=m) * 0.1).astype(np.float32)
    return X, y, theta


def gcn_query(n: int) -> fra.Query:
    """tests/test_oocore.py's GCN query: mean over nodes of Σ_d conv²,
    differentiable in the edge weights and the node features."""
    conv = fra.Agg(identity_key(1), ADD, fra.Join(
        eq_pred((0, 0)), jproj(L(1)), MUL, fra.scan("Edge", 2), fra.scan("Node", 1)))
    sq = fra.Select(TRUE, identity_key(1), SQUARE, conv)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Select(TRUE, identity_key(1), SUM_CHUNK, sq))
    mean = fra.Select(TRUE, identity_key(0), scale_kernel(1.0 / n), loss)
    return fra.Query(mean, inputs=("Edge", "Node"))


def gcn_fill(db):
    keys, w, x = gcn_data()
    db.put("Edge", partitioned_edges(keys, w, N, SHARDS))
    db.put("Node", torch.as_tensor(x), keys=("node",))
    return db


def gcn_budget() -> float:
    """Node bytes + edge bytes / 4: the edge relation is ≥ 4× its
    headroom, as in the reference's gate."""
    db = gcn_fill(repro_torch.Database(device="cpu"))
    return _rel_bytes(db.get("Node")) + _rel_bytes(db.get("Edge")) / 4


def plan_tuple(plan):
    return (plan.stream, plan.co_streams, plan.num_waves, plan.boundaries,
            plan.axis_of, plan.owner_aligned, plan.budget)


def leaves(out, grads):
    """(name, array) of a step's loss and gradients, COO keys included."""
    got = [("loss", out.data.numpy().copy())]
    for name in sorted(grads):
        g = grads[name]
        if hasattr(g, "values"):
            got += [(name + ".keys", g.keys.numpy().copy()), (name + ".values", g.values.numpy().copy())]
        else:
            got.append((name, g.data.numpy().copy()))
    return got


def gcn_step(db):
    """One budgeted GCN query step through ``db``: its leaves and what the
    handle shows of the waves."""
    gcn_fill(db)
    h = db.query(gcn_query(N))
    got = leaves(*h.step(wrt=("Edge", "Node")))
    last = h.last
    rec = {"leaves": got, "streamed": isinstance(last, StreamedCompiled)}
    if rec["streamed"]:
        inner = last._inner
        rec.update(
            plan=plan_tuple(last.plan), waves=last.num_waves,
            mesh=None if last.mesh is None else tuple(last.mesh.mesh.shape),
            planned_edge=last.planned_spec("Edge"), planned_node=last.planned_spec("Node"),
            plans=sorted((p.kind, p.data_kind) for p in last.plans.values()),
            resolutions=sorted(set(last.resolutions.values())),
            pad_nnz=dict(inner.pad_nnz),
            edge_rows=None if inner.local is None else int(inner.local.meta_env["Edge"].nnz),
            reshard=dict(last.counters["reshard"]),
            spill=db.counters()["spill"],
            lower_count=h.lower_count,
        )
    return rec


def logreg_step(db, wrt=("theta",)):
    X, y, theta = logreg_data()
    db.put("Rx", torch.as_tensor(X), keys=("row", "col"))
    db.put("Ry", torch.as_tensor(y), keys=("row",))
    db.put("theta", torch.as_tensor(theta), keys=("col",))
    h = db.sql(LOGREG_SQL, wrt=wrt)
    got = leaves(*h.step())
    last = h.last
    return {"leaves": got, "streamed": isinstance(last, StreamedCompiled),
            "plan": plan_tuple(last.plan) if isinstance(last, StreamedCompiled) else None}


def drop_last_wave():
    """The planted fault: the merge leaves the last wave out (every wave
    still runs, so no rank leaves the group's collectives). Returns the
    undo."""
    merge = StreamedCompiled._merge

    def drop_last(self, outs, want):
        def first(outs):
            for w, out in enumerate(outs):
                if w < self.num_waves - 1:
                    yield out
        return merge(self, first(outs), want)

    StreamedCompiled._merge = drop_last
    return lambda: setattr(StreamedCompiled, "_merge", merge)


def committed_fitting(rank, mesh):
    """tests/test_oocore.py's budgeted but fitting session on the 2 × 2
    mesh: after ``catalog_shardings`` commits the layouts, a step moves 0
    bytes and warns nothing; then a table committed to another layout
    than the plan's is moved and warned about once."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.launch.sharding import catalog_shardings

    X, y, theta = logreg_data()
    db = repro_torch.Database(device="cpu", memory_budget=1 << 30)
    db.use_mesh(mesh)
    db.put("Rx", torch.as_tensor(X), keys=("row", "col"))
    db.put("Ry", torch.as_tensor(y), keys=("row",))
    db.put("theta", torch.as_tensor(theta), keys=("col",))
    h = db.sql(LOGREG_SQL, wrt=("theta",))
    loss1 = float(h.step()[0].data)
    placed = catalog_shardings(db)
    for name, sh in placed.items():
        db.put(name, distribute_tensor(db.get(name).data, sh.mesh, sh.placements, src_data_rank=None),
               keys=db.schema(name))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        loss2 = float(h.step()[0].data)
    out = {
        "layouts": {k: tuple(v.spec) for k, v in placed.items()},
        "committed_types": sorted({type(db.get(n).data).__name__ for n in placed}),
        "warnings": [w.message.bytes_moved for w in seen if issubclass(w.category, ReshardWarning)],
        "counters": dict(h.last.counters["reshard"]),
        "db_counters": db.counters()["reshard"],
        "losses": (loss1, loss2),
        "streamed": isinstance(h.last, StreamedCompiled),
    }
    # planted: Rx's rows committed over the data ranks, its columns whole,
    # where the plan cuts its columns over the model ranks too: the step's
    # executable, called on it, moves it and warns once over two calls
    comp = h.last
    rows = ROWS // int(mesh.mesh.shape[0])
    local = torch.as_tensor(X).narrow(0, int(mesh.get_coordinate()[0]) * rows, rows)
    wrong = DTensor.from_local(local.contiguous(), mesh, [Shard(0), Replicate()], run_check=False)
    env = {n: db.get(n) for n in ("Rx", "Ry", "theta")}
    env["Rx"] = repro_torch.DenseRelation(wrong, 2)
    planned = comp.planned_spec("Rx")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        before = dict(comp.counters["reshard"])
        got = [float(comp(env)[0].data) for _ in range(2)]
    out["planted"] = {
        "planned": None if planned is None else tuple(planned),
        "warnings": [w.message.bytes_moved for w in seen if issubclass(w.category, ReshardWarning)],
        "moved": comp.counters["reshard"]["bytes_moved"] - before["bytes_moved"],
        "losses": got,
        "rx_bytes": ROWS * COLS * 4,
    }
    return out


def run_checks(rank: int):
    budget = gcn_budget()
    out = {"budget": budget,
           "one": gcn_step(repro_torch.Database(device="cpu", memory_budget=budget))}
    meshes = {m: make_host_mesh(model=m, device_type="cpu") for m in MODELS}
    for m, mesh in meshes.items():
        out[m] = {"gcn": gcn_step(repro_torch.Database(device="cpu", mesh=mesh, memory_budget=budget)),
                  "again": gcn_step(repro_torch.Database(device="cpu", mesh=mesh, memory_budget=budget))}
        # use_mesh on a budgeted session plans on the mesh as the keyword does
        db = repro_torch.Database(device="cpu", memory_budget=budget)
        out[m]["use_mesh"] = gcn_step(db.use_mesh(mesh))
    logreg_budget = (ROWS * COLS + ROWS + COLS) * 4 * 0.5
    out["logreg"] = logreg_step(repro_torch.Database(device="cpu", mesh=meshes[1],
                                                     memory_budget=logreg_budget))
    out["logreg_all"] = logreg_step(repro_torch.Database(device="cpu", mesh=meshes[2],
                                                         memory_budget=logreg_budget),
                                    wrt=("theta", "Rx", "Ry"))
    out["committed"] = committed_fitting(rank, meshes[2])
    # planted: the merge on rank 1 leaves the last wave out
    undo = drop_last_wave() if rank == 1 else (lambda: None)
    try:
        out["planted"] = gcn_step(repro_torch.Database(device="cpu", mesh=meshes[1], memory_budget=budget))
    finally:
        undo()
    # release: the store's chunks go, a later step spills again
    db = repro_torch.Database(device="cpu", mesh=meshes[1], memory_budget=budget)
    gcn_step(db)
    held = db.counters()["spill"]["spilled_relations"]
    db.release()
    out["release"] = (held, db.counters()["spill"]["spilled_relations"])
    return out


def one_rank(rank: int):
    """A one-rank mesh against the mesh-less budgeted step (bit for bit)."""
    budget = gcn_budget()
    mesh = make_host_mesh(device_type="cpu")
    return {"mesh": gcn_step(repro_torch.Database(device="cpu", mesh=mesh, memory_budget=budget)),
            "one": gcn_step(repro_torch.Database(device="cpu", memory_budget=budget)),
            "mesh_shape": tuple(mesh.mesh.shape)}
