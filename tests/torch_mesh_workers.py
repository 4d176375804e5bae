"""Rank programs of tests/test_torch_mesh.py: each runs in a process of a
4-rank ``gloo`` group on the CPU (``repro_torch.launch.mesh.start_ranks``)
and imports no JAX, so that starting a rank stays cheap. ``run_checks``
runs every mesh check of the module in one start and returns plain numbers
and numpy arrays; the test module holds them to the one-process step and
to the reference.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

import repro_torch
from repro_torch.core import fra
from repro_torch.core.engine import RAEngine, ReshardWarning, ShardFallbackWarning
from repro_torch.core.kernels import ADD, MUL, SQUARE, SUM_CHUNK, scale_kernel
from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj
from repro_torch.core.relation import DenseRelation
from repro_torch.launch import collectives
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.relational import gcn_conv, partitioned_edges, rel_linear, rel_matmul_blocked

#: the GCN step of examples/gcn_train.py, small: edges + self loops = 365,
#: which no mesh of 4 or 2 data ranks splits (its nnz rows are padded)
N, E, FEAT, LABELS, HIDDEN = 64, 301, 8, 4, 16
#: the NNMF-shaped product: (BI, BK) × (BK, BJ) blocks of (B, B)
BI, BK, BJ, B = 4, 4, 2, 8
#: the host meshes of the checks, by model-axis size: 4×1, 1×4, 2×2
MODELS = (1, 4, 2)


def problem():
    """The GCN problem (graph, labels, weights) from seed 0, in numpy."""
    from repro_torch.data import synthetic_graph

    g = synthetic_graph(N, E, FEAT, LABELS, seed=0)
    keys, w, x = g["edge_keys"], g["edge_w"], g["x"]
    adj = np.zeros((N, N), np.float64)
    np.add.at(adj, (keys[:, 1], keys[:, 0]), w)
    rng = np.random.default_rng(0)
    y = np.argmax(adj @ adj @ x @ rng.normal(size=(FEAT, LABELS)), axis=1).astype(np.int64)
    params = {
        "w1": (rng.normal(size=(FEAT, HIDDEN)) * FEAT ** -0.5).astype(np.float32),
        "w2": (rng.normal(size=(HIDDEN, LABELS)) * HIDDEN ** -0.5).astype(np.float32),
    }
    return g, y, params


def product_problem():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BI, BK, B, B)).astype(np.float32)
    w = rng.normal(size=(BK, BJ, B, B)).astype(np.float32)
    return x, w


def gcn_query(n: int) -> fra.Query:
    """benchmarks/coo_scale.py's GCN program: mean of squared convolved
    features, differentiable in the edge weights and the node features."""
    conv = fra.Agg(identity_key(1), ADD, fra.Join(
        eq_pred((0, 0)), jproj(L(1)), MUL, fra.scan("Edge", 2), fra.scan("Node", 1)))
    sq = fra.Select(TRUE, identity_key(1), SQUARE, conv)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Select(TRUE, identity_key(1), SUM_CHUNK, sq))
    mean = fra.Select(TRUE, identity_key(0), scale_kernel(1.0 / n), loss)
    return fra.Query(mean, inputs=("Edge", "Node"))


def gcn_step(conv_db, lin_db, data, params):
    """One GCN training step (examples/gcn_train.py): the loss and the
    weight gradients, its gcn_conv calls under ``conv_db`` and its
    rel_linear calls under ``lin_db``."""
    x, keys, w, y = data
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    with conv_db.activate():
        h0 = gcn_conv(x, keys, w)
    with lin_db.activate():
        z1 = rel_linear(h0, p["w1"])
    with conv_db.activate():
        h1 = gcn_conv(torch.relu(z1), keys, w)
    with lin_db.activate():
        z2 = rel_linear(h1, p["w2"])
    loss = -torch.log_softmax(z2, dim=1).gather(1, y[:, None]).mean()
    loss.backward()
    return {"loss": float(loss), **{k: v.grad.numpy().copy() for k, v in p.items()}}


def query_step(db, g):
    """The GCN query's step through Database.query(...).step(): the loss
    and both gradients, and the handle's plans and placements."""
    db.put("Edge", partitioned_edges(g["edge_keys"], g["edge_w"], N, 1))
    db.put("Node", torch.as_tensor(g["x"]), keys=("node",))
    h = db.query(gcn_query(N))
    out, grads = h.step(wrt=("Edge", "Node"))
    plans = {nid: (p.kind, p.data_kind, p.needs_psum, p.needs_data_psum)
             for nid, p in h.plans.items()}
    return {
        "loss": float(out.data),
        "dnode": grads["Node"].data.numpy().copy(),
        "dedge": grads["Edge"].values.numpy().copy(),
        "plans": plans,
        "placements": h.placements,
        "pad_nnz": dict(h.last.pad_nnz),
        "edge_rows": int(h.last.local.meta_env["Edge"].nnz) if h.last.local else None,
    }


def product(db, x, w):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    with db.activate():
        out = rel_matmul_blocked(xt, wt)
        (out * out).sum().backward()
    return {"out": out.detach().numpy().copy(), "dx": xt.grad.numpy().copy(),
            "dw": wt.grad.numpy().copy()}


def drop_one_partial(kind: str, index: int):
    """Make the ``kind`` group's reductions leave out the partial sum of
    the rank at ``index`` (the planted missing reduction)."""
    real_ar, real_rs = collectives.MeshComm.all_reduce, collectives.MeshComm.reduce_scatter

    def drop(self, t):
        return torch.zeros_like(t) if self.index[kind] == index else t

    def all_reduce(self, t, k):
        return real_ar(self, drop(self, t) if k == kind else t, k)

    def reduce_scatter(self, t, dim, k):
        return real_rs(self, drop(self, t) if k == kind else t, dim, k)

    collectives.MeshComm.all_reduce, collectives.MeshComm.reduce_scatter = all_reduce, reduce_scatter
    return lambda: (setattr(collectives.MeshComm, "all_reduce", real_ar),
                    setattr(collectives.MeshComm, "reduce_scatter", real_rs))


def run_checks(rank: int):
    from repro_torch.analysis import certify, certify_kernels
    from torch.distributed.tensor import DTensor, Replicate, Shard

    g, y, params = problem()
    data = (torch.as_tensor(g["x"]), torch.as_tensor(g["edge_keys"]),
            torch.as_tensor(g["edge_w"]), torch.as_tensor(y))
    x, w = product_problem()
    one = repro_torch.Database(device="cpu")
    out = {"one": {"gcn": gcn_step(one, one, data, params),
                   "query": query_step(repro_torch.Database(device="cpu"), g),
                   "product": product(one, x, w)}}
    meshes = {m: make_host_mesh(model=m, device_type="cpu") for m in MODELS}
    for m, mesh in meshes.items():
        db = repro_torch.Database(device="cpu", mesh=mesh)
        # a budget no relation fits: the product co-partitions on the
        # contraction key and the convolution's node table is sharded on
        # the model axis (the rel_linear products have no key to shard)
        tight = repro_torch.Database(device="cpu", mesh=mesh, mem_budget=1.0)
        collectives.reset_collectives()
        rec = {"gcn": gcn_step(db, db, data, params)}
        rec["gcn_collectives"] = collectives.last_collectives()
        rec["gcn_tight"] = gcn_step(tight, db, data, params)
        rec["query"] = query_step(repro_torch.Database(device="cpu", mesh=mesh), g)
        rec["again"] = query_step(repro_torch.Database(device="cpu", mesh=mesh), g)
        rec["product"] = product(tight, x, w)
        rec["product_plans"] = [
            (p.kind, p.data_kind) for c in tight._compiled_refs for p in c.plans.values()]
        out[m] = rec

    # a data-axis reduction that leaves rank 1's partial out
    restore = drop_one_partial("data", 1)
    try:
        out["planted"] = query_step(repro_torch.Database(device="cpu", mesh=meshes[1]), g)
    finally:
        restore()

    # a dense dim that does not split over the model axis: replicated, warned
    mesh = meshes[4]
    odd = product_problem_odd()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tight = repro_torch.Database(device="cpu", mesh=mesh, mem_budget=1.0)
        res = product(tight, *odd)
    out["fallback"] = {
        "warnings": [(w_.category.__name__, getattr(w_.message, "relation", None),
                      getattr(w_.message, "dim", None)) for w_ in seen
                     if issubclass(w_.category, ShardFallbackWarning)],
        "out": res["out"],
        "want": product(repro_torch.Database(device="cpu"), *odd)["out"],
    }

    # committed layouts: a node table committed sharded over the data axis
    # where the plan wants it whole
    mesh = meshes[1]
    q = gcn_query(N)
    edge = partitioned_edges(g["edge_keys"], g["edge_w"], N, 4)
    node = torch.as_tensor(g["x"])
    env = {"Edge": edge, "Node": DenseRelation(node, 1)}
    comp = RAEngine(q).lower(env, dispatch="ref").compile(mesh=mesh)
    clean = certify(comp, env)
    local = node.narrow(0, rank * (N // 4), N // 4)
    placements = [Shard(0)] + [Replicate()] * (mesh.ndim - 1)
    wrong = {"Edge": edge, "Node": DenseRelation(
        DTensor.from_local(local, mesh, placements, run_check=False), 1)}
    bad = certify(comp, wrong)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = [float(comp(wrong).data) for _ in range(2)]
    out["committed"] = {
        "clean_ok": clean.ok,
        "clean": {k: clean.to_dict()[k] for k in ("reshard", "divisibility")},
        "bad_ok": bad.ok,
        "bad_reshard": bad.reshard,
        "reshard_warnings": [w_.message.bytes_moved for w_ in seen
                             if issubclass(w_.category, ReshardWarning)],
        "counters": dict(comp.counters["reshard"]),
        "losses": got,
        "want": float(comp(env).data),
        "kernels_ok": certify_kernels(comp).ok,
        "kernel_sites": len(comp.local.resolutions.sites),
    }
    return out


def product_problem_odd():
    """A product whose contraction blocks (3) do not split over 4 model ranks."""
    rng = np.random.default_rng(2)
    return (rng.normal(size=(4, 3, B, B)).astype(np.float32),
            rng.normal(size=(3, 2, B, B)).astype(np.float32))
