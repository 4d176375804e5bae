"""Rank programs of tests/test_torch_lm_mesh.py: each runs in a process of
a 4-rank ``gloo`` group on the CPU (``repro_torch.launch.mesh.start_ranks``)
and imports no JAX. ``run_checks`` takes the reference's weights of each
arch (numpy, from the test module), runs the one-process port steps, the
steps on a 1 × 4 (data × model) mesh (prefill and greedy decode) and on a
2 × 2 mesh (one train step), a planted missing all-reduce, and the
non-slice kinds' refusals, and returns plain numbers and numpy arrays.
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch

import torch_mesh_workers

import repro_torch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import collectives
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import Placement, catalog_shardings, shard_params, to_shardings
from repro_torch.models import build_model
from repro_torch.serving import init_cache, make_decode_step, make_prefill_step
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import trainer

ARCHS = ("olmoe-1b-7b", "llama3-405b")
#: prefill of B prompts of S tokens, then DECODE steps fed the tokens of
#: ``batch``; one train step over B × S tokens
B, S, DECODE = 4, 8, 2
CACHE = S + DECODE
LR = 1e-3


def config(arch):
    return get_config(arch).reduced()


def batch(cfg, seed=0):
    """(tokens (B, S), labels (B, S), the decode steps' tokens (B, DECODE))."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -100
    fed = rng.integers(0, cfg.vocab, size=(B, DECODE)).astype(np.int32)
    return tokens, labels, fed


def serve(model, db, mesh=None):
    """Prefill then DECODE steps: every step's logits, the last caches' K
    of layer 0 and the decode step's placed-params cache size."""
    tokens, _, fed = batch(model.cfg)
    prefill = make_prefill_step(model, CACHE, mesh=mesh, db=db)
    decode = make_decode_step(model, mesh=mesh, db=db)
    logits, caches = prefill({"tokens": torch.as_tensor(tokens)})
    out = [logits.numpy()]
    for i in range(DECODE):
        logits, caches = decode(torch.as_tensor(fed[:, i:i + 1]), caches, S + i)
        out.append(logits.numpy())
    k0 = caches[0]["scan"][0]["0:" + model.cfg.pattern[0]]["kv"]["k"]
    placed = getattr(decode, "_placed_cache", None)
    return {"logits": np.stack(out), "k0": tuple(k0.shape),
            "placed": None if placed is None else len(placed)}


class Grads:
    """Records the gradients each Adam update is given (the synced ones
    on a mesh)."""

    def __enter__(self):
        self.real, self.seen = trainer.adam_update, []

        def update(params, grads, state, **kw):
            self.seen.append({k: g.detach().clone() for k, g in grads.items()})
            return self.real(params, grads, state, **kw)

        trainer.adam_update = update
        return self

    def __exit__(self, *exc):
        trainer.adam_update = self.real


def whole(place, name, t):
    """The whole parameter from the ranks' shards of ``name``."""
    for d, e in enumerate(place.specs[name]):
        kind = place.kind_of(e, place.shapes[name][d])
        if kind is not None:
            t = place.comm.all_gather(t.contiguous(), d, kind)
    return t


def train(model, db, mesh=None):
    """One Adam step: the loss, the gradients the update took and the new
    parameters, whole."""
    tokens, labels, _ = batch(model.cfg)
    state = init_train_state(model)
    params = {k: v.clone() for k, v in state.params.items()}
    step = make_train_step(model, lr=LR, database=db, mesh=mesh)
    with Grads() as rec:
        new, _, metrics = step(params, state.opt_state,
                               {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)})
    grads = rec.seen[0]
    if mesh is not None:
        place = Placement(model.cfg, mesh)
        grads = {k: whole(place, k, g) for k, g in grads.items()}
        new = {k: whole(place, k, v) for k, v in new.items()}
    return {"loss": float(metrics["loss"]), "total": float(metrics["total"]),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "params": {k: v.numpy() for k, v in new.items()}}


def drop_model_all_reduce(index=0):
    """Plant a missing reduction: the ``index``-th model-axis all-reduce of
    the next run returns each rank's partial unsummed. Returns the undo."""
    real = collectives.MeshComm.all_reduce
    seen = [0]

    def all_reduce(self, t, kind):
        if kind == "model":
            seen[0] += 1
            if seen[0] == index + 1:
                return t.clone()
        return real(self, t, kind)

    collectives.MeshComm.all_reduce = all_reduce

    def undo():
        collectives.MeshComm.all_reduce = real
    return undo


def refusals(mesh):
    """The non-slice kinds on a mesh: each raises NotImplementedError
    naming ROADMAP.md (the message, or None where none raised)."""
    out = {}
    for arch in ("falcon-mamba-7b", "gemma2-9b", "whisper-small", "qwen2-vl-72b", "deepseek-v3-671b"):
        try:
            Placement(get_config(arch).reduced(), mesh)
            out[arch] = None
        except NotImplementedError as e:
            out[arch] = str(e)
    return out


def collective_checks(mesh):
    """Each autograd collective of ``launch.collectives`` over the model
    axis against its definition, forward and backward, on rank-dependent
    f64 values: (name → equal)."""
    from repro_torch.core.planner import MeshGeometry

    comm = collectives.comm_for(mesh, MeshGeometry.from_mesh(mesh))
    m, r = comm.size["model"], comm.index["model"]
    base = torch.arange(4 * m, dtype=torch.float64)
    parts = [base * (i + 1) for i in range(m)]          # rank i's whole input
    ups = [base + 10 * i for i in range(m)]             # rank i's cotangent of a whole
    n = base.numel() // m

    def run(fn, x, up):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        y.backward(up)
        return y.detach(), x.grad

    out = {}
    y, g = run(lambda x: collectives.reduce_from(x, comm), parts[r], ups[r])
    out["reduce_from"] = torch.equal(y, sum(parts)) and torch.equal(g, ups[r])
    y, g = run(lambda x: collectives.copy_to(x, comm), parts[r], ups[r])
    out["copy_to"] = torch.equal(y, parts[r]) and torch.equal(g, sum(ups))
    mine = slice(r * n, (r + 1) * n)
    y, g = run(lambda x: collectives.gather_from(x, comm, 0), parts[r][mine], ups[0])
    out["gather_from"] = (torch.equal(y, torch.cat([p[i * n:(i + 1) * n] for i, p in enumerate(parts)]))
                          and torch.equal(g, ups[0][mine]))
    y, g = run(lambda x: collectives.scatter_to(x, comm, 0), parts[0], ups[r][:n])
    out["scatter_to"] = (torch.equal(y, parts[0][mine])
                         and torch.equal(g, torch.cat([u[:n] for u in ups])))
    y, g = run(lambda x: collectives.all_gather(x, comm, 0, "model"), parts[r][mine], ups[r])
    out["all_gather"] = (torch.equal(y, torch.cat([p[i * n:(i + 1) * n] for i, p in enumerate(parts)]))
                         and torch.equal(g, sum(ups)[mine]))
    y, g = run(lambda x: collectives.reduce_scatter(x, comm, 0, "model"), parts[r], ups[r][:n])
    out["reduce_scatter"] = (torch.equal(y, sum(parts)[mine])
                             and torch.equal(g, torch.cat([u[:n] for u in ups])))
    return out


def run_checks(rank: int, weights):
    torch.manual_seed(0)
    m14 = make_host_mesh(model=4, device_type="cpu")
    m22 = make_host_mesh(model=2, device_type="cpu")
    out = {"rank": rank}
    for arch in ARCHS:
        cfg = config(arch)
        model = convert.lm_params(build_model(cfg, device="cpu", seed=1), weights[arch])
        one = repro_torch.Database(device="cpu")
        rec = {"one": {"serve": serve(model, one), "train": train(model, one)}}
        db14 = repro_torch.Database(device="cpu", mesh=m14)
        collectives.reset_collectives()
        rec["mesh"] = serve(model, db14)
        rec["collectives"] = collectives.last_collectives()
        rec["again"] = serve(model, repro_torch.Database(device="cpu", mesh=m14))["logits"]
        undo = drop_model_all_reduce()
        try:
            rec["planted"] = serve(model, db14)["logits"]
        finally:
            undo()
        place = Placement(cfg, m14)
        rec["cache_k"] = tuple(init_cache(cfg, B, CACHE, "cpu", place=place)[0]["scan"][0][
            "0:" + cfg.pattern[0]]["kv"]["k"].shape)
        # the model built on the mesh: its own shards, cut as it is drawn
        own = build_model(cfg, device="cpu", seed=1, mesh=m14)
        whole_model = build_model(cfg, device="cpu", seed=1)
        rec["built_shards"] = all(
            torch.equal(p, place.cut(n, dict(whole_model.named_parameters())[n]))
            for n, p in own.named_parameters())
        rec["train22"] = train(model, repro_torch.Database(device="cpu"), m22)
        out[arch] = rec
    out["refusals"] = refusals(m14)
    out["collectives"] = collective_checks(m14)
    # the specs as DTensor placements on the 2 × 2 mesh
    place = Placement(config("olmoe-1b-7b"), m22)
    shard = to_shardings(place.specs, m22)
    out["placements"] = {k: [str(p) for p in shard[k].placements]
                         for k in ("embed", "stages.0.scan.0.0:moe.moe.wi_gate",
                                   "stages.0.scan.0.0:moe.attn.wq", "ln_f")}
    out["specs"] = {k: tuple(place.specs[k]) for k in out["placements"]}
    whole_params = dict(build_model(config("olmoe-1b-7b"), device="cpu", seed=1).named_parameters())
    cut = shard_params(whole_params, place.specs, m22)
    out["shard_params"] = all(torch.equal(cut[k], place.cut(k, v)) and cut[k].shape == place.local_shape(k)
                              for k, v in whole_params.items())
    # the layouts a mesh-compiled step committed the catalog's relations to
    g, _, _ = torch_mesh_workers.problem()
    qdb = repro_torch.Database(device="cpu", mesh=m14)
    torch_mesh_workers.query_step(qdb, g)
    out["catalog"] = {k: (tuple(v.spec), [str(p) for p in v.placements])
                      for k, v in catalog_shardings(qdb).items()}
    out["layouts"] = {k: None if qdb.layout(k) is None else tuple(qdb.layout(k))
                      for k in ("Edge", "Node")}
    try:
        make_train_step(build_model(config("gemma2-9b"), device="cpu"), mesh=m22)
        out["train_refusal"] = None
    except NotImplementedError as e:
        out["train_refusal"] = str(e)
    return out


def one_rank(rank: int):
    """The steps on a one-rank ("model",) mesh against the mesh-less ones,
    bit for bit, and an endpoint on it: (arch, part) → equal."""
    mesh = make_host_mesh(device_type="cpu")
    out = {}
    for arch in ARCHS:
        model = build_model(config(arch), device="cpu", seed=1)
        a, b = serve(model, repro_torch.Database(device="cpu")), serve(model, repro_torch.Database(
            device="cpu", mesh=mesh))
        out[arch, "serve"] = np.array_equal(a["logits"], b["logits"])
        a = train(model, repro_torch.Database(device="cpu"))
        b = train(model, repro_torch.Database(device="cpu", mesh="host"))
        out[arch, "train"] = (a["loss"] == b["loss"] and a["total"] == b["total"]
                              and all(np.array_equal(a[part][k], b[part][k])
                                      for part in ("grads", "params") for k in a[part]))
        # an endpoint on a session whose mesh has one rank serves through
        # the steps on that mesh: the same tokens as a mesh-less session's
        tokens, _, _ = batch(model.cfg)
        served = []
        for db in (repro_torch.Database(device="cpu"), repro_torch.Database(device="cpu", mesh=mesh)):
            db.register_model("lm", model, dict(model.named_parameters()))
            ep = db.endpoint("lm", cache_len=CACHE, buckets=[(1, S)])
            served.append(asyncio.run(ep.submit(tokens[0], max_new_tokens=DECODE)).token_ids.tolist())
        out[arch, "endpoint"] = served[0] == served[1] and len(served[0]) == DECODE
    return out
