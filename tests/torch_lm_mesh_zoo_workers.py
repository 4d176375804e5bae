"""Rank programs of the mesh tests of whisper, qwen2-vl and a pod axis
(tests/test_torch_lm_mesh_whisper.py, tests/test_torch_lm_mesh_qwen2_vl.py,
tests/test_torch_lm_mesh_pod.py, tests/test_torch_launch_tools.py): each
runs in a process of a 4-rank ``gloo`` group on the CPU
(``repro_torch.launch.mesh.start_ranks``) and imports no JAX.

``run_checks`` takes a suite's name (``SUITES``: its archs, batch, meshes
and plants) and the reference's weights of each of its archs (numpy, from
the test module), runs the one-process port steps — a prefill (over
whisper's frames or qwen2-vl's patches too), greedy-free decode steps fed
seeded tokens (whisper's with ``make_encode_step``'s encoder output), one
Adam step — the same on each of the suite's meshes, and the suite's
planted faults, and returns plain numbers and numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

import torch_lm_mesh_workers as W

import repro_torch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import collectives, sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import DP, Placement, hint
from repro_torch.models import blocks, build_model
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model
from repro_torch.serving import init_cache, make_decode_step, make_encode_step, make_prefill_step
from repro_torch.train import init_train_state, make_train_step

LR = W.LR


@dataclasses.dataclass(frozen=True)
class Suite:
    """A test module's archs (``reduced()``, with ``changes`` (arch, field,
    value) on top), its batch — a prefill of ``b`` prompts of ``s`` tokens
    (after ``vis_seq`` patches, or over ``enc_seq`` frames, where the arch
    has them), then ``decode`` steps; one train step over b × s tokens —,
    the meshes its ranks serve and train on ({name: (pod, model)}) and
    which plants they run."""

    archs: Tuple[str, ...]
    meshes: Tuple[Tuple[str, Tuple[int, int]], ...]
    b: int = 4
    s: int = 8
    decode: int = 2
    changes: Tuple[Tuple[str, str, Any], ...] = ()
    plants: Tuple[str, ...] = ()
    min_fsdp_bytes: Any = 32 << 10

    def overrides(self, arch) -> Dict[str, Any]:
        return {k: v for a, k, v in self.changes if a == arch}

    def cache(self, cfg) -> int:
        return self.s + self.decode + (cfg.vis_seq or 0)


SUITES = {
    # whisper as published has as many KV heads as heads: 4 of 4 here, so
    # that each of 4 model ranks attends over one
    "whisper": Suite(("whisper-small",), (("1x4", (1, 4)), ("2x2", (1, 2))),
                     changes=(("whisper-small", "n_kv_heads", 4),),
                     plants=("xattn_uncopied", "dec_reduce_dropped")),
    "qwen2_vl": Suite(("qwen2-vl-72b",), (("2x2", (1, 2)),),
                      plants=("prefix_on_model", "positions_on_sequence")),
    "pod": Suite(("olmoe-1b-7b",), (("2x2x1", (2, 1)),), plants=("pod_dropped",)),
}

#: the model all-reduces of a whisper pass on the 1 × 4 mesh before layer
#: L's of the decoder: the lookup's, then 3 a layer (the self-attention's,
#: the cross-attention's and the MLP's row-parallel outputs); the encoder,
#: whole on every rank, has none (ROADMAP.md §3)
DEC_PLANTED_LAYER = 1


def config(arch, suite):
    return get_config(arch).reduced(**suite.overrides(arch))


def batch(cfg, suite, seed=0):
    """{tokens (b, s), labels (b, s), fed (b, decode)} and the arch's
    ``frames`` (b, enc_seq, d) or ``patches`` (b, vis_seq, d), numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(suite.b, suite.s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -100
    out = {"tokens": tokens, "labels": labels,
           "fed": rng.integers(0, cfg.vocab, size=(suite.b, suite.decode)).astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.normal(size=(suite.b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.vis_seq:
        out["patches"] = rng.normal(size=(suite.b, cfg.vis_seq, cfg.d_model)).astype(np.float32)
    return out


def _inputs(data, keys):
    return {k: torch.as_tensor(data[k]) for k in keys if k in data}


def serve(model, db, suite, mesh=None):
    """Prefill then the suite's decode steps fed seeded tokens (whisper's
    on ``make_encode_step``'s encoder output): every step's logits, layer
    0's cache shapes and each call's collectives."""
    cfg = model.cfg
    data = batch(cfg, suite)
    vis = cfg.vis_seq or 0
    prefill = make_prefill_step(model, suite.cache(cfg), mesh=mesh, db=db)
    decode = make_decode_step(model, mesh=mesh, db=db)
    coll = []
    collectives.reset_collectives()
    logits, caches = prefill(_inputs(data, ("tokens", "frames", "patches")))
    coll.append(collectives.last_collectives())
    kw = {}
    if cfg.encoder_layers:
        collectives.reset_collectives()
        kw["enc_out"] = make_encode_step(model, mesh=mesh, db=db)(torch.as_tensor(data["frames"]))
        coll.append(collectives.last_collectives())
    out = [logits.numpy()]
    for i in range(suite.decode):
        collectives.reset_collectives()
        logits, caches = decode(torch.as_tensor(data["fed"][:, i:i + 1]), caches, suite.s + vis + i, **kw)
        coll.append(collectives.last_collectives())
        out.append(logits.numpy())
    layer0 = W._shapes(caches[0]["scan"][0][W.first_block(cfg)])
    rec = {"logits": np.stack(out), "cache0": layer0, "collectives": coll}
    if "enc_out" in kw:
        rec["enc_out"] = kw["enc_out"].numpy()
    return rec


def train(model, db, suite, mesh=None):
    """One Adam step: the loss, the global norm, the gradients the update
    took and the new parameters, whole."""
    cfg = model.cfg
    data = batch(cfg, suite)
    state = init_train_state(model)
    params = {k: v.clone() for k, v in state.params.items()}
    step = make_train_step(model, lr=LR, database=db, mesh=mesh)
    with W.Grads() as rec:
        new, _, metrics = step(params, state.opt_state, _inputs(data, ("tokens", "labels", "frames", "patches")))
    grads = rec.seen[0]
    if mesh is not None:
        place = Placement(cfg, mesh)
        grads = {k: place.whole(k, g) for k, g in grads.items()}
        new = {k: place.whole(k, v) for k, v in new.items()}
    return {"loss": float(metrics["loss"]), "total": float(metrics["total"]), "norm": rec.norms[0],
            "grads": {k: g.numpy() for k, g in grads.items()},
            "params": {k: v.numpy() for k, v in new.items()}}


def step_collectives(model, suite, mesh):
    """The collectives one train step of ``model`` on ``mesh`` records on
    this rank, the step alone (``train`` records its gradients and norm
    with collectives of their own)."""
    data = batch(model.cfg, suite)
    state = init_train_state(model)
    params = {k: v.clone() for k, v in state.params.items()}
    step = make_train_step(model, lr=LR, mesh=mesh)
    collectives.reset_collectives()
    with repro_torch.Database(device="cpu").activate():
        step(params, state.opt_state, _inputs(data, ("tokens", "labels", "frames", "patches")))
    return collectives.last_collectives()


def drop_all_reduce(kind, index=0):
    """Plant a missing reduction: the ``index``-th all-reduce over ``kind``
    of the next run returns the rank's own tensor. Returns the undo."""
    real = collectives.MeshComm.all_reduce
    seen = [0]

    def all_reduce(self, t, k):
        if k == kind:
            seen[0] += 1
            if seen[0] == index + 1:
                return t.clone()
        return real(self, t, k)

    collectives.MeshComm.all_reduce = all_reduce

    def undo():
        collectives.MeshComm.all_reduce = real
    return undo


def _positions_on_sequence(self, b, s, length=None, vis=0):
    """M-RoPE positions cut on the sequence axis over the batch fold
    instead of on the batch axis, as the tokens are."""
    return hint(self._batch_positions(b, s, length, vis), None, None, DP)


def _prefix_on_model(t, b=None):
    """The vision prefix's rows (the patches, the positions) cut over the
    model axis instead of the tokens' batch fold."""
    return hint(t, "model", *([None] * (t.dim() - 1)))


def plant(what, suite, model, meshes):
    """Run the planted fault ``what``: its record (logits or gradients),
    or the error's type name where the planted step fails outright."""
    m = meshes[suite.meshes[0][0]]
    if what == "xattn_uncopied":
        undo = W.planted("_kv_source", lambda place, e: e, blocks)
        run = lambda: train(model, repro_torch.Database(device="cpu"), suite, m)["grads"]  # noqa: E731
    elif what == "dec_reduce_dropped":
        undo = drop_all_reduce("model", 1 + 3 * DEC_PLANTED_LAYER)
        run = lambda: serve(model, repro_torch.Database(device="cpu", mesh=m), suite)["logits"]  # noqa: E731
    elif what == "prefix_on_model":
        undo = W.planted("_rows", _prefix_on_model, model_mod)
        run = lambda: serve(model, repro_torch.Database(device="cpu", mesh=m), suite)["logits"]  # noqa: E731
    elif what == "positions_on_sequence":
        undo = W.planted("_positions", _positions_on_sequence, Model)
        run = lambda: train(model, repro_torch.Database(device="cpu"), suite, m)["grads"]  # noqa: E731
    elif what == "pod_dropped":
        undo = _drop_every("pod")
        run = lambda: train(model, repro_torch.Database(device="cpu"), suite, m)  # noqa: E731
    else:
        raise KeyError(what)
    try:
        return run()
    except RuntimeError as e:
        return type(e).__name__
    finally:
        undo()


def _drop_every(kind):
    """Plant every all-reduce over ``kind`` left out. Returns the undo."""
    real = collectives.MeshComm.all_reduce

    def all_reduce(self, t, k):
        return t.clone() if k == kind else real(self, t, k)

    collectives.MeshComm.all_reduce = all_reduce

    def undo():
        collectives.MeshComm.all_reduce = real
    return undo


def arch_checks(arch, weights, suite, meshes):
    """One arch's record (module docstring)."""
    cfg = config(arch, suite)
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), weights)
    one = repro_torch.Database(device="cpu")
    rec = {"one": {"serve": serve(model, one, suite), "train": train(model, one, suite)}}
    whole_params = {n: p.detach() for n, p in model.named_parameters()}
    for name, mesh in meshes.items():
        place = Placement(cfg, mesh)
        rec[name] = {"serve": serve(model, repro_torch.Database(device="cpu", mesh=mesh), suite),
                     "train": train(model, repro_torch.Database(device="cpu"), suite, mesh),
                     "shard": W.shard_checks(place, whole_params),
                     "encoder_whole": all(place.local_shape(k) == place.shapes[k]
                                          for k in place.shapes if k.startswith("encoder.")),
                     "cache0": W._shapes(init_cache(cfg, suite.b, suite.cache(cfg), "cpu", place=place)[0][
                         "scan"][0][W.first_block(cfg)]),
                     "coords": {k: place.index(k) for k in place.comm.size}}
    # the model built on the first mesh: its own shards, cut as drawn
    name, mesh = next(iter(meshes.items()))
    own = build_model(cfg, device="cpu", seed=1, mesh=mesh)
    drawn = {n: p.detach() for n, p in build_model(cfg, device="cpu", seed=1).named_parameters()}
    rec["built_shards"] = all(torch.equal(p, own.placement.cut(n, drawn[n])) for n, p in own.named_parameters())
    rec["plants"] = {what: plant(what, suite, model, meshes) for what in suite.plants}
    return rec


def meshes_of(suite):
    return {name: make_host_mesh(model=m, pod=pod, device_type="cpu") for name, (pod, m) in suite.meshes}


def run_checks(rank: int, weights, suite: str):
    torch.manual_seed(0)
    sw = SUITES[suite]
    sharding.param_pspec.__kwdefaults__["min_fsdp_bytes"] = sw.min_fsdp_bytes
    meshes = meshes_of(sw)
    out = {"rank": rank}
    for arch in sw.archs:
        out[arch] = arch_checks(arch, weights[arch], sw, meshes)
    return out


def one_rank(rank: int, suite: str):
    """The suite's steps on a one-rank ("model",) mesh against the
    mesh-less ones, bit for bit: (arch, part) → equal."""
    sw = SUITES[suite]
    mesh = make_host_mesh(device_type="cpu")
    out = {}
    for arch in sw.archs:
        model = build_model(config(arch, sw), device="cpu", seed=1)
        a = serve(model, repro_torch.Database(device="cpu"), sw)
        b = serve(model, repro_torch.Database(device="cpu", mesh=mesh), sw)
        out[arch, "serve"] = np.array_equal(a["logits"], b["logits"])
        a = train(model, repro_torch.Database(device="cpu"), sw)
        b = train(model, repro_torch.Database(device="cpu"), sw, mesh)
        out[arch, "train"] = (a["loss"] == b["loss"] and a["norm"] == b["norm"]
                              and all(np.array_equal(a[part][k], b[part][k])
                                      for part in ("grads", "params") for k in a[part]))
    return out


def dryrun_checks(rank: int, suite: str = "pod"):
    """The collectives each step of the suite's first arch records on this
    rank against what ``launch.dryrun`` walks on ``meta`` for rank 0 of a
    mesh of the same axis sizes (the comparison is made on rank 0): per
    mesh and step, (measured, walked) records, and the rank's parameter
    bytes against the walk's."""
    from repro_torch.launch import dryrun

    sw = SUITES[suite]
    sharding.param_pspec.__kwdefaults__["min_fsdp_bytes"] = sw.min_fsdp_bytes
    arch = sw.archs[0]
    cfg = config(arch, sw)
    out = {}
    for name, mesh in {**meshes_of(sw), "1x4": make_host_mesh(model=4, device_type="cpu")}.items():
        model = build_model(cfg, device="cpu", seed=1, mesh=mesh)
        measured = {"train": step_collectives(model, sw, mesh)}
        got = serve(model, repro_torch.Database(device="cpu", mesh=mesh), sw)
        measured["prefill"], measured["decode"] = got["collectives"][0], got["collectives"][1]
        sizes = sharding.axis_sizes(mesh)
        data = batch(cfg, sw)
        walked = {kind: dryrun.walk(cfg, sizes, kind, sw.b, sw.s if kind != "decode" else sw.cache(cfg),
                                    length=sw.s)
                  for kind in ("train", "prefill", "decode")}
        out[name] = {"measured": measured,
                     "walked": {k: v["collectives"] for k, v in walked.items()},
                     "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
                     "walked_param_bytes": walked["train"]["param_bytes"],
                     "tokens": data["tokens"].shape}
    return out
