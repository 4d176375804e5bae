"""Rank programs of the language-model mesh tests
(tests/test_torch_lm_mesh.py, tests/test_torch_lm_mesh_ssm.py,
tests/test_torch_lm_mesh_gemma.py, tests/test_torch_lm_mesh_mla.py): each runs in a process of a 4-rank
``gloo`` group on the CPU (``repro_torch.launch.mesh.start_ranks``) and
imports no JAX. ``run_checks`` takes a suite's name (``SUITES``: its
archs, batch and checks) and the reference's weights of each of its
archs (numpy, from the test module), runs the one-process port steps,
the steps on a 1 × 4 (data × model) mesh (prefill and greedy decode) and
on a 2 × 2 mesh (one train step), the planted faults, and the suite's own
checks, and returns plain numbers and numpy arrays.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

import torch_mesh_workers

import repro_torch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import collectives, sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import Placement, catalog_shardings, to_shardings
from repro_torch.models import blocks, build_model
from repro_torch.models.model import stages_of
from repro_torch.serving import BucketedPrefill, init_cache, make_decode_step, make_prefill_step
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import trainer


@dataclasses.dataclass(frozen=True)
class Suite:
    """A test module's archs (``reduced()``, with ``changes`` (arch, field,
    value) on top), its batch — a prefill of ``b`` prompts of ``s`` tokens,
    then ``decode`` steps; one train step over b × s tokens — and which
    checks its ranks run: ``common`` the module-wide ones of
    test_torch_lm_mesh.py, ``serve22`` serving on the 2 × 2 mesh too,
    ``ssm`` the SSM layers' planted faults, ``mla`` MLA's planted faults,
    its latent cache and ``BucketedPrefill(mesh=)``. ``min_fsdp_bytes``,
    where set, is the FSDP threshold of the ranks' specs (so that a
    reduced model gathers on "data" the leaves the full one does)."""

    archs: Tuple[str, ...]
    b: int = 4
    s: int = 8
    decode: int = 2
    changes: Tuple[Tuple[str, str, Any], ...] = ()
    common: bool = False
    serve22: bool = False
    ssm: bool = False
    mla: bool = False
    min_fsdp_bytes: Any = None

    @property
    def cache(self) -> int:
        return self.s + self.decode

    def overrides(self, arch) -> Dict[str, Any]:
        return {k: v for a, k, v in self.changes if a == arch}


SUITES = {
    "lm": Suite(("olmoe-1b-7b", "llama3-405b"), common=True),
    # the scan on ssm_scan's path (its plain version on the CPU); zamba2 at
    # 6 layers: 5 mamba2 and the mamba2_attn with the shared block
    "ssm": Suite(("falcon-mamba-7b", "zamba2-7b"), ssm=True,
                 changes=(("falcon-mamba-7b", "ssm_pallas", True), ("zamba2-7b", "ssm_pallas", True),
                          ("zamba2-7b", "n_layers", 6))),
    # prompts of 20 tokens, past the reduced window of 16
    "gemma": Suite(("gemma2-9b", "gemma3-4b"), s=20, serve22=True),
    # 2 layers: mla, then mla_moe (4 heads, 4 experts and the shared one)
    "mla": Suite(("deepseek-v3-671b",), mla=True, min_fsdp_bytes=32 << 10),
}
LM = SUITES["lm"]
ARCHS = LM.archs
#: test_torch_lm_mesh.py's batch: a prefill of B prompts of S tokens, then
#: DECODE steps fed the tokens of ``batch``; one train step over B × S
B, S, DECODE = LM.b, LM.s, LM.decode
CACHE = LM.cache
LR = 1e-3


def config(arch, suite=LM):
    return get_config(arch).reduced(**suite.overrides(arch))


def batch(cfg, seed=0, suite=LM):
    """(tokens (b, s), labels (b, s), the decode steps' tokens (b, decode))."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(suite.b, suite.s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -100
    fed = rng.integers(0, cfg.vocab, size=(suite.b, suite.decode)).astype(np.int32)
    return tokens, labels, fed


def first_block(cfg) -> str:
    """The key of layer 0 in its superblock."""
    return "0:" + stages_of(cfg)[0].pattern[0]


def _shapes(node, prefix=""):
    """{leaf path: shape} of a cache entry."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(node.shape)}


def serve(model, db, mesh=None, suite=LM):
    """Prefill then the suite's decode steps: every step's logits, the
    shapes of layer 0's last cache entry (``k0`` its K, where it has one)
    and the decode step's placed-params cache size."""
    tokens, _, fed = batch(model.cfg, suite=suite)
    prefill = make_prefill_step(model, suite.cache, mesh=mesh, db=db)
    decode = make_decode_step(model, mesh=mesh, db=db)
    logits, caches = prefill({"tokens": torch.as_tensor(tokens)})
    out = [logits.numpy()]
    for i in range(suite.decode):
        logits, caches = decode(torch.as_tensor(fed[:, i:i + 1]), caches, suite.s + i)
        out.append(logits.numpy())
    layer0 = _shapes(caches[0]["scan"][0][first_block(model.cfg)])
    placed = getattr(decode, "_placed_cache", None)
    return {"logits": np.stack(out), "k0": layer0.get("kv/k"), "cache0": layer0,
            "placed": None if placed is None else len(placed)}


class Grads:
    """Records the gradients each Adam update is given (the synced ones
    on a mesh) and the global norm it clips to (on a mesh
    ``Placement.grad_norm``'s, else the same Σ over the whole gradient)."""

    def __enter__(self):
        self.real, self.seen, self.norms = trainer.adam_update, [], []

        def update(params, grads, state, **kw):
            self.seen.append({k: g.detach().clone() for k, g in grads.items()})
            norm = kw.get("grad_norm")
            self.norms.append(float(norm(grads) if norm is not None else
                                    torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))))
            return self.real(params, grads, state, **kw)

        trainer.adam_update = update
        return self

    def __exit__(self, *exc):
        trainer.adam_update = self.real


def train(model, db, mesh=None, suite=LM):
    """One Adam step: the loss, the global norm, the gradients the update
    took and the new parameters, whole."""
    tokens, labels, _ = batch(model.cfg, suite=suite)
    state = init_train_state(model)
    params = {k: v.clone() for k, v in state.params.items()}
    step = make_train_step(model, lr=LR, database=db, mesh=mesh)
    with Grads() as rec:
        new, _, metrics = step(params, state.opt_state,
                               {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)})
    grads = rec.seen[0]
    if mesh is not None:
        place = Placement(model.cfg, mesh)
        grads = {k: place.whole(k, g) for k, g in grads.items()}
        new = {k: place.whole(k, v) for k, v in new.items()}
    return {"loss": float(metrics["loss"]), "total": float(metrics["total"]), "norm": rec.norms[0],
            "grads": {k: g.numpy() for k, g in grads.items()},
            "params": {k: v.numpy() for k, v in new.items()}}


def planted(method, fake, owner=Placement):
    """Plant a fault: ``owner.<method>`` (a ``Placement`` method by
    default) replaced by ``fake``. Returns the undo."""
    real = getattr(owner, method)
    setattr(owner, method, fake)

    def undo():
        setattr(owner, method, real)
    return undo


#: the SSM layers' planted faults: (the kind they apply to, what runs,
#: the Placement method, its fake)
SSM_PLANTS = {
    # x_proj's sum kept forward, its backward sum left out
    "x_proj_backward": ("mamba1", "train", "psum", lambda self, t: self.reduce(t)),
    # B and C gathered with a slicing backward
    "bc_slicing": ("mamba2", "train", "gather_summed", lambda self, t, dim: self.gather_from(t, dim)),
    # the gated norm's Σy² not summed over the ranks
    "norm_unsummed": ("mamba2", "serve", "psum", lambda self, t: t),
    # every rank's Σg² counted whole: the replicated leaves once per rank
    "norm_overcount": (None, "train", "grad_norm", lambda self, grads: torch.sqrt(self.comm.all_reduce(
        self.comm.all_reduce(sum(torch.sum(g.float() ** 2) for g in grads.values()), "model"),
        "data"))),
}


#: MLA's planted faults, each in a train step: (the owner, the method,
#: its fake)
MLA_PLANTS = {
    # the q latent gathered with a slicing backward
    "q_slicing": (Placement, "gather_summed", lambda self, t, dim: self.gather_from(t, dim)),
    # c_kv fed to the rank's heads without copy_to: its gradient each
    # rank's part
    "latent_unsummed": (blocks, "_latent", lambda place, c, r: (c, place.copy_to(r))),
}

#: the model all-reduce of layer 0's wo in an MLA serve on a split model
#: axis: after the lookup's and the q latent's Σx²
MLA_WO_REDUCE = 2


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


#: the archs whose kinds a placement once refused (whisper's enc/dec
#: layers, qwen2-vl's vision prefix), placed now
REFUSED = ("whisper-small", "qwen2-vl-72b")


def refusals(mesh):
    """The once-refused kinds on a mesh: the message of what each raises
    (None where the placement builds, as it must now)."""
    out = {}
    for arch in REFUSED:
        try:
            Placement(get_config(arch).reduced(), mesh)
            out[arch] = None
        except (NotImplementedError, ValueError) as e:
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


def segments_by_hand(cfg, name):
    """The segments that parameter ``name``'s model-axis dimension
    concatenates, from the SSM blocks' layouts (None for a leaf cut in one
    block): ``mamba1``'s ``in_proj`` [x | z]; ``mamba2``'s [z | x | B | C |
    dt] and its conv over [x | B | C]."""
    di, n, leaf = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, name.rsplit(".", 1)[-1]
    if "mamba1" in cfg.pattern and leaf == "in_proj":
        return (di, di)
    if "mamba2" in cfg.pattern and leaf == "in_proj":
        return (di, di, n, n, di // cfg.ssm_head_dim)
    if "mamba2" in cfg.pattern and leaf in ("conv_w", "conv_b"):
        return (di, n, n)
    return None


def shard_by_hand(place, name, t):
    """The rank's shard of the whole parameter ``t``: each dimension its
    spec puts on a mesh axis narrowed to the rank's block, except one that
    concatenates segments, where the rank takes its block of each."""
    widths = segments_by_hand(place.cfg, name)
    for d, e in enumerate(place.specs[name]):
        if e not in ("data", "model") or t.shape[d] % place.size(e):
            continue
        m, r = place.size(e), place.index(e)
        parts = torch.split(t, list(widths), dim=d) if e == "model" and widths else (t,)
        t = torch.cat([q.narrow(d, r * (q.shape[d] // m), q.shape[d] // m) for q in parts], dim=d)
    return t


def shard_checks(place, whole_params):
    """Whether ``Placement.shard`` gives each whole parameter the rank's
    shard by hand, of the shape ``local_shape`` gives."""
    cut = place.shard(whole_params)
    return all(torch.equal(cut[k], shard_by_hand(place, k, v)) and cut[k].shape == place.local_shape(k)
               for k, v in whole_params.items())


def arch_checks(arch, weights, suite, m14, m22):
    """One arch's record (module docstring)."""
    cfg = config(arch, suite)
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), weights)
    one = repro_torch.Database(device="cpu")
    rec = {"one": {"serve": serve(model, one, suite=suite), "train": train(model, one, suite=suite)}}
    db14 = repro_torch.Database(device="cpu", mesh=m14)
    collectives.reset_collectives()
    rec["mesh"] = serve(model, db14, suite=suite)
    rec["collectives"] = collectives.last_collectives()
    rec["again"] = serve(model, repro_torch.Database(device="cpu", mesh=m14), suite=suite)["logits"]
    undo = drop_model_all_reduce()
    try:
        rec["planted"] = serve(model, db14, suite=suite)["logits"]
    finally:
        undo()
    place = Placement(cfg, m14)
    rec["cache0"] = _shapes(init_cache(cfg, suite.b, suite.cache, "cpu", place=place)[0]["scan"][0][
        first_block(cfg)])
    rec["cache_k"] = rec["cache0"].get("kv/k")
    # the model built on the mesh: its own shards, cut as it is drawn
    own = build_model(cfg, device="cpu", seed=1, mesh=m14)
    whole_params = {n: p.detach() for n, p in build_model(cfg, device="cpu", seed=1).named_parameters()}
    rec["built_shards"] = all(torch.equal(p, place.cut(n, whole_params[n]))
                              for n, p in own.named_parameters())
    rec["whole_of_cut"] = all(torch.equal(place.whole(n, place.cut(n, p)), p)
                              for n, p in whole_params.items())
    rec["segments"] = sorted(place.segments)
    rec["shard"] = {"1x4": shard_checks(place, whole_params),
                    "2x2": shard_checks(Placement(cfg, m22), whole_params)}
    rec["train22"] = train(model, repro_torch.Database(device="cpu"), m22, suite=suite)
    if suite.serve22:
        rec["mesh22"] = serve(model, repro_torch.Database(device="cpu", mesh=m22), suite=suite)
        rec["cache22"] = _shapes(init_cache(cfg, suite.b, suite.cache, "cpu", place=Placement(cfg, m22))[
            0]["scan"][0][first_block(cfg)])
    if suite.ssm:
        rec["plants"] = {}
        for what, (kind, run, method, fake) in SSM_PLANTS.items():
            if kind not in (None, cfg.pattern[0]):
                continue
            undo = planted(method, fake)
            try:
                got = (train(model, repro_torch.Database(device="cpu"), m22, suite=suite) if run == "train"
                       else serve(model, db14, suite=suite))
            finally:
                undo()
            rec["plants"][what] = ({"norm": got["norm"], "grads": got["grads"]} if run == "train"
                                   else got["logits"])
    if suite.mla:
        rec.update(mla_checks(model, suite, db14, m14, m22))
    return rec


def latent_cache(model, db, suite):
    """Layer 0's latent cache {"c", "r"} after the suite's prefill under
    ``db`` (on its mesh, if it has one)."""
    tokens, _, _ = batch(model.cfg, suite=suite)
    _, caches = make_prefill_step(model, suite.cache, db=db)({"tokens": torch.as_tensor(tokens)})
    return {k: v.numpy() for k, v in caches[0]["scan"][0][first_block(model.cfg)]["kv"].items()}


def mla_checks(model, suite, db14, m14, m22):
    """MLA's own checks: the prefill through ``BucketedPrefill(mesh=)``
    (on a mesh-less session: the mesh is the keyword's), the latent cache
    on the mesh and off it, the wo all-reduce of layer 0 dropped, and the
    planted faults of ``MLA_PLANTS``."""
    tokens, _, _ = batch(model.cfg, suite=suite)
    pre = BucketedPrefill(model, suite.cache, db=repro_torch.Database(device="cpu"), mesh=m14,
                          buckets=[(suite.b, suite.s)])
    logits, _ = pre.prefill(None, {"tokens": torch.as_tensor(tokens)})
    out = {"bucketed": logits.numpy(),
           "latent": latent_cache(model, db14, suite),
           "latent_one": latent_cache(model, repro_torch.Database(device="cpu"), suite)}
    undo = drop_model_all_reduce(MLA_WO_REDUCE)
    try:
        out["wo_dropped"] = serve(model, db14, suite=suite)["logits"]
    finally:
        undo()
    out["plants"] = {}
    for what, (owner, method, fake) in MLA_PLANTS.items():
        undo = planted(method, fake, owner)
        try:
            out["plants"][what] = train(model, repro_torch.Database(device="cpu"), m22, suite=suite)["grads"]
        finally:
            undo()
    return out


def run_checks(rank: int, weights, suite: str = "lm"):
    torch.manual_seed(0)
    sw = SUITES[suite]
    if sw.min_fsdp_bytes is not None:
        sharding.param_pspec.__kwdefaults__["min_fsdp_bytes"] = sw.min_fsdp_bytes
    m14 = make_host_mesh(model=4, device_type="cpu")
    m22 = make_host_mesh(model=2, device_type="cpu")
    out = {"rank": rank}
    for arch in sw.archs:
        out[arch] = arch_checks(arch, weights[arch], sw, m14, m22)
    if not sw.common:
        return out
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
    out["shard_params"] = shard_checks(place, whole_params)
    # the layouts a mesh-compiled step committed the catalog's relations to
    g, _, _ = torch_mesh_workers.problem()
    qdb = repro_torch.Database(device="cpu", mesh=m14)
    torch_mesh_workers.query_step(qdb, g)
    out["catalog"] = {k: (tuple(v.spec), [str(p) for p in v.placements])
                      for k, v in catalog_shardings(qdb).items()}
    out["layouts"] = {k: None if qdb.layout(k) is None else tuple(qdb.layout(k))
                      for k in ("Edge", "Node")}
    try:
        make_train_step(build_model(config("whisper-small"), device="cpu"), mesh=m22)
        out["train_refusal"] = None
    except (NotImplementedError, ValueError) as e:
        out["train_refusal"] = str(e)
    return out


def one_rank(rank: int, suite: str = "lm"):
    """The steps on a one-rank ("model",) mesh against the mesh-less ones,
    bit for bit, and an endpoint on it: (arch, part) → equal. A one-rank
    mesh admits each of the suite's archs (``admitted``)."""
    sw = SUITES[suite]
    mesh = make_host_mesh(device_type="cpu")
    out = {}
    for arch in sw.archs:
        model = build_model(config(arch, sw), device="cpu", seed=1)
        out[arch, "admitted"] = Placement(model.cfg, mesh).size("model") == 1
        a = serve(model, repro_torch.Database(device="cpu"), suite=sw)
        b = serve(model, repro_torch.Database(device="cpu", mesh=mesh), suite=sw)
        out[arch, "serve"] = np.array_equal(a["logits"], b["logits"])
        a = train(model, repro_torch.Database(device="cpu"), suite=sw)
        b = train(model, repro_torch.Database(device="cpu", mesh="host"), suite=sw)
        out[arch, "train"] = (a["loss"] == b["loss"] and a["total"] == b["total"]
                              and a["norm"] == b["norm"]
                              and all(np.array_equal(a[part][k], b[part][k])
                                      for part in ("grads", "params") for k in a[part]))
        # an endpoint on a session whose mesh has one rank serves through
        # the steps on that mesh: the same tokens as a mesh-less session's
        tokens, _, _ = batch(model.cfg, suite=sw)
        served = []
        for db in (repro_torch.Database(device="cpu"), repro_torch.Database(device="cpu", mesh=mesh)):
            db.register_model("lm", model, dict(model.named_parameters()))
            ep = db.endpoint("lm", cache_len=sw.cache, buckets=[(1, sw.s)])
            served.append(asyncio.run(ep.submit(tokens[0], max_new_tokens=sw.decode)).token_ids.tolist())
        out[arch, "endpoint"] = served[0] == served[1] and len(served[0]) == sw.decode
    return out
