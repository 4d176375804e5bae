"""Rank programs of tests/test_torch_serving_data_mesh.py: an endpoint over
4 ``gloo`` ranks on the CPU (``repro_torch.launch.mesh.start_ranks``) on
meshes whose batch fold has more than one rank: 2 × 2 (data × model), 4 × 1
and 2 × 1 × 2 (pod × data × model). Rank 0 serves; ranks 1-3 run
``Endpoint.follow()``. Imports no JAX: the test module runs the reference
meanwhile.

Each run serves ``torch_serving_mesh_workers.traffic`` (warmup; a burst of
4 whose decode bucket drops 4 → 2 → 1, an EOS stop, a hot swap, a
staggered pair). On a fold of 2 ranks a rank holds 2 of bucket 4's cache
rows and 1 of bucket 2's, and bucket 1 whole; on a fold of 4 it holds 1 of
bucket 4's and buckets 2 and 1 whole. The compaction 4 → 2 keeps old rows 2
and 3, which the second rank of a fold of 2 holds.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

import repro_torch
import torch_serving_mesh_workers as W
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving import BucketedPrefill, make_decode_step, service

# the module: the package's ``serve`` is the front door's function
serve_mod = importlib.import_module("repro_torch.serving.serve")

#: mesh name → ``make_host_mesh`` arguments on 4 ranks
MESHES = {"2x2": {"model": 2}, "4x1": {"model": 1}, "2x1x2": {"model": 2, "pod": 2}}
#: (mesh, arch) of each served run: zamba2 at 6 layers (5 mamba2, then the
#: mamba2_attn with the shared block), gemma3 at 6 (5 local, 1 global)
RUNS = (("2x2", "olmoe-1b-7b"), ("2x2", "gemma3-4b"), ("2x2", "zamba2-7b"),
        ("4x1", "olmoe-1b-7b"), ("2x1x2", "olmoe-1b-7b"))
ARCHS = tuple(sorted({a for _, a in RUNS}))
LAYERS = {"gemma3-4b": 6, "zamba2-7b": 6}
#: the BucketedPrefill case: 3 prompts in the bucket of 4, then DECODE steps
PREFILL_BUCKET, PREFILL_ROWS, DECODE = 4, 3, 4


def config(arch):
    return get_config(arch).reduced(**({"n_layers": LAYERS[arch]} if arch in LAYERS else {}))


def tiled_rows(t, place):
    """The planted gather: the rank's own rows in every rank's place."""
    return t.repeat(place.size(place.batch), *([1] * (t.dim() - 1)))


@contextlib.contextmanager
def counted_gathers():
    """While active, the rows each of the mover's gathers holds before
    and after, in call order."""
    real, seen = serve_mod._gather_rows, []

    def gather(t, place):
        out = real(t, place)
        seen.append((t.shape[0], out.shape[0]))
        return out

    serve_mod._gather_rows = gather
    try:
        yield seen
    finally:
        serve_mod._gather_rows = real


@contextlib.contextmanager
def no_exchange_compaction():
    """While active, each rank's compaction keeps its own rows and
    exchanges nothing across the batch fold: where it would gather the old
    rows, every rank's place holds its own (the planted fault)."""
    real_take = service._take_cache_batch

    def take(caches, idx, bucket_b, place=None):
        real_gather = serve_mod._gather_rows
        serve_mod._gather_rows = tiled_rows
        try:
            return real_take(caches, idx, bucket_b, place)
        finally:
            serve_mod._gather_rows = real_gather

    service._take_cache_batch = take
    try:
        yield
    finally:
        service._take_cache_batch = real_take


def prefill_case(model, params, mesh):
    """``BucketedPrefill`` on ``mesh`` (None: off one): PREFILL_ROWS prompts
    in the bucket of PREFILL_BUCKET, then DECODE steps fed seeded tokens.
    Each step's logits, or the error a step raised."""
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, model.cfg.vocab, size=(PREFILL_ROWS, W.SEQ)), dtype=torch.int32)
    fed = torch.as_tensor(rng.integers(0, model.cfg.vocab, size=(PREFILL_ROWS, DECODE)), dtype=torch.int32)
    db = repro_torch.Database(device="cpu")
    pre = BucketedPrefill(model, W.CACHE_LEN, db=db, buckets=[(PREFILL_BUCKET, W.SEQ)], mesh=mesh)
    step = make_decode_step(model, db=db, mesh=mesh)
    out = []
    try:
        logits, caches = pre.prefill(params, {"tokens": tokens})
        out.append(logits[:, -1].numpy().copy())
        for i in range(DECODE):
            logits, caches = step(fed[:, i:i + 1], caches, W.SEQ + i, params)
            out.append(logits[:, -1].numpy().copy())
    except Exception as e:  # recorded: the test names the step that failed
        return {"logits": out, "error": repr(e)}
    return {"logits": out, "error": None}


def run_checks(rank: int, weights, eos):
    from repro_torch.launch import collectives

    torch.set_num_threads(1)
    meshes = {name: make_host_mesh(device_type="cpu", **kw) for name, kw in MESHES.items()}
    out = {"rank": rank}
    for mesh_name, arch in RUNS:
        mesh = meshes[mesh_name]
        cfg = config(arch)
        model, params = W.params_of(cfg, weights[arch])
        _, params_v2 = W.params_of(cfg, W.swapped(weights[arch]))
        ps = W.prompts(cfg.vocab)
        collectives.reset_collectives()
        with counted_gathers() as gathers:
            rec = W.serve(repro_torch.Database(device="cpu", mesh=mesh), model, params, params_v2, ps,
                          eos[arch], follower=rank != 0)
        rec["collectives"], rec["gathers"] = collectives.last_collectives(), gathers
        with no_exchange_compaction():
            bad = W.serve(repro_torch.Database(device="cpu", mesh=mesh), model, params, params_v2, ps,
                          eos[arch], follower=rank != 0)
        rec["planted_log"] = bad["log"]
        out[(mesh_name, arch)] = rec
    cfg = config("olmoe-1b-7b")
    model, params = W.params_of(cfg, weights["olmoe-1b-7b"])
    out["prefill"] = prefill_case(model, params, meshes["2x2"])
    return out
