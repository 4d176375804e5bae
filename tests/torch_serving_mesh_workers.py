"""Rank programs of tests/test_torch_serving_mesh.py: an endpoint over 4
``gloo`` ranks on the CPU (``repro_torch.launch.mesh.start_ranks``), a
1 × 4 (data × model) mesh. Rank 0 serves; ranks 1-3 run
``Endpoint.follow()``. Imports no JAX: the test module runs the reference
meanwhile.

``traffic`` is the one burst sequence every endpoint of the test serves
(the mesh's, the mesh-less port's, and through ``jax_traffic`` of the test
module the reference's): warmup; 4 concurrent requests with
``max_new_tokens`` 5, 6, 7, 8, so slots free in slot order and the decode
bucket drops from 4 to 2 (a compaction that moves rows) to 1, with an EOS
token that stops one of them early; then a hot swap (the bare name's latest
version becomes ``v2``, ``ln_f`` perturbed) and 2 requests submitted apart
within ``gather_window``, which form one batch.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import torch

import repro_torch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.serving import make_decode_step, make_prefill_step
from repro_torch.serving.service import FollowTimeout

#: the archs: olmoe (attention + MoE) and one dense arch, gemma3 at 6
#: layers (5 local + 1 global; prompts past nothing, decode past its window
#: of 16 at the last steps)
ARCHS = ("olmoe-1b-7b", "gemma3-4b")
LAYERS = {"gemma3-4b": 6}
SEQ, BUCKETS = 12, [(1, 12), (2, 12), (4, 12)]
BURST, PAIR = (5, 6, 7, 8), (3, 4)
CACHE_LEN = SEQ + max(BURST)
GATHER_WINDOW = 0.5
#: a follower's wait for a header in the planted withheld-header run
SHORT_WAIT = 1.0
#: a follower's wait in the quiet run, where rank 0 waits QUIET seconds
#: between two requests (its scheduler sending "idle" headers meanwhile)
IDLE_WAIT, QUIET = 2.0, 5.0


def config(arch):
    return get_config(arch).reduced(**({"n_layers": LAYERS[arch]} if arch in LAYERS else {}))


def prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=SEQ).astype(np.int32) for _ in range(len(BURST) + len(PAIR))]


def swapped(weights):
    """The hot swap's weights: ``ln_f`` scaled by a seeded factor per
    channel."""
    rng = np.random.default_rng(7)
    out = dict(weights)
    out["ln_f"] = (np.asarray(weights["ln_f"]) * rng.uniform(0.5, 1.5, size=np.shape(weights["ln_f"]))
                   ).astype(np.asarray(weights["ln_f"]).dtype)
    return out


def params_of(cfg, weights):
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), weights)
    return model, {k: p.detach() for k, p in model.named_parameters()}


def eos_token(model, params, prompt) -> int:
    """The token the first request generates second: the EOS of the
    traffic, so that request stops early."""
    db = repro_torch.Database(device="cpu")
    logits, caches = make_prefill_step(model, CACHE_LEN, db=db)({"tokens": torch.tensor(prompt)[None]}, params)
    first = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    logits, _ = make_decode_step(model, db=db)(first, caches, SEQ, params)
    return int(logits[0, -1].argmax())


def capture(ep, log):
    """Record every prefill's and decode step's last-position logits of
    ``ep`` (warmup's included), in call order."""
    prefill_for, decode_exec = ep._prefill_for, ep._decode_exec

    def prefill_of(entry):
        pre = prefill_for(entry)
        if not getattr(pre, "_captured", False):
            real = pre.prefill

            def prefill(params, batch):
                logits, caches = real(params, batch)
                log.append(("prefill", logits[:, -1].detach().cpu().numpy().copy()))
                return logits, caches

            pre.prefill, pre._captured = prefill, True
        return pre

    def decode_of(entry, bucket):
        step = decode_exec(entry, bucket)

        def decode(*args):
            logits, caches = step(*args)
            log.append(("decode", logits[:, -1].detach().cpu().numpy().copy()))
            return logits, caches

        return decode

    ep._prefill_for, ep._decode_exec = prefill_of, decode_of


async def traffic(ep, register_v2, ps):
    """The burst, the hot swap and the staggered pair (module docstring):
    each completion's tokens and model, in submit order."""
    outs = await asyncio.gather(*[ep.submit(p, max_new_tokens=n) for p, n in zip(ps, BURST)])
    register_v2()

    async def late(p, n, delay):
        await asyncio.sleep(delay)
        return await ep.submit(p, max_new_tokens=n)

    outs += await asyncio.gather(*[late(p, n, i * GATHER_WINDOW / 4)
                                   for i, (p, n) in enumerate(zip(ps[len(BURST):], PAIR))])
    return [(o.token_ids.tolist(), o.model) for o in outs]


def serve(db, model, params, params_v2, ps, eos, *, follower=False, plant=None):
    """One endpoint over ``db`` through the traffic: rank 0 (or a
    mesh-less session) serves and records its completions; a follower
    registers both versions up front and follows. Returns the logits log,
    the serve counters and the completions or ``follow()``'s summary."""
    db.register_model("lm", model, params)
    if follower:
        db.register_model("lm", model, params_v2)
    ep = db.endpoint("lm", cache_len=CACHE_LEN, buckets=BUCKETS, gather_window=GATHER_WINDOW,
                     eos_token=eos)
    log = []
    capture(ep, log)
    if plant is not None:
        plant(ep)
    out = {"log": log}
    if follower:
        out["followed"] = ep.follow()
    else:
        async def run():
            ep.warmup()
            got = await traffic(ep, lambda: db.register_model("lm", model, params_v2), ps)
            await ep.aclose()
            return got
        out["completions"] = asyncio.run(run())
    c = db.counters()["serve"]
    out["counters"] = {"prefill": dict(c["prefill"]), "decode": {
        k: c["decode"][k] for k in ("compiles", "traces", "steps", "rebuckets")}, "batches": c["batches"]}
    out["serve"] = db.counters()["serve"]
    return out


def skip_a_compaction(ep):
    """The planted follower fault: its first compaction keeps the cache
    rows in place (the bucket drops, the live rows are not moved)."""
    real = ep._receive
    state = {"skipped": False}

    def receive():
        header, batch = real()
        if header["op"] == "compact" and not state["skipped"] and header["idx"] != list(range(header["bucket"])):
            state["skipped"] = True
            header = dict(header, idx=list(range(header["bucket"])))
        return header, batch

    ep._receive = receive


def run_checks(rank: int, weights, eos):
    import torch.distributed as dist

    from repro_torch.launch import collectives

    mesh = make_host_mesh(model=4, device_type="cpu")
    out = {"rank": rank}
    for arch in ARCHS:
        cfg = config(arch)
        model, params = params_of(cfg, weights[arch])
        _, params_v2 = params_of(cfg, swapped(weights[arch]))
        ps = prompts(cfg.vocab)
        collectives.reset_collectives()
        db = repro_torch.Database(device="cpu", mesh=mesh)
        rec = serve(db, model, params, params_v2, ps, eos[arch], follower=rank != 0)
        rec["collectives"] = collectives.last_collectives()
        # planted: rank 3 keeps its cache rows at one compaction
        bad = serve(repro_torch.Database(device="cpu", mesh=mesh), model, params, params_v2, ps, eos[arch],
                    follower=rank != 0, plant=skip_a_compaction if rank == 3 else None)
        rec["planted_log"] = bad["log"]
        out[arch] = rec
    # planted: rank 0 withholds every header of an endpoint whose followers
    # wait SHORT_WAIT seconds
    cfg = config(ARCHS[0])
    model, params = params_of(cfg, weights[ARCHS[0]])
    db = repro_torch.Database(device="cpu", mesh=mesh)
    db.register_model("lm", model, params)
    ep = db.endpoint("lm", cache_len=CACHE_LEN, buckets=BUCKETS, follow_timeout=SHORT_WAIT)
    withheld = {"raised": None, "seconds": None}
    if rank != 0:
        t0 = time.perf_counter()
        try:
            ep.follow()
        except FollowTimeout as e:
            withheld["raised"] = str(e)
        withheld["seconds"] = time.perf_counter() - t0
    dist.barrier()
    out["withheld"] = withheld
    # a quiet spell longer than the followers' wait: rank 0's scheduler
    # keeps them following with "idle" headers
    ep = db.endpoint("lm", cache_len=CACHE_LEN, buckets=BUCKETS, follow_timeout=IDLE_WAIT)
    quiet = {"raised": None}
    if rank == 0:
        async def spell():
            p = prompts(cfg.vocab)[0]
            got = [(await ep.submit(p, max_new_tokens=2)).token_ids.tolist()]
            await asyncio.sleep(QUIET)
            got.append((await ep.submit(p, max_new_tokens=2)).token_ids.tolist())
            await ep.aclose()
            return got
        quiet["tokens"] = asyncio.run(spell())
    else:
        try:
            quiet["followed"] = ep.follow()
        except FollowTimeout as e:
            quiet["raised"] = str(e)
    quiet["left"] = ep._headers is None
    dist.barrier()
    out["quiet"] = quiet
    # the refusals of a follower's front door and a leader's follow()
    refused = {}
    for what, call in (("submit", lambda: asyncio.run(ep.submit(np.zeros(SEQ, np.int32)))),
                       ("warmup", ep.warmup), ("follow", ep.follow)):
        if (what == "follow") == (rank == 0):
            try:
                call()
            except ValueError as e:
                refused[what] = str(e)
    # a mesh with data ranks: the slot pool needs the whole batch's rows
    try:
        db.use_mesh(make_host_mesh(model=2, device_type="cpu")).endpoint("lm", cache_len=CACHE_LEN)
    except NotImplementedError as e:
        refused["data_axes"] = str(e)
    out["refused"] = refused
    return out
