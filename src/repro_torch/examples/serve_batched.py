"""Serving example: concurrent single-prompt requests through the async
serving front door — ``db.endpoint`` (serving/service.py).

The model is registered in the session catalog (``db.register_model``),
the endpoint is warmed (one prefill step per (batch, seq) bucket, one
decode step per batch bucket, each built and run once), and then a burst
of concurrent requests is submitted. The endpoint coalesces them into
bucketed batches (continuous batching), decodes them as a slot pool with
early release + compaction, and the ``db.counters()`` tree shows what
happened.

Presets:
  --preset reduced  2 layers, d_model 256, vocab 512 (seconds on a CPU)
  --preset full     the published widths and depth, in f32 (on the card
                    only: 27.7 GB of weights for olmoe-1b-7b, 29 GB for
                    falcon-mamba-7b, 27.0 GB for zamba2-7b)

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
      PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch zamba2-7b
      [--requests 6] [--prompt-len 32] [--gen 16] [--preset full]

It runs on the CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time

import numpy as np

import repro_torch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model


def make_cfg(arch: str, preset: str):
    cfg = get_config(arch)
    if preset == "reduced":
        return cfg.reduced()
    # the cuda tier's blocked_matmul admits f32 only
    return dataclasses.replace(cfg, dtype="float32")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmoe-1b-7b")
    ap.add_argument("--preset", choices=("reduced", "full"), default="reduced")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help='default "cuda"')
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Serve one burst; returns the completions."""
    args = parse_args(argv)
    cfg = make_cfg(args.arch, args.preset)
    model = build_model(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(0)
    seq = args.prompt_len

    db = repro_torch.Database(model.device, max_cache_entries=16)
    db.register_model("lm", model, dict(model.named_parameters()))   # -> lm@v1
    ep = db.endpoint(
        "lm",
        cache_len=seq + args.gen,
        buckets=[(1, seq), (2, seq), (args.requests, seq)],
    )

    t0 = time.time()
    ep.warmup()
    print(f"arch={args.arch} ({args.preset})  device={model.device}  warmup "
          f"{time.time() - t0:.1f}s (prefill buckets "
          f"{sorted({(1, seq), (2, seq), (args.requests, seq)})}, decode buckets "
          f"{ep.decode_buckets})")

    prompts = [rng.integers(0, cfg.vocab, size=seq) for _ in range(args.requests)]

    async def burst():
        # concurrent submits: the endpoint coalesces whatever is in
        # flight into one bucketed prefill + slot-pooled decode
        return await asyncio.gather(*[
            ep.submit(p, max_new_tokens=args.gen - (i % 3))
            for i, p in enumerate(prompts)
        ])

    t0 = time.time()
    outs = asyncio.run(burst())
    dt = time.time() - t0
    n_tok = sum(len(o.token_ids) for o in outs)
    print(f"served {len(outs)} requests / {n_tok} tokens in {dt * 1e3:.0f} ms "
          f"({n_tok / max(dt, 1e-9):,.0f} tok/s)")
    for o in outs[:2]:
        print(f"  {o.model} prompt={o.prompt_len} latency={o.latency * 1e3:.0f}ms ->",
              o.token_ids.tolist())

    c = db.counters()
    print("serve counters:", json.dumps(c["serve"], indent=1))
    if c["serve"]["completed"] != args.requests:
        raise AssertionError(f"{c['serve']['completed']} of {args.requests} requests completed")
    if args.requests > 1 and c["serve"]["batches"] >= args.requests:
        raise AssertionError("no requests were coalesced")
    for o in outs:
        if not (np.all(o.token_ids >= 0) and np.all(o.token_ids < cfg.vocab)):
            raise AssertionError("a token outside the vocabulary")
    print("ok.")
    return outs


if __name__ == "__main__":
    main()
