"""End-to-end LM training: train a ~100M-parameter OLMoE-family
model (the paper-technique-heavy MoE arch) on the synthetic pipeline, with
checkpointing. Every parameter-bearing product's backward is an
RA-autodiff-generated gradient query (through the relational
``autograd.Function``s inside the model), and the embedding's is the
mirrored gather/segment-sum query.

Presets:
  --preset smoke  2-layer d=256 model, 20 steps        (seconds)
  --preset 100m   8-layer d=512 16-expert MoE ≈ 100M   (the full run)

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_train --preset smoke --device cpu
      PYTHONPATH=src python -m repro_torch.examples.lm_train --preset 100m --steps 300

It runs on the CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import repro_torch
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.models import build_model
from repro_torch.train import init_train_state, make_train_step


def make_cfg(preset: str):
    base = get_config("olmoe-1b-7b")
    if preset == "smoke":
        return base.reduced()
    # ~100M active-param MoE in the olmoe family
    return base.reduced(
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=1024,
        vocab=8192,
        n_experts=16,
        top_k=4,
        head_dim=64,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("smoke", "100m"), default="smoke")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default=None, help='default "cuda"')
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Train; returns the losses of every step."""
    args = parse_args(argv)
    steps = args.steps or (20 if args.preset == "smoke" else 300)

    cfg = make_cfg(args.preset)
    model = build_model(cfg, device=args.device)
    state = init_train_state(model)
    n_params = sum(p.numel() for p in state.params.values())
    print(f"preset={args.preset}  params={n_params/1e6:.1f}M  "
          f"layers={cfg.n_layers} d={cfg.d_model} experts={cfg.n_experts}  device={model.device}")

    # One session for the run: the relational ops inside the model
    # dispatch through it.
    db = repro_torch.Database(device=model.device)
    step_fn = make_train_step(model, lr=args.lr, database=db)
    batches = synthetic_lm_batches(cfg, args.batch, args.seq, seed=0, device=model.device)
    params, opt_state = state.params, state.opt_state

    t_start = time.time()
    losses = []
    for i in range(steps):
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, next(batches))
        losses.append(float(metrics["loss"]))
        if i % 10 == 0 or i == steps - 1:
            tok_s = args.batch * args.seq / (time.time() - t0)
            print(f"step {i:4d}  loss {losses[-1]:.4f}  aux {float(metrics['aux']):.4f}"
                  f"  {tok_s:,.0f} tok/s")
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, i + 1, params, opt_state)
            print(f"  checkpoint → {path}")
    wall = time.time() - t_start
    print(f"\n{steps} steps in {wall:.0f}s "
          f"({steps * args.batch * args.seq / wall:,.0f} tok/s avg)")
    if not (math.isfinite(losses[-1]) and losses[-1] < losses[0]):
        raise AssertionError("loss did not improve")
    print(f"loss {losses[0]:.3f} → {losses[-1]:.3f}  ok.")
    return losses


if __name__ == "__main__":
    main()
