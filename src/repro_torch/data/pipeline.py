"""Synthetic data pipeline: deterministic token batches plus the
modality-stub inputs (frame/patch embeddings) for audio/vlm backbones.

The reference's numpy draws, in the same order, so one seed gives both
packages the same tokens and labels; the arrays then go onto an explicit
device ("cuda" unless the caller passes another)."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.session import resolve_device


def batch_for(cfg, batch: int, seq: int, rng: np.random.Generator, device=None) -> Dict:
    """One training batch matching ``cfg``'s modality, on ``device``:
    tokens and labels, whisper's ``frames`` (B, enc_seq, d_model) and
    qwen2-vl's ``patches`` (B, vis_seq, d_model), standard normals drawn
    in f32 and cast to ``cfg.dtype``."""
    dev = resolve_device(device, owner="repro_torch.data.batch_for")

    def put(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    out = {"tokens": put(rng.integers(0, cfg.vocab, size=(batch, seq)), torch.int32)}
    out["labels"] = put(rng.integers(0, cfg.vocab, size=(batch, seq)), torch.int32)
    dt = getattr(torch, cfg.dtype)
    if cfg.encoder_layers:
        out["frames"] = put(rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32), dt)
    if cfg.vis_seq:
        out["patches"] = put(rng.normal(size=(batch, cfg.vis_seq, cfg.d_model)).astype(np.float32), dt)
    return out


def synthetic_lm_batches(cfg, batch: int, seq: int, seed: int = 0, device=None) -> Iterator[Dict]:
    rng = np.random.default_rng(seed)
    while True:
        yield batch_for(cfg, batch, seq, rng, device)
