"""Synthetic data pipeline: deterministic token batches. The reference's
modality stubs (frame/patch embeddings for audio/vlm backbones) wait for
their slices.

The reference's numpy draws, in the same order, so one seed gives both
packages the same tokens and labels; the arrays then go onto an explicit
device ("cuda" unless the caller passes another)."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.session import resolve_device


def batch_for(cfg, batch: int, seq: int, rng: np.random.Generator, device=None) -> Dict:
    """One training batch of tokens and labels for ``cfg``, on ``device``."""
    dev = resolve_device(device, owner="repro_torch.data.batch_for")

    def put(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    if cfg.encoder_layers or cfg.vis_seq:
        raise NotImplementedError(
            "batch_for: audio frames (whisper) and image patches (qwen2-vl) are not "
            "ported yet (ROADMAP.md, queue 1, item 6.4)"
        )
    out = {"tokens": put(rng.integers(0, cfg.vocab, size=(batch, seq)), torch.int32)}
    out["labels"] = put(rng.integers(0, cfg.vocab, size=(batch, seq)), torch.int32)
    return out


def synthetic_lm_batches(cfg, batch: int, seq: int, seed: int = 0, device=None) -> Iterator[Dict]:
    rng = np.random.default_rng(seed)
    while True:
        yield batch_for(cfg, batch, seq, rng, device)
