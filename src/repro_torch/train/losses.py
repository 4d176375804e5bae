"""Losses. Cross entropy computed in f32 with label masking (-100)."""

from __future__ import annotations

import torch


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B,S,V) f32; labels (B,S) integer, -100 = ignore.

    The gold logit is read with a ``gather``, where the reference takes a
    masked reduction over V (which keeps vocab-parallel logits sharded on
    a mesh); a sum of one logit and zeros is that logit, so the two are
    equal."""
    nll, count = lm_nll(logits, labels)
    return nll / torch.clamp(count, min=1)


def lm_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(Σ of the negative log-likelihoods, count of the labels) over the
    labels that are not -100: ``lm_loss``'s two halves. On a mesh each data
    rank sums its rows, and the count of the whole batch divides each
    rank's sum (``train/trainer.py``); the logits are whole over the
    vocabulary there (the head gathers them), so the loss is the
    one-device loss's formula on each rank's rows."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum(), valid.sum()
