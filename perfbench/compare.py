"""The comparisons that decide ``correct``: what the program produced
against the plain reference's f64 values, one number each (the limits are
in ``perfbench/limits/<cell>.json``)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

#: leaves whose reference gradient is under this share of the median leaf's
#: are nought to rounding: Adam moves them by round-off alone
QUIET_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def worst_leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], counted: List[str]) -> float:
    """The largest gap between a leaf's norm in ``got`` and in ``want``, over
    the larger of that leaf's reference norm and the median leaf's."""
    norms = {k: _norm(want[k]) for k in counted}
    med = statistics.median(norms.values())
    worst = 0.0
    for k in counted:
        if tuple(got[k].shape) != tuple(want[k].shape):
            return math.inf
        worst = max(worst, abs(_norm(got[k]) - norms[k]) / max(norms[k], med))
    return worst


def train_gaps(obs: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    """A training run's first steps against the reference's: ``loss``, the
    largest relative gap of a step's loss; ``grad1``, the worst leaf's gap
    of the first gradient's norm; ``change``, the worst leaf's gap of the
    norm of the parameters' change over the steps. Leaves whose reference
    gradient is under ``QUIET_LEAF`` of the median leaf's are left out."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(obs["losses"], ref["losses"])]
    if len(losses) != len(ref["losses"]):
        return {"loss": math.inf, "grad1": math.inf, "change": math.inf}
    gnorm = {k: _norm(g) for k, g in ref["grad1"].items()}
    med = statistics.median(gnorm.values())
    counted = [k for k, v in gnorm.items() if v >= QUIET_LEAF * med]
    return {
        "loss": max(losses),
        "grad1": worst_leaf_gap(obs["grad1"], ref["grad1"], counted),
        "change": worst_leaf_gap(obs["change"], ref["change"], counted),
    }


def worst_over_rms(got: torch.Tensor, want: torch.Tensor, rows: int = 1 << 20) -> float:
    """max |got - want| / rms(want), every entry compared, in f64, in blocks
    of ``rows`` moved to ``want``'s device; inf for another shape or a
    value that is not finite."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    worst, sq = 0.0, 0.0
    for r0 in range(0, want.shape[0], rows):
        w = want[r0:r0 + rows].double()
        g = got[r0:r0 + rows].to(w.device).double()
        worst = max(worst, float((g - w).abs().max()) if g.numel() else 0.0)
        sq += float((w * w).sum())
    rms = math.sqrt(sq / max(want.numel(), 1))
    if not math.isfinite(worst):
        return math.inf
    return worst / rms if rms > 0 else (0.0 if worst == 0 else math.inf)


def query_gaps(obs: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    """A gradient query's answers against the reference's: ``loss``, the
    largest relative gap of any step's loss; ``dnode`` and ``dedge``, the
    worst entry's gap over the reference's root mean square, for the last
    step's gradients where it has them (dEdge in the order the reference
    works out)."""
    losses = [abs(v - ref["loss"]) / abs(ref["loss"]) if math.isfinite(v) else math.inf
              for v in obs["losses"]]
    gaps = {"loss": max(losses) if losses else math.inf}
    for name in ("dnode", "dedge"):
        if obs.get(name) is not None:
            gaps[name] = worst_over_rms(obs[name], ref[name])
    return gaps
