"""Size and statistics estimates over FRA graphs — the estimator half of
the reference's distribution planner.

``RelationStats`` is what the ``Database`` catalog tracks per relation
(``relation.measure_stats``); ``estimate_graph`` walks a query leaves-first
and estimates each node's bytes, COO-ness, distinct key counts and
histograms; ``agg_shrink`` is the Σ output-size rule. The rewrite stage
(``core/rewrite.py``) gates its rules on these numbers. Choosing a physical
plan per join across devices is the mesh half, which belongs to the
multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import fra
from .keys import In, L, R
from .relation import CooRelation, DenseRelation

#: equi-width buckets per key column in ``RelationStats.hist`` (see
#: ``relation.measure_stats``) — coarse on purpose: the histograms only
#: feed the rewrite stage's join output-size estimate, and a snapshot of
#: them rides in the lowering cache key.
HIST_BUCKETS = 8


@dataclass(frozen=True)
class RelationStats:
    """Tracked key-domain statistics for one relation — what a database
    catalog stores and the optimizer consults per query. Produced by
    ``relation.measure_stats`` (refreshed on ``Database.put``), consumed
    by the estimator below (``estimate_graph``) and the rewrite gate:

    * ``distinct`` — distinct key values per key column. Replaces the
      1/8-per-dropped-key Agg output estimate (a Σ dropping key column
      ``i`` reduces the child by ``distinct[i]``).
    * ``extents`` — declared key-domain extents per key column (the
      dense grid shape / COO extents).
    * ``nnz`` — live (non-padded) tuple count; for a DenseRelation this
      is the full grid size.
    * ``density`` — ``nnz / prod(extents)``; 1.0 for dense grids.
    * ``hist`` — optional per-key-column equi-width histograms
      (``HIST_BUCKETS`` tuple counts over ``[0, extents[i])``), refreshed
      on ``Database.put``. The rewrite stage's cost gate overlaps two
      columns' histograms to sharpen the join output-size estimate that
      decides a Σ-pushdown; ``None`` falls back to the extent/distinct
      heuristics, bit-identically to a stats-less plan.

    Frozen and tuple-valued so a stats snapshot is hashable — it is part
    of the ``RAEngine.lower`` cache key."""

    distinct: Tuple[int, ...]
    extents: Tuple[int, ...]
    nnz: int
    density: float = 1.0
    hist: Optional[Tuple[Tuple[int, ...], ...]] = None

    def quantized(self) -> "RelationStats":
        """Counts bucketed to powers of two (extents kept exact) — the
        form compile cache *keys* use, so per-batch statistics jitter
        (e.g. a re-sampled edge set whose distinct counts wobble a few
        percent) does not re-lower every step. Estimates themselves
        always use the raw statistics; only key identity is coarse."""

        def q(x: int) -> int:
            x = int(x)
            return x if x <= 1 else 1 << (x - 1).bit_length()

        nnz = q(self.nnz)
        size = 1
        for e in self.extents:
            size *= int(e)
        return RelationStats(
            distinct=tuple(q(d) for d in self.distinct),
            extents=self.extents,
            nnz=nnz,
            density=(nnz / size) if size else 0.0,
            hist=(
                tuple(tuple(q(c) for c in col) for col in self.hist)
                if self.hist is not None
                else None
            ),
        )


def _rel_bytes(rel) -> float:
    """Payload bytes of a relation (keys count for a COO relation: they
    move with the values)."""
    if isinstance(rel, DenseRelation):
        return float(rel.data.numel() * rel.data.element_size())
    if isinstance(rel, CooRelation):
        return float(
            rel.values.numel() * rel.values.element_size()
            + rel.keys.numel() * rel.keys.element_size()
        )
    raise TypeError(f"not a relation: {type(rel)}")


@dataclass
class GraphEstimate:
    """Bottom-up size/statistics estimates over one FRA graph — the walk
    the rewrite stage (``core/rewrite.py``) gates its rules on. All maps
    are keyed by node id.

    * ``sizes`` — estimated bytes per node (join-agg semantics: a Join is
      at most its big side, a Σ divides its child by the dropped keys'
      measured domains or the 1/8-per-key fallback).
    * ``is_coo`` — whether the node's subtree is COO-keyed.
    * ``dist`` — per key position, estimated distinct values (None = no
      statistics reached this node / position).
    * ``hists`` — per key position, the equi-width histogram propagated
      from ``RelationStats.hist`` (None wherever unavailable); only the
      rewrite gate consumes these.
    * ``stat_aggs`` — Agg node ids whose size came from statistics.
    * ``agg_of`` — Join id → the Agg sitting directly above it.
    * ``joins`` — Join nodes in topo (leaves-first) order.
    """

    sizes: Dict[int, float]
    is_coo: Dict[int, bool]
    dist: Dict[int, Optional[Tuple[Optional[float], ...]]]
    hists: Dict[int, Optional[Tuple[Optional[Tuple[int, ...]], ...]]]
    stat_aggs: set
    agg_of: Dict[int, "fra.Agg"]
    joins: List["fra.Join"]


def agg_shrink(
    child_arity: int,
    grp,
    child_dist: Optional[Tuple[Optional[float], ...]],
) -> Tuple[float, bool]:
    """The Σ output-size rule shared by ``estimate_graph`` and the
    rewrite cost gate: ``(shrink_factor, from_stats)`` such that the Agg
    output is ``child_bytes / shrink_factor``. With statistics covering
    every dropped key position the factor is the product of their
    measured domains; otherwise the flat 1/8-per-dropped-key fallback."""
    kept = {c.idx for c in grp.comps if isinstance(c, In)}
    dropped_pos = [i for i in range(child_arity) if i not in kept]
    if (
        child_dist is not None
        and dropped_pos
        and all(child_dist[i] is not None for i in dropped_pos)
    ):
        factor = 1.0
        for i in dropped_pos:
            factor *= max(1.0, float(child_dist[i]))
        return factor, True
    return 8.0 ** len(dropped_pos), False


def estimate_graph(
    root: fra.Node,
    env: Dict[str, object],
    stats: Optional[Dict[str, RelationStats]] = None,
) -> GraphEstimate:
    """Walk ``root`` leaves-first and estimate per-node sizes, COO-ness,
    and (with a catalog snapshot) distinct counts and histograms. This is
    the cost model the rewrite stage's gate reads; stats-less calls use
    the flat 1/8-per-dropped-key heuristic."""
    sizes: Dict[int, float] = {}
    is_coo: Dict[int, bool] = {}
    agg_of: Dict[int, fra.Agg] = {}
    joins: List[fra.Join] = []
    dist: Dict[int, Optional[Tuple[Optional[float], ...]]] = {}
    hists: Dict[int, Optional[Tuple[Optional[Tuple[int, ...]], ...]]] = {}
    stat_aggs: set = set()

    for node in root.topo():
        hists[node.id] = None
        if isinstance(node, (fra.TableScan, fra.Const)):
            ref = node.name if isinstance(node, fra.TableScan) else node.ref
            if ref in env:
                sizes[node.id] = _rel_bytes(env[ref])
                is_coo[node.id] = isinstance(env[ref], CooRelation)
            else:  # unresolved (__seed/__fwd): assume small
                sizes[node.id] = 0.0
                is_coo[node.id] = False
            st = stats.get(ref) if stats else None
            dist[node.id] = (
                tuple(float(d) for d in st.distinct) if st is not None else None
            )
            if st is not None and st.hist is not None:
                hists[node.id] = tuple(st.hist)
        elif isinstance(node, fra.Select):
            sizes[node.id] = sizes[node.child.id]
            is_coo[node.id] = is_coo[node.child.id]
            cd = dist.get(node.child.id)
            dist[node.id] = (
                tuple(
                    cd[c.idx] if isinstance(c, In) else None
                    for c in node.proj.comps
                )
                if cd is not None
                else None
            )
            ch = hists.get(node.child.id)
            if ch is not None:
                hists[node.id] = tuple(
                    ch[c.idx] if isinstance(c, In) else None
                    for c in node.proj.comps
                )
        elif isinstance(node, fra.Agg):
            child = sizes[node.child.id]
            cd = dist.get(node.child.id)
            factor, from_stats = agg_shrink(node.child.key_arity, node.grp, cd)
            if from_stats:
                # catalog statistics: a Σ dropping key position i merges
                # its distinct[i] values into one group — the measured
                # replacement for the flat 1/8-per-dropped-key guess
                sizes[node.id] = child / factor
                stat_aggs.add(node.id)
                dist[node.id] = tuple(
                    cd[c.idx] if isinstance(c, In) else None
                    for c in node.grp.comps
                )
            else:
                # no statistics: assume a 1/8 reduction per dropped key
                sizes[node.id] = child / factor
                dist[node.id] = None
            # grouping rescales bucket counts unpredictably: drop hists
            is_coo[node.id] = False  # Σ over COO materializes the grid
            if isinstance(node.child, fra.Join):
                agg_of[node.child.id] = node
        elif isinstance(node, fra.Join):
            joins.append(node)
            sizes[node.id] = max(
                sizes[node.left.id], sizes[node.right.id]
            )  # join-agg output is at most the big side
            is_coo[node.id] = (
                is_coo[node.left.id] or is_coo[node.right.id]
            )  # the gather join keeps the COO key set
            ld, rd = dist.get(node.left.id), dist.get(node.right.id)
            comps_dist: List[Optional[float]] = []
            for c in node.proj.comps:
                if isinstance(c, L) and ld is not None:
                    comps_dist.append(ld[c.idx])
                elif isinstance(c, R) and rd is not None:
                    comps_dist.append(rd[c.idx])
                else:
                    comps_dist.append(None)
            dist[node.id] = tuple(comps_dist)
            lh, rh = hists.get(node.left.id), hists.get(node.right.id)
            if lh is not None or rh is not None:
                hists[node.id] = tuple(
                    lh[c.idx] if isinstance(c, L) and lh is not None
                    else rh[c.idx] if isinstance(c, R) and rh is not None
                    else None
                    for c in node.proj.comps
                )
        elif isinstance(node, fra.Restrict):
            sizes[node.id] = sizes[node.children[0].id]
            is_coo[node.id] = is_coo[node.ref.id]
            # restricted to the ref's key set: its statistics apply
            dist[node.id] = dist.get(node.ref.id) or dist.get(node.child.id)
        elif isinstance(node, fra.AddOp):
            sizes[node.id] = sizes[node.children[0].id]
            is_coo[node.id] = is_coo[node.left.id] and is_coo[node.right.id]
            dist[node.id] = dist.get(node.left.id) or dist.get(node.right.id)

    return GraphEstimate(sizes, is_coo, dist, hists, stat_aggs, agg_of, joins)

