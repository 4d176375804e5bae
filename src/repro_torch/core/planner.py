"""Size and statistics estimates over FRA graphs — the estimator half of
the reference's distribution planner.

``RelationStats`` is what the ``Database`` catalog tracks per relation
(``relation.measure_stats``); ``estimate_graph`` walks a query leaves-first
and estimates each node's bytes, COO-ness, distinct key counts and
histograms; ``agg_shrink`` is the Σ output-size rule. The rewrite stage
(``core/rewrite.py``) gates its rules on these numbers. ``plan_waves``
decides whether a step streams through the device in chunk waves under a
memory budget (out-of-core execution, ``core/engine.StreamedCompiled``).
Choosing a physical plan per join across devices is the mesh half, which
belongs to the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import fra
from .keys import In, L, R, join_equiv_classes
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



def _leaf_name(n) -> Optional[str]:
    """Base-relation name of a leaf node (TableScan/Const), else None."""
    if isinstance(n, fra.TableScan):
        return n.name
    if isinstance(n, fra.Const):
        return n.ref
    return None


# ---------------------------------------------------------------------------
# Out-of-core wave planning: stream one relation through the step in chunks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WavePlan:
    """Decision record of ``plan_waves``: stream ``stream`` (and slice the
    dense ``co_streams`` with the same row boundaries) through the compiled
    step in ``num_waves`` host→device waves under ``budget`` bytes of
    device memory. ``axis_of`` maps each streamed dense relation to the
    key dim being sliced; the primary stream's manifest carries the cut
    vector (owner-aligned for owner-partitioned COO streams)."""

    stream: str
    co_streams: Tuple[str, ...]
    num_waves: int
    boundaries: Tuple[int, ...]
    axis_of: Tuple[Tuple[str, int], ...]
    owner_aligned: bool
    budget: float

    @property
    def streamed_names(self) -> Tuple[str, ...]:
        return (self.stream,) + self.co_streams


# Stream-analysis states (see ``_stream_states``):
#   ("untainted",)   — value identical in every wave
#   ("rows", p)      — dense stream rows at key position p, wave-local ids
#   ("coo", p)       — streamed COO rows; global keys; owner column at p
#                      (p is None once the owner column is projected away)
#   ("owner", p)     — dense grid over the Σ segment key at position p:
#                      complete on wave-owned segments, ⊕-unit elsewhere
#   ("merged",)      — additive partial: full value = Σ over waves
_UNTAINTED = ("untainted",)
_MERGED = ("merged",)


class _Restart(Exception):
    """A new co-stream was discovered; re-run the analysis with it."""


def _stream_states(
    root: fra.Node,
    env: Dict[str, object],
    stream: str,
    co: Dict[str, int],
    owner_aligned: bool,
):
    """Walk the forward graph classifying every node's wave behaviour.

    Raises OutOfCoreError when some node combines wave-partial values in a
    way that is not additive across waves (the budget-too-small /
    unstreamable error path); mutates ``co`` and raises ``_Restart`` when a
    join demands that another dense base relation be sliced with the
    stream's boundaries."""
    from .chunkstore import OutOfCoreError

    memo: Dict[int, tuple] = {}

    def die(n: fra.Node, why: str):
        raise OutOfCoreError(
            f"cannot stream '{stream}' through {n.describe()}: {why}"
        )

    def new_pos(comps, pos, of=None):
        """Position of source comp index ``pos`` among projection comps."""
        for o, c in enumerate(comps):
            if not _is_lit(c) and c.idx == pos and (of is None or isinstance(c, of)):
                return o
        return None

    def _is_lit(c) -> bool:
        return type(c).__name__ == "Lit"

    def visit(n: fra.Node):
        if n.id in memo:
            return memo[n.id]
        s = _visit(n)
        memo[n.id] = s
        return s

    def _scan_state(name: str, n: fra.Node):
        if name == stream:
            rel = env[name]
            if isinstance(rel, CooRelation):
                return ("coo", rel.owner_dim)
            return ("rows", 0)
        if name in co:
            return ("rows", co[name])
        return _UNTAINTED

    def _select(n: fra.Select):
        s = visit(n.child)
        if s == _UNTAINTED:
            return _UNTAINTED
        kind = s[0]
        if kind == "coo":
            # σ over COO: no predicate (compiler contract), proj permutes
            # key columns; any per-row kernel is wave-local
            p = s[1]
            return ("coo", new_pos(n.proj.comps, p) if p is not None else None)
        if kind == "rows":
            p = s[1]
            if any(i == p for i, _ in n.pred.eqs):
                die(n, "a σ predicate fixes a literal row of the wave-local "
                       "streamed axis")
            q = new_pos(n.proj.comps, p)
            if q is None:
                die(n, "σ projects away the streamed row axis")
            return ("rows", q)
        if kind == "owner":
            if not n.kernel.zero_preserving:
                die(n, f"⊙{n.kernel.name} is not zero-preserving over "
                       "segments untouched by this wave")
            p = s[1]
            if any(i == p for i, _ in n.pred.eqs):
                return _MERGED
            q = new_pos(n.proj.comps, p)
            return ("owner", q) if q is not None else _MERGED
        # merged
        if not n.kernel.linear:
            die(n, f"⊙{n.kernel.name} is not linear over partially "
                   "accumulated Σ values")
        return _MERGED

    def _agg(n: fra.Agg, s):
        if s == _UNTAINTED:
            return _UNTAINTED
        if not n.kernel.is_add:
            die(n, f"⊕{n.kernel.name} cannot merge wave partials (not +)")
        kind = s[0]
        if kind == "rows":
            q = new_pos(n.grp.comps, s[1])
            return ("rows", q) if q is not None else _MERGED
        if kind == "coo":
            p = s[1]
            q = new_pos(n.grp.comps, p) if p is not None else None
            if q is not None and owner_aligned:
                return ("owner", q)
            return _MERGED
        if kind == "owner":
            q = new_pos(n.grp.comps, s[1])
            return ("owner", q) if q is not None else _MERGED
        return _MERGED

    def _join(n: fra.Join):
        sl, sr = visit(n.left), visit(n.right)
        if sl == _UNTAINTED and sr == _UNTAINTED:
            return _UNTAINTED
        la, ra = n.left.key_arity, n.right.key_arity
        uf = join_equiv_classes(n.pred, la, ra)

        def out_pos(cls):
            for o, c in enumerate(n.proj.comps):
                if not _is_lit(c) and uf.find(c) == cls:
                    return o
            return None

        if sl[0] == "rows" and sr[0] == "rows":
            # both sides wave-local rows (stream + co-stream): valid only
            # when the join aligns them row-for-row
            if uf.find(L(sl[1])) != uf.find(R(sr[1])):
                die(n, "two wave-local row sets join on different keys")
            q = out_pos(uf.find(L(sl[1])))
            return ("rows", q) if q is not None else _MERGED
        if sl != _UNTAINTED and sr != _UNTAINTED:
            die(n, "both sides depend on the streamed relation")
        tainted_left = sl != _UNTAINTED
        s, other = (sl, n.right) if tainted_left else (sr, n.left)
        kind = s[0]
        if kind == "coo":
            # streamed COO keys are global: gathers against resident dense
            # relations are wave-exact under any kernel
            p = s[1]
            if p is None:
                return ("coo", None)
            cls = uf.find(L(p) if tainted_left else R(p))
            return ("coo", out_pos(cls))
        if kind == "rows":
            cls = uf.find(L(s[1]) if tainted_left else R(s[1]))
            opp = [R(j) for j in range(ra)] if tainted_left else [
                L(i) for i in range(la)
            ]
            hit = [c for c in opp if uf.find(c) == cls]
            if hit:
                # the other side joins ON the wave-local row ids: it must
                # be co-streamed with the same boundaries
                name = _leaf_name(other)
                rel = env.get(name) if name else None
                if name is None or not isinstance(rel, DenseRelation):
                    die(n, "the other side joins on the streamed row axis "
                           "but is not a sliceable dense base relation")
                if name == stream or name in co:
                    die(n, "the streamed row axis joins a relation that is "
                           "already streamed on a different axis")
                co[name] = hit[0].idx
                raise _Restart()
            q = out_pos(cls)
            return ("rows", q) if q is not None else _MERGED
        # owner / merged operands pass through a join only when the kernel
        # is linear in that operand (0 stays 0, partials distribute)
        if not n.kernel.multiplicative:
            die(n, f"⊗{n.kernel.name} is not multiplicative: wave partials "
                   "do not distribute through it")
        if kind == "owner":
            cls = uf.find(L(s[1]) if tainted_left else R(s[1]))
            q = out_pos(cls)
            return ("owner", q) if q is not None else _MERGED
        return _MERGED

    def _visit(n: fra.Node):
        if isinstance(n, fra.TableScan):
            return _scan_state(n.name, n)
        if isinstance(n, fra.Const):
            return _scan_state(n.ref, n) if n.ref in env else _UNTAINTED
        if isinstance(n, fra.Select):
            return _select(n)
        if isinstance(n, fra.Agg):
            return _agg(n, visit(n.child))
        if isinstance(n, fra.Join):
            return _join(n)
        if isinstance(n, fra.Restrict):
            if visit(n.ref) != _UNTAINTED:
                die(n, "restriction reference depends on the stream")
            s = visit(n.child)
            if s[0] == "rows":
                die(n, "restricting wave-local rows against global keys")
            return s
        if isinstance(n, fra.AddOp):
            sl, sr = visit(n.left), visit(n.right)
            if sl == sr:
                return sl
            die(n, f"summands have incompatible wave states {sl} vs {sr}")
        raise TypeError(f"unknown node {n}")

    return visit(root)


def _co_streams(query: fra.Query, env: Dict[str, object], stream: str) -> Dict[str, int]:
    """The co-streams ``stream`` needs ({name: sliced dim}), after
    ``_stream_states`` has shown that its waves merge exactly (raises
    OutOfCoreError otherwise)."""
    from .chunkstore import OutOfCoreError

    srel = env[stream]
    owner_aligned = isinstance(srel, CooRelation) and srel.owner_dim is not None
    co: Dict[str, int] = {}
    for _ in range(len(env) + 1):
        try:
            _stream_states(query.root, env, stream, co, owner_aligned)
            return co
        except _Restart:
            continue
    raise OutOfCoreError("co-stream discovery did not converge")


def plan_waves(
    query: fra.Query,
    env: Dict[str, object],
    memory_budget: Optional[float],
    *,
    stats: Optional[Dict[str, RelationStats]] = None,
) -> Optional[WavePlan]:
    """Decide whether (and how) to stream this query's environment through
    the device in chunk waves under ``memory_budget`` bytes.

    Returns None when everything fits (or no budget is set) — the
    bit-identity gate: the in-core path then runs with zero new code.
    Otherwise streams the largest base relation whose per-wave results
    merge exactly (``_stream_states``), and sizes the wave count so
    resident relations plus one wave fit the budget. When no base
    relation can stream, raises ``chunkstore.OutOfCoreError`` naming the
    largest one and its offending node.

    The reference streams the largest base relation or raises: a GCN
    whose node features outweigh its edge relation (every graph at the
    paper's widths) cannot stream there, because the features join the
    edges on their row ids. Wherever the reference streams, the largest
    relation streams here too, with the same plan."""
    from .chunkstore import OutOfCoreError
    from .relation import make_manifest

    if memory_budget is None:
        return None
    sizes = {name: _rel_bytes(rel) for name, rel in env.items()}
    total = sum(sizes.values())
    if total <= memory_budget:
        return None
    # streamable leaves: TableScans plus Const refs resolving to env
    # relations — the SQL front door lowers every non-``wrt`` relation to
    # a Const, and those are exactly the big constant data relations
    # (design matrix, labels) a budgeted step most needs to stream
    base = {s.name for s in query.root.table_scans()}
    base.update(
        c.ref
        for c in query.root.topo()
        if isinstance(c, fra.Const) and c.ref in env
    )
    candidates = [n for n in sizes if n in base]
    if not candidates:
        raise OutOfCoreError(
            f"environment ({total:.0f} B) exceeds the memory budget "
            f"({memory_budget:.0f} B) but the query has no streamable "
            "base relation"
        )
    # the largest candidate that can stream (a stable sort keeps the
    # reference's tie order); when none can, the largest one's reason
    first_error: Optional[OutOfCoreError] = None
    for stream in sorted(candidates, key=lambda n: -sizes[n]):
        try:
            co = _co_streams(query, env, stream)
            break
        except OutOfCoreError as err:
            first_error = first_error or err
    else:
        raise first_error
    srel = env[stream]

    moving = sizes[stream] + sum(sizes[n] for n in co)
    resident = total - moving
    headroom = memory_budget - resident
    if headroom <= 0:
        raise OutOfCoreError(
            f"memory budget too small: resident relations alone hold "
            f"{resident:.0f} B of the {memory_budget:.0f} B budget"
        )
    num_waves = max(2, -int(-moving // headroom))
    rows = (
        srel.nnz if isinstance(srel, CooRelation) else int(srel.extents[0])
    )
    if num_waves > rows:
        raise OutOfCoreError(
            f"memory budget too small: '{stream}' needs {num_waves} waves "
            f"but has only {rows} rows"
        )
    # co-streamed relations are sliced with the stream's boundaries along
    # their joined dim — their row extents must agree
    for name, dim in co.items():
        ext = int(env[name].extents[dim])
        if ext != rows and not isinstance(srel, CooRelation):
            raise OutOfCoreError(
                f"co-streamed '{name}' dim {dim} extent {ext} != streamed "
                f"'{stream}' rows {rows}"
            )
    manifest = make_manifest(srel, num_waves, axis=0)
    axis_of = tuple(sorted([(stream, 0)] + list(co.items())))
    return WavePlan(
        stream=stream,
        co_streams=tuple(sorted(co)),
        num_waves=manifest.num_chunks,
        boundaries=manifest.boundaries,
        axis_of=axis_of,
        owner_aligned=manifest.owner_aligned,
        budget=float(memory_budget),
    )
