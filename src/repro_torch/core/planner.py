"""Size and statistics estimates over FRA graphs — the estimator half of
the reference's distribution planner.

``RelationStats`` is what the ``Database`` catalog tracks per relation
(``relation.measure_stats``); ``estimate_graph`` walks a query leaves-first
and estimates each node's bytes, COO-ness, distinct key counts and
histograms; ``agg_shrink`` is the Σ output-size rule. The rewrite stage
(``core/rewrite.py``) gates its rules on these numbers. ``plan_waves``
decides whether a step streams through the device in chunk waves under a
memory budget (out-of-core execution, ``core/engine.StreamedCompiled``).

The mesh half is the distribution planner: the paper's claim that "the
database query optimizer will automatically distribute the computation,
taking into account the sizes of the two matrices" (§1). For every Join it
picks, by bytes moved per device, between the paper's two physical plans:

  * BROADCAST the small side (the data-parallel plan): the small relation
    is replicated, the big side stays partitioned on a non-contraction
    block axis; no output collective.
  * CO-PARTITION both sides on the join key (the tensor-parallel plan):
    both relations are sharded on the contraction block axis, and the
    join-aggregate's Σ ends in an all-reduce of the output.

On a (data × model) mesh (``launch/mesh.make_host_mesh``) it also picks,
per join, a data-axis placement: a surviving batch dim of one side over
the (folded) data axes, or a COO side's nnz rows, whose Σ then ends in a
data-axis reduction. ``plan_query`` emits a ``JoinPlan`` per join and
``input_pspecs`` the ``P`` spec per base relation; the engine places the
relations by those specs and runs each join on its local shards, with
the collectives the plan names (``core/compiler.py``). The planner is
pure Python over a ``MeshGeometry``: given the same geometry, its plans
equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import fra
from .keys import In, L, R, join_equiv_classes
from .relation import CooRelation, DenseRelation

#: mesh axes treated as data-parallel (batch) axes, in fold order — the
#: multi-pod production mesh folds ("pod", "data") onto one relation dim.
DATA_AXIS_NAMES = ("pod", "data")

#: fallback edge-cut estimate for the Σ-over-COO scatter when the edge
#: relation is owner-partitioned on the Σ's segment key
#: (relation.owner_partition) but no tracked statistics are available:
#: each shard then owns a contiguous segment range, so only boundary-
#: crossing contributions move. With a catalog the planner replaces it by
#: ``RelationStats.edge_cut``.
EDGE_CUT_LOCAL = 0.125

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

    def edge_cut(self, owner_dim: int, num_shards: int) -> float:
        """Estimated non-local fraction of an owner-partitioned Σ-scatter
        over ``num_shards`` data shards: each shard owns a contiguous
        range of the ``distinct[owner_dim]`` segment keys, so only the
        ≤ ``num_shards - 1`` boundary-straddling segments move. A skewed
        (small) owner domain pushes this toward the full scatter."""
        if num_shards <= 1:
            return 0.0
        owners = max(1, int(self.distinct[owner_dim]))
        return min(1.0, float(num_shards - 1) / float(owners))


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
# The mesh half: physical plans per join on a (data × model) mesh
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: one entry per array dim — a mesh axis name, a
    tuple of axis names folded onto the dim, or None (replicated). A tuple,
    so a spec compares equal to the reference's as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self)).replace(",)", ")")


def fold_axes(axes: Tuple[str, ...]):
    """Spec entry for a dim carrying ``axes``: the folded tuple,
    a single axis name, or None — the one place the fold rule lives."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


@dataclass(frozen=True)
class MeshGeometry:
    """Static description of the mesh the planner plans for: one
    tensor-parallel (model) axis plus zero or more folded data axes.

    ``from_mesh`` derives it from a ``torch.distributed`` DeviceMesh;
    ``single`` is the legacy 1-D geometry (model axis only) used when the
    caller only knows a device count."""

    model_axis: str
    model_size: int
    data_axes: Tuple[str, ...] = ()
    data_size: int = 1

    @classmethod
    def single(cls, n_devices: int, axis: str = "model") -> "MeshGeometry":
        return cls(axis, max(1, int(n_devices or 1)))

    @classmethod
    def from_mesh(cls, mesh, axis: Optional[str] = None) -> "MeshGeometry":
        """Read the (data × model) geometry off a DeviceMesh (its
        ``mesh_dim_names`` and sizes): ``axis`` (or
        ``"model"``) is the tensor-parallel axis — on a 1-axis mesh the
        sole axis plays that role, reproducing the 1-D plans — and every
        ``DATA_AXIS_NAMES`` axis present is folded into the batch pair."""
        names = tuple(mesh.mesh_dim_names or ())
        sizes = dict(zip(names, tuple(mesh.mesh.shape)))
        if axis is not None:
            if axis not in names:
                raise ValueError(
                    f"model axis {axis!r} is not on the mesh (axes: {names})"
                )
            model = axis
        elif "model" in names:
            model = "model"
        elif len(names) == 1:
            model = names[0]
        else:
            raise ValueError(
                f"cannot infer the model axis of a multi-axis mesh with no "
                f"'model' axis (axes: {names}); pass axis= explicitly"
            )
        data_axes = tuple(
            a for a in DATA_AXIS_NAMES if a in names and a != model
        )
        data_size = 1
        for a in data_axes:
            data_size *= int(sizes[a])
        return cls(model, int(sizes[model]), data_axes, data_size)

    @property
    def data_spec(self):
        """Spec entry for a data-sharded dim: the folded axis
        tuple, or the single axis name."""
        return fold_axes(self.data_axes)


@dataclass(frozen=True)
class JoinPlan:
    """Physical plan for one Join node."""

    kind: str                      # broadcast_left | broadcast_right | copartition
    node_id: int
    # estimated bytes moved per device for each candidate (the cost table;
    # 2-D plans add the data-axis candidates under "data:*" keys)
    costs: Dict[str, float]
    # block-axis index carrying the model axis, per side (None = replicated)
    left_shard_dim: Optional[int]
    right_shard_dim: Optional[int]
    # does the plan end in a model-axis all-reduce of the join-agg output?
    needs_psum: bool
    # block-axis index carrying the data (batch) axes, per side
    left_batch_dim: Optional[int] = None
    right_batch_dim: Optional[int] = None
    # the mesh axes the dims above refer to
    model_axis: str = "model"
    data_axes: Tuple[str, ...] = ()
    # chosen data-axis placement: none | data:shard_left | data:shard_right
    #            | data:replicate | data:shard_nnz_left | data:shard_nnz_right
    data_kind: str = "none"
    # does the Σ reduce the data-sharded batch key (data-axis all-reduce),
    # or scatter a data-sharded nnz axis into segments (psum_scatter)?
    needs_data_psum: bool = False
    # which side is a CooRelation (nnz-row layout, no shardable key dims)
    coo_sides: Tuple[bool, bool] = (False, False)

    def nnz_sharded(self, side: str) -> bool:
        """Did the data axes land on ``side``'s COO nnz row dimension?"""
        return self.data_kind == f"data:shard_nnz_{side}"

    def pspec(self, side: str, arity: int, axis: Optional[str] = None) -> P:
        if self.coo_sides[0 if side == "left" else 1]:
            # COO payloads have one shardable axis: the nnz row dim.
            if self.nnz_sharded(side) and self.data_axes:
                return P(fold_axes(self.data_axes))
            return P()
        dim = self.left_shard_dim if side == "left" else self.right_shard_dim
        bdim = (
            self.left_batch_dim if side == "left" else self.right_batch_dim
        )
        spec: list = [None] * arity
        if dim is not None and dim < arity:
            spec[dim] = axis or self.model_axis
        if bdim is not None and bdim < arity and self.data_axes:
            spec[bdim] = fold_axes(self.data_axes)
        return P(*spec)


def _contraction_dims(join: fra.Join) -> Tuple[Optional[int], Optional[int]]:
    """Joined-on block-key dims (left, right) — the contraction axes a
    co-partition plan shards. (The join-agg tree's Σ typically drops this
    key from the final output; whether it survives the join's own proj is
    irrelevant to the physical plan.)"""
    al = join.left.key_arity
    ar = join.right.key_arity
    uf = join_equiv_classes(join.pred, al, ar)
    for i in range(al):
        root = uf.find(L(i))
        for j in range(ar):
            if uf.find(R(j)) == root:
                return i, j
    return None, None


def _output_dims(join: fra.Join) -> Tuple[Optional[int], Optional[int]]:
    """First *non-contraction* block dim per side that survives into the
    output (for the broadcast plans: the kept side stays sharded on a dim
    requiring no collective — sharding the contraction dim would still
    force a psum). On a 2-D mesh this is also each side's candidate batch
    dim for the data axes."""
    lc, rc = _contraction_dims(join)
    ldim = rdim = None
    for c in join.proj.comps:
        if isinstance(c, L) and ldim is None and c.idx != lc:
            ldim = c.idx
        if isinstance(c, R) and rdim is None and c.idx != rc:
            rdim = c.idx
    return ldim, rdim


#: the per-device plan-feasibility budget of one relation, in bytes: the
#: reference's value, kept so that plans equal the reference's by default
DEFAULT_MEM_BUDGET = 8e9


def plan_join(
    join: fra.Join,
    left_bytes: float,
    right_bytes: float,
    out_bytes: float,
    n_devices: int,
    mem_budget: float = DEFAULT_MEM_BUDGET,
    *,
    geometry: Optional[MeshGeometry] = None,
    sum_out_bytes: Optional[float] = None,
    batch_survives: Tuple[bool, bool] = (True, True),
    coo_sides: Tuple[bool, bool] = (False, False),
    coo_local: Tuple[bool, bool] = (False, False),
    committed_dims: Tuple[Optional[Dict], Optional[Dict]] = (None, None),
    coo_edge_cut: Tuple[Optional[float], Optional[float]] = (None, None),
    sum_out_stat: bool = False,
) -> JoinPlan:
    """Pick the cheapest *feasible* physical plan by bytes moved per
    device, exactly the way the paper describes the database optimizer
    (§1): broadcast requires the broadcast relation to be replicated on
    every node, so it is only feasible within the per-node memory budget;
    otherwise the relations are co-partitioned on the join key.

    all-gather of X over N devices moves ~X·(N-1)/N per device;
    a ring all-reduce of the output moves ~2·out·(N-1)/N.

    ``geometry`` extends the decision to a 2-D (data × model) mesh: the
    data axes are placed first — shard one side's surviving batch dim
    (replicating the other side over the data axes) or replicate both —
    and the model axis then avoids the batch dim. ``sum_out_bytes`` is
    the post-Σ output estimate the all-reduce costs use on the 2-D path;
    ``batch_survives`` says, per side, whether the batch dim survives the
    enclosing grouping (a dropped batch key costs a data-axis all-reduce
    of the Σ output). A 1-axis geometry reproduces the historical 1-D
    plans bit-for-bit.

    ``coo_sides`` marks CooRelation sides. A COO side has no block axes —
    its one shardable axis is the physical nnz row dim, which only the
    data axes may take (``data:shard_nnz_*``): the dense side is
    replicated over them and the enclosing Σ pays a **psum_scatter** of
    the segment grid, priced at the edge-cut estimate — ``EDGE_CUT_LOCAL``
    when ``coo_local`` says the relation is owner-partitioned on the Σ's
    segment key, the full scatter otherwise. The model axis never takes
    nnz rows: a COO side is replicated over it, and a co-partition plan
    key-shards only the dense side (the one model-axis plan that keeps an
    over-budget dense grid partitioned, matching the 1-D planner).

    ``committed_dims`` folds the device-layout rechunk cost in: per side,
    the ``{"data": dim, "model": dim}`` placement the input is *known* to
    be committed to (None = unknown). A candidate that wants a side
    pre-sharded on a different dim pays that side's all-to-all, instead
    of ``Compiled.__call__`` paying it silently per step.

    ``coo_edge_cut`` overrides the scatter's edge-cut *fraction* per COO
    side with a catalog-derived estimate (``RelationStats.edge_cut``);
    ``None`` falls back to the stats-less heuristic (``EDGE_CUT_LOCAL``
    when ``coo_local``, the full scatter otherwise). ``sum_out_stat``
    marks ``sum_out_bytes`` as catalog-backed: the defensive dense-side
    cap on the segment-grid estimate is then skipped — the statistics
    already bound the Σ output by the real key domain.
    """
    geo = geometry or MeshGeometry.single(n_devices)
    n_model = max(1, geo.model_size)
    frac_m = (n_model - 1) / n_model
    two_d = geo.data_size > 1
    lc, rc = _contraction_dims(join)
    lo, ro = _output_dims(join)
    coo_l, coo_r = coo_sides
    cdim_l, cdim_r = committed_dims

    def _move(cdims, axis_kind, required, bytes_, frac):
        """Rechunk fold: a candidate expecting a side pre-sharded on
        ``required`` while it is committed sharded on a *different* dim
        pays the all-to-all. Replication candidates charge their
        all-gather in the base cost already (``required=None`` never
        adds), and an input committed replicated on this axis shards by a
        zero-communication local slice (``committed None`` never adds)."""
        if cdims is None or required is None or frac <= 0.0:
            return 0.0
        cur = cdims.get(axis_kind)
        if cur is None:
            return 0.0
        return bytes_ * frac if cur != required else 0.0

    costs: Dict[str, float] = {}

    # --- data axes: shard a batch dim / the COO nnz dim, or replicate ----
    left_batch = right_batch = None
    data_kind = "none"
    needs_data_psum = False
    if two_d:
        frac_d = (geo.data_size - 1) / geo.data_size
        sum_out = out_bytes if sum_out_bytes is None else sum_out_bytes

        def _scatter(dense_bytes: float, local: bool, cut: Optional[float]) -> float:
            """psum_scatter of the Σ-over-COO segment grid. Without an
            enclosing Σ the output stays nnz-aligned (no collective). A
            stats-backed ``sum_out`` is trusted as-is; the heuristic one
            is bounded by the gathered dense side, which caps the
            post-Agg guess. ``cut`` is the catalog edge-cut fraction,
            falling back to the EDGE_CUT_LOCAL constant."""
            if sum_out_bytes is None:
                return 0.0
            if sum_out_stat:
                est = sum_out
            else:
                est = min(sum_out, dense_bytes) if dense_bytes > 0 else sum_out
            if cut is None:
                cut = EDGE_CUT_LOCAL if local else 1.0
            return est * frac_d * cut

        # feasibility mirrors the model axis: a candidate must fit every
        # relation it replicates within the per-device budget
        dcosts: Dict[str, float] = {}
        if left_bytes <= mem_budget and right_bytes <= mem_budget:
            # no batch parallelism: both inputs replicated over the axes
            dcosts["data:replicate"] = (left_bytes + right_bytes) * frac_d
        if coo_l:
            if right_bytes <= mem_budget:
                dcosts["data:shard_nnz_left"] = (
                    right_bytes * frac_d
                    + _scatter(right_bytes, coo_local[0], coo_edge_cut[0])
                    + _move(cdim_l, "data", 0, left_bytes, frac_d)
                )
        elif lo is not None and right_bytes <= mem_budget:
            dcosts["data:shard_left"] = (
                right_bytes * frac_d
                + (0.0 if batch_survives[0] else 2.0 * sum_out * frac_d)
                + _move(cdim_l, "data", lo, left_bytes, frac_d)
            )
        if coo_r:
            if left_bytes <= mem_budget:
                dcosts["data:shard_nnz_right"] = (
                    left_bytes * frac_d
                    + _scatter(left_bytes, coo_local[1], coo_edge_cut[1])
                    + _move(cdim_r, "data", 0, right_bytes, frac_d)
                )
        elif ro is not None and left_bytes <= mem_budget:
            dcosts["data:shard_right"] = (
                left_bytes * frac_d
                + (0.0 if batch_survives[1] else 2.0 * sum_out * frac_d)
                + _move(cdim_r, "data", ro, right_bytes, frac_d)
            )
        if not dcosts:
            # nothing feasible (e.g. both sides over budget): best effort —
            # keep the partitionable side partitioned (a COO's nnz rows
            # beat a dense batch dim: that is the only placement that can
            # ever fit a beyond-memory edge relation), else replicate
            if coo_l:
                dcosts["data:shard_nnz_left"] = (
                    right_bytes * frac_d + _scatter(right_bytes, coo_local[0], coo_edge_cut[0])
                )
            elif coo_r:
                dcosts["data:shard_nnz_right"] = (
                    left_bytes * frac_d + _scatter(left_bytes, coo_local[1], coo_edge_cut[1])
                )
            elif lo is not None:
                dcosts["data:shard_left"] = right_bytes * frac_d
            elif ro is not None:
                dcosts["data:shard_right"] = left_bytes * frac_d
            else:
                dcosts["data:replicate"] = (left_bytes + right_bytes) * frac_d
        data_kind = min(dcosts, key=dcosts.get)
        costs.update(dcosts)
        if data_kind == "data:shard_left":
            left_batch = lo
            needs_data_psum = not batch_survives[0]
        elif data_kind == "data:shard_right":
            right_batch = ro
            needs_data_psum = not batch_survives[1]
        elif data_kind.startswith("data:shard_nnz"):
            # the Σ over the sharded nnz rows always scatters into the
            # (replicated) segment grid: that IS the planned collective
            needs_data_psum = sum_out_bytes is not None

    # --- model axis: broadcast vs co-partition, avoiding the batch dims --
    # The kept side of a broadcast plan stays sharded on a surviving dim;
    # if the data axes already took that dim, the model axis would sit
    # idle and the "broadcast" degenerates to replicating *both* sides —
    # charge it as such (2-D path only; 1-D keeps the historical costs).
    # A COO side has no key dims at all: it behaves like a dim-less side.
    lo_m = None if coo_l or (lo is not None and lo == left_batch) else lo
    ro_m = None if coo_r or (ro is not None and ro == right_batch) else ro
    mcosts: Dict[str, float] = {}
    if left_bytes <= mem_budget:
        c = left_bytes * frac_m
        if two_d and ro_m is None:
            c += right_bytes * frac_m
        c += _move(cdim_r, "model", ro_m, right_bytes, frac_m)
        mcosts["broadcast_left"] = c
    if right_bytes <= mem_budget:
        c = right_bytes * frac_m
        if two_d and lo_m is None:
            c += left_bytes * frac_m
        c += _move(cdim_l, "model", lo_m, left_bytes, frac_m)
        mcosts["broadcast_right"] = c
    if lc is not None and rc is not None and not (coo_l and coo_r):
        # co-partition on the contraction key: inputs land pre-sharded
        # (no repartition cost for our static plans — parameters/data are
        # *created* in the planned layout, and committed_dims charges the
        # all-to-all when the caller knows otherwise), output needs the
        # psum. The 2-D path prices the psum at the post-Σ output size.
        # With one COO side only the dense side is key-sharded (nnz rows
        # carry no key dims; the gather against the sharded grid leaves a
        # partial sum per rank, reduced by the psum) — still the one model-axis plan that keeps
        # an over-budget dense side partitioned, as in the 1-D planner.
        psum_out = sum_out if two_d and sum_out_bytes is not None else out_bytes
        mcosts["copartition"] = (
            2.0 * psum_out * frac_m
            + _move(cdim_l, "model", None if coo_l else lc, left_bytes, frac_m)
            + _move(cdim_r, "model", None if coo_r else rc, right_bytes, frac_m)
        )
    if not mcosts:
        if coo_l or coo_r:
            # COO ⋈ COO has no key-shardable side at all; best effort:
            # replicate both over the model axis
            kind = "broadcast_left" if coo_l else "broadcast_right"
            mcosts[kind] = (left_bytes + right_bytes) * frac_m
        else:
            raise ValueError(
                "no feasible plan: both sides exceed the memory budget and "
                "the join has no contraction key to co-partition on"
            )
    kind = min(mcosts, key=mcosts.get)
    costs.update(mcosts)

    common = dict(
        left_batch_dim=left_batch,
        right_batch_dim=right_batch,
        model_axis=geo.model_axis,
        data_axes=geo.data_axes,
        data_kind=data_kind,
        needs_data_psum=needs_data_psum,
        coo_sides=coo_sides,
    )
    if kind == "copartition":
        return JoinPlan(
            kind,
            join.id,
            costs,
            None if coo_l else lc,
            None if coo_r else rc,
            needs_psum=True,
            **common,
        )
    if kind == "broadcast_left":
        return JoinPlan(kind, join.id, costs, None, ro_m, needs_psum=False, **common)
    return JoinPlan(kind, join.id, costs, lo_m, None, needs_psum=False, **common)


def _batch_survival(
    join: fra.Join, agg: Optional[fra.Agg]
) -> Tuple[bool, bool]:
    """Does each side's batch dim survive the enclosing Σ's grouping?
    Dropped batch keys cost a data-axis all-reduce of the Σ output."""
    lo, ro = _output_dims(join)

    def survives(comp) -> bool:
        if comp is None or agg is None:
            return True
        try:
            pos = join.proj.comps.index(comp)
        except ValueError:
            return True
        return any(
            isinstance(c, In) and c.idx == pos for c in agg.grp.comps
        )

    return (
        survives(None if lo is None else L(lo)),
        survives(None if ro is None else R(ro)),
    )


def _coo_owner_survives(
    join: fra.Join, agg: Optional[fra.Agg], side: str, owner_dim: Optional[int]
) -> bool:
    """Is the COO side's owner-partition column the enclosing Σ's segment
    key? Then the scatter is local except at shard-boundary segments and
    the planner prices it at ``EDGE_CUT_LOCAL``."""
    if agg is None or owner_dim is None:
        return False
    comp = L(owner_dim) if side == "left" else R(owner_dim)
    try:
        pos = join.proj.comps.index(comp)
    except ValueError:
        return False
    return any(isinstance(c, In) and c.idx == pos for c in agg.grp.comps)


def _spec_dims(spec, geo: MeshGeometry) -> Optional[Dict[str, Optional[int]]]:
    """Parse a committed partition spec into the ``{"data": dim, "model":
    dim}`` placement the rechunk fold compares against."""
    if spec is None:
        return None
    model = data = None
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if geo.model_axis in axes:
            model = d
        if any(a in geo.data_axes for a in axes):
            data = d
    return {"model": model, "data": data}



def plan_query(
    query: fra.Query,
    env: Dict[str, object],
    n_devices: int,
    mem_budget: float = DEFAULT_MEM_BUDGET,
    *,
    geometry: Optional[MeshGeometry] = None,
    committed: Optional[Dict[str, P]] = None,
    stats: Optional[Dict[str, RelationStats]] = None,
) -> Dict[int, JoinPlan]:
    """Walk the query graph, estimate relation sizes bottom-up, and emit a
    JoinPlan per Join node (keyed by node id). ``geometry`` plans for a
    2-D (data × model) mesh (see ``MeshGeometry.from_mesh``); omitted, it
    is the legacy 1-D model-axis-only geometry over ``n_devices``.

    CooRelation leaves are planned for real: the walk tracks which
    subtrees are COO-keyed, and ``plan_join`` may place a join's COO nnz
    rows on the data axes (``data:shard_nnz_*``), costing the Σ's
    psum_scatter at the owner-partition edge-cut estimate.

    ``committed`` maps base-relation names to the partition spec their
    arrays are already committed to (see ``engine._committed_layouts``);
    candidates that would force a device-layout rechunk then pay the
    all-to-all in the cost table instead of hiding it in
    ``Compiled.__call__``'s placement.

    ``stats`` maps base-relation names to tracked ``RelationStats`` (the
    catalog snapshot — ``Database.catalog.snapshot()``). When present,
    per-key distinct counts are propagated through the graph and replace
    three heuristics: a Σ's output size divides the child by the dropped
    keys' *measured* domains (not a flat 1/8 per key), the Σ-over-COO
    scatter's edge cut is priced from the owner column's distinct count
    (not the ``EDGE_CUT_LOCAL`` constant), and the stats-backed Σ output
    estimate is trusted without the defensive dense-side cap. Relations
    missing from ``stats`` fall back to the old heuristics, so a
    stats-less call plans bit-identically to earlier releases."""
    geo = geometry or MeshGeometry.single(n_devices)
    est = estimate_graph(query.root, env, stats)
    sizes = est.sizes
    is_coo = est.is_coo
    agg_of = est.agg_of
    joins = est.joins
    stat_aggs = est.stat_aggs

    def owner_dim_of(n) -> Optional[int]:
        name = _leaf_name(n)
        rel = env.get(name) if name is not None else None
        return rel.owner_dim if isinstance(rel, CooRelation) else None

    def edge_cut_of(n, side: str, join: fra.Join, agg) -> Optional[float]:
        """Catalog edge-cut fraction for a COO side's Σ-scatter, or None
        to fall back to the EDGE_CUT_LOCAL/full-scatter heuristic."""
        name = _leaf_name(n)
        st = stats.get(name) if stats and name is not None else None
        rel = env.get(name) if name is not None else None
        if st is None or not isinstance(rel, CooRelation):
            return None
        od = rel.owner_dim
        if od is None or not _coo_owner_survives(join, agg, side, od):
            return None
        return st.edge_cut(od, geo.data_size)

    def committed_of(n) -> Optional[Dict[str, Optional[int]]]:
        if not committed:
            return None
        name = _leaf_name(n)
        if name is None or name not in committed:
            return None
        return _spec_dims(committed[name], geo)

    plans: Dict[int, JoinPlan] = {}
    for node in joins:
        lb = sizes[node.left.id]
        rb = sizes[node.right.id]
        ob = sizes[node.id]
        agg = agg_of.get(node.id)
        coo_sides = (is_coo[node.left.id], is_coo[node.right.id])
        plans[node.id] = plan_join(
            node,
            lb,
            rb,
            ob,
            geo.model_size,
            mem_budget,
            geometry=geo,
            sum_out_bytes=sizes[agg.id] if agg is not None else None,
            batch_survives=_batch_survival(node, agg),
            coo_sides=coo_sides,
            coo_local=(
                _coo_owner_survives(node, agg, "left", owner_dim_of(node.left)),
                _coo_owner_survives(node, agg, "right", owner_dim_of(node.right)),
            ),
            committed_dims=(committed_of(node.left), committed_of(node.right)),
            coo_edge_cut=(
                edge_cut_of(node.left, "left", node, agg),
                edge_cut_of(node.right, "right", node, agg),
            ),
            sum_out_stat=agg is not None and agg.id in stat_aggs,
        )
    return plans


def input_pspecs(
    query: fra.Query,
    plans: Dict[int, JoinPlan],
    axis: Optional[str] = None,
) -> Dict[str, P]:
    """Partition specs (``P``) for the query's base relations implied by the plans
    — 2-D on a (data × model) geometry: the model axis on the shard dim,
    the (folded) data axes on the batch dim. ``axis`` overrides the model
    axis name (legacy callers); default is each plan's own.

    When a relation feeds multiple joins with conflicting specs the first
    (bottom-most) join wins; the engine reshards it where another join's
    operand wants another layout (``core/compiler.py``)."""
    specs: Dict[str, P] = {}

    for node in query.root.topo():
        if not isinstance(node, fra.Join) or node.id not in plans:
            continue
        plan = plans[node.id]
        for side, child in (("left", node.left), ("right", node.right)):
            name = _leaf_name(child)
            if name is None or name in specs:
                continue
            specs[name] = plan.pspec(side, child.key_arity, axis)
    return specs


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
