"""Staged query engine: lower → compile → run, on one device or a mesh.

The paper's systems claim (§1) is that a relational engine compiles a
differentiated query once and reuses it across training iterations. This
module is that pipeline, staged explicitly:

    RAEngine(program)             # FRA query / gradient program
        .lower(env)               # → Lowered: validate (typed check) →
                                  #   rewrite (cost-gated) → a lowering walk
                                  #   over ``meta`` tensors that resolves
                                  #   every kernel-dispatch site and records
                                  #   the output shapes; cached per
                                  #   (env signature, dispatch table,
                                  #   rewrite key)
        .compile(mesh=...)        # → Compiled: planner.plan_query picks a
                                  #   JoinPlan per join — 2-D (data ×
                                  #   model) on a launch/mesh mesh — and
                                  #   its specs place every relation
    compiled(env)                 # runs the lowered program on env: on a
                                  #   mesh, each rank on its shards, with
                                  #   the plan's collectives

Kernel dispatch is part of the lowering: ``lower(env, dispatch=...)``
pins a kernels.DispatchTable (cuda / ref / torch tier per hot op) into
the lowering cache key, so switching tiers lowers afresh and kernel choice
can never alias a stale entry. The decisions taken are recorded on
``Compiled.resolutions``.

PyTorch runs eagerly, so a ``Compiled`` call walks the (rewritten) graph
and launches the tensor ops and kernels its lowering resolved; what it
never repeats is the validate / rewrite / resolve work.
``RAEngine.lower_count`` counts lowerings (cache misses) — one per
signature.

On a mesh (a ``torch.distributed`` DeviceMesh, ``launch/mesh.py``) every
rank runs the same program: ``Compiled.__call__`` takes the whole
relations, or ``DTensor``s committed to a layout on the mesh, cuts each
rank's shard by the planned spec (a view of a whole tensor; a COO whose
rows do not split is padded first), runs the walk on the shards with the
plan's collectives (``compiler.Placement``) and returns outputs that are
whole and equal on every rank. A committed input whose layout differs from
the plan is moved (all-gather, then slice), counted under
``counters["reshard"]`` and warned about once (``ReshardWarning``), unless
``compile(committed=...)`` priced the move into the plan.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import warnings
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple, Union

import torch

from . import fra, kernels, planner
from . import rewrite as _rewrite
from .autodiff import GradientProgram
from .planner import P
from .relation import CooRelation, DenseRelation, pad_coo_nnz, relation_device

AnyRel = Union[DenseRelation, CooRelation]
Env = Dict[str, AnyRel]
Program = Union[fra.Query, fra.Node, GradientProgram]

#: per-Lowered bound on retained Compiled executables (LRU)
_MAX_COMPILED = 64


class ShardFallbackWarning(UserWarning):
    """A planned sharding could not be emitted and the relation fell back
    to replication. Structured: carries the relation name, the offending
    dim/extent, and the divisor, so callers can grep/assert on them."""

    def __init__(self, relation: str, dim: int, extent: int, divisor: int):
        self.relation = relation
        self.dim = dim
        self.extent = extent
        self.divisor = divisor
        super().__init__(
            f"relation {relation!r}: planned sharding of block dim {dim} "
            f"(extent {extent}) dropped — not divisible by the mesh axes' "
            f"product {divisor}; the dim is replicated instead"
        )


class ReshardWarning(UserWarning):
    """``Compiled.__call__`` moved committed input bytes to the planned
    layout — an all-gather the plan did not account for. Structured
    (carries the relation name and the bytes moved) and emitted once per
    *(cache entry, relation)*. See ``Compiled.counters["reshard"]``; fold
    the cost into planning with ``compile(committed=...)`` or let
    ``compile_auto`` / the ``Database`` session thread it."""

    def __init__(self, relation: str, bytes_moved: int):
        self.relation = relation
        self.bytes_moved = bytes_moved
        super().__init__(
            f"relation {relation!r}: Compiled step resharded {bytes_moved} "
            f"committed input bytes to the planned layout (a move the plan "
            f"did not cost); pass committed= layouts to compile() — or step "
            f"through repro_torch.Database, which threads them — to fold it "
            f"into the plan. See Compiled.counters['reshard']."
        )


# ---------------------------------------------------------------------------
# Environment signatures: the lowering-cache key
# ---------------------------------------------------------------------------


def _rel_signature(name: str, rel: AnyRel) -> Tuple:
    if isinstance(rel, DenseRelation):
        return (
            name,
            "dense",
            rel.key_arity,
            tuple(rel.data.shape),
            str(rel.data.dtype),
            rel.data.device.type,
        )
    if isinstance(rel, CooRelation):
        return (
            name,
            "coo",
            tuple(rel.extents),
            tuple(rel.keys.shape),
            str(rel.keys.dtype),
            tuple(rel.values.shape),
            str(rel.values.dtype),
            rel.values.device.type,
            rel.owner_dim,
            rel.shard_offsets,
        )
    raise TypeError(f"env entry {name!r} is not a relation: {type(rel)}")


def env_signature(env: Env, seed: Optional[AnyRel] = None) -> Tuple:
    """Hashable (graph-independent) structure+shape+dtype+device-type key
    for an environment — the lowering cache is keyed on this per engine."""
    sig = tuple(_rel_signature(n, env[n]) for n in sorted(env))
    if seed is not None:
        sig += (_rel_signature("__seed_arg", seed),)
    return sig


def _stats_key(stats) -> Optional[Tuple]:
    """Hashable snapshot key for a {name: RelationStats} dict. Counts are
    quantized to powers of two (``RelationStats.quantized``): statistics
    jitter across refreshes of the same-shaped relation lands on the same
    key, while an order-of-magnitude shift lowers afresh."""
    if not stats:
        return None
    return tuple(sorted((n, st.quantized()) for n, st in stats.items()))


def env_device(env: Env, seed: Optional[AnyRel] = None) -> torch.device:
    """The one device an environment's relations lie on (raises when they
    are spread over several: nothing is moved behind the caller's back)."""
    devs = {relation_device(r) for r in env.values()}
    if seed is not None:
        devs.add(relation_device(seed))
    if len(devs) != 1:
        raise ValueError(
            f"environment relations must lie on one device, found {sorted(map(str, devs))}"
        )
    return devs.pop()


def _meta_tensor(t: torch.Tensor) -> torch.Tensor:
    if _dtensor_spec(t) is not None:
        # the whole shape: a DTensor's shape is its global one
        return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
    return torch.empty_like(t, device="meta")


def _meta(rel: AnyRel) -> AnyRel:
    """The relation with every tensor replaced by an empty ``meta`` tensor
    of the same (whole) shape and dtype (relation schema kept)."""
    if isinstance(rel, DenseRelation):
        return DenseRelation(_meta_tensor(rel.data), rel.key_arity)
    return CooRelation(
        _meta_tensor(rel.keys),
        _meta_tensor(rel.values),
        rel.extents,
        rel.owner_dim,
        rel.shard_offsets,
    )


def _norm_spec(spec) -> Tuple:
    """A partition spec normalized for layout comparison: trailing
    replicated dims dropped, so ``P('data')`` and ``P('data', None)``
    describe the same placement."""
    t = tuple(spec) if spec is not None else ()
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _payload(rel: AnyRel) -> torch.Tensor:
    """The tensor a relation's placement is read off: a DenseRelation's
    ``data``, a CooRelation's ``values``."""
    return rel.data if isinstance(rel, DenseRelation) else rel.values


def _dtensor_spec(t) -> Optional[P]:
    """The partition spec of a ``DTensor`` (None for a plain tensor): per
    tensor dim, the mesh axes whose placement shards it."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return None
    names = tuple(t.device_mesh.mesh_dim_names or ())
    entries: list = [()] * t.dim()
    for name, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            entries[pl.dim] = entries[pl.dim] + (name,)
    return P(*[planner.fold_axes(e) for e in entries])




# ---------------------------------------------------------------------------
# Compiled / Lowered
# ---------------------------------------------------------------------------


class Compiled:
    """The executable for one lowering and one placement: calling it with
    an environment of the lowering's signature runs the (rewritten)
    program under the lowering's dispatch table — on one device, or on
    each rank's shards of a mesh. A Compiled can only be replayed on
    environments whose signature matches the one it was lowered for
    (``__call__`` re-checks and raises otherwise).

    Cache-key semantics: a Compiled is cached on its parent ``Lowered``
    under ``(mesh, axis, donate, mem_budget, n_devices, geometry,
    committed, stats)``."""

    def __init__(
        self,
        lowered: "Lowered",
        plans: Optional[Dict[int, planner.JoinPlan]] = None,
        input_specs: Optional[Dict[str, P]] = None,
        mesh=None,
        geometry: Optional[planner.MeshGeometry] = None,
        in_shardings: Optional[Dict[str, P]] = None,
        pad_nnz: Optional[Dict[str, int]] = None,
        rechunks: Optional[Dict[str, int]] = None,
        donate_names: Tuple[str, ...] = (),
    ):
        self.lowered = lowered
        self.donate_names = donate_names
        #: planner.JoinPlan per Join node id — the chosen physical plans.
        self.plans = dict(plans or {})
        #: planner-emitted partition spec per base relation (pre-padding).
        self.input_specs = dict(input_specs or {})
        self.mesh = mesh
        #: the (data × model) MeshGeometry this executable was planned for.
        self.geometry = geometry
        #: the effective spec each relation's payload is placed at on the
        #: mesh (a non-divisible dense dim dropped; None without a mesh).
        self.in_shardings = None if in_shardings is None else dict(in_shardings)
        #: COO relations whose nnz rows are padded to a shard multiple
        #: (pad-and-mask): relation name → padded row count.
        self.pad_nnz = dict(pad_nnz or {})
        #: relations whose committed layout differed from the plan's at
        #: compile time, the move priced into the plan (name → bytes):
        #: ``__call__`` books these moves as planned and does not warn.
        self.rechunks: Dict[str, int] = dict(rechunks or {})
        #: layout moves of committed inputs (``counters["reshard"]``).
        self._reshard: Dict[str, int] = {
            "calls": 0,
            "resharded_calls": 0,
            "bytes_moved": 0,
            "last_call_bytes": 0,
            "planned_bytes": 0,
        }
        self._reshard_warned: set = set()
        #: the lowering at one rank's shard shapes (its dispatch sites are
        #: the ones the kernels launch at): made at the first call on a mesh.
        self.local: Optional["Lowered"] = None

    @property
    def dispatch(self) -> kernels.DispatchTable:
        """The kernel DispatchTable this executable was lowered under."""
        return self.lowered.dispatch

    @property
    def resolutions(self) -> Dict[str, str]:
        """``op[site] → tier`` record of every kernel-dispatch decision
        taken while lowering (e.g. ``segment_sum[E=1335586,D=256,S=169343]``
        → ``'cuda'``); on a mesh, at one rank's shard shapes once a call
        has run."""
        low = self.local if self.local is not None else self.lowered
        return dict(low.resolutions)

    @property
    def counters(self) -> Dict[str, Dict[str, int]]:
        """This executable's slice of the telemetry tree:
        ``{"reshard": {calls, resharded_calls, bytes_moved,
        last_call_bytes, planned_bytes}}`` (live dicts)."""
        return {"reshard": self._reshard}

    @property
    def placements(self) -> Dict[str, Dict[str, Optional[int]]]:
        """``relation → {"data": dim, "model": dim}``: which dim carries
        the mesh's (folded) data axes and which the model axis (None =
        replicated on that axis). For a CooRelation dim 0 is the nnz row
        axis. On a mesh this reads the effective specs (non-divisible
        dense dims dropped); without one, the planner's intent."""
        geo = self.geometry
        model_axis = geo.model_axis if geo is not None else "model"
        data_axes = set(geo.data_axes) if geo is not None else set()

        def dims_of(spec) -> Dict[str, Optional[int]]:
            data_dim = model_dim = None
            for d, entry in enumerate(tuple(spec)):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                if any(a in data_axes for a in axes):
                    data_dim = d
                if model_axis in axes:
                    model_dim = d
            return {"data": data_dim, "model": model_dim}

        specs = self.input_specs if self.in_shardings is None else self.in_shardings
        return {n: dims_of(s) for n, s in specs.items()}

    def planned_spec(self, name: str) -> Optional[P]:
        """The spec this executable places relation ``name``'s payload
        (a DenseRelation's ``data`` / a CooRelation's ``values``) at."""
        if self.in_shardings is None:
            return self.input_specs.get(name)
        return self.in_shardings.get(name)

    def _unpad(self, out):
        """Cut padded nnz rows out of the results: an output leaf whose
        leading dim exceeds the lowering's (all other dims equal) is a
        row-aligned COO payload of a padded relation."""
        got, struct = _flatten(out)
        want, _ = _flatten(self.lowered.out_shape)
        cut = []
        for g, w in zip(got, want):
            ws = tuple(w.shape)
            if (tuple(g.shape) != ws and g.dim() == len(ws) and ws
                    and g.shape[0] > ws[0] and tuple(g.shape[1:]) == ws[1:]):
                g = g[: ws[0]]
            cut.append(g)
        return _unflatten(struct, cut)

    def _comm(self):
        from ..launch.collectives import comm_for

        return comm_for(self.mesh, self.geometry)

    def _place(self, name: str, rel: AnyRel, place) -> Tuple[AnyRel, Dict[int, str], int]:
        """This rank's shard of ``rel`` at the planned spec (a COO padded
        to ``pad_nnz`` first), its layout, and the bytes of a committed
        layout moved to get there."""
        from .compiler import spec_layout

        arity = 1 if isinstance(rel, CooRelation) else rel.key_arity
        target = spec_layout(self.in_shardings.get(name), self.geometry, arity)
        have = _dtensor_spec(_payload(rel))
        pad = self.pad_nnz.get(name)
        if have is None:
            if pad is not None:
                rel = pad_coo_nnz(rel, pad)
            return (*place.move(rel, {}, target), 0)
        local = (
            DenseRelation(rel.data.to_local(), rel.key_arity)
            if isinstance(rel, DenseRelation)
            else CooRelation(rel.keys.to_local(), rel.values.to_local(), rel.extents,
                             rel.owner_dim, rel.shard_offsets)
        )
        lay = spec_layout(have, self.geometry, arity)
        if lay == target and pad is None:
            return local, lay, 0
        # a relation committed whole on every rank is cut for free
        nbytes = int(planner._rel_bytes(rel)) if lay else 0
        whole, _ = place.whole(local, lay)
        if pad is not None:
            whole = pad_coo_nnz(whole, pad)
        return (*place.move(whole, {}, target), nbytes)

    def _local_lowering(self, local_env: Env, layouts, seed, comm) -> "Lowered":
        """The lowering walk at one rank's shard shapes: the placed walk
        on ``meta`` shards with shape-only collectives, recording the
        dispatch sites the kernels launch at."""
        from ..launch.collectives import ShapeComm
        from .compiler import Placement

        low = self.lowered
        meta_env = {k: _meta(v) for k, v in local_env.items()}
        meta_seed = None if seed is None else _meta(seed)
        resolutions = kernels.ResolutionLog()
        place = Placement(ShapeComm(comm), layouts, self.plans)
        out = low.engine._execute(meta_env, meta_seed, dispatch=low.dispatch,
                                  resolutions=resolutions, program=low.program, place=place)
        return Lowered(low.engine, env_signature(meta_env, meta_seed), low.dispatch, out,
                       resolutions, program=low.program, rewrite_report=low.rewrite_report,
                       check_report=low.check_report, meta_env=meta_env)

    def __call__(self, env: Env, seed: Optional[AnyRel] = None):
        sig = env_signature(env, seed)
        if sig != self.lowered.sig:
            raise ValueError(
                "environment signature does not match this Compiled's "
                "lowering; call RAEngine.lower(env) again for the new "
                f"shapes.\n  lowered: {self.lowered.sig}\n  got:     {sig}"
            )
        low = self.lowered
        if self.mesh is None:
            return low.engine._execute(env, seed, dispatch=low.dispatch, program=low.program)
        from .compiler import Placement

        comm = self._comm()
        place = Placement(comm, {}, self.plans)
        local_env: Env = {}
        moved: Dict[str, int] = {}
        for name, rel in env.items():
            local_env[name], place.layouts[name], nbytes = self._place(name, rel, place)
            if nbytes:
                moved[name] = nbytes
        # moves the plan priced (its rechunk stage) are booked as planned;
        # the others are the silent reshards the counter and warning report
        stats = self._reshard
        stats["calls"] += 1
        stats["planned_bytes"] += sum(b for n, b in moved.items() if n in self.rechunks)
        silent = {n: b for n, b in moved.items() if n not in self.rechunks}
        stats["last_call_bytes"] = sum(silent.values())
        if silent:
            stats["resharded_calls"] += 1
            stats["bytes_moved"] += sum(silent.values())
            for name, nbytes in silent.items():
                if name not in self._reshard_warned:
                    self._reshard_warned.add(name)
                    warnings.warn(ReshardWarning(name, nbytes), stacklevel=2)
        if self.local is None:
            self.local = self._local_lowering(local_env, place.layouts, seed, comm)
        out = low.engine._execute(local_env, seed, dispatch=low.dispatch,
                                  program=low.program, place=place)
        return self._unpad(out) if self.pad_nnz else out


class Lowered:
    """The lowering of an engine's program for one environment signature
    and one kernel DispatchTable: the validate report, the rewritten
    program, the resolved dispatch sites and the output shapes.

    Cache-key semantics: the engine caches Lowereds under ``(sig,
    dispatch, rewrite-key)`` where ``sig`` is ``env_signature(env, seed)``
    — relation structure, key arities, shapes, dtypes, device type —
    ``dispatch`` is the (hashable) DispatchTable, and the rewrite key is
    the enabled ``rewrite.RuleSet`` plus the quantized statistics snapshot
    the cost gate read (None when the rewrite stage is off)."""

    def __init__(
        self,
        engine: "RAEngine",
        sig: Tuple,
        dispatch: kernels.DispatchTable,
        out_shape,
        resolutions: Dict[str, str],
        program: Optional[Program] = None,
        rewrite_report: Optional[_rewrite.RewriteReport] = None,
        check_report=None,
        meta_env: Optional[Env] = None,
    ):
        self.engine = engine
        self.sig = sig
        #: the environment on ``meta`` tensors (whole shapes): what the
        #: planner sizes relations from at compile time.
        self.meta_env = dict(meta_env or {})
        #: validate-stage report (analysis.typecheck.CheckReport): error-free
        #: by construction (errors raise before a Lowered is built).
        self.check_report = check_report
        #: the kernel tier table this lowering resolved against.
        self.dispatch = dispatch
        #: the program this lowering executes: the engine's program as
        #: rewritten by the cost-gated rewrite stage (core/rewrite.py),
        #: or the engine's own program when the stage was off/declined.
        self.program: Program = engine.program if program is None else program
        #: gate decisions of the rewrite stage (None when it was off).
        self.rewrite_report = rewrite_report
        #: the program output with ``meta`` tensors (shapes and dtypes).
        self.out_shape = out_shape
        #: op[site] → tier decisions recorded during the lowering walk
        #: (a kernels.ResolutionLog: the dict plus per-site SiteRecords).
        self.resolutions = resolutions
        #: analysis.kernelcheck.certify_kernels caches its CheckReport
        #: here — the Lowered is already cached per (sig, dispatch,
        #: rewrite) key, so kernel certification is computed at most once
        #: per lowering and never on the execution hot path.
        self._kernel_report = None
        #: LRU-bounded Compiled executables per placement key.
        self._compiled: "OrderedDict[Tuple, Compiled]" = OrderedDict()
        #: compile_auto's plan record: per (mesh, donate, …) base key the
        #: Compiled whose committed-layout plan the catalog stands by.
        self._auto: "OrderedDict[Tuple, Compiled]" = OrderedDict()

    def eager(self, env: Env, seed: Optional[AnyRel] = None):
        """Un-staged execution of this lowering's program under its table
        (re-walks the graph; debugging only)."""
        return self.engine._execute(
            env, seed, dispatch=self.dispatch, program=self.program
        )

    def compile(
        self,
        mesh=None,
        *,
        axis: Optional[str] = None,
        donate: Tuple[str, ...] = (),
        mem_budget: float = planner.DEFAULT_MEM_BUDGET,
        n_devices: Optional[int] = None,
        committed: Optional[Dict[str, P]] = None,
        stats: Optional[Dict[str, planner.RelationStats]] = None,
    ) -> Compiled:
        """plan_query → placement → the (cached) executable.

        ``mesh``: a DeviceMesh — ``launch/mesh.make_host_mesh`` and
        ``make_production_mesh`` are the canonical constructors. The
        planner reads the (data × model) geometry off it
        (``planner.MeshGeometry.from_mesh``): a 1-axis mesh gives the 1-D
        model-axis plans, a 2-D mesh adds batch-dim sharding over the data
        axes and may shard a CooRelation's nnz rows over them (padding a
        row count that does not split instead of replicating it). None
        compiles for one device but still runs the planner (the plans are
        inspectable either way). ``axis`` overrides the name of the model
        axis. ``donate`` names env entries the caller hands over (part of
        the cache key; PyTorch runs eagerly and reuses nothing itself).
        ``committed`` maps relation names to the spec their tensors are
        already committed to (``_committed_layouts(env)``): the planner
        then charges candidates that would move them. ``stats`` maps
        relation names to tracked ``planner.RelationStats`` (a catalog
        snapshot): the planner replaces its Σ-size / edge-cut heuristics
        with them. Both are part of the cache key."""
        donate = tuple(sorted(donate))
        geo = planner.MeshGeometry.from_mesh(mesh, axis=axis) if mesh is not None else None
        if n_devices is None:
            n_devices = geo.model_size if geo is not None else 1
        elif geo is not None and n_devices != geo.model_size:
            # an explicit n_devices overrides the mesh's model-axis size in
            # the cost model (the reference's contract)
            geo = dataclasses.replace(geo, model_size=n_devices)
        committed_key = tuple(sorted(committed.items())) if committed else None
        key = (mesh, axis, donate, mem_budget, n_devices, geo, committed_key, _stats_key(stats))
        hit = self._compiled.get(key)
        if hit is not None:
            self._compiled.move_to_end(key)
            return hit

        fwd_query = (
            self.program.forward if isinstance(self.program, GradientProgram) else self.program
        )
        env = self.meta_env
        plans = planner.plan_query(
            fwd_query, env, n_devices, mem_budget=mem_budget, geometry=geo,
            committed=committed, stats=stats,
        )
        input_specs = planner.input_pspecs(fwd_query, plans)
        # the rechunk stage: relations committed to another layout than the
        # plan's, the move priced by the planner (committed=)
        rechunks: Dict[str, int] = {}
        if committed and mesh is not None:
            for name, spec in committed.items():
                if _norm_spec(spec) != _norm_spec(input_specs.get(name)) and name in env:
                    rechunks[name] = int(planner._rel_bytes(env[name]))
        in_shardings = pad_nnz = None
        if mesh is not None:
            in_shardings, pad_nnz = {}, {}
            sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
            for name, rel in env.items():
                in_shardings[name], pad = self._rel_sharding(name, rel, input_specs.get(name), sizes)
                if pad is not None:
                    pad_nnz[name] = pad
        compiled = Compiled(self, plans, input_specs, mesh, geo, in_shardings, pad_nnz, rechunks,
                            donate)
        self._compiled[key] = compiled
        while len(self._compiled) > _MAX_COMPILED:
            self._compiled.popitem(last=False)
        return compiled

    def compile_auto(
        self,
        env: Env,
        *,
        mesh=None,
        axis: Optional[str] = None,
        donate: Tuple[str, ...] = (),
        mem_budget: float = planner.DEFAULT_MEM_BUDGET,
        stats: Optional[Dict[str, planner.RelationStats]] = None,
    ) -> Compiled:
        """``compile`` with committed layouts threaded and a plan-stability
        guarantee: the committed layouts of ``env``'s tensors (DTensors on
        the mesh, ``_committed_layouts``) are folded into planning, but
        when every committed input already sits at the recorded plan's own
        placement that ``Compiled`` is returned as-is, so first and later
        calls run the identical plan. Only an input committed to a
        different layout re-plans, the move priced. This is the compile
        entry the ``Database`` session and the relational operators step
        through."""
        donate = tuple(sorted(donate))
        base = (mesh, axis, donate, mem_budget, _stats_key(stats))
        committed = _committed_layouts(env) if mesh is not None else {}
        prev = self._auto.get(base)
        if prev is not None and all(
            _norm_spec(prev.planned_spec(name)) == _norm_spec(spec)
            for name, spec in committed.items()
        ):
            self._auto.move_to_end(base)
            return prev
        compiled = self.compile(
            mesh=mesh, axis=axis, donate=donate, mem_budget=mem_budget,
            committed=committed or None, stats=stats,
        )
        self._auto[base] = compiled
        while len(self._auto) > _MAX_COMPILED:
            self._auto.popitem(last=False)
        return compiled

    @staticmethod
    def _rel_sharding(
        name: str, rel: AnyRel, spec: Optional[P], sizes: Dict[str, int]
    ) -> Tuple[P, Optional[int]]:
        """The effective spec of one relation's payload on the mesh, plus
        the padded nnz row count when a COO's planned nnz sharding does not
        divide (pad-and-mask; None = no padding).

        Dense: the planner's block-axis spec over the data's dims; a
        folded data-axis entry divides by the axes' product, and a
        non-divisible extent falls back to replicating that dim with a
        ``ShardFallbackWarning``. COO: the planner's nnz entry on the row
        axis; a row count that does not split is padded up to the next
        shard multiple rather than replicated."""

        def axes_total(ax) -> Optional[int]:
            axes = ax if isinstance(ax, tuple) else (ax,)
            if any(a not in sizes for a in axes):
                return None
            total = 1
            for a in axes:
                total *= int(sizes[a])
            return total

        if isinstance(rel, CooRelation):
            row_ax = tuple(spec)[0] if spec is not None and tuple(spec) else None
            total = axes_total(row_ax) if row_ax is not None else None
            if row_ax is None or total is None or total <= 1:
                return P(), None
            nnz = int(rel.keys.shape[0])
            pad = ((nnz + total - 1) // total) * total if nnz % total else None
            return P(row_ax, *([None] * (rel.values.dim() - 1))), pad

        full: list = [None] * rel.data.dim()
        if spec is not None:
            for d, ax in enumerate(tuple(spec)):
                if ax is None or d >= rel.key_arity:
                    continue
                total = axes_total(ax)
                if total is None:
                    continue
                if rel.data.shape[d] % total == 0:
                    full[d] = ax
                elif total > 1:
                    warnings.warn(
                        ShardFallbackWarning(name, d, int(rel.data.shape[d]), total),
                        stacklevel=4,
                    )
        return P(*full), None


# ---------------------------------------------------------------------------
# StreamedCompiled: out-of-core chunk-wave execution
# ---------------------------------------------------------------------------


def _flatten(tree) -> Tuple[list, object]:
    """(tensor leaves, structure) of an engine output: relations (their
    tensors), tuples and dicts (in sorted key order) — the structures
    ``_execute`` returns."""
    if isinstance(tree, DenseRelation):
        return [tree.data], ("dense", tree.key_arity)
    if isinstance(tree, CooRelation):
        return [tree.keys, tree.values], (
            "coo", tree.extents, tree.owner_dim, tree.shard_offsets,
        )
    if isinstance(tree, tuple):
        parts = [_flatten(t) for t in tree]
        return [x for leaves, _ in parts for x in leaves], (
            "tuple", tuple(d for _, d in parts),
        )
    if isinstance(tree, dict):
        names = sorted(tree)
        parts = [_flatten(tree[n]) for n in names]
        return [x for leaves, _ in parts for x in leaves], (
            "dict", tuple(names), tuple(d for _, d in parts),
        )
    raise TypeError(f"cannot flatten an engine output of type {type(tree)}")


def _unflatten(struct, leaves: list):
    """Inverse of ``_flatten``: consumes ``leaves`` from the front."""
    kind = struct[0]
    if kind == "dense":
        return DenseRelation(leaves.pop(0), struct[1])
    if kind == "coo":
        keys, values = leaves.pop(0), leaves.pop(0)
        return CooRelation(keys, values, *struct[1:])
    if kind == "tuple":
        return tuple(_unflatten(d, leaves) for d in struct[1])
    return {n: _unflatten(d, leaves) for n, d in zip(struct[1], struct[2])}


class StreamedCompiled:
    """Chunk-wave executor for a ``planner.WavePlan``: the session's
    memory budget did not fit the environment, so the streamed relation
    (and its co-streams) live host-side in the ``ChunkStore`` and each
    call runs the normally-compiled step once per wave over ``resident +
    one chunk``. The host→device copy of wave ``w+1`` is issued on the
    store's copy stream before wave ``w``'s compute, and wave ``w+1``'s
    compute waits for it on its own stream (``chunkstore.Fetched.wait``).

    Wave results merge by the plan's soundness analysis
    (``planner._stream_states``): an output leaf whose shape equals the
    full in-core lowering's expectation is an additive partial (Σ across
    waves, in wave order, on the device — the loss, gradients of resident
    relations); a leaf whose shape differs along exactly one axis is
    wave-local rows of the streamed axis (gradients of the streamed
    relation itself) and is sliced to the wave's live rows — dropping the
    COO pad rows of ``pad_coo_nnz`` — copied to the host and concatenated
    there in row order as CPU tensors: the full-size streamed-axis result
    is host-tier data by definition (it did not fit the device budget).
    Each wave is folded in as it ends, so no two waves' partials are held
    at once. Either way the merged result equals the in-core step's.

    The full environment is lowered once on ``meta`` tensors, for its
    output shapes only (never executed): its streamed relations lie on the
    host beside the device-resident ones. Every wave's environment lies
    wholly on the session's device; COO waves are padded to the largest
    chunk, so they share one signature and one lowering.

    On a mesh each wave runs as a mesh ``Compiled`` (``compile_wave``
    compiles it on the step's mesh): every rank fetches the whole wave from
    its own store, and the step cuts the rank's rows, as it cuts any whole
    relation. ``row_multiple`` is then the number of ranks: a COO wave is
    padded to the largest chunk rounded up to it, so the mesh step pads
    nothing more and the pad rows are dropped once, by the merge. A mesh
    step's outputs are whole and equal on every rank, so every rank merges
    the same leaves.

    Exposes what the session reads off a ``Compiled`` (``mesh``,
    ``resolutions``, ``lowered``, ``plans``, ``placements``,
    ``planned_spec``) by delegating to the per-wave inner ``Compiled``
    (identical across waves of equal signature, so its ``counters`` add
    each wave's reshards). ``planned_spec`` is None for a streamed
    relation: it lies on the host, and no layout is committed for it."""

    def __init__(self, plan, store, compile_wave, lower_full, *, row_multiple: int = 1):
        self.plan = plan
        self.store = store
        #: wave env → Compiled (the session's normal staged path; the
        #: engine's lowering cache makes waves 2..n cache hits).
        self._compile_wave = compile_wave
        #: full env → Lowered (shapes only — never executed): its
        #: out_shape is the merge oracle for ADD-vs-CONCAT leaves.
        self._lower_full = lower_full
        #: a COO wave's rows are padded to a multiple of this (the ranks)
        self.row_multiple = max(1, int(row_multiple))
        self._inner: Optional[Compiled] = None

    # -- Compiled surface ---------------------------------------------------

    @property
    def num_waves(self) -> int:
        return self.plan.num_waves

    @property
    def resolutions(self) -> Dict[str, str]:
        return self._inner.resolutions if self._inner is not None else {}

    @property
    def mesh(self):
        """The inner ``Compiled``'s mesh (None before the first call)."""
        return self._inner.mesh if self._inner is not None else None

    @property
    def plans(self):
        return self._inner.plans if self._inner is not None else {}

    @property
    def placements(self):
        return self._inner.placements if self._inner is not None else {}

    @property
    def counters(self) -> Dict[str, Dict[str, int]]:
        if self._inner is None:
            return {"reshard": {
                "calls": 0, "resharded_calls": 0, "bytes_moved": 0,
                "last_call_bytes": 0, "planned_bytes": 0,
            }}
        return self._inner.counters

    def planned_spec(self, name: str):
        if name in self.plan.streamed_names or self._inner is None:
            return None
        return self._inner.planned_spec(name)

    @property
    def lowered(self) -> Optional[Lowered]:
        """The per-wave lowering (None before the first call)."""
        return self._inner.lowered if self._inner is not None else None

    # -- execution ----------------------------------------------------------

    def _fetch_wave(self, w: int):
        """Wave ``w``'s chunks, their copies issued (in flight on CUDA)."""
        return {name: self.store.fetch(name, w) for name in self.plan.streamed_names}

    def _waves(self, resident: Env, seed: Optional[AnyRel]):
        """Run the step once per wave, yielding each wave's output."""
        from .relation import pad_coo_nnz

        bnd = self.plan.boundaries
        max_rows = max(bnd[w + 1] - bnd[w] for w in range(self.plan.num_waves))
        max_rows = -(-max_rows // self.row_multiple) * self.row_multiple
        fetched = self._fetch_wave(0)
        for w in range(self.plan.num_waves):
            wave = dict(resident)
            for name, f in fetched.items():
                rel = f.wait()
                if isinstance(rel, CooRelation):
                    # pad every COO wave to the largest chunk (rounded up
                    # to the ranks) so all waves share one env signature
                    # (one lowering); pad rows carry COO_PAD_KEY and are
                    # sliced off on merge
                    rel = pad_coo_nnz(rel, max_rows)
                wave[name] = rel
            # the next wave's copy runs while this wave computes
            fetched = self._fetch_wave(w + 1) if w + 1 < self.plan.num_waves else {}
            compiled = self._compile_wave(wave, seed)
            self._inner = compiled
            yield compiled(wave, seed)

    def _merge(self, wave_outs, want_shape):
        """Fold the waves' outputs (an iterable, consumed in wave order)
        into the in-core result whose shapes ``want_shape`` gives."""
        from .chunkstore import OutOfCoreError

        want_leaves, want_def = _flatten(want_shape)
        bnd = self.plan.boundaries
        sums: list = [None] * len(want_leaves)
        rows: list = [None] * len(want_leaves)  # (axis, host parts, shapes)
        for w, out in enumerate(wave_outs):
            leaves, _ = _flatten(out)
            if len(leaves) != len(want_leaves):
                raise OutOfCoreError(
                    "wave output structure does not match the in-core lowering"
                )
            for i, (want, g) in enumerate(zip(want_leaves, leaves)):
                wshape = tuple(want.shape)
                if tuple(g.shape) == wshape and rows[i] is None:
                    sums[i] = g if sums[i] is None else sums[i] + g
                    continue
                seen = {tuple(g.shape)} | (set(rows[i][2]) if rows[i] else set())
                if sums[i] is not None:
                    seen.add(wshape)
                diff_axes = {
                    ax
                    for s in seen
                    if len(s) == len(wshape)
                    for ax in range(len(s))
                    if s[ax] != wshape[ax]
                }
                if (
                    sums[i] is not None
                    or len(diff_axes) != 1
                    or any(len(s) != len(wshape) for s in seen)
                ):
                    raise OutOfCoreError(
                        f"cannot merge wave output leaf of shapes {seen} "
                        f"into expected {wshape}: not an additive partial and "
                        "not single-axis wave rows"
                    )
                ax = diff_axes.pop()
                if rows[i] is None:
                    rows[i] = (ax, [], [])
                # drop the wave's COO pad rows; host-side assembly
                live = g.narrow(ax, 0, bnd[w + 1] - bnd[w])
                rows[i][1].append(live.cpu())
                rows[i][2].append(tuple(g.shape))
            del out, leaves
        merged = [
            sums[i] if rows[i] is None else torch.cat(rows[i][1], dim=rows[i][0])
            for i in range(len(want_leaves))
        ]
        return _unflatten(want_def, merged)

    def __call__(self, env: Env, seed: Optional[AnyRel] = None):
        from .relation import ChunkManifest

        plan = self.plan
        streamed = set(plan.streamed_names)
        axis_of = dict(plan.axis_of)
        smani = ChunkManifest(
            axis=0,
            boundaries=plan.boundaries,
            owner_aligned=plan.owner_aligned,
        )
        self.store.spill(plan.stream, env[plan.stream], smani)
        for name in plan.co_streams:
            # co-streams share the stream's cut vector on their own axis:
            # wave w of the stream joins wave w of every co-stream
            self.store.spill(
                name,
                env[name],
                ChunkManifest(axis=axis_of[name], boundaries=plan.boundaries),
            )
        resident = {k: v for k, v in env.items() if k not in streamed}
        want_shape = self._lower_full(env, seed).out_shape
        return self._merge(self._waves(resident, seed), want_shape)


# ---------------------------------------------------------------------------
# RAEngine: the wrapped program
# ---------------------------------------------------------------------------


class RAEngine:
    """Staged executor for an FRA query, bare gradient-graph root, or
    GradientProgram. Holds the lowering cache and the lowering counter.

    This is the library-level staged executor; the ``repro_torch.Database``
    session API (``db.query(...)``) layers the catalog — tracked
    statistics, the session's device and dispatch table — on top of it."""

    def __init__(self, program: Program, *, fuse_join_agg: bool = True):
        self.source = program
        self.fuse_join_agg = fuse_join_agg
        #: number of lowerings (cache misses of ``lower``).
        self.lower_count = 0
        self._lowered: Dict[Tuple, Lowered] = {}

        if isinstance(program, GradientProgram):
            self.kind = "grad"
            self.program = program
        elif isinstance(program, fra.Query):
            self.kind = "query"
            self.program = program
        elif isinstance(program, fra.Node):
            self.kind = "query"
            inputs = tuple(sorted({s.name for s in program.table_scans()}))
            self.program = fra.Query(program, inputs)
        else:
            raise TypeError(f"cannot wrap program of type {type(program)}")

    @property
    def lowerings(self) -> Tuple["Lowered", ...]:
        """Every Lowered in this engine's cache (one per signature, table
        and rewrite key)."""
        return tuple(self._lowered.values())

    @property
    def forward_query(self) -> fra.Query:
        return (
            self.program.forward if self.kind == "grad" else self.program
        )

    # -- execution body (runs on real or meta tensors) ----------------------
    def _execute(
        self,
        env: Env,
        seed: Optional[AnyRel] = None,
        dispatch: Optional[kernels.DispatchTable] = None,
        resolutions: Optional[Dict[str, str]] = None,
        program: Optional[Program] = None,
        place=None,
    ):
        """Walk the program's FRA graph(s) over ``env``. ``program``
        overrides the engine's own program — the handle a ``Lowered`` uses
        to execute the *rewritten* program its cache entry lowered.
        ``place`` (a ``compiler.Placement``) runs the walks on one rank's
        shards of a mesh; their outputs are whole."""
        from . import compiler

        prog = self.program if program is None else program
        if not isinstance(prog, GradientProgram):
            if seed is not None:
                raise ValueError("seed is only meaningful for GradientPrograms")
            return compiler._execute_graph(
                prog.root,
                env,
                fuse_join_agg=self.fuse_join_agg,
                dispatch=dispatch,
                resolutions=resolutions,
                place=place,
            )

        fwd_cache: Env = {}
        out = compiler._execute_graph(
            prog.forward.root,
            env,
            cache=fwd_cache,
            fuse_join_agg=self.fuse_join_agg,
            dispatch=dispatch,
            resolutions=resolutions,
            place=place,
        )
        if seed is None:
            if not (isinstance(out, DenseRelation) and out.key_arity == 0):
                raise ValueError("default seed requires a scalar-loss output")
            seed = DenseRelation(torch.ones_like(out.data), key_arity=0)
        genv = dict(env)
        genv.update(fwd_cache)
        genv["__seed"] = seed
        # Gradient graphs fuse their own join-aggs regardless of how the
        # forward was executed (the reference's grad_eval contract).
        grads = {
            name: compiler._execute_graph(
                rootn, genv, dispatch=dispatch, resolutions=resolutions, place=place
            )
            for name, rootn in prog.grads.items()
        }
        return out, grads

    # -- the staged pipeline ----------------------------------------------
    def eager(
        self, env: Env, seed: Optional[AnyRel] = None, *, dispatch=None
    ):
        """Un-staged execution: walk the graph now, no validate or rewrite
        stage. ``dispatch`` takes anything ``kernels.make_table`` accepts;
        the device type comes from ``env``."""
        table = kernels.make_table(dispatch, backend=env_device(env, seed).type)
        return self._execute(env, seed, dispatch=table)

    def lower(
        self,
        env: Env,
        seed: Optional[AnyRel] = None,
        *,
        dispatch=None,
        stats: Optional[Dict[str, planner.RelationStats]] = None,
        rewrite=None,
    ) -> Lowered:
        """Lower the program at ``env``'s shapes under a kernel
        DispatchTable (``dispatch`` accepts anything ``kernels.make_table``
        does; None → the device type's default). Cached: a second call with
        an identical (signature, table, rewrite-key) triple returns the
        same Lowered without another walk; switching tiers is a cache miss.

        ``rewrite`` enables the cost-gated algebraic rewrite stage
        (core/rewrite.py): anything ``rewrite.make_rules`` accepts — True
        for the default rule set, a ``RuleSet``, an iterable of rule names;
        None/False skips the stage. ``stats`` is the catalog statistics
        snapshot the cost gate prices pushdowns with; its quantized form
        joins the enabled RuleSet in the cache key. An environment of
        ``meta`` tensors needs ``dispatch`` to be a DispatchTable: it names
        the device type the lowering resolves kernels for."""
        backend = env_device(env, seed).type
        # an environment of meta tensors (shapes only, as the streamed
        # executor's full-size lowering passes) lowers for the device type
        # of the DispatchTable it comes with
        table = kernels.make_table(dispatch, backend=None if backend == "meta" else backend)
        rules = _rewrite.make_rules(rewrite)
        rw_key = None if rules is None else (rules, _stats_key(stats))
        sig = env_signature(env, seed)
        key = (sig, table, rw_key)
        hit = self._lowered.get(key)
        if hit is not None:
            return hit
        # mandatory validate stage (repro_torch.analysis.typecheck): a
        # malformed query fails here with node-path diagnostics instead of
        # an error from deep inside the chunked lowering
        from ..analysis.typecheck import ValidationError, check_query

        check_report = check_query(
            self.forward_query, env, fuse_join_agg=self.fuse_join_agg
        )
        if not check_report.ok:
            raise ValidationError(check_report)
        meta_env = {k: _meta(v) for k, v in env.items()}
        meta_seed = None if seed is None else _meta(seed)
        program = None
        report = None
        if rules is not None:
            program, report = _rewrite.rewrite_program(
                self.program, meta_env, stats=stats, rules=rules
            )
        # the lowering walk, on meta tensors: resolves every dispatch site
        # (a ResolutionLog keeps each decision's site info) and yields the
        # output shapes, computing nothing
        resolutions: Dict[str, str] = kernels.ResolutionLog()
        out_shape = self._execute(
            meta_env, meta_seed, dispatch=table, resolutions=resolutions, program=program
        )
        self.lower_count += 1
        low = Lowered(
            self,
            sig,
            table,
            out_shape,
            resolutions,
            program=program,
            rewrite_report=report,
            check_report=check_report,
            meta_env=meta_env,
        )
        self._lowered[key] = low
        return low


# ---------------------------------------------------------------------------
# Module-level engine registry
# ---------------------------------------------------------------------------

_ENGINES: "OrderedDict[Tuple[int, bool], RAEngine]" = OrderedDict()
_MAX_ENGINES = 256


def engine_for(program: Program, *, fuse_join_agg: bool = True) -> RAEngine:
    """Engine per (program identity, fuse flag), LRU-bounded. The engine
    holds a strong reference to the program, so the id key cannot be
    recycled while the entry lives. This is the registry the ``Database``
    session steps through."""
    key = (id(program), fuse_join_agg)
    eng = _ENGINES.get(key)
    if eng is not None and eng.source is program:
        _ENGINES.move_to_end(key)
        return eng
    eng = RAEngine(program, fuse_join_agg=fuse_join_agg)
    _ENGINES[key] = eng
    while len(_ENGINES) > _MAX_ENGINES:
        _ENGINES.popitem(last=False)
    return eng


# ---------------------------------------------------------------------------
# The ambient mesh and committed layouts
# ---------------------------------------------------------------------------

#: ambient-mesh stack; a ContextVar so concurrent threads / tasks each see
#: only their own mesh-context nesting.
_MESH_STACK: "contextvars.ContextVar[Tuple[Any, ...]]" = contextvars.ContextVar(
    "repro_torch_engine_mesh_stack", default=()
)


@contextlib.contextmanager
def _use_mesh(mesh, device_type: str = "cuda"):
    """Ambient-mesh context: pushes ``mesh`` — a DeviceMesh or a
    ``launch/mesh.resolve_mesh`` spec string — onto the stack
    ``default_mesh`` reads."""
    if isinstance(mesh, str):
        from ..launch.mesh import resolve_mesh

        mesh = resolve_mesh(mesh, device_type=device_type)
    token = _MESH_STACK.set(_MESH_STACK.get() + (mesh,))
    try:
        yield mesh
    finally:
        _MESH_STACK.reset(token)


def default_mesh():
    """The innermost ambient (``_use_mesh``) mesh, or None."""
    stack = _MESH_STACK.get()
    return stack[-1] if stack else None


def _ambient_mesh():
    """The mesh a staged execution compiles against when it names none:
    the innermost ambient mesh (PyTorch has no trace to keep it out of)."""
    return default_mesh()


def _committed_layouts(env: Env) -> Dict[str, P]:
    """Partition spec per relation whose payload is a ``DTensor``
    (committed to its placements on a mesh) — the dict
    ``Lowered.compile(committed=...)`` expects. Plain tensors are whole
    on every rank, cut for free, and omitted."""
    out: Dict[str, P] = {}
    for name, rel in env.items():
        spec = _dtensor_spec(_payload(rel))
        if spec is not None:
            out[name] = spec
    return out
