"""Staged query engine: lower → compile → run, on one device.

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
        .compile()                # → Compiled: the cached callable
    compiled(env)                 # runs the lowered program on env

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
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple, Union

import torch

from . import fra, kernels, planner
from . import rewrite as _rewrite
from .autodiff import GradientProgram
from .relation import CooRelation, DenseRelation, relation_device

AnyRel = Union[DenseRelation, CooRelation]
Env = Dict[str, AnyRel]
Program = Union[fra.Query, fra.Node, GradientProgram]


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


def _meta(rel: AnyRel) -> AnyRel:
    """The relation with every tensor replaced by an empty ``meta`` tensor
    of the same shape and dtype (relation schema kept)."""
    if isinstance(rel, DenseRelation):
        return DenseRelation(torch.empty_like(rel.data, device="meta"), rel.key_arity)
    return CooRelation(
        torch.empty_like(rel.keys, device="meta"),
        torch.empty_like(rel.values, device="meta"),
        rel.extents,
        rel.owner_dim,
        rel.shard_offsets,
    )


# ---------------------------------------------------------------------------
# Compiled / Lowered
# ---------------------------------------------------------------------------


class Compiled:
    """The executable for one lowering: calling it with an environment of
    the lowering's signature runs the (rewritten) program under the
    lowering's dispatch table. A Compiled can only be replayed on
    environments whose signature matches the one it was lowered for
    (``__call__`` re-checks and raises otherwise)."""

    def __init__(self, lowered: "Lowered"):
        self.lowered = lowered

    @property
    def dispatch(self) -> kernels.DispatchTable:
        """The kernel DispatchTable this executable was lowered under."""
        return self.lowered.dispatch

    @property
    def resolutions(self) -> Dict[str, str]:
        """``op[site] → tier`` record of every kernel-dispatch decision
        taken while lowering (e.g. ``segment_sum[E=1335586,D=256,S=169343]``
        → ``'cuda'``)."""
        return dict(self.lowered.resolutions)

    def __call__(self, env: Env, seed: Optional[AnyRel] = None):
        sig = env_signature(env, seed)
        if sig != self.lowered.sig:
            raise ValueError(
                "environment signature does not match this Compiled's "
                "lowering; call RAEngine.lower(env) again for the new "
                f"shapes.\n  lowered: {self.lowered.sig}\n  got:     {sig}"
            )
        low = self.lowered
        return low.engine._execute(env, seed, dispatch=low.dispatch, program=low.program)


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
    ):
        self.engine = engine
        self.sig = sig
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
        self._compiled: Optional[Compiled] = None

    def compile(self) -> Compiled:
        """The (cached) executable of this lowering."""
        if self._compiled is None:
            self._compiled = Compiled(self)
        return self._compiled


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

    Exposes what the session reads off a ``Compiled`` (``resolutions``,
    ``lowered``) by delegating to the per-wave inner
    ``Compiled`` (identical across waves of equal signature)."""

    def __init__(self, plan, store, compile_wave, lower_full):
        self.plan = plan
        self.store = store
        #: wave env → Compiled (the session's normal staged path; the
        #: engine's lowering cache makes waves 2..n cache hits).
        self._compile_wave = compile_wave
        #: full env → Lowered (shapes only — never executed): its
        #: out_shape is the merge oracle for ADD-vs-CONCAT leaves.
        self._lower_full = lower_full
        self._inner: Optional[Compiled] = None

    # -- Compiled surface ---------------------------------------------------

    @property
    def num_waves(self) -> int:
        return self.plan.num_waves

    @property
    def resolutions(self) -> Dict[str, str]:
        return self._inner.resolutions if self._inner is not None else {}

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
        fetched = self._fetch_wave(0)
        for w in range(self.plan.num_waves):
            wave = dict(resident)
            for name, f in fetched.items():
                rel = f.wait()
                if isinstance(rel, CooRelation):
                    # pad every COO wave to the largest chunk so all waves
                    # share one env signature (one lowering); pad rows
                    # carry COO_PAD_KEY and are sliced off on merge
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
    ):
        """Walk the program's FRA graph(s) over ``env``. ``program``
        overrides the engine's own program — the handle a ``Lowered`` uses
        to execute the *rewritten* program its cache entry lowered."""
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
            )

        fwd_cache: Env = {}
        out = compiler._execute_graph(
            prog.forward.root,
            env,
            cache=fwd_cache,
            fuse_join_agg=self.fuse_join_agg,
            dispatch=dispatch,
            resolutions=resolutions,
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
                rootn, genv, dispatch=dispatch, resolutions=resolutions
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
