"""Database session: the front door from an FRA query to a compiled
gradient step, on one device or a mesh of ranks.

``Database`` (re-exported as ``repro_torch.Database``) owns the **catalog**
a relational system keeps — named relations with schemas (key attribute
names) and tracked key-domain statistics (``planner.RelationStats``,
refreshed on ``db.put``) — plus the session's device and kernel dispatch
table, and one query path::

    db = repro_torch.Database()                   # device "cuda"
    db.put("Rx", X, keys=("row", "col"))
    db.put("Ry", y, keys=("row",))
    db.put("theta", theta, keys=("col",))
    handle = db.sql(LOGREG_SQL, wrt=("theta",))   # or db.query(fra.Query)
    loss = handle.forward()
    grads = handle.grad()                         # RA-autodiff, compiled
    loss, grads = handle.step()                   # the training hot path

``forward`` / ``grad`` / ``step`` lower → compile through the staged engine
(core/engine.py) and source everything from the catalog: relation
environments by name, the statistics snapshot the rewrite stage prices
with, and the dispatch table.

A session runs on ``device="cuda"`` unless the caller asks for another
device; it raises where there is no GPU rather than run on the CPU unasked.

``Database(mesh=...)`` plans and places every step on a (data × model)
``DeviceMesh`` over the ranks of a ``torch.distributed`` group (a mesh, or
a ``launch/mesh.resolve_mesh`` spec string such as ``"host:2"``, resolved
on the session's device type): each rank runs the same step on its shards
(``engine.Compiled``); ``handle.plans``/``placements`` show the physical
plans, ``db.counters()["reshard"]`` the layout moves of committed inputs.

``Database(memory_budget=...)`` bounds the bytes of relations a step may
hold on the device: a step whose environment exceeds it streams its largest
streamable base relation through the device in chunk waves (``planner.plan_waves``,
``engine.StreamedCompiled``), from the session's host-resident
``ChunkStore``. A relation larger than the budget is kept on the host by
``put``, and one that a step streams moves there (``Database._place``).
``db.counters()["spill"]`` reads the store's counters. On a mesh every
rank's session keeps a store of its own that holds the whole stream (the
budget is the session's, not divided by the ranks); each wave is compiled
on the step's mesh, and the mesh step cuts the rank's rows of the wave as
it cuts any whole relation. ``db.release()`` drops the store's chunks and
hands their pinned host blocks back.

The catalog also holds the **model registry** the serving front door
resolves requests through (``db.register_model``, ``db.model``,
``db.endpoint``: serving/service.py), and the session keeps an LRU
**executable cache** (``cached_executable``, bounded by
``max_cache_entries``) that holds the serving steps, one per bucket;
``db.counters()["cache"]`` and ``["serve"]`` count both.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

from . import chunkstore as _chunkstore
from . import engine as _engine
from . import fra, kernels, planner
from . import rewrite as _rewrite
from . import spans as _spans
from . import sql as _sql
from .autodiff import GradientProgram, ra_autodiff
from .relation import (
    CooRelation,
    DenseRelation,
    measure_stats,
    relation_device,
    to_device,
)

AnyRel = Union[DenseRelation, CooRelation]


class CatalogError(KeyError):
    """A query referenced a relation the session's catalog does not hold
    (or holds in an unusable state, e.g. donated to a compiled step)."""

    def __str__(self) -> str:  # KeyError repr()s its args; keep prose
        return self.args[0] if self.args else ""


@dataclass
class TableEntry:
    """One catalog row: a named relation plus what the optimizer knows
    about it."""

    name: str
    relation: AnyRel
    #: key attribute names (the schema; positional order = key dims).
    key_attrs: Tuple[str, ...]
    #: tracked key-domain statistics (refreshed on ``Database.put``).
    stats: planner.RelationStats
    #: True once the relation was handed to a step as donated — the entry
    #: must be re-``put`` before it can be read again.
    donated: bool = False


@dataclass
class ModelEntry:
    """One row of the catalog's model registry: a served model under a
    ``name@version`` coordinate. The serving front door
    (``Database.endpoint``) resolves every request — including per-tenant
    aliases — through these entries, so re-registering a version swaps
    the served parameters without touching the endpoint."""

    name: str
    version: str
    model: Any
    params: Any

    @property
    def key(self) -> Tuple[str, str]:
        return (self.name, self.version)

    def __str__(self) -> str:
        return f"{self.name}@{self.version}"


class Catalog:
    """Named relations + schemas + statistics, plus the model registry
    the serving front door resolves requests through."""

    def __init__(self) -> None:
        self._tables: "OrderedDict[str, TableEntry]" = OrderedDict()
        #: name → version → ModelEntry (insertion order; last = latest).
        self._models: "OrderedDict[str, OrderedDict[str, ModelEntry]]" = (
            OrderedDict()
        )

    def __contains__(self, name: str) -> bool:
        return name in self._tables

    def __iter__(self) -> Iterator[str]:
        return iter(self._tables)

    def __len__(self) -> int:
        return len(self._tables)

    def entry(self, name: str) -> TableEntry:
        try:
            return self._tables[name]
        except KeyError:
            raise CatalogError(
                f"relation {name!r} is not in the catalog "
                f"(tables: {sorted(self._tables)}); db.put(...) it first"
            ) from None

    def items(self):
        return self._tables.items()

    def put(
        self,
        name: str,
        relation: AnyRel,
        key_attrs: Optional[Sequence[str]] = None,
        *,
        refresh_stats: bool = True,
    ) -> TableEntry:
        """Register ``relation`` under ``name``. ``refresh_stats=False``
        keeps the previous entry's statistics (when there is one)."""
        prev = self._tables.get(name)
        if key_attrs is None:
            if prev is not None and len(prev.key_attrs) == relation.key_arity:
                key_attrs = prev.key_attrs  # keep the declared schema
            else:
                key_attrs = tuple(f"k{i}" for i in range(relation.key_arity))
        key_attrs = tuple(key_attrs)
        if len(key_attrs) != relation.key_arity:
            raise ValueError(
                f"relation {name!r}: {len(key_attrs)} key attribute name(s) "
                f"{key_attrs} for key arity {relation.key_arity}"
            )
        if refresh_stats or prev is None:
            stats = measure_stats(relation)
        else:
            stats = prev.stats
        entry = TableEntry(name, relation, key_attrs, stats)
        self._tables[name] = entry
        return entry

    def drop(self, name: str) -> None:
        self._tables.pop(name, None)

    def schema(self) -> Dict[str, Tuple[str, ...]]:
        """{relation: key attribute names}."""
        return {n: e.key_attrs for n, e in self._tables.items()}

    def snapshot(
        self, names: Optional[Sequence[str]] = None
    ) -> Dict[str, planner.RelationStats]:
        """Cheap, hashable statistics snapshot (the ``stats=`` argument of
        ``RAEngine.lower``). ``names`` restricts the snapshot to the given
        relations, so that the snapshot (a cache key component) is
        insensitive to updates of unrelated catalog tables."""
        if names is None:
            return {n: e.stats for n, e in self._tables.items()}
        return {
            n: self._tables[n].stats for n in names if n in self._tables
        }

    # -- model registry (the serving front door resolves through this) -----

    def put_model(
        self, name: str, model, params, version: Optional[str] = None
    ) -> ModelEntry:
        """Register (or update) a served model version. ``version``
        defaults to ``v<n+1>``; re-registering an existing version swaps
        its model/params in place (live endpoints pick the new parameters
        up on the next batch they form)."""
        versions = self._models.setdefault(name, OrderedDict())
        if version is None:
            version = f"v{len(versions) + 1}"
        entry = ModelEntry(name, str(version), model, params)
        versions[entry.version] = entry
        versions.move_to_end(entry.version)
        return entry

    def model(self, name: str, version: Optional[str] = None) -> ModelEntry:
        """Resolve ``name[@version]`` to a registered ModelEntry (latest
        registered version when ``version`` is None)."""
        if version is None and "@" in name:
            name, _, version = name.partition("@")
        try:
            versions = self._models[name]
        except KeyError:
            raise CatalogError(
                f"model {name!r} is not registered (models: "
                f"{sorted(self._models)}); db.register_model(...) it first"
            ) from None
        if version is None:
            return next(reversed(versions.values()))
        try:
            return versions[str(version)]
        except KeyError:
            raise CatalogError(
                f"model {name!r} has no version {version!r} "
                f"(versions: {list(versions)})"
            ) from None

    def models(self) -> Dict[str, Tuple[str, ...]]:
        """{model name: registered versions, oldest→latest}."""
        return {n: tuple(v) for n, v in self._models.items()}


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

#: ambient session stack (ContextVar: concurrent threads/tasks see only
#: their own ``Database.activate`` nesting).
_SESSION_STACK: "contextvars.ContextVar[Tuple[Database, ...]]" = (
    contextvars.ContextVar("repro_torch_session_stack", default=())
)
_PROCESS_DEFAULT: Optional["Database"] = None


def current() -> "Database":
    """The ambient session: the innermost ``Database.activate`` block's
    session, else a process-wide default ``Database()`` (device "cuda").
    The relational operator layer (``rel_matmul``, ``gcn_conv``) steps
    through this, so activating a session picks the device and dispatch
    table of those ops without new arguments crossing the
    ``torch.autograd.Function`` boundary."""
    stack = _SESSION_STACK.get()
    if stack:
        return stack[-1]
    global _PROCESS_DEFAULT
    if _PROCESS_DEFAULT is None:
        _PROCESS_DEFAULT = Database()
    return _PROCESS_DEFAULT


def resolve_device(device, owner: str = "repro_torch.Database") -> torch.device:
    """``device`` as a torch.device, "cuda" when it is None; raises when it
    names a CUDA device and there is none, rather than run on the CPU
    unasked. ``owner`` names the caller in the error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner} runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _serve_counters() -> Dict[str, Any]:
    """Zeroed ``serve/`` subtree of the unified counter tree — the async
    serving front door (serving/service.py) increments these."""
    return {
        "requests": 0,        # submitted to an endpoint on this session
        "admitted": 0,        # passed the bounded admission queue
        "completed": 0,       # futures resolved with a Completion
        "failed": 0,          # futures resolved with an error
        "shed_queue_full": 0,  # rejected: admission queue at max_queue
        "shed_deadline": 0,    # rejected: deadline passed before service
        "batches": 0,          # coalesced prefill batches executed
        "batched_requests": 0,  # requests that shared a batch (size > 1)
        "queue_peak": 0,       # high-water admission queue depth
        "prefill": {"compiles": 0, "steps": 0},
        "decode": {
            "compiles": 0,      # decode executables built (per bucket)
            "traces": 0,        # first calls of those (one per bucket)
            "steps": 0,         # decode steps executed
            "rebuckets": 0,     # mid-decode compactions to a smaller bucket
            "slot_releases": 0,  # slots freed by finished requests
            "eos_stops": 0,      # slots released early on an EOS token
        },
    }


class Database:
    """A session: catalog + statistics + device + dispatch table, and the
    one query path from an FRA query to a compiled gradient step.

    ``device`` is where the session's relations live and its steps run
    (default ``"cuda"``; raises if no GPU is present — pass
    ``device="cpu"`` for the CPU). ``dispatch`` takes anything
    ``kernels.make_table`` accepts and pins the kernel tier for every
    query compiled in this session. ``rewrite`` configures the cost-gated
    rewrite stage (True — the default — enables the full rule set, False
    disables it, a ``rewrite.RuleSet`` or an iterable of rule names
    selects rules). ``memory_budget`` is the out-of-core device-memory
    budget in bytes (module docstring); None — the default — disables
    spilling: plans and results are bit-identical to an unbudgeted
    session. ``max_cache_entries`` bounds the session's executable cache
    (LRU) — the serving bucket steps ride on it; None = unbounded.
    """

    def __init__(
        self,
        device=None,
        *,
        mesh=None,
        dispatch=None,
        mem_budget: Optional[float] = None,
        memory_budget: Optional[float] = None,
        rewrite=True,
        fuse_join_agg: bool = True,
        max_cache_entries: Optional[int] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self._mesh_spec = mesh
        self._mesh = None if isinstance(mesh, str) else mesh
        #: the planner's per-device plan-feasibility budget in bytes
        #: (distinct from ``memory_budget``): a candidate plan that
        #: replicates a relation larger than this is infeasible.
        self.mem_budget = planner.DEFAULT_MEM_BUDGET if mem_budget is None else mem_budget
        #: the session's enabled rewrite rules (None = stage off).
        self.rewrite_rules = _rewrite.make_rules(rewrite)
        self.dispatch = kernels.make_table(dispatch, backend=self.device.type)
        #: out-of-core device-memory budget in bytes: when a step's
        #: environment exceeds it, the largest streamable base relation is
        #: spilled to the host-resident ChunkStore and streamed through the
        #: step in chunk waves. None disables spilling entirely.
        self.memory_budget = memory_budget
        self._chunkstore = _chunkstore.ChunkStore(self.device)
        self.fuse_join_agg = fuse_join_agg
        self.max_cache_entries = max_cache_entries
        self._exec_cache: "OrderedDict[Any, Any]" = OrderedDict()
        #: the session's telemetry tree (``db.counters()``): the ``cache``
        #: and ``serve`` subtrees live here, ``spill`` is read off the
        #: ChunkStore at snapshot time.
        self._counters: Dict[str, Any] = {
            "cache": {"hits": 0, "misses": 0, "evictions": 0},
            "serve": _serve_counters(),
        }
        #: every executable this session compiled (weak — the engine's
        #: caches keep live ones alive), for the reshard counter aggregate.
        self._compiled_refs: "weakref.WeakSet" = weakref.WeakSet()
        #: per catalog relation, the layout the newest mesh-compiled plan
        #: committed it to (``layout``, ``launch.sharding.catalog_shardings``)
        self._layouts: Dict[str, Any] = {}

    # -- catalog front door ------------------------------------------------

    def put(
        self,
        name: str,
        value,
        *,
        keys: Optional[Sequence[str]] = None,
        key_arity: Optional[int] = None,
        refresh_stats: bool = True,
    ) -> "Database":
        """Register (or update) a named relation on the session's device
        and refresh its tracked statistics. ``value`` is a relation, or an
        array (tensor or numpy) made into a ``DenseRelation`` whose key
        arity is ``len(keys)``, else ``key_arity``, else every dim — the
        leading dims are the key grid, the rest the tuple chunk.
        ``refresh_stats=False`` keeps the previous statistics (it skips the
        COO distinct-count pass when only values changed). Returns the
        session for chaining.

        Under a ``memory_budget``, a relation larger than the budget is
        kept on the host (the host tier: a step streams it in waves, and
        nothing forces it onto the device). Putting a name drops its
        chunks from the session's ChunkStore, so a later streamed step
        spills the new data."""
        if not isinstance(value, (DenseRelation, CooRelation)):
            arr = torch.as_tensor(value)
            if keys is not None:
                arity = len(tuple(keys))
            elif key_arity is not None:
                arity = key_arity
            else:
                arity = arr.dim()
            value = DenseRelation(arr, arity)
        device = self.device
        if (
            self.memory_budget is not None
            and planner._rel_bytes(value) > self.memory_budget
        ):
            device = torch.device("cpu")
        self._chunkstore.drop(name)
        self.catalog.put(
            name, to_device(value, device), keys, refresh_stats=refresh_stats
        )
        return self

    def get(self, name: str) -> AnyRel:
        """The named relation (raises ``CatalogError`` when absent or
        when it was donated to a compiled step)."""
        e = self.catalog.entry(name)
        if e.donated:
            raise CatalogError(
                f"relation {name!r} was donated to a compiled step; "
                f"db.put(...) its updated value before reading it again"
            )
        return e.relation

    def __contains__(self, name: str) -> bool:
        return name in self.catalog

    def drop(self, name: str) -> None:
        self._chunkstore.drop(name)
        self.catalog.drop(name)

    def release(self) -> None:
        """Drop every spilled chunk of the session's ChunkStore and hand
        the pinned host blocks they were staged in back to the system
        (``ChunkStore.clear``); a later streamed step spills again. Ranks
        that share one host each keep a store, so a set of ranks that
        outlives its budgeted steps calls this once they are done."""
        self._chunkstore.clear()

    # -- model registry + the serving front door ---------------------------

    def register_model(
        self, name: str, model, params, *, version: Optional[str] = None
    ) -> ModelEntry:
        """Register a model version in the catalog's model registry —
        what the serving front door (``db.endpoint``) resolves request
        model/tenant coordinates through. ``version`` defaults to
        ``v<n+1>``; re-registering a version hot-swaps its parameters
        (live endpoints serve the new ones from the next batch on). A port
        ``Model`` takes ``params`` as a name → tensor dict with
        ``named_parameters()``'s names, on the session's device."""
        return self.catalog.put_model(name, model, params, version)

    def model(self, name: str, version: Optional[str] = None) -> ModelEntry:
        """Resolve ``name`` (or ``"name@version"``) from the model
        registry — latest registered version when unversioned."""
        return self.catalog.model(name, version)

    def endpoint(self, model=None, **kwargs) -> Any:
        """The serving front door: an async ``Endpoint`` over this
        session — continuous batching of concurrent requests into the
        session's (batch, seq) bucketed steps, decode-step bucketing,
        per-tenant model versions resolved through the catalog's model
        registry, and bounded-queue/deadline load shedding counted under
        ``db.counters()["serve"]``. It runs on the session's device.

        ``model`` is a registered model name (``"lm"`` / ``"lm@v2"``) or
        a Model instance (auto-registered; pass ``params=``). See
        ``repro_torch.serving.service.Endpoint`` for the keyword surface
        (``cache_len``, ``buckets``, ``decode_buckets``, ``tenants``,
        ``max_queue``, ``max_new_tokens``, ``eos_token``, ``make_batch``)."""
        from repro_torch.serving.service import Endpoint

        return Endpoint(self, model, **kwargs)

    # -- unified telemetry -------------------------------------------------

    def counters(self) -> Dict[str, Any]:
        """The session's telemetry tree, snapshotted (mutating the returned
        dict never touches live state)::

            {"cache":   {hits, misses, evictions},          # exec cache
             "spill":   {spilled_relations, spilled_bytes,
                         fetched_chunks, fetched_bytes,
                         merged_bytes},                     # out-of-core
             "reshard": {calls, resharded_calls, bytes_moved,
                         last_call_bytes, planned_bytes},   # mesh layouts
             "serve":   {requests, admitted, completed, failed,
                         shed_queue_full, shed_deadline, batches,
                         batched_requests, queue_peak,
                         prefill: {compiles, steps},
                         decode:  {compiles, traces, steps, rebuckets,
                                   slot_releases, eos_stops}}}

        ``reshard`` sums, over every executable the session compiled, the
        committed-input bytes a mesh step moved to its planned layout
        (``engine.Compiled.counters``). ``spill``'s ``merged_bytes`` counts
        the bytes a streamed step copied back to the host
        (``chunkstore.ChunkStore``)."""
        reshard = {
            "calls": 0, "resharded_calls": 0, "bytes_moved": 0,
            "last_call_bytes": 0, "planned_bytes": 0,
        }
        for c in list(self._compiled_refs):
            for k, v in c.counters["reshard"].items():
                reshard[k] += v
        return {
            "cache": dict(self._counters["cache"]),
            "spill": dict(self._chunkstore.stats),
            "serve": copy.deepcopy(self._counters["serve"]),
            "reshard": reshard,
        }

    # -- session executable cache (the serving bucket steps) ---------------

    def cached_executable(self, key, build: Callable[[], Any]):
        """One executable per ``key`` in the session's LRU cache: returns
        the cached value (a hit), or ``build()``'s result after inserting
        it (a miss), evicting least-recently-used entries beyond
        ``max_cache_entries``. ``db.counters()["cache"]`` counts hits,
        misses and evictions — the serving front door asserts on them."""
        cache = self._counters["cache"]
        hit = self._exec_cache.get(key)
        if hit is not None:
            self._exec_cache.move_to_end(key)
            cache["hits"] += 1
            return hit
        cache["misses"] += 1
        val = build()
        self._exec_cache[key] = val
        if self.max_cache_entries is not None:
            while len(self._exec_cache) > self.max_cache_entries:
                self._exec_cache.popitem(last=False)
                cache["evictions"] += 1
        return val

    def stats(self, name: str) -> planner.RelationStats:
        """The tracked key-domain statistics of one relation."""
        return self.catalog.entry(name).stats

    def schema(self, name: str) -> Tuple[str, ...]:
        """The key attribute names of one relation."""
        return self.catalog.entry(name).key_attrs

    def layout(self, name: str):
        """The partition spec (``P``) the newest plan compiled on a mesh
        committed the catalog relation to (None before any)."""
        return self._layouts.get(name)

    # -- the active mesh ---------------------------------------------------

    @property
    def mesh(self):
        """The session's mesh (a spec string is resolved at first use, on
        the session's device type), or None."""
        if isinstance(self._mesh_spec, str) and self._mesh is None:
            from repro_torch.launch.mesh import resolve_mesh

            self._mesh = resolve_mesh(self._mesh_spec, device_type=self.device.type)
        return self._mesh

    def use_mesh(self, mesh) -> "Database":
        """Re-point the session at another mesh (a spec string, a mesh or
        None). Compiled plans are cached per mesh, so switching back
        re-plans nothing."""
        self._mesh_spec = mesh
        self._mesh = None if isinstance(mesh, str) else mesh
        return self

    def _step_mesh(self):
        """The mesh a step compiles against: the session's own, else the
        ambient mesh (``engine._use_mesh``)."""
        mesh = self.mesh
        return mesh if mesh is not None else _engine._ambient_mesh()

    @contextlib.contextmanager
    def activate(self):
        """Make this the ambient session of the block: the relational
        operator layer (and any code calling ``session.current()``) runs
        through it."""
        token = _SESSION_STACK.set(_SESSION_STACK.get() + (self,))
        try:
            yield self
        finally:
            _SESSION_STACK.reset(token)

    # -- query front door --------------------------------------------------

    def sql(self, script: str, *, wrt: Sequence[str] = ()) -> "QueryHandle":
        """Compile a SQL script against the catalog's schemas and return
        a differentiable ``QueryHandle``. ``wrt`` names the relations to
        treat as differentiable inputs (everything else is constant
        data); table and column references resolve against the key
        attribute names declared via ``db.put(..., keys=...)``."""
        query = _sql.compile_sql(
            script, schema=self.catalog.schema(), inputs=tuple(wrt)
        )
        return QueryHandle(self, query)

    def query(
        self, q: Union[fra.Query, fra.Node], *, wrt: Optional[Sequence[str]] = None
    ) -> "QueryHandle":
        """Wrap an FRA query (or bare graph root) built in code. ``wrt``
        defaults to the query's declared inputs (for a bare node: its
        table scans)."""
        q = _as_query(q)
        if wrt is not None:
            missing = set(wrt) - set(q.inputs)
            if missing:
                raise ValueError(
                    f"wrt relations {sorted(missing)} are not inputs of the "
                    f"query (inputs: {q.inputs})"
                )
        return QueryHandle(self, q, default_wrt=None if wrt is None else tuple(wrt))

    def check(self, q: Union[fra.Query, fra.Node], *, wrt: Sequence[str] = ()):
        """Statically check an FRA query (or bare graph root) against the
        catalog: the typed checker (``repro_torch.analysis.typecheck``)
        infers schemas/shapes/dtypes bottom-up and returns a
        ``CheckReport`` of node-path diagnostics — compiler-guaranteed
        failures as errors (bad join keys, non-permutation σ, non-additive
        Σ, COO ⋈ COO...), hazards as warnings (f32→f64 promotion,
        statically empty selections, stale statistics, partial-RJP
        gradients for ``wrt`` inputs). Relations, statistics,
        key-attribute names and the mesh geometry (the
        ``non-divisible-shard`` warning) are sourced from the session
        exactly as a compiled step would source them. Purely
        observational — nothing is lowered or cached; the same checker
        runs as the engine's mandatory validate stage, which *raises* on
        the error-severity findings reported here."""
        from repro_torch.analysis.typecheck import check_query

        q = _as_query(q)
        names = _base_names([q.root])
        env = {
            n: self.catalog.entry(n).relation
            for n in names
            if n in self.catalog
        }
        mesh = self.mesh
        return check_query(
            q,
            env,
            stats=self.catalog.snapshot(names),
            schema=self.catalog.schema(),
            wrt=tuple(wrt),
            fuse_join_agg=self.fuse_join_agg,
            geometry=planner.MeshGeometry.from_mesh(mesh) if mesh is not None else None,
        )

    def explain(self, q: Union[fra.Query, fra.Node]) -> str:
        """What the rewrite stage would do to ``q`` against the current
        catalog: the query tree before, every cost-gate verdict (with the
        byte estimates the gate compared), the tree after, and the typed
        check's diagnostics. Relations and their tracked statistics are
        sourced from the catalog exactly as ``forward``/``grad``/``step``
        would source them, so the verdicts shown are the ones a compiled
        step takes, and the kernel certifier's proof of the dispatch sites
        the lowering resolves (``analysis.kernelcheck.certify_kernels``,
        skipped when the typed check fails). Purely observational."""
        q = _as_query(q)
        names = _base_names([q.root])
        env = {n: self.get(n) for n in names}
        stats = self.catalog.snapshot(names)
        rules = (
            self.rewrite_rules
            if self.rewrite_rules is not None
            else _rewrite.DEFAULT_RULES
        )
        rewritten, report = _rewrite.rewrite_query(
            q, env, stats=stats, rules=rules
        )
        lines = ["before:"]
        lines += ["  " + ln for ln in q.root.pretty().splitlines()]
        lines.append("rewrite decisions:")
        lines += ["  " + ln for ln in report.render().splitlines()]
        if self.rewrite_rules is None:
            lines.append("  (session rewrite stage is OFF: plan unchanged)")
            lines.append("after: (unchanged)")
        elif not report.changed:
            lines.append("after: (unchanged)")
        else:
            lines.append("after:")
            lines += [
                "  " + ln for ln in rewritten.root.pretty().splitlines()
            ]
        lines.append("diagnostics:")
        report = self.check(q)
        if report.diagnostics:
            lines += ["  " + ln for ln in report.render().splitlines()]
        else:
            lines.append("  (none)")
        lines.append("kernel certification:")
        if report.errors:
            lines.append("  (skipped: typed check failed)")
        else:
            from ..analysis import kernelcheck as _kernelcheck

            eng = _engine.engine_for(q, fuse_join_agg=self.fuse_join_agg)
            low = eng.lower(
                env,
                dispatch=self.dispatch,
                stats=stats,
                rewrite=self.rewrite_rules,
            )
            kreport = _kernelcheck.certify_kernels(low)
            sites = len(getattr(low.resolutions, "sites", ()))
            lines.append(
                f"  {sites} dispatch site(s): " + kreport.render().splitlines()[0]
            )
            if kreport.diagnostics:
                lines += [
                    "  " + ln for ln in kreport.render().splitlines()[1:]
                ]
        return "\n".join(lines)

    # -- staged execution (the engine underneath) --------------------------

    def _compiled_for(
        self,
        program,
        env: Dict[str, AnyRel],
        seed: Optional[AnyRel] = None,
        *,
        donate: Tuple[str, ...] = (),
        stats: Optional[Dict[str, planner.RelationStats]] = None,
        mesh=None,
    ):
        eng = _engine.engine_for(program, fuse_join_agg=self.fuse_join_agg)
        step_mesh = self._step_mesh() if mesh is None else mesh
        if self.memory_budget is not None:
            wave_plan = planner.plan_waves(eng.forward_query, env, self.memory_budget)
            self._place(env, () if wave_plan is None else wave_plan.streamed_names)
            if wave_plan is not None:
                if donate:
                    raise _chunkstore.OutOfCoreError(
                        f"cannot donate {sorted(donate)} while streaming "
                        "chunk waves: the buffers are reused across waves"
                    )

                def compile_wave(wave_env, wave_seed):
                    # every wave on the step's mesh, as the reference
                    # compiles it (the planner sees the wave's shapes)
                    wstats = self._catalog_stats_for(wave_env)
                    wave = eng.lower(
                        wave_env,
                        wave_seed,
                        dispatch=self.dispatch,
                        stats=wstats,
                        rewrite=self.rewrite_rules,
                    ).compile_auto(
                        wave_env,
                        mesh=step_mesh,
                        stats=wstats,
                        mem_budget=self.mem_budget,
                    )
                    self._record_layouts(wave, skip=wave_plan.streamed_names)
                    return wave

                def lower_full(full_env, full_seed):
                    # the streamed relations lie on the host beside the
                    # device-resident ones: lower on meta tensors, for the
                    # output shapes only
                    return eng.lower(
                        {k: _engine._meta(v) for k, v in full_env.items()},
                        None if full_seed is None else _engine._meta(full_seed),
                        dispatch=self.dispatch,
                        stats=stats,
                        rewrite=self.rewrite_rules,
                    )

                # a COO wave's rows split evenly over every rank of the
                # mesh, so that the mesh step pads nothing more
                ranks = 1 if step_mesh is None else int(step_mesh.mesh.numel())
                return _engine.StreamedCompiled(
                    wave_plan, self._chunkstore, compile_wave, lower_full,
                    row_multiple=ranks,
                )
        low = eng.lower(
            env,
            seed,
            dispatch=self.dispatch,
            stats=stats,
            rewrite=self.rewrite_rules,
        )
        compiled = low.compile_auto(
            env,
            mesh=step_mesh,
            donate=donate,
            stats=stats,
            mem_budget=self.mem_budget,
        )
        self._record_layouts(compiled)
        return compiled

    def _record_layouts(self, compiled, skip: Tuple[str, ...] = ()) -> None:
        """Keep ``compiled`` for the reshard counters and record the
        layouts its plan commits the catalog relations to (a streamed
        relation, ``skip``, has none: it lies on the host)."""
        self._compiled_refs.add(compiled)
        for name, spec in (compiled.in_shardings or {}).items():
            if name in self.catalog and name not in skip and spec is not None:
                self._layouts[name] = spec

    def _place(self, env: Dict[str, AnyRel], streamed: Tuple[str, ...]) -> None:
        """Moves the catalog relations of a budgeted CUDA session's step
        to their tier, in the catalog and in ``env``: a streamed relation
        to the host, so that the device holds the resident relations and
        one wave, as the budget says (each wave is fetched from the
        store's host chunks whether or not a device copy exists); any
        other to the device (a relation that an earlier step streamed and
        this one holds in core). Relations ``env`` does not share with
        the catalog stay where the caller put them."""
        if self.device.type == "cpu":
            return
        for name, rel in list(env.items()):
            if name not in self.catalog or self.catalog.entry(name).relation is not rel:
                continue
            want = "cpu" if name in streamed else self.device.type
            if relation_device(rel).type != want:
                moved = to_device(rel, self.device if want != "cpu" else torch.device("cpu"))
                self.catalog.entry(name).relation = env[name] = moved

    def _catalog_stats_for(
        self, env: Dict[str, AnyRel]
    ) -> Optional[Dict[str, planner.RelationStats]]:
        """Tracked statistics for the env relations that match a catalog
        table of the same name, layout class and key-domain extents — the
        guard that lets anonymous wrapper environments (whose names are
        program-local, e.g. the GCN's ``Edge``/``Node``) pick up catalog
        statistics without a same-named but unrelated table leaking in."""
        out: Dict[str, planner.RelationStats] = {}
        for name, rel in env.items():
            if name not in self.catalog:
                continue
            e = self.catalog.entry(name)
            if (
                type(rel) is type(e.relation)
                and rel.key_arity == len(e.stats.distinct)
                and tuple(int(x) for x in rel.extents) == e.stats.extents
            ):
                out[name] = e.stats
        return out or None

    def execute(
        self,
        program,
        env: Dict[str, AnyRel],
        seed: Optional[AnyRel] = None,
        *,
        donate: Tuple[str, ...] = (),
        stats: Optional[Dict[str, planner.RelationStats]] = None,
        mesh=None,
    ):
        """Staged execution of a program over an *anonymous* environment
        (relations passed directly rather than named in the catalog) — the
        path the relational operator layer steps through. The environment
        must lie on the session's device; when an env relation matches a
        registered catalog table by name, layout class and extents, that
        relation's tracked statistics feed the planner and the rewrite
        gate. ``mesh`` overrides the session's step mesh (an operator's
        backward passes the mesh its forward ran on).

        ``donate`` names env relations the caller hands over to the step,
        as ``QueryHandle.step(donate=)`` does: one that is also the
        catalog's relation of that name is marked donated, and reading it
        raises until it is ``put`` again."""
        donate = tuple(sorted(donate))
        missing = [n for n in donate if n not in env]
        if missing:
            raise KeyError(f"cannot donate {missing}: not in the environment ({sorted(env)})")
        with _spans.span(_spans.PLAN):
            if stats is None:
                stats = self._catalog_stats_for(env)
            compiled = self._compiled_for(
                program, env, seed, donate=donate, stats=stats, mesh=mesh
            )
        out = compiled(env, seed)
        for n in donate:
            if n in self.catalog and self.catalog.entry(n).relation is env[n]:
                self.catalog.entry(n).donated = True
        return out


# ---------------------------------------------------------------------------
# QueryHandle: a differentiable, compiled query over the catalog
# ---------------------------------------------------------------------------


def _as_query(q: Union[fra.Query, fra.Node]) -> fra.Query:
    """A bare graph root as a query whose inputs are its table scans."""
    if isinstance(q, fra.Node):
        return fra.Query(q, tuple(sorted({s.name for s in q.table_scans()})))
    return q


def _base_names(roots) -> Tuple[str, ...]:
    """Base-relation names a set of graph roots read from the catalog:
    TableScan names plus Const refs, excluding the engine-internal
    ``__seed`` / ``__fwd_*`` references."""
    names = set()
    for root in roots:
        for node in root.topo():
            if isinstance(node, fra.TableScan):
                names.add(node.name)
            elif isinstance(node, fra.Const) and not node.ref.startswith("__"):
                names.add(node.ref)
    return tuple(sorted(names))


class QueryHandle:
    """A differentiable query bound to a session's catalog.

    ``forward()`` runs the query; ``grad(wrt=...)`` runs the
    RA-autodiff-generated gradient queries; ``step(donate=...)`` is the
    training hot path — forward + all gradients in one compiled
    executable. All three source relations, statistics and the dispatch
    table from the catalog, and reuse their lowering across calls (one
    lowering per environment signature)."""

    def __init__(
        self,
        db: Database,
        query: fra.Query,
        *,
        default_wrt: Optional[Tuple[str, ...]] = None,
    ):
        self.db = db
        self.query = query
        #: default gradient targets when grad/step get no ``wrt``.
        self.default_wrt = default_wrt
        self._grad_progs: Dict[Tuple[str, ...], GradientProgram] = {}
        self._full_prog: Optional[GradientProgram] = None
        #: the most recently used Compiled or StreamedCompiled
        #: (resolutions, dispatch; the wave plan of a streamed step).
        self.last = None

    def check(self, *, wrt: Optional[Sequence[str]] = None):
        """``db.check`` on this handle's query (see ``Database.check``);
        ``wrt`` defaults to the handle's gradient targets, so partial-RJP
        warnings cover exactly the inputs ``grad``/``step`` would
        differentiate."""
        if wrt is None:
            wrt = self.default_wrt or self.query.inputs
        return self.db.check(self.query, wrt=tuple(wrt))

    def _env(self, names: Sequence[str]) -> Dict[str, AnyRel]:
        return {n: self.db.get(n) for n in names}

    # -- the three entry points --------------------------------------------

    def forward(self):
        """Execute the (forward) query; returns its output relation."""
        with _spans.span(_spans.PLAN):
            names = _base_names([self.query.root])
            env = self._env(names)
            compiled = self.db._compiled_for(
                self.query, env, stats=self.db.catalog.snapshot(names)
            )
        self.last = compiled
        return compiled(env)

    def _program(self, wrt: Optional[Sequence[str]]) -> GradientProgram:
        if wrt is None:
            wrt = self.default_wrt
        if self._full_prog is None:
            if not self.query.inputs:
                raise ValueError(
                    "query has no differentiable inputs; declare inputs on "
                    "the fra.Query"
                )
            self._full_prog = ra_autodiff(self.query)
        if wrt is None:
            return self._full_prog
        wrt = tuple(wrt)
        missing = set(wrt) - set(self._full_prog.grads)
        if missing:
            raise ValueError(
                f"no gradient for {sorted(missing)}; differentiable inputs "
                f"are {sorted(self._full_prog.grads)}"
            )
        prog = self._grad_progs.get(wrt)
        if prog is None:
            prog = GradientProgram(
                self._full_prog.forward,
                {n: self._full_prog.grads[n] for n in wrt},
                wrt,
            )
            self._grad_progs[wrt] = prog
        return prog

    def _seed_rel(self, seed) -> Optional[AnyRel]:
        if seed is None or isinstance(seed, (DenseRelation, CooRelation)):
            return seed
        return DenseRelation(
            torch.as_tensor(seed, device=self.db.device), self.query.root.key_arity
        )

    def _run_grad(
        self,
        wrt: Optional[Sequence[str]],
        seed,
        donate: Tuple[str, ...],
    ):
        with _spans.span(_spans.PLAN):
            prog = self._program(wrt)
            names = _base_names(
                [prog.forward.root, *prog.grads.values()]
            )
            env = self._env(names)
            bad = set(donate) - set(env)
            if bad:
                raise ValueError(
                    f"cannot donate {sorted(bad)}: not relations of this query "
                    f"(env: {sorted(env)})"
                )
            seed_rel = self._seed_rel(seed)
            compiled = self.db._compiled_for(
                prog, env, seed_rel,
                donate=tuple(sorted(donate)),
                stats=self.db.catalog.snapshot(names),
            )
        self.last = compiled
        out, grads = compiled(env, seed_rel)
        for n in donate:
            self.db.catalog.entry(n).donated = True
        return out, grads

    def grad(self, *, wrt: Optional[Sequence[str]] = None, seed=None):
        """Gradients of the query output w.r.t. the (``wrt``-selected)
        differentiable inputs: ``{name: relation}``. ``seed`` is the
        output cotangent (default: ones — requires a scalar-loss
        output); arrays are wrapped at the output's key arity."""
        _, grads = self._run_grad(wrt, seed, ())
        return grads

    def step(
        self,
        *,
        wrt: Optional[Sequence[str]] = None,
        seed=None,
        donate: Tuple[str, ...] = (),
    ):
        """One compiled training step: ``(output, gradients)``. ``donate``
        names catalog relations the caller hands over to the step (the
        parameters it is about to replace) — a donated relation must be
        re-``put`` before its next read, and the catalog enforces that."""
        return self._run_grad(wrt, seed, tuple(donate))

    # -- introspection -----------------------------------------------------

    @property
    def lower_count(self) -> int:
        """Lowerings made for this handle's query and gradient programs —
        one per environment signature however many steps ran."""
        progs = [self.query, *self._grad_progs.values()]
        if self._full_prog is not None:
            progs.append(self._full_prog)
        return sum(
            _engine.engine_for(p, fuse_join_agg=self.db.fuse_join_agg).lower_count
            for p in progs
        )

    def plan(
        self,
        *,
        geometry: Optional[planner.MeshGeometry] = None,
        n_devices: Optional[int] = None,
        use_stats: bool = True,
    ) -> Dict[int, planner.JoinPlan]:
        """Planning-only inspection: the physical ``JoinPlan`` per join
        the optimizer would choose for this query on a mesh of the given
        geometry, sourced from the catalog (``use_stats=False`` gives the
        stats-less heuristic baseline)."""
        names = _base_names([self.query.root])
        env = self._env(names)
        if n_devices is None:
            n_devices = geometry.model_size if geometry is not None else 1
        return planner.plan_query(
            self.query,
            env,
            n_devices,
            mem_budget=self.db.mem_budget,
            geometry=geometry,
            stats=self.db.catalog.snapshot(names) if use_stats else None,
        )

    @property
    def plans(self) -> Dict[int, planner.JoinPlan]:
        """The physical plans of the most recent compiled executable."""
        if self.last is None:
            raise ValueError("no compiled step yet: call forward/grad/step")
        return self.last.plans

    @property
    def placements(self):
        """Per-relation {"data": dim, "model": dim} placements of the
        most recent compiled executable."""
        if self.last is None:
            raise ValueError("no compiled step yet: call forward/grad/step")
        return self.last.placements

    @property
    def resolutions(self) -> Dict[str, str]:
        """Kernel-dispatch decisions of the most recent executable."""
        if self.last is None:
            raise ValueError("no compiled step yet: call forward/grad/step")
        return self.last.resolutions
