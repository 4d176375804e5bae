"""Kernel functions for the functional RA, with derivative registry, plus
the physical-kernel **dispatch registry** the chunked compiler routes hot
operators through.

The paper parameterizes RA operations with scalar kernel functions and, in
the chunked "tensor-relational" extension (Appendix A), with tensor kernels
(MatMul/MatAdd/...). RJP construction needs, for every kernel, its
derivative in VJP form:

  unary   ⊙ : V -> V          vjp(g, x)        =  (∂⊙(x)/∂x)ᵀ · g
  binary  ⊗ : V x V -> V      vjp_l(g, l, r)   =  (∂⊗/∂l)ᵀ · g
                              vjp_r(g, l, r)   =  (∂⊗/∂r)ᵀ · g
  agg     ⊕ : V x V -> V      commutative+associative; for ⊕ = add the
                              derivative is the identity map on g.

Kernels are looked up by name so query graphs stay hashable and the
compiler can pattern-match (e.g. ⊗ ∈ {mul, matmul} + ⊕ = add → einsum).
Per Appendix A, derivatives of *chunk* kernels may be produced by
conventional auto-diff (``torch.func.vjp``) — the relational layer above
never calls it.

Kernel functions take tensors, or Python floats where the tuple-at-a-time
interpreter hands them scalars; ``_t`` lifts a float to a 0-d tensor before
a torch function sees it.

Separately from the *logical* kernels, this module owns the **dispatch
registry** (``register_impl`` / ``resolve_impl`` / ``DispatchTable``): the
mapping from the compiler's hot logical ops to physical implementations,
tiered per device type — ``cuda`` (the hand-written kernels, CUDA devices
only), ``sanitizer`` (their launch models replayed, the plain versions
computing), ``ref`` (their plain PyTorch versions) and ``torch`` (the
compiler's own plain lowering; always registered, always applicable) —
and the kernel **contracts** the static certifier
(``analysis/kernelcheck.py``) and the sanitizer interpret.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch


def _t(x):
    """A Python number as a 0-d float64 tensor; tensors pass through. (A
    0-d tensor does not widen a float32 tensor it meets.)"""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def _pull(fn, args, g, idx: int):
    """Component ``idx`` of the VJP of ``fn`` at ``args`` against ``g`` —
    ``torch.func.vjp``, with ``g`` broadcast to the output (the seed of a
    scalar loss arrives as the float 1.0)."""
    out, pull = torch.func.vjp(fn, *(_t(a) for a in args))
    g = torch.broadcast_to(torch.as_tensor(g, dtype=out.dtype, device=out.device), out.shape)
    return pull(g)[idx]


@dataclass(frozen=True)
class UnaryKernel:
    name: str
    fn: Callable
    vjp: Callable  # vjp(g, x)
    # Streamability hints for out-of-core wave planning:
    #   linear           — ⊙(a + b) = ⊙(a) + ⊙(b)
    #   zero_preserving  — ⊙(0) = 0
    linear: bool = False
    zero_preserving: bool = False

    def __repr__(self) -> str:
        return f"⊙{self.name}"


@dataclass(frozen=True)
class BinKernel:
    name: str
    fn: Callable
    vjp_l: Callable  # vjp_l(g, l, r)
    vjp_r: Callable  # vjp_r(g, l, r)
    # "multiplicative" kernels admit the paper's §4 ⋈_const-elimination:
    # ∂⊗/∂l depends only on (g, r) and ∂⊗/∂r only on (g, l).
    multiplicative: bool = False
    # einsum lowering hints for the chunked compiler:
    #   elementwise  — ⊗ multiplies chunks pointwise (broadcasting)
    #   chunk_spec   — (l, r, out) einsum letters over *chunk* dims
    #                  (e.g. matmul: ('mk', 'kn', 'mn')); lowercase reserved
    #                  for chunks, uppercase for block-key axes.
    elementwise: bool = False
    chunk_spec: Optional[tuple] = None

    def __repr__(self) -> str:
        return f"⊗{self.name}"


@dataclass(frozen=True)
class AggKernel:
    name: str
    fn: Callable  # fn(a, b), commutative + associative
    # unit for reductions over an empty/masked set, as a float
    unit: float = 0.0
    # is ⊕ == +? (enables the paper's constant-grp RJP simplification and
    # einsum lowering)
    is_add: bool = True

    def __repr__(self) -> str:
        return f"⊕{self.name}"


_UNARY: Dict[str, UnaryKernel] = {}
_BIN: Dict[str, BinKernel] = {}
_AGG: Dict[str, AggKernel] = {}


def register_unary(
    name: str,
    fn: Callable,
    vjp: Optional[Callable] = None,
    linear: bool = False,
    zero_preserving: bool = False,
) -> UnaryKernel:
    if vjp is None:
        # Appendix A: chunk-kernel derivatives via conventional auto-diff.
        def vjp(g, x, _fn=fn):  # type: ignore[no-redef]
            return _pull(_fn, (x,), g, 0)

    k = UnaryKernel(name, fn, vjp, linear, zero_preserving)
    _UNARY[name] = k
    return k


def register_bin(
    name: str,
    fn: Callable,
    vjp_l: Optional[Callable] = None,
    vjp_r: Optional[Callable] = None,
    multiplicative: bool = False,
    elementwise: bool = False,
    chunk_spec: Optional[tuple] = None,
) -> BinKernel:
    if vjp_l is None:
        def vjp_l(g, l, r, _fn=fn):  # type: ignore[no-redef]
            return _pull(_fn, (l, r), g, 0)

    if vjp_r is None:
        def vjp_r(g, l, r, _fn=fn):  # type: ignore[no-redef]
            return _pull(_fn, (l, r), g, 1)

    k = BinKernel(name, fn, vjp_l, vjp_r, multiplicative, elementwise, chunk_spec)
    _BIN[name] = k
    return k


def register_agg(name: str, fn: Callable, unit: float = 0.0, is_add: bool = True) -> AggKernel:
    k = AggKernel(name, fn, unit, is_add)
    _AGG[name] = k
    return k


def unary(name: str) -> UnaryKernel:
    return _UNARY[name]


def bin_kernel(name: str) -> BinKernel:
    return _BIN[name]


def agg(name: str) -> AggKernel:
    return _AGG[name]


# ---------------------------------------------------------------------------
# Standard kernels
# ---------------------------------------------------------------------------

# -- aggregation ⊕ ----------------------------------------------------------
ADD = register_agg("add", lambda a, b: a + b)           # scalars and chunks
MATADD = register_agg("matadd", lambda a, b: a + b)      # alias, paper's name
MAX = register_agg(
    "max", lambda a, b: torch.maximum(_t(a), _t(b)), unit=-float("inf"), is_add=False
)

# -- binary ⊗ ---------------------------------------------------------------
MUL = register_bin(
    "mul",
    lambda l, r: l * r,
    vjp_l=lambda g, l, r: g * r,
    vjp_r=lambda g, l, r: g * l,
    multiplicative=True,
    elementwise=True,
)

# Blocked matrix multiply over chunks. vjp_l/vjp_r are the paper's Fig. 4
# optimized RJP kernels: dL = g @ rᵀ, dR = lᵀ @ g.
MATMUL = register_bin(
    "matmul",
    lambda l, r: torch.matmul(l, r),
    vjp_l=lambda g, l, r: torch.matmul(g, r.transpose(-1, -2)),
    vjp_r=lambda g, l, r: torch.matmul(l.transpose(-1, -2), g),
    multiplicative=True,
    chunk_spec=("mk", "kn", "mn"),
)

ADD2 = register_bin(
    "add2",
    lambda l, r: l + r,
    vjp_l=lambda g, l, r: g,
    vjp_r=lambda g, l, r: g,
)

SUB = register_bin(
    "sub",
    lambda l, r: l - r,
    vjp_l=lambda g, l, r: g,
    vjp_r=lambda g, l, r: -g,
)

# cross-entropy ⊗ for logistic regression (paper §2.3):
#   ⊗(yhat, y) = -y·log(yhat) + (y-1)·log(1-yhat)
XENT = register_bin(
    "xent",
    lambda yhat, y: -y * torch.log(_t(yhat)) + (y - 1.0) * torch.log1p(-_t(yhat)),
    vjp_l=lambda g, yhat, y: g * (-y / yhat - (y - 1.0) / (1.0 - yhat)),
    vjp_r=lambda g, yhat, y: g * (-torch.log(_t(yhat)) + torch.log1p(-_t(yhat))),
)

# squared error ⊗(pred, target) = 0.5(pred-target)^2, for NNMF / KGE
SQERR = register_bin(
    "sqerr",
    lambda p, t: 0.5 * (p - t) ** 2,
    vjp_l=lambda g, p, t: g * (p - t),
    vjp_r=lambda g, p, t: g * (t - p),
)

# -- unary ⊙ ----------------------------------------------------------------
IDENT = register_unary(
    "ident", lambda x: x, vjp=lambda g, x: g, linear=True, zero_preserving=True
)
NEG = register_unary(
    "neg", lambda x: -x, vjp=lambda g, x: -g, linear=True, zero_preserving=True
)
LOGISTIC = register_unary(
    "logistic",
    lambda x: torch.sigmoid(_t(x)),
    vjp=lambda g, x: g * torch.sigmoid(_t(x)) * (1.0 - torch.sigmoid(_t(x))),
)
RELU = register_unary(
    "relu",
    lambda x: torch.relu(_t(x)),
    vjp=lambda g, x: g * (_t(x) > 0),
    zero_preserving=True,
)
EXP = register_unary(
    "exp", lambda x: torch.exp(_t(x)), vjp=lambda g, x: g * torch.exp(_t(x))
)
SQUARE = register_unary(
    "square", lambda x: x * x, vjp=lambda g, x: 2.0 * g * x, zero_preserving=True
)
# Reduce a chunk to a scalar value (chunked losses). Chunk-local semantics:
# the compiler vmaps kernels over block-key axes, so torch.sum sees one chunk.
SUM_CHUNK = register_unary(
    "sum_chunk",
    lambda x: torch.sum(_t(x)),
    vjp=lambda g, x: g * torch.ones_like(_t(x)),
    linear=True,
    zero_preserving=True,
)
SCALE: Dict[float, UnaryKernel] = {}


def scale_kernel(c: float) -> UnaryKernel:
    """⊙(x) = c·x — memoized per constant."""
    key = float(c)
    if key not in SCALE:
        SCALE[key] = register_unary(
            f"scale[{key}]",
            lambda x, _c=key: _c * x,
            vjp=lambda g, x, _c=key: _c * g,
            linear=True,
            zero_preserving=True,
        )
    return SCALE[key]


# ---------------------------------------------------------------------------
# Kernel dispatch registry: (logical op, device type, predicate) → implementation
#
# The chunked compiler (compiler.py) has three hardware hot-spots:
#
#   segment_sum     Σ over a CooRelation — fn(msg2d, seg, num_segments),
#                   msg2d: (E, D) float, seg: (E,) int32 (out-of-range ids
#                   are dropped), returns (num_segments, D).
#   blocked_matmul  the matmul-shaped Σ∘⋈ einsum — fn(x2d, y2d) → x @ y.
#   gather_join     the COO gather join (edge ⋈ node) and the restricted-
#                   join sparse-gradient gather — fn(table2d, rows),
#                   table2d: (N, D), rows: (E,) int32; out-of-range /
#                   negative ids (COO nnz padding) yield zero rows;
#                   returns (E, D).
#
# The compiler resolves each site against this registry at lowering time.
# A resolved choice is pinned by the DispatchTable the engine carries, so
# kernel selection is part of the lowering cache key (core/engine.py).
# Tiers, from most to least specialized:
#
#   cuda    the hand-written CUDA kernels (kernels/segsum, gather, matmul);
#           CUDA devices only, f32 only
#   sanitizer  the instrumented cross-check tier: it replays the kernel's
#           launch model (its contract, built from the plan the cuda tier
#           would launch) with out-of-bounds / write-race / uninitialized-
#           accumulator instrumentation, raising SanitizerError, and
#           computes through the plain version; it launches no kernel and
#           is never part of a default table (``make_table("sanitizer")``)
#   ref     the kernels' plain PyTorch versions (kernels/*/ref.py)
#   torch   the compiler's own plain lowering (einsum / index_add_ /
#           index_select); always registered, always applicable — the
#           default tier off the card
# ---------------------------------------------------------------------------

#: logical ops the compiler routes through the registry.
DISPATCH_OPS: Tuple[str, ...] = ("segment_sum", "blocked_matmul", "gather_join")

#: known tiers, in decreasing specialization order.
DISPATCH_TIERS: Tuple[str, ...] = ("cuda", "sanitizer", "ref", "torch")


class KernelDispatchError(LookupError):
    """No registered implementation matched (op, device type, predicate)."""


@dataclass(frozen=True)
class KernelImpl:
    """One registry entry.

    ``predicate(info)`` sees a dict of shape/dtype facts for the call site
    (segment_sum: nnz/dim/num_segments/dtype; blocked_matmul: m/k/n/dtype;
    gather_join: rows/num_rows/dim/dtype) and must be a pure function of
    it — resolution happens at lowering time and is replayed on every
    call, so a flappy predicate would desync the lowering from its cache
    key.
    """

    op: str
    tier: str
    fn: Callable
    backends: Tuple[str, ...] = ()   # () = any device type
    priority: int = 0                # higher wins within a tier
    predicate: Optional[Callable] = None

    def __repr__(self) -> str:
        plats = ",".join(self.backends) or "any"
        return f"<{self.op}:{self.tier}@{plats}>"


_IMPLS: Dict[Tuple[str, str], List[KernelImpl]] = {}


def register_impl(
    op: str,
    tier: str,
    fn: Callable,
    *,
    backends: Tuple[str, ...] = (),
    priority: int = 0,
    predicate: Optional[Callable] = None,
) -> KernelImpl:
    """Register a physical implementation for a logical op under a tier.

    Entries within one (op, tier) bucket are tried in decreasing
    ``priority``, in registration order among equals; the first whose
    backend list admits the table's device type and whose predicate
    accepts the site's shape/dtype info wins.
    """
    if tier not in DISPATCH_TIERS:
        raise ValueError(f"unknown tier {tier!r}; have {DISPATCH_TIERS}")
    impl = KernelImpl(op, tier, fn, tuple(backends), priority, predicate)
    bucket = _IMPLS.setdefault((op, tier), [])
    bucket.append(impl)
    bucket.sort(key=lambda i: -i.priority)  # stable: equals keep their order
    return impl


@dataclass(frozen=True)
class DispatchTable:
    """Immutable (hashable) tier preference per logical op, pinned to one
    device type (``backend``: ``"cuda"`` or ``"cpu"``). The engine folds it
    into the lowering cache key: two tables that differ in any op's tier
    order produce distinct ``Lowered`` objects."""

    backend: str
    entries: Tuple[Tuple[str, Tuple[str, ...]], ...]  # sorted by op name

    def tiers(self, op: str) -> Tuple[str, ...]:
        for name, tiers in self.entries:
            if name == op:
                return tiers
        return ("torch",)

    def describe(self) -> str:
        body = ", ".join(
            f"{op}→{'>'.join(tiers)}" for op, tiers in self.entries
        )
        return f"[{self.backend}] {body}"


def default_table(backend: str) -> DispatchTable:
    """The default tier order for a device type: the CUDA kernels
    (predicate-gated, torch fallback) on a CUDA device; the plain torch
    lowerings elsewhere."""
    tiers = ("cuda", "torch") if backend == "cuda" else ("torch",)
    return DispatchTable(
        backend, tuple((op, tiers) for op in sorted(DISPATCH_OPS))
    )


def make_table(spec=None, backend: Optional[str] = None) -> DispatchTable:
    """Normalize a dispatch request into a DispatchTable for the device
    type ``backend``.

    ``spec`` may be: None / ``"auto"`` (the device type's default), an
    existing DispatchTable, a tier name applied to every op (``"ref"``), a
    tuple of tier names tried in order, or a dict ``{op: tier |
    (tiers...)}`` — unmentioned ops keep their default tiers. ``backend``
    may be omitted only when ``spec`` is a DispatchTable.
    """
    if isinstance(spec, DispatchTable):
        if backend is not None and spec.backend != backend:
            raise ValueError(
                f"DispatchTable is pinned to device type {spec.backend!r} and "
                f"cannot be reinterpreted for {backend!r}; rebuild it "
                "with make_table(<tier spec>, backend=...)"
            )
        return spec
    if backend is None:
        raise ValueError("make_table needs the device type (backend='cuda' or 'cpu')")
    if spec is None or spec == "auto":
        return default_table(backend)

    def norm(tiers) -> Tuple[str, ...]:
        if isinstance(tiers, str):
            tiers = (tiers,)
        tiers = tuple(tiers)
        bad = [t for t in tiers if t not in DISPATCH_TIERS]
        if bad:
            raise ValueError(f"unknown tier(s) {bad}; have {DISPATCH_TIERS}")
        return tiers

    if isinstance(spec, (str, tuple, list)):
        tiers = norm(spec)
        return DispatchTable(
            backend, tuple((op, tiers) for op in sorted(DISPATCH_OPS))
        )
    if isinstance(spec, dict):
        unknown = set(spec) - set(DISPATCH_OPS)
        if unknown:
            raise ValueError(f"unknown op(s) {sorted(unknown)}; have {DISPATCH_OPS}")
        base = dict(default_table(backend).entries)
        base.update({op: norm(t) for op, t in spec.items()})
        return DispatchTable(backend, tuple(sorted(base.items())))
    raise TypeError(f"cannot build a DispatchTable from {type(spec)}")


def resolve_impl(op: str, info: Dict, table: DispatchTable) -> KernelImpl:
    """Walk the table's tier order for ``op`` and return the first
    implementation whose device type and predicate admit this site."""
    for tier in table.tiers(op):
        for impl in _IMPLS.get((op, tier), ()):
            if impl.backends and table.backend not in impl.backends:
                continue
            if impl.predicate is not None and not impl.predicate(info):
                continue
            return impl
    raise KernelDispatchError(
        f"no implementation of {op!r} for device type {table.backend!r} under "
        f"tiers {table.tiers(op)} with site info {info}"
    )


# ---------------------------------------------------------------------------
# Kernel contracts: the statically checkable shape of a CUDA launch
#
# Every kernel package declares a ``CONTRACT`` (a KernelContract) next to
# its wrapper: the dtype domain its hardware tiers accept, the f32
# accumulator it carries, the masking obligations the kernel discharges
# (ids outside the valid range, the in-kernel guards of ragged last tiles),
# which dispatch ops its backward re-enters, and — the load-bearing part —
# a ``grid_model`` mapping a dispatch site-info dict to the launches the
# C entry point makes, built from the package's ``plan()``.
#
# The vocabulary is the reference's (a grid, block models with index maps,
# an accumulator over the innermost reduction axis), read for CUDA:
#
#   - the grid's leading axes are the launch's blockIdx axes (x, y, z); its
#     ``loops`` trailing axes are loops inside a block (over K, over a
#     window of edges, over time), never launched as blocks;
#   - a block model's tile is what one block reads or writes; a ragged last
#     tile is bounds-checked inside the kernel, never padded in memory, so
#     array shapes are the unpadded extents (block counts round up);
#   - an index map may return None: an in-kernel guard keeps that point
#     from touching the operand;
#   - a call that takes several launches (a sorted segment sum, a split-K
#     product) is an ordered tuple of launch models; an input named as an
#     earlier launch's output is a workspace, and every block of it that a
#     later launch reads must have been written exactly once.
#
# ``analysis.kernelcheck`` interprets the models abstractly; the
# ``sanitizer`` dispatch tier interprets the same models concretely at
# runtime; on the card, chip_smoke.py holds each model's launches to the
# launch record the C entry point keeps (``kernels.common.last_launches``).
# The vocabulary lives here, not in analysis/, so kernel packages never
# import the analysis layer.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Interval:
    """Inclusive integer range for index-map coordinates that are only
    known as a range statically (row ids read from memory)."""

    lo: int
    hi: int

    def __repr__(self) -> str:
        return f"[{self.lo}..{self.hi}]"


#: an index-map coordinate: exact, or an inclusive range.
Coord = Union[int, Interval]


@dataclass(frozen=True)
class BlockModel:
    """One operand's tiles, abstractly: the array shape the kernel
    addresses (unpadded), the tile one block covers, and the index map
    from grid coordinates to tile indices (a ``Coord`` per dim, or None
    where an in-kernel guard skips the operand)."""

    name: str
    array_shape: Tuple[int, ...]
    block_shape: Tuple[int, ...]
    index_map: Callable[..., Optional[Tuple[Coord, ...]]]

    def block_counts(self) -> Tuple[int, ...]:
        return tuple(
            -(-a // b) for a, b in zip(self.array_shape, self.block_shape)
        )


@dataclass(frozen=True)
class AccumModel:
    """An f32 accumulator carried across the ``axis`` grid dimension (a
    loop inside the block): zeroed when the axis coordinate equals
    ``init_at``, with the output tile stored at the axis' last step
    (``store="last"``) or at every step (``store="every"``, the scan)."""

    axis: int
    init_at: int = 0
    store: str = "last"  # "last" | "every"


@dataclass(frozen=True)
class GridModel:
    """The geometry of one kernel launch: grid extents, input/output block
    models, the optional accumulator, and what the launch record shows of
    it — the kernel's name (``kernel``), its ``blockDim`` (``block``), the
    number of trailing grid axes that are loops inside a block (``loops``;
    the rest are its ``gridDim``) and its thread-block cluster's dimensions
    (``cluster``; (1, 1, 1) for a launch without clusters). The blocks of a
    cluster may read each other's shared memory, which no block model
    shows: each still stores its own output tiles, so the race and
    coverage checks hold as for any grid."""

    grid: Tuple[int, ...]
    inputs: Tuple[BlockModel, ...]
    output: BlockModel
    accumulator: Optional[AccumModel] = None
    kernel: str = ""
    block: Tuple[int, int, int] = (1, 1, 1)
    loops: int = 0
    cluster: Tuple[int, int, int] = (1, 1, 1)

    def launch(self) -> Tuple:
        """``(kernel, gridDim, blockDim)`` as the launch record shows them,
        and the cluster's dimensions after them for a cluster launch."""
        dims = tuple(self.grid[: len(self.grid) - self.loops])
        out = (self.kernel, tuple(dims + (1,) * (3 - len(dims))), tuple(self.block))
        return out if tuple(self.cluster) == (1, 1, 1) else out + (tuple(self.cluster),)


#: what a contract's grid model gives for a site: one launch, an ordered
#: tuple of launches, or None when nothing is launched.
LaunchModel = Union[GridModel, Tuple[GridModel, ...]]


def model_launches(model: Optional[LaunchModel]) -> Tuple[Tuple, ...]:
    """The ``(kernel, gridDim, blockDim)`` of every launch of a model, in
    order: what ``kernels.common.last_launches`` must show after the call."""
    if model is None:
        return ()
    models = model if isinstance(model, tuple) else (model,)
    return tuple(m.launch() for m in models)


@dataclass(frozen=True)
class VjpPair:
    """One dispatch op the kernel's backward re-enters at the forward's
    tier; ``info_map`` translates the forward site info into the backward
    site's info dict."""

    op: str
    info_map: Callable[[Dict], Dict]


@dataclass(frozen=True)
class KernelContract:
    """The statically checkable contract of one kernel package.

    ``dtypes`` is the domain of the hardware (cuda/sanitizer) tiers —
    ``"floating"`` or ``"any"``; ``accum_dtype`` names the accumulator
    dtype; ``masking`` lists the masking obligations the kernel discharges
    (prose: the in-kernel guards the models state); ``vjp`` describes the
    backward; ``vjp_pairs`` are the dispatch ops it re-enters in-tier;
    ``grid_model(info, **concrete)`` builds the launch model for a site
    (``None`` when nothing is launched) — ``concrete`` may carry runtime
    operands (the sanitizer passes actual row ids) to sharpen Interval
    coordinates into exact ones; ``concrete_check(info, **concrete)``, where
    given, checks what depends on the data alone (the routing of a sorted
    segment sum's chunk sums) and returns ``(kind, detail)`` violations.
    """

    op: str
    dtypes: str
    accum_dtype: str
    masking: Tuple[str, ...]
    vjp: str
    vjp_pairs: Tuple[VjpPair, ...]
    grid_model: Callable[..., Optional[LaunchModel]]
    concrete_check: Optional[Callable[..., List[Tuple[str, str]]]] = None


#: kernel package module per contract-carrying op. ``ssm_scan`` carries a
#: contract but no registry entries (the models layer calls it directly).
_CONTRACT_MODULES: Dict[str, str] = {
    "segment_sum": "repro_torch.kernels.segsum.ops",
    "blocked_matmul": "repro_torch.kernels.matmul.ops",
    "gather_join": "repro_torch.kernels.gather.ops",
    "ssm_scan": "repro_torch.kernels.ssm_scan.ops",
}


def contract_ops() -> Tuple[str, ...]:
    """Ops with a declared KernelContract (dispatch ops + ssm_scan)."""
    return tuple(_CONTRACT_MODULES)


def kernel_contract(op: str) -> KernelContract:
    """The ``CONTRACT`` declared in ``op``'s kernel package (lazy import,
    matching the lazy impl wrappers below)."""
    import importlib

    mod = _CONTRACT_MODULES.get(op)
    if mod is None:
        raise KeyError(f"no kernel contract for op {op!r}; have {contract_ops()}")
    return importlib.import_module(mod).CONTRACT


# -- grid-model interpretation ----------------------------------------------
# Shared by the static certifier (analysis/kernelcheck.py wraps violations
# into node-path Diagnostics) and the sanitizer tier (raises
# SanitizerError). Index maps are affine in the grid coordinates, which is
# what makes corner sampling sound for grids too large to enumerate.

#: grids at most this large are enumerated exhaustively (exact coverage /
#: race counts, workspace reads); larger grids are corner-sampled (bounds +
#: race only).
GRID_ENUM_CAP: int = 32768

#: CUDA's limits on gridDim (x; y and z), on the threads of a block and on
#: the blocks of a portable cluster.
CUDA_GRID_X_MAX, CUDA_GRID_YZ_MAX, CUDA_BLOCK_THREADS_MAX = 2**31 - 1, 65535, 1024
CUDA_CLUSTER_MAX = 8


class SanitizerError(RuntimeError):
    """A sanitizer-tier instrumentation check failed. ``kind`` is the
    violation code, matching the static certifier's diagnostic codes."""

    def __init__(self, kind: str, detail: str):
        super().__init__(f"[{kind}] {detail}")
        self.kind = kind
        self.detail = detail


def _grid_coords(grid: Tuple[int, ...], cap: int) -> Tuple[List[Tuple[int, ...]], bool]:
    import itertools

    total = 1
    for s in grid:
        total *= s
    if total <= cap:
        pts = list(itertools.product(*(range(s) for s in grid)))
        return pts, True
    corners = [
        sorted({p for p in (0, 1, s - 2, s - 1) if 0 <= p < s}) for s in grid
    ]
    return list(itertools.product(*corners)), False


def _map_axis_deps(index_map: Callable, grid: Tuple[int, ...]) -> Tuple[int, ...]:
    """Grid axes the index map depends on, by probing unit moves from the
    origin (sound for affine maps)."""
    base = index_map(*(0,) * len(grid))
    deps = []
    for ax, size in enumerate(grid):
        if size <= 1:
            continue
        probe = [0] * len(grid)
        probe[ax] = size - 1
        if index_map(*probe) != base:
            deps.append(ax)
    return tuple(deps)


def _coord_range(v: Coord) -> Tuple[int, int]:
    if isinstance(v, Interval):
        return v.lo, v.hi
    return int(v), int(v)


def _launch_limits(model: GridModel) -> List[Tuple[str, str]]:
    """A CUDA launch's own limits (no counterpart on the TPU, whose grid
    is a loop): gridDim.x < 2³¹, gridDim.y and .z ≤ 65,535, ≤ 1,024
    threads a block; a cluster of at most CUDA_CLUSTER_MAX blocks (the
    portable size) whose dimensions divide the grid's."""
    _, dims, block = model.launch()[:3]
    threads = block[0] * block[1] * block[2]
    if (dims[0] > CUDA_GRID_X_MAX or max(dims[1:]) > CUDA_GRID_YZ_MAX
            or len(model.grid) - model.loops > 3 or threads > CUDA_BLOCK_THREADS_MAX):
        return [(
            "launch-limit",
            f"{model.kernel}: gridDim {dims} x blockDim {block} is beyond "
            f"CUDA's ({CUDA_GRID_X_MAX}, {CUDA_GRID_YZ_MAX}, "
            f"{CUDA_GRID_YZ_MAX}) blocks of {CUDA_BLOCK_THREADS_MAX} threads",
        )]
    cluster = tuple(model.cluster)
    if (min(cluster) < 1 or cluster[0] * cluster[1] * cluster[2] > CUDA_CLUSTER_MAX
            or any(d % c for d, c in zip(dims, cluster))):
        return [(
            "launch-limit",
            f"{model.kernel}: cluster {cluster} of gridDim {dims} is not a portable "
            f"cluster (at most {CUDA_CLUSTER_MAX} blocks, dividing the grid)",
        )]
    return []


@dataclass
class _Written:
    """What one launch stored into its output: per tile, how many blocks
    stored it; ``complete`` when every tile was stored exactly once and
    the count is exhaustive."""

    block: BlockModel
    stores: Dict[Tuple[int, ...], int]
    exhaustive: bool
    complete: bool


def _reads_written(bm: BlockModel, idx, src: _Written) -> bool:
    """Every tile of ``src``'s array that the read tile ``idx`` of ``bm``
    overlaps was stored exactly once."""
    import itertools

    ranges = []
    for v, b, wb, n in zip(idx, bm.block_shape, src.block.block_shape, bm.array_shape):
        lo, hi = _coord_range(v)
        first, last = lo * b, min((hi + 1) * b, n) - 1
        ranges.append(range(first // wb, last // wb + 1))
    return all(src.stores.get(t, 0) == 1 for t in itertools.product(*ranges))


def _simulate_one(
    model: GridModel, cap: int, written: Dict[str, _Written]
) -> Tuple[List[Tuple[str, str]], _Written]:
    viols: List[Tuple[str, str]] = []
    grid = model.grid
    if any(s <= 0 for s in grid):
        return viols, _Written(model.output, {}, False, False)  # nothing launched
    if model.kernel:
        viols += _launch_limits(model)
    coords, exhaustive = _grid_coords(grid, cap)
    acc = model.accumulator

    # revisit axes (grid axes the output map ignores — the reduction /
    # sweep axes) must be the innermost suffix, so that one output tile's
    # partial sums stay adjacent; on CUDA they must also be loops inside
    # the block: blocks along a launched axis run concurrently, and would
    # all store the same tile
    out_deps = set(_map_axis_deps(model.output.index_map, grid))
    revisit = [ax for ax in range(len(grid)) if ax not in out_deps and grid[ax] > 1]
    if revisit != list(range(len(grid) - len(revisit), len(grid))):
        viols.append((
            "grid-reduction-order",
            f"revisit axes {tuple(revisit)} of grid {grid} are not the "
            f"innermost suffix (output map depends on axes {tuple(sorted(out_deps))})",
        ))
    elif model.kernel and revisit and revisit[0] < len(grid) - model.loops:
        viols.append((
            "grid-race",
            f"{model.kernel}: reduction axes {tuple(revisit)} of grid {grid} "
            f"include launched blockIdx axes (only the last {model.loops} are "
            "loops inside a block): their blocks run concurrently and each "
            "stores the same output tile",
        ))
    if acc is not None:
        if acc.init_at != 0:
            viols.append((
                "uninit-accumulator",
                f"accumulator on grid axis {acc.axis} is zeroed at step "
                f"{acc.init_at}, so steps 0..{acc.init_at - 1} accumulate "
                "into an uninitialized register tile",
            ))
        if not 0 <= acc.axis < len(grid):
            viols.append((
                "uninit-accumulator",
                f"accumulator axis {acc.axis} outside grid {grid}",
            ))
            acc = None

    oob_seen = set()
    unread: set = set()
    stores: Dict[Tuple[int, ...], int] = {}
    out_counts = model.output.block_counts()
    for coord in coords:
        for bm in model.inputs + (model.output,):
            idx = bm.index_map(*coord)
            if idx is None:
                continue  # an in-kernel guard skips the operand here
            counts = bm.block_counts()
            if len(idx) != len(counts):
                if bm.name not in oob_seen:
                    oob_seen.add(bm.name)
                    viols.append((
                        "grid-oob-index",
                        f"{bm.name}: index map arity {len(idx)} != "
                        f"array rank {len(counts)}",
                    ))
                continue
            inside = True
            for d, (v, n) in enumerate(zip(idx, counts)):
                lo, hi = _coord_range(v)
                if lo < 0 or hi >= n:
                    inside = False
                    key = (bm.name, d)
                    if key not in oob_seen:
                        oob_seen.add(key)
                        viols.append((
                            "grid-oob-index",
                            f"{bm.name} dim {d}: block index {v} at grid "
                            f"point {coord} outside [0, {n}) "
                            f"(array {bm.array_shape}, block {bm.block_shape})",
                        ))
            src = written.get(bm.name) if bm is not model.output else None
            if (inside and src is not None and src.exhaustive and not src.complete
                    and bm.name not in unread and not _reads_written(bm, idx, src)):
                unread.add(bm.name)
                viols.append((
                    "uninit-accumulator",
                    f"{bm.name}: tile {idx} read at grid point {coord} is not "
                    "written exactly once by the launch before that stores it",
                ))
        if acc is None or acc.store == "every":
            stored = True
        else:
            stored = coord[acc.axis] == grid[acc.axis] - 1
        if stored:
            oidx = model.output.index_map(*coord)
            if oidx is None:
                continue
            if any(isinstance(v, Interval) for v in oidx):
                viols.append((
                    "grid-race",
                    f"output block index {oidx} at grid point {coord} is "
                    "not statically exact — cannot prove single-writer",
                ))
                continue
            oidx = tuple(int(v) for v in oidx)
            stores[oidx] = stores.get(oidx, 0) + 1

    races = sorted(idx for idx, c in stores.items() if c > 1)
    if races:
        viols.append((
            "grid-race",
            f"{len(races)} output block(s) stored by more than one program "
            f"instance, e.g. block {races[0]} stored {stores[races[0]]}x",
        ))
    missing: List[Tuple[int, ...]] = []
    if exhaustive:
        import itertools

        missing = [
            idx
            for idx in itertools.product(*(range(n) for n in out_counts))
            if idx not in stores
        ]
        if missing:
            viols.append((
                "grid-uncovered",
                f"{len(missing)} output block(s) never stored, e.g. "
                f"block {missing[0]} of {out_counts}",
            ))
    done = _Written(model.output, stores, exhaustive, exhaustive and not races and not missing)
    return viols, done


def simulate_grid(
    model: LaunchModel, cap: int = GRID_ENUM_CAP
) -> List[Tuple[str, str]]:
    """Interpret a kernel's launch model and return ``(kind, detail)``
    violations (empty = sound). Kinds: ``grid-oob-index`` (an input or
    output block index leaves the array), ``grid-race`` (an output block
    stored by more than one block, or a reduction over a launched axis),
    ``grid-uncovered`` (an output block never stored; exhaustive
    enumeration only), ``grid-reduction-order`` (revisit axes not
    innermost), ``uninit-accumulator`` (accumulated before its zeroing
    step, or a workspace tile read that no earlier launch of the sequence
    wrote exactly once) and ``launch-limit`` (a gridDim or blockDim beyond
    CUDA's limits). A tuple of models is one call's ordered launches; their
    violations name the launch."""
    if not isinstance(model, tuple):
        return _simulate_one(model, cap, {})[0]
    viols: List[Tuple[str, str]] = []
    written: Dict[str, _Written] = {}
    for i, m in enumerate(model):
        got, done = _simulate_one(m, cap, written)
        viols += [(kind, f"launch {i} ({m.kernel}): {detail}") for kind, detail in got]
        written[m.output.name] = done
    return viols


# -- dispatch-site resolution log --------------------------------------------


@dataclass(frozen=True)
class SiteRecord:
    """One dispatch decision with enough context to replay it: the
    ``op[site]`` key, the site-info dict (frozen as sorted items), and
    the tier that resolved."""

    key: str
    op: str
    site: str
    tier: str
    info: Tuple[Tuple[str, object], ...]

    def info_dict(self) -> Dict:
        return dict(self.info)


class ResolutionLog(Dict[str, str]):
    """The ``op[site] → tier`` dict the engine exposes as
    ``Compiled.resolutions``, plus per-site SiteRecords for replay."""

    def __init__(self) -> None:
        super().__init__()
        self.sites: List[SiteRecord] = []

    def record(self, key: str, op: str, site: str, tier: str, info: Dict) -> None:
        self.sites.append(
            SiteRecord(key, op, site, tier, tuple(sorted(info.items())))
        )


# -- registered implementations ---------------------------------------------
# The kernel packages are imported lazily, so importing repro_torch.core
# never touches the kernel library (and never builds it).


def _is_float(info: Dict) -> bool:
    # the contracts' "floating" dtype domain
    return info["dtype"].is_floating_point


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _is_f32_bf16_f16(info: Dict) -> bool:
    # the segment-sum, gather and matmul kernels take f32, bf16 and f16 (the
    # sum in f32, rounded once); f64 falls through to the next tier and is
    # recorded so
    return info["dtype"] in (torch.float32, torch.bfloat16, torch.float16)


def _segsum_ref(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    from repro_torch.kernels.segsum.ref import segment_sum_ref

    return segment_sum_ref(msg, seg, num_segments)


def _segsum_cuda(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    from repro_torch.kernels.segsum.ops import segment_sum

    return segment_sum(msg, seg, num_segments)


def _matmul_torch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, y)


def _matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.matmul.ref import matmul_ref

    return matmul_ref(x, y)


def _matmul_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.matmul.ops import blocked_matmul

    return blocked_matmul(x, y)


def _gather_ref(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    # also the torch tier: the default lowering IS the masked-gather
    # version (one definition of the COO pad-and-mask contract)
    from repro_torch.kernels.gather.ref import gather_rows_ref

    return gather_rows_ref(table, rows)


def _gather_cuda(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.gather.ops import gather_rows

    return gather_rows(table, rows)


# -- sanitizer tier ----------------------------------------------------------
# Instrumented cross-check impls: they replay the contract's launch model at
# the call's shapes (and, where the model reads them, its ids) with
# out-of-bounds / write-race / uninitialized-accumulator instrumentation,
# raising SanitizerError with the codes the static certifier reports, and
# compute the result through the plain version. On the card the model is
# the one the cuda tier would launch (the operands' alignment included),
# and no kernel is launched.


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _sanitize_site(op: str, info: Dict, **concrete: Any) -> None:
    contract = kernel_contract(op)
    if contract.dtypes == "floating" and not _is_float(info):
        raise SanitizerError(
            "dtype-domain",
            f"{op}: dtype {_dtype_name(info['dtype'])} outside the "
            f"contract's floating domain at site {info}",
        )
    model = contract.grid_model(info, **concrete)
    viols = [] if model is None else simulate_grid(model)
    if not viols and contract.concrete_check is not None and concrete:
        viols = contract.concrete_check(info, **concrete)
    if viols:
        kind, detail = viols[0]
        raise SanitizerError(kind, f"{op}: {detail} (site {info})")


def _segsum_sanitizer(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    from repro_torch.kernels.segsum.ref import segment_sum_ref

    info = {
        "nnz": msg.shape[0], "dim": msg.shape[1],
        "num_segments": num_segments, "dtype": msg.dtype,
    }
    # the ids decide the sorted path's routing of chunk sums
    _sanitize_site("segment_sum", info, seg=seg, aligned=_aligned(msg))
    return segment_sum_ref(msg, seg, num_segments)


def _matmul_sanitizer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.matmul.ref import matmul_ref

    info = {
        "m": x.shape[0], "k": x.shape[1], "n": y.shape[1],
        "dtype": torch.result_type(x, y),
    }
    # the bases decide which 16-bit tiled kernel runs
    _sanitize_site("blocked_matmul", info, aligned=_aligned(x, y))
    return matmul_ref(x, y)


def _gather_sanitizer(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.gather.ref import gather_rows_ref

    info = {
        "rows": rows.shape[0], "num_rows": table.shape[0],
        "dim": table.shape[1], "dtype": table.dtype,
    }
    # concrete row ids sharpen the table's Interval into the rows each
    # block reads
    _sanitize_site("gather_join", info, rows=rows, aligned=_aligned(table))
    return gather_rows_ref(table, rows)


register_impl(
    "segment_sum", "cuda", _segsum_cuda, backends=("cuda",), predicate=_is_f32_bf16_f16
)
register_impl("segment_sum", "sanitizer", _segsum_sanitizer, predicate=_is_f32_bf16_f16)
register_impl("segment_sum", "ref", _segsum_ref)
register_impl("segment_sum", "torch", _segsum_ref)

register_impl(
    "blocked_matmul", "cuda", _matmul_cuda, backends=("cuda",), predicate=_is_f32_bf16_f16
)
register_impl("blocked_matmul", "sanitizer", _matmul_sanitizer, predicate=_is_f32_bf16_f16)
register_impl("blocked_matmul", "ref", _matmul_ref)
register_impl("blocked_matmul", "torch", _matmul_torch)

register_impl(
    "gather_join", "cuda", _gather_cuda, backends=("cuda",), predicate=_is_f32_bf16_f16
)
register_impl("gather_join", "sanitizer", _gather_sanitizer, predicate=_is_f32_bf16_f16)
register_impl("gather_join", "ref", _gather_ref)
register_impl("gather_join", "torch", _gather_ref)
