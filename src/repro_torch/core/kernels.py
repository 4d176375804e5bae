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
only), ``ref`` (their plain PyTorch versions) and ``torch`` (the
compiler's own plain lowering; always registered, always applicable).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

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
#   ref     the kernels' plain PyTorch versions (kernels/*/ref.py)
#   torch   the compiler's own plain lowering (einsum / index_add_ /
#           index_select); always registered, always applicable — the
#           default tier off the card
# ---------------------------------------------------------------------------

#: logical ops the compiler routes through the registry.
DISPATCH_OPS: Tuple[str, ...] = ("segment_sum", "blocked_matmul", "gather_join")

#: known tiers, in decreasing specialization order.
DISPATCH_TIERS: Tuple[str, ...] = ("cuda", "ref", "torch")


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
    predicate: Optional[Callable] = None,
) -> KernelImpl:
    """Register a physical implementation for a logical op under a tier.

    Entries within one (op, tier) bucket are tried in registration order;
    the first whose backend list admits the table's device type and whose
    predicate accepts the site's shape/dtype info wins.
    """
    if tier not in DISPATCH_TIERS:
        raise ValueError(f"unknown tier {tier!r}; have {DISPATCH_TIERS}")
    impl = KernelImpl(op, tier, fn, tuple(backends), predicate)
    _IMPLS.setdefault((op, tier), []).append(impl)
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


def _is_f32(info: Dict) -> bool:
    # blocked_matmul reads and writes f32 and sums in f32; any other dtype
    # (f64, bf16, ...) falls through to the next tier and is recorded so
    return info["dtype"] == torch.float32


def _is_f32_bf16_f16(info: Dict) -> bool:
    # the segment-sum and gather kernels take f32, bf16 and f16 (the sum in
    # f32, rounded once); f64 falls through to the next tier
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


register_impl(
    "segment_sum", "cuda", _segsum_cuda, backends=("cuda",), predicate=_is_f32_bf16_f16
)
register_impl("segment_sum", "ref", _segsum_ref)
register_impl("segment_sum", "torch", _segsum_ref)

register_impl(
    "blocked_matmul", "cuda", _matmul_cuda, backends=("cuda",), predicate=_is_f32
)
register_impl("blocked_matmul", "ref", _matmul_ref)
register_impl("blocked_matmul", "torch", _matmul_torch)

register_impl(
    "gather_join", "cuda", _gather_cuda, backends=("cuda",), predicate=_is_f32_bf16_f16
)
register_impl("gather_join", "ref", _gather_ref)
register_impl("gather_join", "torch", _gather_ref)
