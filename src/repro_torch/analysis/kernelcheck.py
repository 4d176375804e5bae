"""Static certification of the kernel dispatch registry.

``core/kernels.py`` routes the engine's hardware hot spots (Σ-over-COO
segment-sum, gather-join, blocked matmul) through registered
``KernelImpl`` tiers, and every kernel package declares a
:class:`~repro_torch.core.kernels.KernelContract` — dtype domain, masking
obligations, accumulator dtype, the dispatch ops its backward re-enters,
and a ``grid_model`` mapping a dispatch site to the CUDA launches its C
entry point makes (built from the package's ``plan()``; a multi-launch
call as an ordered tuple). This module *proves* the registry sound
against those contracts, per impl and shape class, before anything runs:

- **grid/write-race soundness** — abstract interpretation of each launch's
  grid and tile index maps: every output tile is stored by exactly one
  block (``grid-race`` / ``grid-uncovered``; a reduction over a launched
  blockIdx axis is a race), all index maps stay inside the unpadded arrays
  plus the in-kernel guards the models state (``grid-oob-index``),
  reduction loops are the innermost grid suffix
  (``grid-reduction-order``), accumulators are zeroed before first use and
  every workspace tile a later launch reads was written exactly once by an
  earlier one (``uninit-accumulator``), and each launch stays inside
  CUDA's grid and block limits (``launch-limit``).
- **VJP pairing** — every hardware forward tier re-enters its declared
  backward ops at the *same* tier, and that backward has a registered
  impl whose backend/predicate domain covers the forward's
  (``unpaired-vjp`` / ``vjp-domain-gap``): no site where the gradient
  silently falls to a different tier than ``Compiled.resolutions``
  recorded.
- **predicate determinism** — dispatch predicates are pure functions of
  the site-info dict (``flappy-predicate``); ``certify_kernels``
  additionally replays every recorded ``SiteRecord`` through
  ``resolve_impl`` and flags resolution drift, turning the retrace-desync
  hazard documented on ``KernelImpl`` into a checked invariant.

Two entry points: :func:`certify_registry` sweeps the whole registry over
representative shape classes (``python -m
repro_torch.analysis.kernelcheck``); :func:`certify_kernels` certifies exactly
the sites one ``Compiled``/``Lowered`` resolved, at their recorded
site-info dicts, and caches the report on the ``Lowered`` (which the
engine already caches per ``(sig, dispatch, rewrite)`` key) so repeated
``db.explain``/``certify`` calls — and the hot path itself — pay nothing.

The dynamic twin is the ``sanitizer`` dispatch tier (core/kernels.py):
the same launch models interpreted concretely at runtime, raising
``SanitizerError`` with these diagnostic codes as ``kind``. On the card,
``chip_smoke.py`` holds every model's launches to the launch record the C
entry points keep (``kernels.common.last_launches``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..core import kernels as K

from .diagnostics import CheckReport, Diagnostic

__all__ = [
    "certify_kernels",
    "certify_registry",
    "check_contract_grid",
    "check_impl",
    "default_shape_classes",
    "launch_mismatch",
    "main",
]

#: tiers whose backward re-enters dispatch ops physically (the torch/ref
#: tiers differentiate through plain torch and need no pairing proof).
_HARDWARE_TIERS: Tuple[str, ...] = ("cuda", "sanitizer")

#: device types a backend-unrestricted impl is certified under.
_BACKENDS: Tuple[str, ...] = ("cpu", "cuda")


def default_shape_classes(op: str) -> Tuple[Dict[str, Any], ...]:
    """Representative site-info dicts per op: the reference's classes
    (tile-exact, ragged, a single-tile degenerate, an integer dtype the
    torch/ref tiers alone admit), then one per CUDA path the reference's
    classes do not reach: the sorted segment sum (E above its scan
    crossover; few segments, so that chunks combine), element units
    (rows of 200 bytes), the split-K products (tiled, skinny, and the
    ordered sum's 32 lanes an entry) and the scan's reverse walk."""
    f32, i32 = torch.float32, torch.int32
    if op == "segment_sum":
        return (
            {"nnz": 512, "dim": 128, "num_segments": 128, "dtype": f32},
            {"nnz": 1000, "dim": 96, "num_segments": 300, "dtype": f32},
            {"nnz": 7, "dim": 3, "num_segments": 5, "dtype": f32},
            {"nnz": 1024, "dim": 64, "num_segments": 256, "dtype": i32},
            {"nnz": 5000, "dim": 96, "num_segments": 300, "dtype": f32},
            {"nnz": 5000, "dim": 50, "num_segments": 3, "dtype": f32},
        )
    if op == "blocked_matmul":
        return (
            {"m": 128, "k": 128, "n": 128, "dtype": f32},
            {"m": 200, "k": 384, "n": 72, "dtype": f32},
            {"m": 7, "k": 5, "n": 3, "dtype": f32},
            {"m": 64, "k": 64, "n": 64, "dtype": i32},
            {"m": 100, "k": 2000, "n": 300, "dtype": f32},
            {"m": 2, "k": 4096, "n": 300, "dtype": f32},
            {"m": 4, "k": 40000, "n": 8, "dtype": f32},
        )
    if op == "gather_join":
        return (
            {"rows": 512, "num_rows": 128, "dim": 64, "dtype": f32},
            {"rows": 1000, "num_rows": 300, "dim": 96, "dtype": f32},
            {"rows": 7, "num_rows": 5, "dim": 3, "dtype": f32},
            {"rows": 256, "num_rows": 64, "dim": 32, "dtype": i32},
            {"rows": 1000, "num_rows": 300, "dim": 50, "dtype": f32},
        )
    if op == "ssm_scan":
        return (
            {"batch": 2, "seq": 512, "channels": 16, "state": 4, "dtype": f32},
            {"batch": 1, "seq": 12, "channels": 6, "state": 4, "dtype": f32},
            {"batch": 3, "seq": 7, "channels": 5, "state": 2, "dtype": f32},
            {"batch": 3, "seq": 7, "channels": 5, "state": 2, "dtype": f32, "reverse": True},
        )
    return ()


def _site_label(op: str, info: Dict[str, Any]) -> str:
    """The compiler's site label for an info dict (compiler._note)."""
    if op == "segment_sum":
        return f"E={info['nnz']},D={info['dim']},S={info['num_segments']}"
    if op == "blocked_matmul":
        return f"m={info['m']},k={info['k']},n={info['n']}"
    if op == "gather_join":
        return f"E={info['rows']},N={info['num_rows']},D={info['dim']}"
    return ",".join(f"{k}={v}" for k, v in sorted(info.items()) if k != "dtype")


_HINTS = {
    "grid-race": "make the output index map injective over the non-reduction "
    "grid axes, or store from an accumulator at the reduction axis' last step",
    "grid-uncovered": "the output index map must reach every "
    "ceil(shape/block) tile of the output array",
    "grid-oob-index": "pad the operand to a block multiple in the ops.py "
    "wrapper (and mirror the padding in the contract's grid_model)",
    "grid-reduction-order": "move the reduction loops to the end of the "
    "grid tuple and count them in the model's loops",
    "uninit-accumulator": "zero the accumulator at the reduction loop's "
    "first step, and let a launch read only workspace tiles an earlier "
    "launch of the call wrote exactly once",
    "launch-limit": "split the launch, or move the axis beyond the limit "
    "to gridDim.x",
}


@functools.lru_cache(maxsize=4096)
def _grid_verdict(contract: K.KernelContract, info_items: Tuple) -> Tuple[Tuple[str, str], ...]:
    """``simulate_grid`` of the contract's model at one site, memoized: a
    plan repeats one site shape at every layer, and plans repeat sites. The
    key holds the contract itself, so a replaced contract is checked anew."""
    model = contract.grid_model(dict(info_items))
    return () if model is None else tuple(K.simulate_grid(model))


def _grid_diags(
    op: str, contract: K.KernelContract, info: Dict[str, Any], node_path: str
) -> List[Diagnostic]:
    return [
        Diagnostic(
            severity="error",
            code=kind,
            node_path=node_path,
            message=detail,
            hint=_HINTS.get(kind, ""),
        )
        for kind, detail in _grid_verdict(contract, tuple(sorted(info.items())))
    ]


def check_contract_grid(
    op: str,
    contract: K.KernelContract,
    infos: Sequence[Dict[str, Any]],
    node_path: Optional[str] = None,
) -> List[Diagnostic]:
    """Grid/write-race soundness of ``contract.grid_model`` over the
    given shape classes (floating classes only — the hardware tiers'
    domain, which is what the model describes)."""
    diags: List[Diagnostic] = []
    for info in infos:
        if contract.dtypes == "floating" and not K._is_float(info):
            continue
        path = node_path or f"registry:{op}[{_site_label(op, info)}]"
        diags += _grid_diags(op, contract, info, path)
    return diags


def _predicate_diags(
    impl: K.KernelImpl, infos: Sequence[Dict[str, Any]], node_path: str
) -> List[Diagnostic]:
    """Predicate determinism: two evaluations on independently built but
    equal info dicts must agree — a stateful (call-counting, clock- or
    RNG-reading) predicate flips somewhere across the double sweep."""
    if impl.predicate is None:
        return []
    try:
        first = [bool(impl.predicate(dict(info))) for info in infos]
        second = [bool(impl.predicate(dict(info))) for info in infos]
    except Exception as exc:  # a raising predicate can never be replayed
        return [
            Diagnostic(
                severity="error",
                code="flappy-predicate",
                node_path=node_path,
                message=f"predicate raised {type(exc).__name__}: {exc}",
                hint="dispatch predicates must be total pure functions of "
                "the site-info dict",
            )
        ]
    diags = []
    for info, a, b in zip(infos, first, second):
        if a != b:
            diags.append(
                Diagnostic(
                    severity="error",
                    code="flappy-predicate",
                    node_path=node_path,
                    message=(
                        f"predicate is not a pure function of the site info: "
                        f"two evaluations at {_site_label(impl.op, info)} "
                        f"returned {a} then {b} — resolution would desync "
                        "from the lowering cache key on retrace"
                    ),
                    hint="derive the decision only from the info dict "
                    "(shapes/dtype); hoist any state into the DispatchTable",
                )
            )
    return diags


def _vjp_diags(
    impl: K.KernelImpl,
    contract: K.KernelContract,
    infos: Sequence[Dict[str, Any]],
    node_path: str,
) -> List[Diagnostic]:
    """VJP pairing: each declared backward op must have a registered impl
    *at the forward's tier* whose backend + predicate domain covers every
    site the forward accepts."""
    if impl.tier not in _HARDWARE_TIERS or not contract.vjp_pairs:
        return []
    backends = impl.backends or _BACKENDS
    diags: List[Diagnostic] = []
    for pair in contract.vjp_pairs:
        bucket = K._IMPLS.get((pair.op, impl.tier), ())
        if not bucket:
            diags.append(
                Diagnostic(
                    severity="error",
                    code="unpaired-vjp",
                    node_path=node_path,
                    message=(
                        f"backward re-enters {pair.op!r} at tier "
                        f"{impl.tier!r} but no impl is registered there"
                    ),
                    hint=f"register_impl({pair.op!r}, {impl.tier!r}, ...) "
                    "or change the contract's vjp_pairs",
                )
            )
            continue
        for info in infos:
            if impl.predicate is not None and not impl.predicate(dict(info)):
                continue  # the forward never fires here
            binfo = pair.info_map(dict(info))
            for backend in backends:
                covered = any(
                    (not b.backends or backend in b.backends)
                    and (b.predicate is None or b.predicate(dict(binfo)))
                    for b in bucket
                )
                if not covered:
                    diags.append(
                        Diagnostic(
                            severity="error",
                            code="vjp-domain-gap",
                            node_path=node_path,
                            message=(
                                f"forward accepts "
                                f"{_site_label(impl.op, info)} on "
                                f"{backend} but its backward "
                                f"{pair.op!r}@{impl.tier} rejects the "
                                f"cotangent site "
                                f"{_site_label(pair.op, binfo)} — the "
                                "gradient would fall to a different tier "
                                "than Compiled.resolutions recorded"
                            ),
                            hint="widen the backward impl's predicate/"
                            "backends to cover the forward's domain",
                        )
                    )
                    break  # one gap per (pair, info) is enough
    return diags


def _dtype_diags(
    impl: K.KernelImpl,
    contract: K.KernelContract,
    infos: Sequence[Dict[str, Any]],
    node_path: str,
) -> List[Diagnostic]:
    """Hardware tiers must not accept sites outside the contract's dtype
    domain (the kernels accumulate in f32 and store the input dtype —
    integer inputs would round-trip through float silently)."""
    if impl.tier not in _HARDWARE_TIERS or contract.dtypes != "floating":
        return []
    diags = []
    for info in infos:
        if K._is_float(info):
            continue
        if impl.predicate is None or impl.predicate(dict(info)):
            diags.append(
                Diagnostic(
                    severity="error",
                    code="dtype-domain",
                    node_path=node_path,
                    message=(
                        f"tier {impl.tier!r} admits dtype "
                        f"{K._dtype_name(info['dtype'])} at "
                        f"{_site_label(impl.op, info)} but the contract's "
                        "domain is floating (f32 accumulate + store-input-"
                        "dtype would silently round-trip integers)"
                    ),
                    hint="gate the impl with a floating predicate "
                    "(kernels._is_float) or widen the contract",
                )
            )
            break
    return diags


def check_impl(
    impl: K.KernelImpl,
    contract: K.KernelContract,
    infos: Sequence[Dict[str, Any]],
) -> List[Diagnostic]:
    """All per-impl checks: predicate determinism, dtype domain, VJP
    pairing."""
    node_path = f"registry:{impl.op}:{impl.tier}"
    return (
        _predicate_diags(impl, infos, node_path)
        + _dtype_diags(impl, contract, infos, node_path)
        + _vjp_diags(impl, contract, infos, node_path)
    )


def _missing_contract(op: str) -> Diagnostic:
    return Diagnostic(
        severity="error",
        code="missing-contract",
        node_path=f"registry:{op}",
        message=f"dispatch op {op!r} has no KernelContract",
        hint="declare CONTRACT next to the registration in the kernel "
        "package's ops.py and map it in kernels._CONTRACT_MODULES",
    )


def certify_registry(
    ops: Optional[Iterable[str]] = None,
    shape_classes: Optional[Dict[str, Sequence[Dict[str, Any]]]] = None,
) -> CheckReport:
    """Certify the full registry (or ``ops``) over representative shape
    classes: contract grid soundness once per (op, class), then every
    registered impl's determinism / dtype-domain / VJP-pairing checks."""
    diags: List[Diagnostic] = []
    for op in ops if ops is not None else K.DISPATCH_OPS:
        try:
            contract = K.kernel_contract(op)
        except KeyError:
            diags.append(_missing_contract(op))
            continue
        infos = tuple(
            (shape_classes or {}).get(op) or default_shape_classes(op)
        )
        diags += check_contract_grid(op, contract, infos)
        for tier in K.DISPATCH_TIERS:
            for impl in K._IMPLS.get((op, tier), ()):
                diags += check_impl(impl, contract, infos)
    # contract-only kernels (ssm_scan): grid proof without registry entries
    for op in set(K.contract_ops()) - set(K.DISPATCH_OPS):
        if ops is not None and op not in ops:
            continue
        diags += check_contract_grid(op, K.kernel_contract(op), default_shape_classes(op))
    return CheckReport(tuple(diags))


def _lowered_of(compiled: Any):
    """Accept a Compiled, StreamedCompiled, or Lowered."""
    inner = getattr(compiled, "_inner", None)
    if inner is not None:  # StreamedCompiled wraps a per-wave Compiled
        compiled = inner
    return getattr(compiled, "lowered", compiled)


def certify_kernels(compiled: Any, *, recheck: bool = False) -> CheckReport:
    """Certify exactly the kernels one compiled plan resolved.

    For every ``SiteRecord`` the lowering walk logged (op, site-info
    snapshot, chosen tier) this (1) replays ``resolve_impl`` on the
    snapshot against the plan's DispatchTable and flags any drift from
    the recorded tier (``flappy-predicate`` — the retrace-desync hazard,
    now checked), (2) proves the contract's grid model sound *at the
    site's actual shapes*, and (3) runs the per-impl dtype/determinism/
    VJP-pairing checks for every op the plan touched. The report is
    cached on the ``Lowered`` (itself cached per ``(sig, dispatch,
    rewrite)``), so certification adds zero hot-path cost; ``recheck``
    forces a fresh pass (tests that mutate contracts underneath).
    """
    lowered = _lowered_of(compiled)
    cached = getattr(lowered, "_kernel_report", None)
    if cached is not None and not recheck:
        return cached
    table = getattr(lowered, "dispatch", None) or K.default_table("cpu")
    resolutions = getattr(lowered, "resolutions", {})
    sites: Sequence[K.SiteRecord] = getattr(resolutions, "sites", ())

    diags: List[Diagnostic] = []
    infos_by_op: Dict[str, List[Dict[str, Any]]] = {}
    for rec in sites:
        info = rec.info_dict()
        infos_by_op.setdefault(rec.op, []).append(info)
        node_path = f"dispatch:{rec.key}"
        try:
            replayed = K.resolve_impl(rec.op, dict(info), table)
        except K.KernelDispatchError as exc:
            diags.append(
                Diagnostic(
                    severity="error",
                    code="flappy-predicate",
                    node_path=node_path,
                    message=f"recorded tier {rec.tier!r} no longer resolves: {exc}",
                    hint="dispatch predicates must be pure functions of the "
                    "site-info dict",
                )
            )
            continue
        if replayed.tier != rec.tier:
            diags.append(
                Diagnostic(
                    severity="error",
                    code="flappy-predicate",
                    node_path=node_path,
                    message=(
                        f"lowering resolved tier {rec.tier!r} but replaying "
                        f"the recorded site info resolves {replayed.tier!r} "
                        "— a stateful predicate desyncs retraces from the "
                        "lowering cache key"
                    ),
                    hint="derive the decision only from the info dict; "
                    "hoist any state into the DispatchTable",
                )
            )
        try:
            contract = K.kernel_contract(rec.op)
        except KeyError:
            diags.append(_missing_contract(rec.op))
            continue
        diags += check_contract_grid(rec.op, contract, [info], node_path=node_path)

    for op, infos in sorted(infos_by_op.items()):
        try:
            contract = K.kernel_contract(op)
        except KeyError:
            continue  # already reported per site
        for tier in table.tiers(op):
            for impl in K._IMPLS.get((op, tier), ()):
                diags += check_impl(impl, contract, infos)

    report = CheckReport(tuple(diags))
    if getattr(lowered, "dispatch", None) is not None:
        # cache only on a real Lowered — a StreamedCompiled whose inner
        # plan has not materialized yet must not pin an empty report
        lowered._kernel_report = report
    return report


def launch_mismatch(
    op: str,
    info: Dict[str, Any],
    record: Sequence[Tuple],
    model: Optional[K.LaunchModel] = None,
    **concrete: Any,
) -> Optional[str]:
    """On the card: hold the launch record of one call
    (``kernels.common.last_launches()``) to the launches the contract's
    model gives for its site (or to ``model``, where the caller plants
    one). None when they are equal, else what differs."""
    if model is None:
        model = K.kernel_contract(op).grid_model(dict(info), **concrete)
    want = K.model_launches(model)
    got = tuple(record)
    if got == want:
        return None
    return (f"{op} at {_site_label(op, info)}: launched {got}, but the "
            f"contract's model launches {want}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: certify the full registry, print the report, exit non-zero on
    any error-severity diagnostic."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="repro_torch.analysis.kernelcheck",
        description="statically certify the kernel dispatch registry",
    )
    parser.add_argument(
        "ops", nargs="*", help="ops to certify (default: the full registry)"
    )
    ns = parser.parse_args(argv)
    report = certify_registry(ns.ops or None)
    n_impls = sum(
        len(K._IMPLS.get((op, tier), ()))
        for op in K.DISPATCH_OPS
        for tier in K.DISPATCH_TIERS
    )
    print(
        f"kernelcheck: {len(K.DISPATCH_OPS)} dispatch op(s), "
        f"{n_impls} registered impl(s), "
        f"{len(K.contract_ops())} contract(s)"
    )
    print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
