"""Typed checker for FRA queries (bottom-up schema/shape/dtype inference).

``check_query`` walks the graph leaves-first, inferring for every node a
:class:`RelType` — layout kind (dense/COO), key arity, per-component
extents and provenance labels, value dtype — and emitting
:class:`~repro_torch.analysis.diagnostics.Diagnostic` records along the way.

Severity contract: an ``error`` diagnostic means the chunked compiler is
*guaranteed* to reject (or crash on) the query — every error rule
mirrors a concrete raise site in ``core/compiler.py`` (the rule codes
below cite them). ``warning`` marks executable hazards: implicit dtype
promotion (f32→f64), statically empty selections, stale catalog
statistics, and joins whose gradient falls back to the general
partial-RJP path.

The engine runs this as a mandatory validate stage at the start of
``RAEngine.lower``, ahead of the rewrite stage (raising
:class:`ValidationError` on errors).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import fra
from ..core.keys import (
    In,
    JoinPred,
    JoinProj,
    L,
    Lit,
    R,
    join_equiv_classes,
    solve_left_key,
)
from ..core.relation import CooRelation, DenseRelation
from .diagnostics import CheckReport, Diagnostic


class ValidationError(ValueError):
    """Raised by the engine's validate stage when the typed checker
    produces error-severity diagnostics. Carries the full report."""

    def __init__(self, report: CheckReport):
        self.report = report
        super().__init__(
            "query rejected by the validate stage:\n" + report.render()
        )


#: torch dtype → numpy dtype, for the promotion rules below (a torch.dtype
#: is not a numpy dtype; bfloat16 has no numpy counterpart and maps to None,
#: which the checker treats as unknown).
_NUMPY_DTYPES = {
    torch.float16: np.float16,
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.uint8: np.uint8,
    torch.bool: np.bool_,
}


def numpy_dtype(dtype) -> Optional[np.dtype]:
    """The numpy dtype of a torch dtype, or None where there is none."""
    found = _NUMPY_DTYPES.get(dtype)
    return None if found is None else np.dtype(found)


@dataclass
class RelType:
    """Inferred relation type for one node: layout kind, key arity,
    per-component extents (None = unknown), provenance labels (where each
    key component originated, e.g. ``edges[0]``), and value dtype."""

    kind: str  # "dense" | "coo" | "unknown"
    key_arity: int
    extents: Tuple[Optional[int], ...]
    labels: Tuple[str, ...]
    dtype: Optional[np.dtype]


def _label(name: str, i: int, schema) -> str:
    attrs = (schema or {}).get(name)
    if attrs is not None and i < len(attrs):
        return f"{name}.{attrs[i]}"
    return f"{name}[{i}]"


def _unknown(arity: int) -> RelType:
    return RelType(
        "unknown", arity, (None,) * arity, tuple(f"?[{i}]" for i in range(arity)), None
    )


def _mirror_join(pred: JoinPred, proj: JoinProj) -> Tuple[JoinPred, JoinProj]:
    """Swap the L/R sides of a join's key functions (for solving the
    *right* input's RJP key with ``solve_left_key``)."""

    def sw(c):
        if isinstance(c, L):
            return R(c.idx)
        if isinstance(c, R):
            return L(c.idx)
        return c

    return (
        JoinPred(tuple((sw(a), sw(b)) for a, b in pred.eqs)),
        JoinProj(tuple(sw(c) for c in proj.comps)),
    )


def check_query(
    query,
    env: Optional[Dict[str, object]] = None,
    *,
    stats: Optional[Dict[str, object]] = None,
    schema: Optional[Dict[str, Tuple[str, ...]]] = None,
    wrt: Tuple[str, ...] = (),
    fuse_join_agg: bool = True,
) -> CheckReport:
    """Statically check an FRA query (``fra.Query`` or bare ``fra.Node``).

    ``env`` maps relation names to relations (their tensors may lie on
    the ``meta`` device: only shapes and dtypes are read); ``stats`` is a
    catalog ``RelationStats`` snapshot for key-domain soundness;
    ``schema`` maps relation names to key-attribute-name tuples (SQL
    catalogs) for readable provenance labels; ``wrt``
    names gradient inputs for partial-RJP derivability warnings (the
    query's own ``inputs`` are used when it is a ``fra.Query``).
    ``fuse_join_agg`` mirrors the engine flag (a Σ directly over a ⋈ is
    checked as the fused form)."""
    root = query.root if isinstance(query, fra.Query) else query
    if isinstance(query, fra.Query) and not wrt:
        wrt = query.inputs
    wrt_set = set(wrt)
    diags: List[Diagnostic] = []
    memo: Dict[int, RelType] = {}

    def emit(severity, code, path, message, hint=""):
        diags.append(Diagnostic(severity, code, path, message, hint))

    def err(code, path, message, hint=""):
        emit("error", code, path, message, hint)

    def warn(code, path, message, hint=""):
        emit("warning", code, path, message, hint)

    def _dtype_of(rel):
        arr = rel.values if isinstance(rel, CooRelation) else getattr(rel, "data", None)
        return None if arr is None else numpy_dtype(arr.dtype)

    def _promotion(lt: RelType, rt: RelType, path: str, what: str):
        if lt.dtype is None or rt.dtype is None or lt.dtype == rt.dtype:
            return lt.dtype or rt.dtype
        out = np.promote_types(lt.dtype, rt.dtype)
        f32_to_f64 = out == np.float64 and np.float32 in (lt.dtype, rt.dtype)
        warn(
            "dtype-promotion",
            path,
            f"{what} mixes {lt.dtype} and {rt.dtype}; the result silently "
            f"promotes to {out}" + (" (f32→f64 upcast)" if f32_to_f64 else ""),
            "cast the wider operand down (e.g. .to(torch.float32)) or "
            "accept the promotion explicitly",
        )
        return out

    def _scan(name: str, node: fra.Node, path: str) -> RelType:
        if name.startswith("__"):  # cached forward intermediates (grad graphs)
            return _unknown(node.key_arity)
        labels = tuple(_label(name, i, schema) for i in range(node.key_arity))
        if env is None or name not in env:
            if env is not None:
                err(
                    "unknown-relation",
                    path,
                    f"relation {name!r} is not defined in the environment",
                    "db.put(...) the relation (or declare it) before "
                    "checking/lowering the query",
                )
            t = _unknown(node.key_arity)
            return RelType(t.kind, t.key_arity, t.extents, labels, None)
        rel = env[name]
        arity = getattr(rel, "key_arity", node.key_arity)
        if arity != node.key_arity:
            err(
                "arity-mismatch",
                path,
                f"scan declares key arity {node.key_arity} but relation "
                f"{name!r} has key arity {arity}",
                "match the scan's arity to the stored relation",
            )
            return RelType("unknown", node.key_arity, (None,) * node.key_arity, labels, None)
        rel_ext = getattr(rel, "extents", None)
        if rel_ext is None:
            return RelType("unknown", arity, (None,) * arity, labels, _dtype_of(rel))
        extents = tuple(int(e) for e in rel_ext[:arity])
        if stats and name in stats:
            st_ext = tuple(int(e) for e in stats[name].extents[:arity])
            if st_ext != extents:
                warn(
                    "stale-stats",
                    path,
                    f"catalog statistics for {name!r} record extents "
                    f"{st_ext} but the relation has {extents}",
                    "refresh with db.put (stats are re-measured on put) "
                    "before planning against them",
                )
        kind = "coo" if isinstance(rel, CooRelation) else "dense"
        return RelType(kind, arity, extents, labels, _dtype_of(rel))

    def _select(n: fra.Select, path: str) -> RelType:
        ct = visit(n.child, path)
        a = ct.key_arity

        def comp_ok(c, what) -> bool:
            if isinstance(c, Lit):
                return True
            if not (0 <= c.idx < a):
                err(
                    "bad-key-index",
                    path,
                    f"{what} references key component {c.idx} but the "
                    f"input has arity {a}",
                    "key components are 0-indexed over the child's key",
                )
                return False
            return True

        for i, v in n.pred.eqs:
            if not (0 <= i < a):
                err(
                    "bad-key-index",
                    path,
                    f"σ predicate fixes key component {i} but the input "
                    f"has arity {a}",
                    "key components are 0-indexed over the child's key",
                )
            elif ct.extents[i] is not None and not (0 <= v < ct.extents[i]):
                warn(
                    "empty-selection",
                    path,
                    f"σ fixes {ct.labels[i]} == {v} but its domain is "
                    f"[0, {ct.extents[i]}); the selection is statically empty",
                    "check the literal against the relation's key domain",
                )
        if ct.kind == "coo":
            if not n.pred.always_true:
                err(
                    "coo-predicate",
                    path,
                    "predicated σ over a COO relation is not compilable "
                    "(compiler: 'predicated σ over COO not supported')",
                    "materialize the relation densely or filter at load time",
                )
            for c in n.proj.comps:
                if isinstance(c, Lit):
                    err(
                        "literal-projection",
                        path,
                        "Lit component in a σ projection over COO is not "
                        "compilable",
                        "project only existing key columns over COO",
                    )
                else:
                    comp_ok(c, "σ projection")
        elif ct.kind == "dense":
            if n.pred.custom is not None:
                err(
                    "custom-predicate",
                    path,
                    "custom σ predicates are interpreter-only "
                    "(compiler: 'custom σ predicate not compilable')",
                    "express the predicate as key equalities "
                    "(SelPred(eqs=...)) or run via the interpreter",
                )
            fixed = {i for i, _ in n.pred.eqs}
            proj_idx = []
            for c in n.proj.comps:
                if isinstance(c, Lit):
                    err(
                        "literal-projection",
                        path,
                        "Lit component in a σ projection over dense is not "
                        "compilable",
                        "introduce literal key components via a join "
                        "projection under a Σ instead",
                    )
                    continue
                if not comp_ok(c, "σ projection"):
                    continue
                if c.idx in fixed:
                    err(
                        "projects-fixed",
                        path,
                        f"σ projects key component {c.idx} which the "
                        "predicate fixes to a literal (the compiler slices "
                        "fixed components away)",
                        "drop the fixed component from the projection",
                    )
                    continue
                proj_idx.append(c.idx)
            remaining = [i for i in range(a) if i not in fixed]
            if sorted(proj_idx) != remaining:
                err(
                    "non-permutation",
                    path,
                    f"σ projection keeps components {sorted(proj_idx)} but "
                    f"must permute exactly the surviving components "
                    f"{remaining} (dense σ cannot drop or duplicate keys)",
                    "aggregate (Σ) to drop key components; permutations "
                    "only in σ",
                )
        out_ext, out_lab = [], []
        for c in n.proj.comps:
            if isinstance(c, Lit) or not (0 <= c.idx < a):
                out_ext.append(None)
                out_lab.append("lit" if isinstance(c, Lit) else "?")
            else:
                out_ext.append(ct.extents[c.idx])
                out_lab.append(ct.labels[c.idx])
        return RelType(ct.kind, n.key_arity, tuple(out_ext), tuple(out_lab), ct.dtype)

    def _agg(n: fra.Agg, path: str) -> RelType:
        fused = isinstance(n.child, fra.Join) and fuse_join_agg
        if fused:
            ct = _join(n.child, path + "/⋈", grp=n.grp)
        else:
            ct = visit(n.child, path)
        if not n.kernel.is_add:
            err(
                "non-additive-agg",
                path,
                f"Σ kernel ⊕{n.kernel.name} is not additive; the compiler "
                "supports only additive aggregation "
                "(compiler: 'non-additive Σ not supported')",
                "use the interpreter for max-style aggregates, or rewrite "
                "as additive Σ",
            )
        a = ct.key_arity
        comps = n.grp.comps
        lits = [c for c in comps if isinstance(c, Lit)]
        if lits:
            err(
                "literal-group",
                path,
                "Lit components in a Σ grouping are not compilable "
                "(compiler: 'mixed Lit grp' / 'Lit grp over COO')",
                "group by existing key components; a full reduce is "
                "grp=KeyFn(())",
            )
        idxs = [c.idx for c in comps if isinstance(c, In)]
        for i in idxs:
            if not (0 <= i < a):
                err(
                    "bad-key-index",
                    path,
                    f"Σ grouping references key component {i} but the "
                    f"input has arity {a}",
                    "key components are 0-indexed over the child's key",
                )
        if ct.kind != "coo" and len(set(idxs)) != len(idxs):
            err(
                "duplicate-group",
                path,
                "duplicate Σ grouping components over a dense input "
                "(compiler: 'duplicate grp components over dense')",
                "group by each key component at most once; duplicates "
                "are only meaningful over COO inputs",
            )
        out_ext = tuple(
            ct.extents[c.idx] if isinstance(c, In) and 0 <= c.idx < a else None
            for c in comps
        )
        out_lab = tuple(
            ct.labels[c.idx] if isinstance(c, In) and 0 <= c.idx < a else "lit"
            for c in comps
        )
        return RelType("dense", n.key_arity, out_ext, out_lab, ct.dtype)

    def _join(n: fra.Join, path: str, grp=None) -> RelType:
        lt = visit(n.left, path + "/L:")
        rt = visit(n.right, path + "/R:")
        la, ra = n.left.key_arity, n.right.key_arity
        coo_side = "coo" in (lt.kind, rt.kind)
        if lt.kind == "coo" and rt.kind == "coo":
            err(
                "coo-coo-join",
                path,
                "COO ⋈ COO is not compilable "
                "(compiler: 'COO ⋈ COO not supported')",
                "densify one operand, or restructure so each join has at "
                "most one sparse side",
            )

        def side_t(c):
            return lt if isinstance(c, L) else rt

        def comp_ok(c, what) -> bool:
            if isinstance(c, Lit):
                return True
            arity = la if isinstance(c, L) else ra
            if not (0 <= c.idx < arity):
                err(
                    "bad-key-index",
                    path,
                    f"{what} references {'left' if isinstance(c, L) else 'right'} "
                    f"key component {c.idx} but that side has arity {arity}",
                    "key components are 0-indexed per join side",
                )
                return False
            return True

        has_lit_pred = False
        same_side_pairs = False
        for a, b in n.pred.eqs:
            comp_ok(a, "⋈ predicate")
            comp_ok(b, "⋈ predicate")
            if isinstance(a, Lit) or isinstance(b, Lit):
                has_lit_pred = True
                lit, other = (a, b) if isinstance(a, Lit) else (b, a)
                if not isinstance(other, Lit):
                    t = side_t(other)
                    if (
                        0 <= other.idx < t.key_arity
                        and t.extents[other.idx] is not None
                        and not (0 <= lit.val < t.extents[other.idx])
                    ):
                        warn(
                            "empty-selection",
                            path,
                            f"⋈ predicate fixes {t.labels[other.idx]} == "
                            f"{lit.val} outside its domain "
                            f"[0, {t.extents[other.idx]}); the join is "
                            "statically empty",
                            "check the literal against the key domain",
                        )
            elif type(a) is type(b):
                same_side_pairs = True
        if has_lit_pred:
            if coo_side:
                err(
                    "literal-join-pred",
                    path,
                    "literal ⋈ predicates over a COO operand are not "
                    "compilable (compiler: 'literal predicates on COO "
                    "joins not supported')",
                    "σ-select the dense side before joining instead",
                )
            else:
                emit(
                    "info",
                    "literal-join-pred",
                    path,
                    "literal ⋈ predicate over dense operands falls off the "
                    "einsum fast path (aligned/broadcast fallback)",
                    "σ-select before joining to stay on the einsum path",
                )
        if same_side_pairs and coo_side:
            err(
                "same-side-equality",
                path,
                "an L-L / R-R equality (diagonal) is not compilable over a "
                "COO operand",
                "pre-apply the diagonal with a σ on the dense side",
            )

        # join-key compatibility: members of one equivalence class must
        # agree on their key domains (einsum binds them to one letter)
        uf = join_equiv_classes(n.pred, la, ra)
        for members in uf.classes().values():
            known = []
            for c in members:
                if isinstance(c, Lit):
                    continue
                t = side_t(c)
                if 0 <= c.idx < t.key_arity and t.extents[c.idx] is not None:
                    known.append((t.labels[c.idx], t.extents[c.idx]))
            exts = {e for _, e in known}
            if len(exts) > 1:
                parts = ", ".join(f"{lab} (extent {e})" for lab, e in known)
                err(
                    "join-extent-mismatch",
                    path,
                    f"⋈ equates key components with different domains: {parts}",
                    "joined key components must range over the same domain; "
                    "check the join predicate's column pairing",
                )

        # COO gather contract: every dense key component must be matched
        if coo_side and not (lt.kind == "coo" and rt.kind == "coo"):
            dense_t, dense_cls = (rt, R) if lt.kind == "coo" else (lt, L)
            matched = set()
            for a, b in n.pred.eqs:
                for c in (a, b):
                    if isinstance(c, dense_cls):
                        matched.add(c.idx)
            if not has_lit_pred and len(matched) < dense_t.key_arity:
                err(
                    "coo-unmatched-dense-key",
                    path,
                    f"COO ⋈ dense requires every dense key component "
                    f"matched by the predicate (matched {sorted(matched)} "
                    f"of arity {dense_t.key_arity}) "
                    "(compiler: gather needs a full index)",
                    "add predicate equalities covering all dense key "
                    "components",
                )

        for c in n.proj.comps:
            comp_ok(c, "⋈ projection")
            if isinstance(c, Lit) and coo_side is False and grp is not None:
                emit(
                    "info",
                    "literal-projection",
                    path,
                    "Lit component in a Σ-fused ⋈ projection falls off the "
                    "einsum fast path",
                    "",
                )

        # a bare dense⋈dense must keep every key class in its output
        # (classes pinned to a literal by the predicate are selection-like
        # and may legitimately be dropped on the fallback paths)
        if grp is None and not coo_side and lt.kind == "dense" and rt.kind == "dense":
            out_roots = {
                uf.find(c) for c in n.proj.comps if not isinstance(c, Lit)
            }
            lit_roots = {
                uf.find(c)
                for pair in n.pred.eqs
                for c in pair
                if isinstance(c, Lit)
            }
            in_roots = {uf.find(L(i)) for i in range(la)} | {
                uf.find(R(j)) for j in range(ra)
            }
            if not (in_roots - lit_roots) <= out_roots:
                err(
                    "join-drops-class",
                    path,
                    "bare ⋈ drops a key class (would implicitly aggregate "
                    "duplicate keys) "
                    "(compiler: 'bare join drops a key class; wrap in Σ')",
                    "wrap the join in a Σ that sums over the dropped "
                    "components",
                )

        # partial-RJP grad derivability: a wrt input below this join whose
        # side key is not solvable from the output key gets the general
        # (slower) partial-RJP gradient fallback
        if wrt_set:
            sides = [("left", n.left, n.pred, n.proj, la, ra)]
            mpred, mproj = _mirror_join(n.pred, n.proj)
            sides.append(("right", n.right, mpred, mproj, ra, la))
            for side, child, pred, proj, sa, oa in sides:
                below = sorted(
                    {s.name for s in child.table_scans()} & wrt_set
                )
                if below and solve_left_key(pred, proj, sa, oa) is None:
                    warn(
                        "partial-rjp",
                        path,
                        f"the {side} input key of this ⋈ is not solvable "
                        f"from its output key; gradients for {below} fall "
                        "back to the general partial-RJP path",
                        "keep the joined key components in the join/Σ "
                        "output, or accept the slower general RJP",
                    )

        dtype = _promotion(lt, rt, path, f"⋈ kernel ⊗{n.kernel.name}")

        def comp_info(c):
            if isinstance(c, Lit):
                return None, "lit"
            t = side_t(c)
            if not (0 <= c.idx < t.key_arity):
                return None, "?"
            return t.extents[c.idx], t.labels[c.idx]

        ext, lab = zip(*[comp_info(c) for c in n.proj.comps]) if n.proj.comps else ((), ())
        kind = "coo" if coo_side else "dense"
        return RelType(kind, n.key_arity, tuple(ext), tuple(lab), dtype)

    def _add(n: fra.AddOp, path: str) -> RelType:
        lt = visit(n.left, path + "/L:")
        rt = visit(n.right, path + "/R:")
        if lt.kind == "coo" and rt.kind == "coo":
            err(
                "coo-coo-add",
                path,
                "COO + COO is not compilable "
                "(compiler: 'COO + COO add not supported')",
                "densify one operand before adding",
            )
        for i in range(min(lt.key_arity, rt.key_arity)):
            le, re = lt.extents[i], rt.extents[i]
            if le is None or re is None or le == re:
                continue
            if 1 in (le, re):
                warn(
                    "broadcast-add",
                    path,
                    f"add over mismatched extents {lt.labels[i]} ({le}) vs "
                    f"{rt.labels[i]} ({re}) silently broadcasts",
                    "make the key domains equal if broadcasting is not "
                    "intended",
                )
            else:
                err(
                    "add-extent-mismatch",
                    path,
                    f"add requires equal key domains: {lt.labels[i]} has "
                    f"extent {le} but {rt.labels[i]} has {re}",
                    "align the operands' key domains before adding",
                )
        dtype = _promotion(lt, rt, path, "add")
        base = lt if lt.kind != "unknown" else rt
        return RelType(base.kind, n.key_arity, base.extents, base.labels, dtype)

    def _restrict(n: fra.Restrict, path: str) -> RelType:
        ct = visit(n.child, path + "/L:")
        ft = visit(n.ref, path + "/R:")
        if ft.kind == "coo" and isinstance(n.child, fra.Join):
            jt_l = memo.get(n.child.left.id)
            jt_r = memo.get(n.child.right.id)
            if (
                jt_l is not None
                and jt_r is not None
                and jt_l.kind == "dense"
                and jt_r.kind == "dense"
            ):
                from ..core.compiler import _solve_side_from_output

                solved = _solve_side_from_output(
                    n.child.pred,
                    n.child.proj,
                    n.child.left.key_arity,
                    n.child.right.key_arity,
                )
                if solved is None:
                    err(
                        "restricted-join-underdetermined",
                        path,
                        "restrict-to-COO over this ⋈ cannot reconstruct "
                        "both input keys from the output key "
                        "(compiler: 'restricted join underdetermined')",
                        "aggregate (Σ) the join before restricting",
                    )
        return RelType(
            ft.kind if ft.kind != "unknown" else ct.kind,
            n.key_arity,
            ct.extents,
            ct.labels,
            ct.dtype,
        )

    def visit(n: fra.Node, prefix: str) -> RelType:
        if isinstance(n, fra.TableScan):
            label = f"τ({n.name})"
        elif isinstance(n, fra.Const):
            label = f"const({n.ref})"
        elif isinstance(n, fra.Select):
            label = "σ"
        elif isinstance(n, fra.Agg):
            label = "Σ"
        elif isinstance(n, fra.Join):
            label = "⋈"
        elif isinstance(n, fra.AddOp):
            label = "+"
        else:
            label = "restrict"
        sep = "" if not prefix or prefix.endswith(":") else "/"
        path = prefix + sep + label
        if n.id in memo:  # shared subgraph: first path's diagnostics win
            return memo[n.id]
        if isinstance(n, fra.TableScan):
            t = _scan(n.name, n, path)
        elif isinstance(n, fra.Const):
            t = _scan(n.ref, n, path)
        elif isinstance(n, fra.Select):
            t = _select(n, path)
        elif isinstance(n, fra.Agg):
            t = _agg(n, path)
        elif isinstance(n, fra.Join):
            t = _join(n, path)
        elif isinstance(n, fra.AddOp):
            t = _add(n, path)
        else:
            t = _restrict(n, path)
        memo[n.id] = t
        return t

    visit(root, "")

    # drop duplicate diagnostics (shared subgraphs), preserving order
    seen = set()
    uniq = []
    for d in diags:
        if d not in seen:
            seen.add(d)
            uniq.append(d)
    return CheckReport(tuple(uniq))
