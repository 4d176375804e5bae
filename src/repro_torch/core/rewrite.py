"""Cost-gated algebraic rewrite stage: factorized evaluation of Σ∘⋈.

This stage decides *what* is computed. It runs inside ``RAEngine.lower``,
after the validate stage and ahead of the lowering walk, and applies a
small rule registry bottom-up over the FRA graph:

* ``sigma_pushdown`` — Σ-through-⋈: when the Σ above a join drops key
  columns that one side contributes and the join predicate never reads,
  a partial Σ over those columns is pushed below the join (the
  factorized-learning rewrite: partial aggregates instead of the
  materialized join output). Σ_g(l ⊗ r) with ⊗ multiplicative (linear
  per argument) distributes over the dropped columns:
  ``Σ_{g}(L ⋈ R) = Σ_{g'}((Σ_{kept} L) ⋈ R)``.
* ``sigma_split`` — the same pushdown applied to *both* join sides at
  once, when each contributes droppable columns (independent branches).
* ``dedup`` — common-subplan elimination: structurally identical
  subtrees (same operator, key functions, kernels, and — recursively —
  children) are merged to one node, so the executor's per-node memo
  computes them once.

Every structural rule is **cost-gated** on the same bottom-up byte
estimates of ``planner.estimate_graph``,
sharpened by ``RelationStats`` catalog snapshots when available: a
pushdown fires only when the estimated post-Agg size beats the
unrewritten join output by ``RuleSet.min_shrink``. Per-column histograms
(``RelationStats.hist``) refine the join output-size estimate via bucket
overlap of the joined columns; without stats the gate falls back to the
estimator's 1/8-per-dropped-key heuristic, and a declined gate returns the
*original* graph object — bit-identical plans, cache keys and all.

The rewritten graph must differentiate correctly: ``rewrite_program``
rewrites a GradientProgram's forward query and re-derives the gradient
graphs with ``ra_autodiff`` (same wrt tuple, same RJPOptions), so the
partial-aggregate VJPs ride the existing segment-sum / gather dispatch
ops and the ``__fwd_*`` cache refs stay consistent with the rewritten
forward. The engine keys its lowering cache on (rule set, stats
snapshot) — see ``RAEngine.lower``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import fra
from .keys import In, JoinPred, JoinProj, KeyFn, L, R
from .planner import GraphEstimate, RelationStats, agg_shrink, estimate_graph

#: rule names, in application order
ALL_RULES = ("dedup", "sigma_pushdown", "sigma_split")


@dataclass(frozen=True)
class RuleSet:
    """The enabled rewrite rules plus the cost gate's firing threshold.

    Frozen and hashable — a RuleSet is part of the ``Lowered`` cache key,
    so two lowerings under different rule sets (or thresholds) can never
    alias one cached plan.

    ``min_shrink``: a pushdown fires only when the estimated post-Agg
    bytes are at least this factor below the unrewritten join-side
    bytes; 2.0 means "don't restructure the program for less than a 2×
    smaller intermediate".
    """

    rules: Tuple[str, ...] = ALL_RULES
    min_shrink: float = 2.0

    def __post_init__(self):
        unknown = set(self.rules) - set(ALL_RULES)
        if unknown:
            raise ValueError(
                f"unknown rewrite rules {sorted(unknown)}; known: {ALL_RULES}"
            )

    def __contains__(self, rule: str) -> bool:
        return rule in self.rules


DEFAULT_RULES = RuleSet()


def make_rules(spec) -> Optional[RuleSet]:
    """Normalize a rewrite spec: None/False → off, True → the default
    rule set, a RuleSet → itself, an iterable of rule names → a RuleSet
    over exactly those rules."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return DEFAULT_RULES
    if isinstance(spec, RuleSet):
        return spec
    return RuleSet(tuple(spec))


@dataclass
class Decision:
    """One cost-gate verdict, for ``Database.explain``."""

    rule: str
    site: str            # describe() of the node the rule looked at
    fired: bool
    est_before: float    # bytes the unrewritten plan materializes here
    est_after: float     # bytes after the rewrite (== est_before if declined)
    detail: str = ""

    def render(self) -> str:
        verdict = "FIRED" if self.fired else "declined"
        line = (
            f"{self.rule} @ {self.site}: {verdict} "
            f"(est {_fmt_bytes(self.est_before)} -> "
            f"{_fmt_bytes(self.est_after)}"
        )
        if self.detail:
            line += f"; {self.detail}"
        return line + ")"


@dataclass
class RewriteReport:
    """What the rewrite stage did to one query: every gate decision (in
    bottom-up application order) plus the changed flag ``RAEngine.lower``
    caches alongside the rewritten program."""

    decisions: List[Decision] = field(default_factory=list)
    changed: bool = False

    @property
    def fired(self) -> List[Decision]:
        return [d for d in self.decisions if d.fired]

    def render(self) -> str:
        if not self.decisions:
            return "no rewrite candidates"
        return "\n".join(d.render() for d in self.decisions)


def _fmt_bytes(b: float) -> str:
    """Deterministic short byte count for explain output."""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024.0 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{b:.0f}B"
        b /= 1024.0
    return f"{b:.1f}GiB"  # pragma: no cover — loop always returns


# ---------------------------------------------------------------------------
# Common-subplan deduplication (structural hashing)
# ---------------------------------------------------------------------------


def _structural_key(node: fra.Node, child_ids: Tuple[int, ...]) -> Tuple:
    """Hashable identity of one node *given* canonical children: operator
    type + its key functions / kernel + the children's canonical ids.
    Key functions are frozen dataclasses, so equality is structural;
    kernels compare by registry name."""
    if isinstance(node, fra.TableScan):
        return ("scan", node.name, node.key_arity)
    if isinstance(node, fra.Const):
        return ("const", node.ref, node.key_arity)
    if isinstance(node, fra.Select):
        return ("select", node.pred, node.proj, node.kernel.name, child_ids)
    if isinstance(node, fra.Agg):
        return ("agg", node.grp, node.kernel.name, child_ids)
    if isinstance(node, fra.Join):
        return ("join", node.pred, node.proj, node.kernel.name, child_ids)
    if isinstance(node, fra.AddOp):
        return ("add", child_ids)
    if isinstance(node, fra.Restrict):
        return ("restrict", child_ids)
    raise TypeError(f"cannot hash node {node}")


def _rebuild(node: fra.Node, children: Tuple[fra.Node, ...]) -> fra.Node:
    if children == node.children:
        return node
    if isinstance(node, fra.Select):
        return fra.Select(node.pred, node.proj, node.kernel, children[0])
    if isinstance(node, fra.Agg):
        return fra.Agg(node.grp, node.kernel, children[0])
    if isinstance(node, fra.Join):
        return fra.Join(node.pred, node.proj, node.kernel, *children)
    if isinstance(node, fra.AddOp):
        return fra.AddOp(*children)
    if isinstance(node, fra.Restrict):
        return fra.Restrict(*children)
    raise TypeError(f"cannot rebuild node {node}")  # pragma: no cover


def dedup(root: fra.Node) -> Tuple[fra.Node, int]:
    """Merge structurally identical subtrees bottom-up. Returns the
    (possibly rebuilt) root and the number of nodes eliminated. Safe for
    gradients: the executors memoize per node id and ``ra_autodiff``
    accumulates fan-out contributions, so a merged node simply becomes a
    shared DAG child."""
    canon: Dict[Tuple, fra.Node] = {}
    memo: Dict[int, fra.Node] = {}
    merged = 0
    for node in root.topo():
        children = tuple(memo[c.id] for c in node.children)
        key = _structural_key(node, tuple(c.id for c in children))
        hit = canon.get(key)
        if hit is not None:
            if hit is not node:
                merged += 1
            memo[node.id] = hit
        else:
            rebuilt = _rebuild(node, children)
            canon[key] = rebuilt
            memo[node.id] = rebuilt
    return memo[root.id], merged


# ---------------------------------------------------------------------------
# Σ-through-⋈ pushdown, cost-gated
# ---------------------------------------------------------------------------


class _Estimator:
    """A ``planner.estimate_graph`` result that can be extended with the
    nodes the rewriter creates, using the same size rules — so a cascaded
    pushdown (a multi-join chain) gates every step on consistent numbers."""

    def __init__(self, base: GraphEstimate):
        self.sizes = dict(base.sizes)
        self.is_coo = dict(base.is_coo)
        self.dist = dict(base.dist)
        self.hists = dict(base.hists)

    def note(self, node: fra.Node) -> None:
        """Record estimates for one freshly created node (children known)."""
        if node.id in self.sizes:
            return
        if isinstance(node, fra.Agg):
            cd = self.dist.get(node.child.id)
            factor, _ = agg_shrink(node.child.key_arity, node.grp, cd)
            self.sizes[node.id] = self.sizes[node.child.id] / factor
            self.dist[node.id] = (
                tuple(
                    cd[c.idx] if isinstance(c, In) else None
                    for c in node.grp.comps
                )
                if cd is not None
                else None
            )
            self.is_coo[node.id] = False
            self.hists[node.id] = None
        elif isinstance(node, fra.Join):
            self.sizes[node.id] = max(
                self.sizes[node.left.id], self.sizes[node.right.id]
            )
            self.is_coo[node.id] = (
                self.is_coo[node.left.id] or self.is_coo[node.right.id]
            )
            ld = self.dist.get(node.left.id)
            rd = self.dist.get(node.right.id)
            self.dist[node.id] = tuple(
                ld[c.idx] if isinstance(c, L) and ld is not None
                else rd[c.idx] if isinstance(c, R) and rd is not None
                else None
                for c in node.proj.comps
            )
            lh = self.hists.get(node.left.id)
            rh = self.hists.get(node.right.id)
            self.hists[node.id] = (
                tuple(
                    lh[c.idx] if isinstance(c, L) and lh is not None
                    else rh[c.idx] if isinstance(c, R) and rh is not None
                    else None
                    for c in node.proj.comps
                )
                if lh is not None or rh is not None
                else None
            )
        else:  # pragma: no cover — the rewriter only creates Agg/Join
            raise TypeError(f"cannot note node {node}")


def _match_fraction(join: fra.Join, est: "_Estimator") -> float:
    """Histogram-sharpened join selectivity: the estimated fraction of a
    side's tuples whose join-column value finds matching mass on the
    other side, from the joined columns' equi-width histograms (columns
    joined by equality are assumed to share a key domain, so buckets
    align). 1.0 — the dense-grid assumption — wherever histograms are
    unavailable, keeping the stats-less gate bit-identical to the
    heuristic path."""
    lh, rh = est.hists.get(join.left.id), est.hists.get(join.right.id)
    if lh is None or rh is None:
        return 1.0
    frac = 1.0
    for a, b in join.pred.eqs:
        if isinstance(a, R) and isinstance(b, L):
            a, b = b, a
        if not (isinstance(a, L) and isinstance(b, R)):
            continue
        hl = lh[a.idx] if a.idx < len(lh) else None
        hr = rh[b.idx] if b.idx < len(rh) else None
        if hl is None or hr is None:
            continue
        tot = float(sum(hl))
        if tot <= 0.0 or not any(hr):
            continue
        matched = float(sum(l for l, r in zip(hl, hr) if r > 0))
        frac *= matched / tot
    return frac


def _side_needed(
    join: fra.Join, proj_eff: JoinProj, side_cls: type
) -> Optional[set]:
    """Key positions of one join side (``side_cls`` is L or R) that the
    predicate or the effective projection reads; None when a literal
    component blocks the analysis (the compiler rejects Lit keys in
    einsum lowerings anyway)."""
    needed: set = set()
    for a, b in join.pred.eqs:
        for c in (a, b):
            if isinstance(c, side_cls):
                needed.add(c.idx)
            elif not isinstance(c, (L, R)):
                return None  # Lit in the predicate: leave the join alone
    for c in proj_eff.comps:
        if isinstance(c, side_cls):
            needed.add(c.idx)
        elif not isinstance(c, (L, R)):
            return None  # Lit in the projection
    return needed


def _remap_side(comp, side_cls, new_idx):
    """Remap one join component's ``side_cls`` index after that side's
    key was compacted to its kept columns."""
    if isinstance(comp, side_cls):
        return side_cls(new_idx[comp.idx])
    return comp


class _Rewriter:
    """One bottom-up pass over a (deduplicated) graph: rebuilds nodes
    whose children changed and attempts the gated Σ-pushdown at every
    Agg-over-Join. Nodes it leaves alone are returned as-is (object
    identity preserved), so a fully declined pass yields the original
    root and the engine's decline path stays bit-identical."""

    def __init__(
        self,
        est: _Estimator,
        parents: Dict[int, int],
        rules: RuleSet,
        report: RewriteReport,
    ):
        self.est = est
        self.parents = parents
        self.rules = rules
        self.report = report
        self.memo: Dict[int, fra.Node] = {}

    def rewrite(self, root: fra.Node) -> fra.Node:
        for node in root.topo():
            children = tuple(self.memo[c.id] for c in node.children)
            out: Optional[fra.Node] = None
            if (
                isinstance(node, fra.Agg)
                and isinstance(children[0], fra.Join)
                and "sigma_pushdown" in self.rules
                # sharing check on the *original* child id: a join output
                # consumed elsewhere too must stay one subplan — splitting
                # it into a per-consumer partial-agg form would double
                # the work dedup just saved
                and self.parents.get(node.children[0].id, 1) <= 1
            ):
                out = self._try_pushdown(node.grp, node.kernel, children[0])
            if out is None:
                out = _rebuild(node, children)
                if out is not node:
                    if isinstance(out, (fra.Agg, fra.Join)):
                        self.est.note(out)
                    else:
                        self._copy_est(node, out)
            self.memo[node.id] = out
        return self.memo[root.id]

    def _copy_est(self, old: fra.Node, new: fra.Node) -> None:
        self.est.sizes[new.id] = self.est.sizes.get(old.id, 0.0)
        self.est.is_coo[new.id] = self.est.is_coo.get(old.id, False)
        self.est.dist[new.id] = self.est.dist.get(old.id)
        self.est.hists[new.id] = self.est.hists.get(old.id)

    # -- the Σ-through-⋈ rule ---------------------------------------------
    def _try_pushdown(
        self, grp: KeyFn, kernel, join: fra.Join
    ) -> Optional[fra.Node]:
        """Push a partial Σ below ``join`` if legal and worth it; returns
        the replacement subtree, or None to keep the plain Agg."""
        est = self.est
        if not kernel.is_add or not join.kernel.multiplicative:
            return None
        if not all(isinstance(c, In) for c in grp.comps):
            return None
        proj_eff = JoinProj(tuple(join.proj.comps[c.idx] for c in grp.comps))
        plans = []  # (side, dropped, kept, decision)
        for side_name, side_cls, side in (
            ("left", L, join.left),
            ("right", R, join.right),
        ):
            needed = _side_needed(join, proj_eff, side_cls)
            if needed is None:
                return None  # literal component: leave the join alone
            dropped = [
                i for i in range(side.key_arity) if i not in needed
            ]
            if not dropped or est.is_coo.get(side.id, False):
                continue
            side_bytes = est.sizes.get(side.id, 0.0)
            sd = est.dist.get(side.id)
            factor, from_stats = agg_shrink(
                side.key_arity,
                KeyFn(tuple(In(i) for i in sorted(needed))),
                sd,
            )
            post = side_bytes / factor
            sel = _match_fraction(join, est)
            fired = (
                side_bytes > 0.0
                and post * self.rules.min_shrink <= side_bytes * sel
            )
            detail = (
                f"drop {side_name}[{','.join(map(str, dropped))}], "
                f"shrink {factor:g}x"
                + (" (stats)" if from_stats else " (heuristic)")
                + (f", join match {sel:.2f}" if sel < 1.0 else "")
            )
            decision = Decision(
                rule="sigma_pushdown",
                site=join.describe(),
                fired=fired,
                est_before=side_bytes * sel,
                est_after=post if fired else side_bytes * sel,
                detail=detail,
            )
            self.report.decisions.append(decision)
            if fired:
                plans.append((side_name, side_cls, side, sorted(needed)))
        if not plans:
            return None
        if len(plans) == 2 and "sigma_split" not in self.rules:
            # split disabled: push only the side with the bigger win
            plans.sort(
                key=lambda p: est.sizes.get(p[2].id, 0.0), reverse=True
            )
            plans = plans[:1]
        if len(plans) == 2:
            self.report.decisions.append(
                Decision(
                    rule="sigma_split",
                    site=join.describe(),
                    fired=True,
                    est_before=est.sizes.get(join.id, 0.0),
                    est_after=est.sizes.get(join.id, 0.0),
                    detail="partial Σ pushed into both branches",
                )
            )

        new_left, new_right = join.left, join.right
        pred_eqs = join.pred.eqs
        proj_comps = proj_eff.comps
        for side_name, side_cls, side, kept in plans:
            new_idx = {old: new for new, old in enumerate(kept)}
            inner_grp = KeyFn(tuple(In(i) for i in kept))
            # cascade: the partial Σ may push further down a join chain
            inner = self._make_agg(inner_grp, kernel, side)
            if side_name == "left":
                new_left = inner
            else:
                new_right = inner
            pred_eqs = tuple(
                (
                    _remap_side(a, side_cls, new_idx),
                    _remap_side(b, side_cls, new_idx),
                )
                for a, b in pred_eqs
            )
            proj_comps = tuple(
                _remap_side(c, side_cls, new_idx) for c in proj_comps
            )
        new_join = fra.Join(
            JoinPred(pred_eqs),
            JoinProj(proj_comps),
            join.kernel,
            new_left,
            new_right,
        )
        est.note(new_join)
        # the join can still merge output keys (e.g. the contracted join
        # class is dropped from proj_eff): keep an outer Σ over the fused
        # projection — the compiler fuses it into the join's einsum
        outer = fra.Agg(
            KeyFn(tuple(In(i) for i in range(len(proj_comps)))),
            kernel,
            new_join,
        )
        est.note(outer)
        return outer

    def _make_agg(self, grp: KeyFn, kernel, child: fra.Node) -> fra.Node:
        """Build Σ(grp, child), recursively attempting pushdown when the
        child is itself a (non-shared) join — the cascade down multi-join
        chains. Nodes the rewriter created are never shared, so missing
        parent counts default to 1."""
        if (
            isinstance(child, fra.Join)
            and self.parents.get(child.id, 1) <= 1
        ):
            pushed = self._try_pushdown(grp, kernel, child)
            if pushed is not None:
                return pushed
        out = fra.Agg(grp, kernel, child)
        self.est.note(out)
        return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def rewrite_query(
    query: fra.Query,
    env: Dict[str, object],
    *,
    stats: Optional[Dict[str, RelationStats]] = None,
    rules: Optional[RuleSet] = DEFAULT_RULES,
) -> Tuple[fra.Query, RewriteReport]:
    """Apply the enabled rules to ``query`` bottom-up. Returns the
    rewritten query and the gate report; when nothing fires the
    *original* query object is returned (``report.changed`` False), so
    downstream plan/lowering caches see a bit-identical program."""
    report = RewriteReport()
    if rules is None:
        return query, report
    root = query.root
    if "dedup" in rules:
        root, merged = dedup(root)
        if merged:
            report.decisions.append(
                Decision(
                    rule="dedup",
                    site=query.root.describe(),
                    fired=True,
                    est_before=float(merged),
                    est_after=0.0,
                    detail=f"{merged} duplicate subplan(s) merged",
                )
            )
    est = _Estimator(estimate_graph(root, env, stats))
    parents: Dict[int, int] = {}
    for node in root.topo():
        for c in node.children:
            parents[c.id] = parents.get(c.id, 0) + 1
    rw = _Rewriter(est, parents, rules, report)
    new_root = rw.rewrite(root)
    if new_root is query.root:
        return query, report
    report.changed = True
    return fra.Query(new_root, query.inputs), report


def _partial_rjp_sites(program) -> int:
    """Count general-path partial-RJP joins (autodiff._partial_bin
    kernels, named ``partial{l,r}[...]``) across a program's gradient
    graphs — the fallback taken when an RJP has no multiplicative
    solution."""
    count = 0
    for g in program.grads.values():
        for n in g.topo():
            if isinstance(n, fra.Join) and n.kernel.name.startswith("partial"):
                count += 1
    return count


def rewrite_program(
    program,
    env: Dict[str, object],
    *,
    stats: Optional[Dict[str, RelationStats]] = None,
    rules: Optional[RuleSet] = DEFAULT_RULES,
):
    """Rewrite a ``GradientProgram``'s forward query and re-derive the
    gradient graphs from the rewritten forward (same ``wrt``, same
    ``RJPOptions``) — gradients are taken *of the rewritten program*, so
    its ``__fwd_*`` cache refs and partial-aggregate VJPs line up with
    what the forward pass actually computes. A plain ``fra.Query`` is
    rewritten directly. Unchanged programs come back as the original
    object (bit-identical decline path).

    The rewrite must leave gradients no harder to derive than they
    were: a pushed-down Σ∘⋈ pair whose RJP loses its multiplicative
    solution would force the general partial-RJP fallback — a strictly
    larger gradient plan the chunked compiler cannot always lower. When
    re-derivation introduces partial-RJP sites the original derivation
    did not have, the whole rewrite is reverted (original program
    object, bit-identical plans) and the reversion is recorded in the
    report."""
    from .autodiff import GradientProgram, ra_autodiff

    if isinstance(program, fra.Query):
        return rewrite_query(program, env, stats=stats, rules=rules)
    if not isinstance(program, GradientProgram):
        raise TypeError(f"cannot rewrite program of type {type(program)}")
    fwd, report = rewrite_query(
        program.forward, env, stats=stats, rules=rules
    )
    if not report.changed:
        return program, report
    rewritten = ra_autodiff(fwd, wrt=program.wrt, opts=program.opts)
    if _partial_rjp_sites(rewritten) > _partial_rjp_sites(program):
        report.changed = False
        report.decisions.append(
            Decision(
                rule="grad_check",
                site=program.forward.root.describe(),
                fired=False,
                est_before=0.0,
                est_after=0.0,
                detail=(
                    "rewrite reverted: the factorized forward forces the "
                    "general partial-RJP fallback on a gradient"
                ),
            )
        )
        return program, report
    return rewritten, report
