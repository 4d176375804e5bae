"""Relational reverse-mode auto-differentiation (paper §3–5).

Algorithms 1 (ChainRule) and 2 (RAAutoDiff), implemented as a *symbolic*
transformation: given a forward ``Query``, we construct for every
differentiable input relation a new FRA query graph that evaluates
∂Q/∂R_input. The gradient graphs reference

  * ``__seed``            — the output cotangent relation (for a one-tuple
                            loss, ``{(): 1.0}``; Algorithm 2 line 7), and
  * ``__fwd_<node_id>``   — forward intermediate relations cached during the
                            forward execution (Algorithm 2 line 6),

as Const leaves resolved from the environment at execution time. Because the
gradient is itself an FRA query, it can be executed by the sparse
interpreter, compiled by the chunked compiler, optimized, sharded, and even
differentiated again.

The §4 RJP optimizations are applied during construction:

  1. ⋈_const elimination for multiplicative ⊗ (mul/MatMul): the RJP joins
     the upstream gradient *directly* against the saved forward operand with
     the VJP kernel (paper Fig. 4) instead of materializing ∂⊗/∂val.
  2. Σ elimination by join cardinality: the trailing Σ of an RJP join is
     emitted only when the (output, other-operand) pair under-determines the
     differentiated operand's key (see ``_needs_agg``).
  3. Join-agg fusion: Σ(grp, +, ⋈(...)) is differentiated as a single fused
     operator by composing grp into the join projection — the Σ is never
     differentiated separately.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class RJPOptions:
    """§4 optimization toggles (benchmarks/rjp_ablation.py measures each)."""

    fuse_join_agg: bool = True       # differentiate Σ∘⋈ as one operator
    eliminate_sigma: bool = True     # drop the RJP's trailing Σ when 1-1
    multiplicative: bool = True      # ⋈_const-eliminated VJP-kernel path


DEFAULT_OPTS = RJPOptions()
NO_OPTS = RJPOptions(False, False, False)

from . import fra, interpreter
from .kernels import (
    ADD,
    BinKernel,
    MUL,
    UnaryKernel,
    register_bin,
)
from .keys import (
    In,
    JoinPred,
    JoinProj,
    KeyFn,
    L,
    Lit,
    R,
    SelPred,
    identity_key,
    join_equiv_classes,
    solve_left_key,
)

SEED = "__seed"


def fwd_ref(node: fra.Node) -> fra.Const:
    """Const leaf referring to ``node``'s cached forward value."""
    return fra.const(f"__fwd_{node.id}", node.key_arity)


# ---------------------------------------------------------------------------
# Derived kernels (memoized so graph nodes share registry entries)
# ---------------------------------------------------------------------------

_DERIVED: Dict[str, BinKernel] = {}


def _vjp_unary(k: UnaryKernel) -> BinKernel:
    """⊗'(g, x) = vjp of unary kernel ⊙ — the RJP-for-σ kernel."""
    name = f"vjp1[{k.name}]"
    if name not in _DERIVED:
        _DERIVED[name] = register_bin(
            name,
            lambda g, x, _k=k: _k.vjp(g, x),
            vjp_l=None,
            vjp_r=None,
        )
    return _DERIVED[name]


def _take_left() -> BinKernel:
    """⊗(g, x) = g — broadcast join used by RJP-for-Σ with ⊕ = add."""
    name = "take_l"
    if name not in _DERIVED:
        _DERIVED[name] = register_bin(
            name,
            lambda g, x: g,
            vjp_l=lambda gg, g, x: gg,
            vjp_r=lambda gg, g, x: (g - g) if hasattr(g, "shape") else 0.0,
        )
    return _DERIVED[name]


def _vjp_bin(k: BinKernel, side: str) -> BinKernel:
    """Optimized RJP kernel for multiplicative ⊗: joins (g, other) directly.

    side='l': fn(g, r) = vjp_l(g, ·, r);  side='r': fn(g, l) = vjp_r(g, l, ·).
    Only valid for multiplicative kernels, whose vjp w.r.t. one operand does
    not reference that operand (paper §4, first optimization).
    """
    assert k.multiplicative, k
    name = f"vjp2{side}[{k.name}]"
    if name not in _DERIVED:
        # Derived einsum lowering hints: the VJP contracts the cotangent
        # (chunk letters = output letters of ⊗) against the other operand.
        spec = None
        if k.chunk_spec is not None:
            lc, rc, oc = k.chunk_spec
            spec = (oc, rc, lc) if side == "l" else (oc, lc, rc)
        if side == "l":
            fn = lambda g, r, _k=k: _k.vjp_l(g, None, r)
        else:
            fn = lambda g, l, _k=k: _k.vjp_r(g, l, None)
        _DERIVED[name] = register_bin(
            name, fn, elementwise=k.elementwise, chunk_spec=spec
        )
    return _DERIVED[name]


def _partial_bin(k: BinKernel, side: str) -> BinKernel:
    """General-path partial-derivative kernel ∂⊗/∂side as a value (paper's
    ⊗₂). Valid for elementwise scalar/chunk kernels where
    vjp_side(g,l,r) = g * ∂⊗/∂side(l,r).

    The RJP's inner join always places the *differentiated* operand on its
    left, so for side='r' the incoming (wrt, other) pair must be swapped
    back into the original kernel's (l, r) order."""
    name = f"partial{side}[{k.name}]"
    if name not in _DERIVED:
        if side == "l":
            fn = lambda wrt, other, _k=k: _k.vjp_l(1.0, wrt, other)
        else:
            fn = lambda wrt, other, _k=k: _k.vjp_r(1.0, other, wrt)
        # No einsum hints: ``elementwise`` promises product semantics to the
        # compiler's einsum path, which a general ∂⊗/∂side does not have —
        # the inner join lowers through the aligned/broadcast dense paths.
        _DERIVED[name] = register_bin(name, fn)
    return _DERIVED[name]


# ---------------------------------------------------------------------------
# RJP constructors (paper §4), one per operator
# ---------------------------------------------------------------------------


def _rjp_select(g: fra.Node, node: fra.Select) -> fra.Node:
    """RJP_σ: ⋈(pred', proj', ⊗', τ(K_o), τ(K_i)) — paper §4.

    pred'(keyO, keyIn) = (keyO == proj(keyIn)) ∧ pred(keyIn)
    proj'            -> keyIn
    ⊗'(g, x)         = ⊙.vjp(g, x)
    """
    child = node.child
    eqs: List[Tuple] = []
    for o, c in enumerate(node.proj.comps):
        rc = R(c.idx) if isinstance(c, In) else Lit(c.val)
        eqs.append((L(o), rc))
    if node.pred.custom is not None:
        raise NotImplementedError("cannot differentiate custom selection predicates")
    for i, v in node.pred.eqs:
        eqs.append((R(i), Lit(v)))
    pred = JoinPred(tuple(eqs))
    proj = JoinProj(tuple(R(i) for i in range(child.key_arity)))
    return fra.Join(pred, proj, _vjp_unary(node.kernel), g, fwd_ref(child))


def _rjp_agg(g: fra.Node, node: fra.Agg) -> fra.Node:
    """RJP_Σ: ⋈(pred, proj, ⊗, τ(K_o), τ(K_i)) with
    pred(keyO, keyIn) = keyO == grp(keyIn), proj -> keyIn,
    ⊗(g, x) = ∂⊕/∂x · g (= g for ⊕ = add: broadcast join)."""
    if not node.kernel.is_add:
        raise NotImplementedError(
            f"RJP for non-additive ⊕ {node.kernel.name} not supported"
        )
    child = node.child
    eqs = []
    for o, c in enumerate(node.grp.comps):
        rc = R(c.idx) if isinstance(c, In) else Lit(c.val)
        eqs.append((L(o), rc))
    pred = JoinPred(tuple(eqs))
    proj = JoinProj(tuple(R(i) for i in range(child.key_arity)))
    return fra.Join(pred, proj, _take_left(), g, fwd_ref(child))


def _mirror(pred: JoinPred, proj: JoinProj) -> Tuple[JoinPred, JoinProj]:
    """Swap L and R roles so the right-operand RJP reuses the left solver."""
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


def _needs_agg(
    pred: JoinPred, proj: JoinProj, wrt_arity: int, other_arity: int
) -> bool:
    """Σ-elimination analysis (paper §4, second optimization).

    The RJP join pairs (output key O, other key R). Duplicate
    differentiated-operand keys — requiring a trailing Σ — arise iff some
    join equivalence class visible in (O, R) is *not* pinned by the
    reconstructed key. This is exactly the n side of a 1-n join.
    """
    solved = solve_left_key(pred, proj, wrt_arity, other_arity)
    if solved is None:
        return True
    exprs, _ = solved
    uf = join_equiv_classes(pred, wrt_arity, other_arity)
    pinned = set()
    for i in range(wrt_arity):
        pinned.add(uf.find(L(i)))
    visible = set()
    for j in range(other_arity):
        visible.add(uf.find(R(j)))
    for c in proj.comps:
        if not isinstance(c, Lit):
            visible.add(uf.find(c))
    return not visible <= pinned


def _rjp_join_one_side(
    g: fra.Node,
    pred: JoinPred,
    proj: JoinProj,
    kernel: BinKernel,
    wrt_child: fra.Node,
    other_child: fra.Node,
    side: str,
    opts: RJPOptions = DEFAULT_OPTS,
) -> fra.Node:
    """RJP_⋈ for one operand, with all three §4 optimizations.

    ``pred``/``proj`` must already be oriented so the differentiated operand
    is on the *left* (use _mirror for the right operand). ``side`` tags which
    VJP kernel to use ('l' or 'r' of the *original* kernel).
    """
    wa, oa = wrt_child.key_arity, other_child.key_arity
    solved = solve_left_key(pred, proj, wa, oa)

    if kernel.multiplicative and solved is not None and opts.multiplicative:
        exprs, consistency = solved
        out = fra.Join(
            consistency,
            JoinProj(tuple(exprs)),
            _vjp_bin(kernel, side),
            g,
            fwd_ref(other_child),
        )
        if _needs_agg(pred, proj, wa, oa) or not opts.eliminate_sigma:
            out = fra.Agg(identity_key(wa), ADD, out)
        # §3.1: the gradient is defined on the differentiated relation's key
        # set — restrict (identity for full-grid relations, keeps sparse
        # relations' gradients sparse).
        return fra.Restrict(out, fwd_ref(wrt_child))

    # General path (paper's unoptimized RJP_⋈): re-derive the forward join
    # matches with the partial-derivative kernel, keyed ⟨keyL, keyO'⟩ where
    # keyO' keeps only the output comps whose equivalence class is not
    # already carried by keyL (a duplicated class would be an einsum output
    # subscript repeated — unlowerable — and is redundant: the outer join
    # reads the class off its keyL position instead). Then join the
    # upstream gradient against ⟨keyL, keyO'⟩ on keyO and contract with ×,
    # then Σ over the surviving other-side classes.
    uf = join_equiv_classes(pred, wa, oa)
    pos_of: Dict[object, int] = {}
    for i in range(wa):
        pos_of.setdefault(uf.find(L(i)), i)
    extra: List = []
    outer_eqs: List[Tuple] = []
    for o, c in enumerate(proj.comps):
        if isinstance(c, Lit):
            # constant output comp: the upstream gradient contributes only
            # where its key carries that constant
            outer_eqs.append((L(o), Lit(c.val)))
            continue
        root = uf.find(c)
        if root not in pos_of:
            pos_of[root] = wa + len(extra)
            extra.append(c)
        outer_eqs.append((L(o), R(pos_of[root])))
    inner_proj = JoinProj(tuple(L(i) for i in range(wa)) + tuple(extra))
    inner = fra.Join(
        pred, inner_proj, _partial_bin(kernel, side),
        fwd_ref(wrt_child), fwd_ref(other_child),
    )
    # When the forward Σ drops a join key, some equivalence class of the
    # inner join is determined by neither ⟨keyL⟩ nor ⟨keyO'⟩, so the inner
    # join emits duplicate ⟨keyL, keyO'⟩ rows — a multiset no executor
    # accepts as a relation. All duplicates of one ⟨keyL, keyO'⟩ meet the
    # same g[keyO] in the outer join, so merging them with the Σ's ⊕ first
    # is exact (distributivity of × over +) and makes the derivation both
    # interpretable (Agg merges the pair list) and lowerable (the fused
    # Agg-over-Join contracts the dropped class).
    determined = set(pos_of)
    for a, b in pred.eqs:
        for c in (a, b):
            if isinstance(c, Lit):
                determined.add(uf.find(c))
    if any(uf.find(R(j)) not in determined for j in range(oa)):
        inner = fra.Agg(identity_key(wa + len(extra)), ADD, inner)
    outer_proj = JoinProj(tuple(R(i) for i in range(wa)))
    outer = fra.Join(JoinPred(tuple(outer_eqs)), outer_proj, MUL, g, inner)
    out = fra.Agg(identity_key(wa), ADD, outer)
    return fra.Restrict(out, fwd_ref(wrt_child))


def _rjp_join(
    g: fra.Node, node: fra.Join, opts: RJPOptions = DEFAULT_OPTS
) -> List[Tuple[int, fra.Node]]:
    """Gradient contributions of a Join to each non-Const child. Returned as
    (child_id, contribution) pairs — a self-join (same node on both sides)
    yields two contributions to the same child, summed by the caller (the
    total-derivative ``add`` of §5)."""
    out: List[Tuple[int, fra.Node]] = []
    if not isinstance(node.left, fra.Const):
        out.append(
            (
                node.left.id,
                _rjp_join_one_side(
                    g, node.pred, node.proj, node.kernel,
                    node.left, node.right, "l", opts,
                ),
            )
        )
    if not isinstance(node.right, fra.Const):
        mp, mj = _mirror(node.pred, node.proj)
        out.append(
            (
                node.right.id,
                _rjp_join_one_side(
                    g, mp, mj, node.kernel, node.right, node.left, "r", opts
                ),
            )
        )
    return out


def _compose_grp_into_proj(grp: KeyFn, proj: JoinProj) -> JoinProj:
    """proj_eff = grp ∘ proj — join-agg fusion (§4 third optimization)."""
    comps = []
    for c in grp.comps:
        if isinstance(c, Lit):
            comps.append(c)
        else:
            comps.append(proj.comps[c.idx])
    return JoinProj(tuple(comps))


# ---------------------------------------------------------------------------
# Algorithm 2: RAAutoDiff
# ---------------------------------------------------------------------------


@dataclass
class GradientProgram:
    """The output of relational auto-diff.

    ``grads[name]`` is the root of an FRA graph computing ∂Q/∂R_name. Its
    environment must contain: the original inputs, ``__seed`` (output
    cotangent), and the ``__fwd_*`` cached intermediates produced by
    ``forward_with_cache``.

    ``opts`` records the RJPOptions the program was derived under, so a
    structural rewrite of the forward query (core/rewrite.py) can
    re-derive the gradient graphs under identical settings.
    """

    forward: fra.Query
    grads: Dict[str, fra.Node]
    wrt: Tuple[str, ...]
    opts: RJPOptions = DEFAULT_OPTS

    def grad_query(self, name: str) -> fra.Query:
        scans = tuple(
            sorted({s.name for s in self.grads[name].table_scans()})
        )
        return fra.Query(self.grads[name], scans)

    # -- execution via the sparse interpreter (oracle path) ----------------
    def forward_with_cache(self, env: interpreter.Env):
        cache: Dict[int, object] = {}
        out = interpreter.run_query(self.forward, env, cache)
        fwd_env = {f"__fwd_{nid}": rel for nid, rel in cache.items()}
        return out, fwd_env

    def eval(
        self,
        env: interpreter.Env,
        seed: Optional[interpreter.SparseRelation] = None,
    ):
        out, fwd_env = self.forward_with_cache(env)
        if seed is None:
            if len(out) != 1:
                raise ValueError(
                    "default seed requires a one-tuple loss output; pass a "
                    "cotangent relation explicitly"
                )
            seed = {k: 1.0 for k in out}
        genv = dict(env)
        genv.update(fwd_env)
        genv[SEED] = seed
        gout = {
            name: interpreter.evaluate(root, genv)
            for name, root in self.grads.items()
        }
        return out, gout


def ra_autodiff(
    query: fra.Query,
    wrt: Optional[Tuple[str, ...]] = None,
    opts: RJPOptions = DEFAULT_OPTS,
) -> GradientProgram:
    """Algorithm 2 (RAAutoDiff), symbolically.

    Walks the operator DAG in reverse topological order, applies ChainRule
    (Algorithm 1) via the RJP constructors, and accumulates fan-out
    contributions with ``add`` (the total derivative, §5).
    """
    if wrt is None:
        wrt = query.inputs
    order = query.root.topo()
    # Accumulated gradient graph per node id.
    acc: Dict[int, fra.Node] = {query.root.id: fra.const(SEED, query.root.key_arity)}

    # Count consumers to know when a node's gradient is complete. For our
    # DAGs (each node knows its children), process in reverse topo order —
    # every parent appears after its children in `order`, so by the time we
    # reach a node all its parents' contributions have been accumulated.
    fused_joins: set = set()

    for node in reversed(order):
        g = acc.get(node.id)
        if g is None or isinstance(node, (fra.TableScan, fra.Const)):
            continue
        if node.id in fused_joins:
            continue

        def accumulate(child_id: int, contrib: fra.Node) -> None:
            if child_id in acc:
                acc[child_id] = fra.AddOp(acc[child_id], contrib)
            else:
                acc[child_id] = contrib

        if isinstance(node, fra.AddOp):
            # d add / d child = identity on both sides (twice if self-add).
            accumulate(node.left.id, g)
            accumulate(node.right.id, g)
        elif isinstance(node, fra.Select):
            accumulate(node.child.id, _rjp_select(g, node))
        elif isinstance(node, fra.Agg):
            child = node.child
            if (
                isinstance(child, fra.Join)
                and node.kernel.is_add
                and opts.fuse_join_agg
                and _single_parent(child, order)
            ):
                # Join-agg fusion: differentiate Σ∘⋈ as one operator.
                proj_eff = _compose_grp_into_proj(node.grp, child.proj)
                fused = fra.Join(
                    child.pred, proj_eff, child.kernel, child.left, child.right
                )
                fused.id = child.id  # same forward intermediates
                for cid, contrib in _rjp_join(g, fused, opts):
                    accumulate(cid, contrib)
                fused_joins.add(child.id)
            else:
                accumulate(child.id, _rjp_agg(g, node))
        elif isinstance(node, fra.Join):
            for cid, contrib in _rjp_join(g, node, opts):
                accumulate(cid, contrib)
        else:
            raise TypeError(f"cannot differentiate node {node}")

    grads: Dict[str, fra.Node] = {}
    for s in query.root.table_scans():
        if s.name in wrt:
            if s.id not in acc:
                raise ValueError(f"input {s.name} does not reach the output")
            if s.name in grads:
                # Distinct τ nodes naming the same input relation: the
                # total derivative (§5) sums their contributions.
                grads[s.name] = fra.AddOp(grads[s.name], acc[s.id])
            else:
                grads[s.name] = acc[s.id]
    missing = set(wrt) - set(grads)
    if missing:
        raise ValueError(f"wrt inputs not found in query: {missing}")
    return GradientProgram(query, grads, tuple(wrt), opts)


def _single_parent(node: fra.Node, order: List[fra.Node]) -> bool:
    n = 0
    for p in order:
        for c in p.children:
            if c.id == node.id:
                n += 1
    return n == 1
