"""Symbolic key-function language for the functional relational algebra.

The paper's RA operations are parameterized by key functions:

  grp  : K_i -> K_o                  (Aggregation)
  pred : K_l x K_r -> bool           (Join)
  proj : K_l x K_r -> K_o            (Join)
  pred : K_i -> bool                 (Selection)
  proj : K_i -> K_o                  (Selection)

Keys are tuples of integers. We represent key functions *symbolically* so
that (1) the RJP construction (autodiff) can derive the paper's transformed
key functions (e.g. ``pred'(keyL, keyR) = keyL == proj(keyR)``) in closed
form, and (2) the chunked compiler can pattern-match joins/aggregations into
einsum / gather / segment-sum lowerings.

Component references:
  In(i)   -- i-th component of the (single) input key
  L(i)    -- i-th component of the left join key
  R(i)    -- i-th component of the right join key
  Lit(v)  -- integer literal
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class In:
    idx: int

    def __repr__(self) -> str:
        return f"k[{self.idx}]"


@dataclass(frozen=True)
class L:
    idx: int

    def __repr__(self) -> str:
        return f"l[{self.idx}]"


@dataclass(frozen=True)
class R:
    idx: int

    def __repr__(self) -> str:
        return f"r[{self.idx}]"


@dataclass(frozen=True)
class Lit:
    val: int

    def __repr__(self) -> str:
        return str(self.val)


Comp = Union[In, Lit]
JoinComp = Union[L, R, Lit]


def _eval_comp(c, key) -> int:
    if isinstance(c, In):
        return key[c.idx]
    if isinstance(c, Lit):
        return c.val
    raise TypeError(f"not a unary component: {c}")


def _eval_join_comp(c, kl, kr) -> int:
    if isinstance(c, L):
        return kl[c.idx]
    if isinstance(c, R):
        return kr[c.idx]
    if isinstance(c, Lit):
        return c.val
    raise TypeError(f"not a join component: {c}")


# ---------------------------------------------------------------------------
# Unary key map:  K_i -> K_o   (used by grp and selection proj)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KeyFn:
    """Key map returning a tuple of components drawn from the input key."""

    comps: Tuple[Comp, ...]

    def __call__(self, key: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(_eval_comp(c, key) for c in self.comps)

    @property
    def arity_out(self) -> int:
        return len(self.comps)

    def is_identity(self, arity_in: int) -> bool:
        return self.comps == tuple(In(i) for i in range(arity_in))

    def is_permutation(self, arity_in: int) -> bool:
        idxs = [c.idx for c in self.comps if isinstance(c, In)]
        return (
            len(idxs) == len(self.comps) == arity_in
            and sorted(idxs) == list(range(arity_in))
        )

    def __repr__(self) -> str:
        return "key->(" + ",".join(map(repr, self.comps)) + ")"


def identity_key(arity: int) -> KeyFn:
    return KeyFn(tuple(In(i) for i in range(arity)))


def project_key(*idxs: int) -> KeyFn:
    return KeyFn(tuple(In(i) for i in idxs))


def const_key(*vals: int) -> KeyFn:
    """Constant grouping function (aggregate everything to one tuple)."""
    return KeyFn(tuple(Lit(v) for v in vals))


EMPTY_KEY = KeyFn(())  # grp(key) -> <>


# ---------------------------------------------------------------------------
# Unary predicate:  K_i -> bool   (selection)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SelPred:
    """Conjunction of equality constraints ``key[idx] == val``.

    ``eqs == ()`` is the always-true predicate. A ``custom`` callable escape
    hatch is provided for tests of general semantics; the compiler rejects
    custom predicates (interpreter-only).
    """

    eqs: Tuple[Tuple[int, int], ...] = ()
    custom: Optional[Callable[[Tuple[int, ...]], bool]] = None

    def __call__(self, key: Tuple[int, ...]) -> bool:
        if self.custom is not None:
            return bool(self.custom(key))
        return all(key[i] == v for i, v in self.eqs)

    @property
    def always_true(self) -> bool:
        return self.custom is None and not self.eqs

    def __repr__(self) -> str:
        if self.custom is not None:
            return "pred<custom>"
        if not self.eqs:
            return "true"
        return " & ".join(f"k[{i}]=={v}" for i, v in self.eqs)


TRUE = SelPred()


# ---------------------------------------------------------------------------
# Join predicate:  K_l x K_r -> bool
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class JoinPred:
    """Conjunction of equalities between join components.

    Each pair ``(a, b)`` asserts ``eval(a) == eval(b)`` where a, b are
    L(i)/R(j)/Lit(v). The typical matmul predicate ``keyL[1] == keyR[0]`` is
    ``JoinPred(((L(1), R(0)),))``.
    """

    eqs: Tuple[Tuple[JoinComp, JoinComp], ...] = ()

    def __call__(self, kl: Tuple[int, ...], kr: Tuple[int, ...]) -> bool:
        return all(
            _eval_join_comp(a, kl, kr) == _eval_join_comp(b, kl, kr)
            for a, b in self.eqs
        )

    def __repr__(self) -> str:
        if not self.eqs:
            return "true"
        return " & ".join(f"{a!r}=={b!r}" for a, b in self.eqs)


JTRUE = JoinPred()


def eq_pred(*pairs: Tuple[int, int]) -> JoinPred:
    """Equality join predicate from (left_idx, right_idx) pairs."""
    return JoinPred(tuple((L(i), R(j)) for i, j in pairs))


# ---------------------------------------------------------------------------
# Join projection:  K_l x K_r -> K_o
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class JoinProj:
    comps: Tuple[JoinComp, ...]

    def __call__(self, kl: Tuple[int, ...], kr: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(_eval_join_comp(c, kl, kr) for c in self.comps)

    @property
    def arity_out(self) -> int:
        return len(self.comps)

    def __repr__(self) -> str:
        return "(l,r)->(" + ",".join(map(repr, self.comps)) + ")"


def jproj(*comps: JoinComp) -> JoinProj:
    return JoinProj(tuple(comps))


# ---------------------------------------------------------------------------
# Equivalence classes over join components
# ---------------------------------------------------------------------------


class UnionFind:
    def __init__(self) -> None:
        self.parent: dict = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb

    def classes(self) -> dict:
        out: dict = {}
        for x in list(self.parent):
            out.setdefault(self.find(x), []).append(x)
        return out


def join_equiv_classes(
    pred: JoinPred,
    left_arity: int,
    right_arity: int,
) -> UnionFind:
    """Union-find over {L(i)}, {R(j)}, literals implied by ``pred``."""
    uf = UnionFind()
    for i in range(left_arity):
        uf.find(L(i))
    for j in range(right_arity):
        uf.find(R(j))
    for a, b in pred.eqs:
        uf.union(a, b)
    return uf


def solve_left_key(
    pred: JoinPred,
    proj: JoinProj,
    left_arity: int,
    right_arity: int,
):
    """Derive, for the RJP of a join, expressions reconstructing each left-key
    component from (output key, right key).

    Returns ``(exprs, consistency)`` where ``exprs[i]`` is a component over
    the *RJP join* inputs — L(o) referring to output-key component ``o`` or
    R(j) referring to right-key component ``j`` (or Lit) — such that
    ``keyL[i] = eval(exprs[i], keyO, keyR)``; and ``consistency`` is a
    JoinPred over (keyO, keyR) expressing the residual match condition.

    Returns ``None`` if some left component is not derivable (the compiler
    then falls back to the general/unoptimized RJP).
    """
    uf = join_equiv_classes(pred, left_arity, right_arity)

    # Where does each equivalence class surface in (O, R)?
    # O components: proj.comps[o] is L(i)/R(j)/Lit -> class visible at L(o)
    # R components: R(j) visible at R(j). Lit classes are visible as Lit.
    class_expr: dict = {}
    for j in range(right_arity):
        class_expr.setdefault(uf.find(R(j)), R(j))
    for o, c in enumerate(proj.comps):
        if isinstance(c, Lit):
            continue
        class_expr.setdefault(uf.find(c), L(o))  # L(o) == output comp o
    for a, b in pred.eqs:
        for c in (a, b):
            if isinstance(c, Lit):
                root = uf.find(c)
                class_expr.setdefault(root, c)

    exprs = []
    for i in range(left_arity):
        root = uf.find(L(i))
        e = class_expr.get(root)
        if e is None:
            return None
        exprs.append(e)

    # Residual consistency: every *other* appearance of a class in (O, R)
    # must equal the representative expression.
    cons = []
    seen: dict = {}
    for j in range(right_arity):
        root = uf.find(R(j))
        rep = class_expr[root]
        if rep != R(j):
            cons.append((rep, R(j)))
        seen[root] = True
    for o, c in enumerate(proj.comps):
        if isinstance(c, Lit):
            cons.append((L(o), Lit(c.val)))
            continue
        root = uf.find(c)
        rep = class_expr[root]
        if rep != L(o):
            cons.append((rep, L(o)))
    # Deduplicate (a,b) pairs regardless of order.
    uniq = []
    for a, b in cons:
        if (a, b) not in uniq and (b, a) not in uniq:
            uniq.append((a, b))
    return tuple(exprs), JoinPred(tuple(uniq))
