"""Functional relational algebra IR (paper §2).

A *query* is a DAG of operator nodes. Leaves are ``TableScan`` (variable
inputs — relations we may differentiate with respect to) and ``Const``
(constant relations — the paper's ⋈_const inputs, training data, cached
forward intermediates). Interior nodes are Selection σ, Aggregation Σ,
Join ⋈ (with the const variant folded in via Const leaves), and the
``add`` operation of §5 used for total derivatives.

Every node carries its output key arity; kernel functions are registry
entries (see kernels.py); key functions are symbolic (see keys.py). Both
the sparse interpreter (interpreter.py — the semantics oracle) and the
chunked compiler (compiler.py — the fast path) execute this IR, and the
relational auto-diff (autodiff.py) transforms it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from .kernels import AggKernel, BinKernel, UnaryKernel
from .keys import JoinPred, JoinProj, KeyFn, SelPred

_ids = itertools.count()


class Node:
    """Base class. Subclasses set ``children`` and ``key_arity``."""

    children: Tuple["Node", ...]
    key_arity: int

    def __post_init__(self):  # dataclasses call this
        self.id = next(_ids)

    # -- graph utilities ----------------------------------------------------
    def topo(self) -> List["Node"]:
        """Topological order, leaves first, root last."""
        seen: Dict[int, Node] = {}
        order: List[Node] = []

        def visit(n: Node) -> None:
            if n.id in seen:
                return
            seen[n.id] = n
            for c in n.children:
                visit(c)
            order.append(n)

        visit(self)
        return order

    def table_scans(self) -> List["TableScan"]:
        return [n for n in self.topo() if isinstance(n, TableScan)]

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        head = f"{pad}{self.describe()}"
        return "\n".join([head] + [c.pretty(indent + 1) for c in self.children])

    def describe(self) -> str:
        return type(self).__name__


@dataclass(eq=False)
class TableScan(Node):
    """τ(K): a named variable input relation."""

    name: str
    key_arity: int

    def __post_init__(self):
        super().__post_init__()
        self.children = ()

    def describe(self) -> str:
        return f"τ({self.name}, arity={self.key_arity})"


@dataclass(eq=False)
class Const(Node):
    """A constant relation embedded in the query (⋈_const operands, data,
    cached forward intermediates in gradient queries). ``ref`` names the
    relation in the environment at execution time."""

    ref: str
    key_arity: int

    def __post_init__(self):
        super().__post_init__()
        self.children = ()

    def describe(self) -> str:
        return f"const({self.ref}, arity={self.key_arity})"


@dataclass(eq=False)
class Select(Node):
    """σ(pred, proj, ⊙, child)."""

    pred: SelPred
    proj: KeyFn
    kernel: UnaryKernel
    child: Node

    def __post_init__(self):
        super().__post_init__()
        self.children = (self.child,)
        self.key_arity = self.proj.arity_out

    def describe(self) -> str:
        return f"σ(pred={self.pred!r}, proj={self.proj!r}, {self.kernel!r})"


@dataclass(eq=False)
class Agg(Node):
    """Σ(grp, ⊕, child)."""

    grp: KeyFn
    kernel: AggKernel
    child: Node

    def __post_init__(self):
        super().__post_init__()
        self.children = (self.child,)
        self.key_arity = self.grp.arity_out

    def describe(self) -> str:
        return f"Σ(grp={self.grp!r}, {self.kernel!r})"


@dataclass(eq=False)
class Join(Node):
    """⋈(pred, proj, ⊗, left, right).

    ⋈_const is represented as a Join whose left/right child is a Const leaf.
    A Join may produce duplicate output keys when ``proj`` is non-injective
    over matches; such a Join is only well-formed under an Agg parent which
    merges duplicates (the paper's join-agg trees). The executors enforce
    this.
    """

    pred: JoinPred
    proj: JoinProj
    kernel: BinKernel
    left: Node
    right: Node

    def __post_init__(self):
        super().__post_init__()
        self.children = (self.left, self.right)
        self.key_arity = self.proj.arity_out

    def describe(self) -> str:
        return f"⋈(pred={self.pred!r}, proj={self.proj!r}, {self.kernel!r})"


@dataclass(eq=False)
class AddOp(Node):
    """add(l, r): pointwise sum of two relations on the same key set (§5)."""

    left: Node
    right: Node

    def __post_init__(self):
        super().__post_init__()
        assert self.left.key_arity == self.right.key_arity, (
            self.left.key_arity,
            self.right.key_arity,
        )
        self.children = (self.left, self.right)
        self.key_arity = self.left.key_arity

    def describe(self) -> str:
        return "add"


@dataclass(eq=False)
class Restrict(Node):
    """Restrict ``child`` to the key set of relation ``ref``.

    The paper defines partial derivatives only for keys *in* the input
    relation's key set (§3.1); gradient queries therefore restrict each
    RJP-join output to the differentiated relation's keys. For dense
    (full-grid) relations this is the identity; for sparse (COO) relations
    it keeps the gradient sparse and lets the compiler fuse the enclosing
    RJP join into a per-tuple gather instead of a dense cross product.
    """

    child: Node
    ref: Node

    def __post_init__(self):
        super().__post_init__()
        assert self.child.key_arity == self.ref.key_arity, (
            self.child.key_arity,
            self.ref.key_arity,
        )
        self.children = (self.child, self.ref)
        self.key_arity = self.child.key_arity

    def describe(self) -> str:
        return "restrict"


@dataclass(eq=False)
class Query:
    """A compiled-ready query: root node + ordered variable-input names."""

    root: Node
    inputs: Tuple[str, ...]

    def __post_init__(self):
        scans = {s.name for s in self.root.table_scans()}
        missing = scans - set(self.inputs)
        if missing:
            raise ValueError(f"table scans not declared as inputs: {missing}")

    def pretty(self) -> str:
        return self.root.pretty()


def scan(name: str, key_arity: int) -> TableScan:
    return TableScan(name, key_arity)


def const(ref: str, key_arity: int) -> Const:
    return Const(ref, key_arity)
