"""Sparse reference interpreter — the semantics oracle.

Executes the FRA IR literally per the paper's definitions (§2.2), over
relations represented as ``dict[key_tuple, value]``. Values may be python
floats or tensors (chunks). This executor is
tuple-at-a-time and deliberately naive: it exists to pin down semantics for
tests; the chunked compiler (compiler.py) is the fast path and is tested
against this one.

A bare Join may produce duplicate output keys (non-injective proj over
matches); per the paper such joins appear only under an Agg ("join-agg
tree"). Internally Join evaluates to a *list* of (key, value) pairs; Agg
consumes either a list or a dict; any other consumer requires uniqueness
and raises otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

from . import fra

SparseRelation = Dict[tuple, object]
Env = Dict[str, SparseRelation]


def _as_relation(pairs: Union[SparseRelation, List[tuple]], ctx: str) -> SparseRelation:
    if isinstance(pairs, dict):
        return pairs
    rel: SparseRelation = {}
    for k, v in pairs:
        if k in rel:
            raise ValueError(
                f"join under {ctx} produced duplicate key {k}; wrap it in an "
                f"Agg (join-agg tree) to merge duplicates"
            )
        rel[k] = v
    return rel


def _items(pairs: Union[SparseRelation, List[tuple]]):
    return pairs.items() if isinstance(pairs, dict) else pairs


def evaluate(
    node: fra.Node,
    env: Env,
    cache: Dict[int, object] | None = None,
) -> SparseRelation:
    """Evaluate ``node`` under ``env``. If ``cache`` is given, every node's
    intermediate relation is stored there by node id (needed by the
    auto-diff forward pass, Algorithm 2 line 6)."""
    memo: Dict[int, object] = {}

    def ev(n: fra.Node):
        if n.id in memo:
            return memo[n.id]
        out = _ev(n)
        memo[n.id] = out
        if cache is not None:
            # Joins cache their raw multiset; with the join-agg fusion of §4
            # the bare-join intermediate is never consumed as a relation.
            cache[n.id] = out
        return out

    def _ev(n: fra.Node):
        if isinstance(n, fra.TableScan):
            return env[n.name]
        if isinstance(n, fra.Const):
            return env[n.ref]
        if isinstance(n, fra.Select):
            child = _as_relation(ev(n.child), "σ")
            out: SparseRelation = {}
            for k, v in child.items():
                if n.pred(k):
                    nk = n.proj(k)
                    if nk in out:
                        raise ValueError(f"σ proj produced duplicate key {nk}")
                    out[nk] = n.kernel.fn(v)
            return out
        if isinstance(n, fra.Agg):
            child = ev(n.child)
            out: SparseRelation = {}
            for k, v in _items(child):
                nk = n.grp(k)
                out[nk] = n.kernel.fn(out[nk], v) if nk in out else v
            return out
        if isinstance(n, fra.Join):
            left = _as_relation(ev(n.left), "⋈.left")
            right = _as_relation(ev(n.right), "⋈.right")
            pairs: List[tuple] = []
            for kl, vl in left.items():
                for kr, vr in right.items():
                    if n.pred(kl, kr):
                        pairs.append((n.proj(kl, kr), n.kernel.fn(vl, vr)))
            return pairs
        if isinstance(n, fra.Restrict):
            child = _as_relation(ev(n.child), "restrict")
            ref = _as_relation(ev(n.ref), "restrict.ref")
            return {k: v for k, v in child.items() if k in ref}
        if isinstance(n, fra.AddOp):
            left = _as_relation(ev(n.left), "add.left")
            right = _as_relation(ev(n.right), "add.right")
            out = dict(left)
            for k, v in right.items():
                out[k] = out[k] + v if k in out else v
            return out
        raise TypeError(f"unknown node {n}")

    return _as_relation(ev(node), "root")


def run_query(q: fra.Query, env: Env, cache: Dict[int, object] | None = None) -> SparseRelation:
    return evaluate(q.root, env, cache)
