"""Mini SQL frontend: compiles the paper's SQL style into functional-RA
query graphs (fra.py) ready for ``ra_autodiff``.

The paper's §6 implementation "accepts SQL input"; this is that layer.
Supported grammar (enough for every SQL fragment the paper shows):

  script   := stmt (";" stmt)* [";"]
  stmt     := NAME ":=" select | select          -- named views; last = root
  select   := SELECT item ("," item)*
              FROM tbl [alias] ("," tbl [alias])*
              [WHERE cond (AND cond)*]
              [GROUP BY colref ("," colref)*]
  item     := colref [AS NAME]                   -- key column
            | [SUM|MAX] "(" call | colref ")" [AS NAME]   -- value column
  call     := NAME "(" valarg ("," valarg)* ")"  -- kernel from the registry
  cond     := colref "=" colref | colref "=" INT

One kernel call per SELECT (the paper builds multi-operator pipelines as
stacked queries — use views, e.g. the §2.3 logistic regression below).
Key columns are the relation's declared key attributes; any other
attribute (``val``, ``mat``, ``vec``...) refers to the tuple's value.

  SQL function         FRA kernel
  matrix_multiply   →  matmul        multiply → mul      add → add2
  (any registered kernel name works verbatim: logistic, xent, sqerr, ...)

Example (paper §2.3):

  compile_sql('''
    mm   := SELECT Rx.row, SUM(multiply(Rx.val, theta.val))
            FROM Rx, theta WHERE Rx.col = theta.col GROUP BY Rx.row;
    pred := SELECT mm.row, logistic(mm.val) FROM mm;
    SELECT SUM(xent(pred.val, Ry.val)) FROM pred, Ry
    WHERE pred.row = Ry.row
  ''', schema={"Rx": ("row", "col"), "theta": ("col",), "Ry": ("row",)},
       inputs=("theta",))
"""

from __future__ import annotations

import re
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import fra
from .kernels import _AGG, _BIN, _UNARY, IDENT, agg, bin_kernel, unary
from .keys import (
    In,
    JoinPred,
    JoinProj,
    KeyFn,
    L,
    Lit,
    R,
    SelPred,
    jproj,
)

_FN_ALIASES = {
    "matrix_multiply": "matmul",
    "matmul": "matmul",
    "multiply": "mul",
    "mul": "mul",
    "add": "add2",
    "matrix_add": "add2",
    "subtract": "sub",
}

_AGG_NAMES = {"SUM": "add", "MAX": "max"}


# the statement being compiled, used as the Diagnostic node path so an
# error in a multi-statement script names the offending stmt/view
_CURRENT_STMT: ContextVar[str] = ContextVar("_CURRENT_STMT", default="script")


class SQLError(ValueError):
    """A SQL frontend error carrying a structured ``Diagnostic``.

    ``str(err)`` renders as ``<node_path>: <message> (hint: ...)`` so
    existing ``except SQLError`` / message-matching callers keep
    working; ``err.diagnostic`` exposes the severity/code/node-path/hint
    record for programmatic consumers (same type the FRA checker
    emits — see ``repro_torch.analysis.diagnostics``)."""

    def __init__(self, message: str = "", *, code: str = "sql",
                 hint: str = "", diagnostic=None):
        from ..analysis.diagnostics import Diagnostic

        if diagnostic is None:
            diagnostic = Diagnostic(
                severity="error",
                code=code,
                node_path=_CURRENT_STMT.get(),
                message=str(message),
                hint=hint,
            )
        self.diagnostic = diagnostic
        super().__init__(diagnostic.render_inline())


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<assign>:=)|(?P<punct>[(),;.=])|(?P<int>\d+)|(?P<name>[A-Za-z_]\w*)|(?P<comment>--[^\n]*))"
)

_KEYWORDS = {"SELECT", "FROM", "WHERE", "GROUP", "BY", "AND", "AS"}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise SQLError(f"cannot tokenize at: {text[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        val = m.group(m.lastgroup)
        if m.lastgroup == "name" and val.upper() in _KEYWORDS:
            toks.append(("kw", val.upper()))
        else:
            toks.append((m.lastgroup, val))
    toks.append(("eof", ""))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class ColRef:
    table: str
    attr: str


@dataclass
class Call:
    fn: str
    args: List[ColRef]


@dataclass
class ValItem:
    aggfn: Optional[str]          # "add"/"max" or None
    call: Optional[Call]          # kernel call, or None for bare colref
    col: Optional[ColRef]
    alias: Optional[str]


@dataclass
class SelectStmt:
    key_items: List[Tuple[ColRef, Optional[str]]]
    val_item: ValItem
    tables: List[Tuple[str, str]]               # (name, alias)
    conds: List[Tuple[ColRef, object]]          # rhs: ColRef | int
    group_by: List[ColRef]


class _Parser:
    def __init__(self, toks: List[Tuple[str, str]]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, val: Optional[str] = None) -> str:
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            raise SQLError(f"expected {val or kind}, got {v!r}")
        return v

    def at_kw(self, kw: str) -> bool:
        k, v = self.peek()
        return k == "kw" and v == kw

    # -- grammar ------------------------------------------------------------

    def script(self) -> List[Tuple[Optional[str], SelectStmt]]:
        stmts = []
        while not self.peek()[0] == "eof":
            name = None
            if self.peek()[0] == "name" and self.toks[self.i + 1][0] == "assign":
                name = self.next()[1]
                self.next()  # :=
            stmts.append((name, self.select()))
            if self.peek() == ("punct", ";"):
                self.next()
        if not stmts:
            raise SQLError("empty script")
        return stmts

    def select(self) -> SelectStmt:
        self.expect("kw", "SELECT")
        key_items: List[Tuple[ColRef, Optional[str]]] = []
        val_item: Optional[ValItem] = None
        while True:
            item = self.sel_item()
            if isinstance(item, tuple):
                key_items.append(item)
            else:
                if val_item is not None:
                    raise SQLError("only one value expression per SELECT")
                val_item = item
            if self.peek() == ("punct", ","):
                self.next()
                continue
            break
        if val_item is None:
            raise SQLError("SELECT needs a value expression "
                           "(bare key projection is not a query)")
        self.expect("kw", "FROM")
        tables = [self.table_ref()]
        while self.peek() == ("punct", ","):
            self.next()
            tables.append(self.table_ref())
        conds: List[Tuple[ColRef, object]] = []
        if self.at_kw("WHERE"):
            self.next()
            conds.append(self.cond())
            while self.at_kw("AND"):
                self.next()
                conds.append(self.cond())
        group_by: List[ColRef] = []
        if self.at_kw("GROUP"):
            self.next()
            self.expect("kw", "BY")
            group_by.append(self.colref())
            while self.peek() == ("punct", ","):
                self.next()
                group_by.append(self.colref())
        return SelectStmt(key_items, val_item, tables, conds, group_by)

    def sel_item(self):
        k, v = self.peek()
        # aggregate or kernel call?
        if k == "name" and self.toks[self.i + 1] == ("punct", "("):
            fname = self.next()[1]
            self.next()  # (
            if fname.upper() in _AGG_NAMES:
                inner_k, _ = self.peek()
                if inner_k == "name" and self.toks[self.i + 1] == ("punct", "("):
                    call = self.call()
                    col = None
                else:
                    col = self.colref()
                    call = None
                self.expect("punct", ")")
                alias = self.opt_alias()
                return ValItem(_AGG_NAMES[fname.upper()], call, col, alias)
            call = self.call_body(fname)
            alias = self.opt_alias()
            return ValItem(None, call, None, alias)
        col = self.colref()
        alias = self.opt_alias()
        return (col, alias)  # may get reclassified by the compiler

    def call(self) -> Call:
        fname = self.expect("name")
        self.expect("punct", "(")
        return self.call_body(fname)

    def call_body(self, fname: str) -> Call:
        args = [self.colref()]
        while self.peek() == ("punct", ","):
            self.next()
            args.append(self.colref())
        self.expect("punct", ")")
        return Call(fname, args)

    def colref(self) -> ColRef:
        t = self.expect("name")
        self.expect("punct", ".")
        a = self.expect("name")
        return ColRef(t, a)

    def opt_alias(self) -> Optional[str]:
        if self.at_kw("AS"):
            self.next()
            return self.expect("name")
        return None

    def table_ref(self) -> Tuple[str, str]:
        name = self.expect("name")
        k, v = self.peek()
        if k == "name":  # alias
            self.next()
            return (name, v)
        return (name, name)

    def cond(self) -> Tuple[ColRef, object]:
        lhs = self.colref()
        self.expect("punct", "=")
        k, v = self.peek()
        if k == "int":
            self.next()
            return (lhs, int(v))
        return (lhs, self.colref())


# ---------------------------------------------------------------------------
# Compiler: AST → FRA
# ---------------------------------------------------------------------------


@dataclass
class _Rel:
    """A compiled relation: FRA node + output key attribute names."""

    node: fra.Node
    key_attrs: Tuple[str, ...]


def _kernel_name(fn: str) -> str:
    name = _FN_ALIASES.get(fn.lower(), fn.lower())
    if name in _BIN or name in _UNARY:
        return name
    if fn.upper() in ("AVG", "MIN", "COUNT", "STDDEV", "MEDIAN", "VAR"):
        raise SQLError(
            f"unsupported aggregate {fn!r} "
            f"(supported aggregates: {sorted(_AGG_NAMES)})",
            code="unsupported-aggregate",
            hint="only additive-monoid aggregates differentiate; "
                 "rewrite AVG as SUM over a pre-scaled value",
        )
    raise SQLError(f"unknown kernel function {fn!r} "
                   f"(registered: {sorted(set(_BIN) | set(_UNARY))})",
                   code="unknown-kernel",
                   hint="register the kernel in core/kernels.py or use a "
                        "registered alias (matrix_multiply, multiply, add)")


def _key_pos(rel: _Rel, attr: str, table: str) -> int:
    try:
        return rel.key_attrs.index(attr)
    except ValueError:
        raise SQLError(
            f"{table}.{attr} is not a key attribute of {table} "
            f"(keys: {rel.key_attrs})",
            code="unknown-column",
            hint=f"key columns of {table} are {list(rel.key_attrs)}; "
                 "any other attribute refers to the tuple's value",
        ) from None


def _is_value_attr(rel: _Rel, attr: str) -> bool:
    return attr not in rel.key_attrs


def _compile_select(
    stmt: SelectStmt,
    env: Dict[str, _Rel],
) -> _Rel:
    # resolve FROM tables
    rels: Dict[str, _Rel] = {}
    order: List[str] = []
    for name, alias in stmt.tables:
        if name not in env:
            raise SQLError(
                f"unknown relation {name!r}",
                code="unknown-relation",
                hint=f"known relations and views: {sorted(env)}",
            )
        if alias in rels:
            raise SQLError(f"duplicate table alias {alias!r}",
                           code="duplicate-alias")
        rels[alias] = env[name]
        order.append(alias)
    if len(order) > 2:
        raise SQLError(
            "at most two tables per SELECT (use views to chain)",
            code="too-many-tables",
            hint="chain joins through named views: "
                 "v := SELECT ... FROM a, b ...; SELECT ... FROM v, c ...",
        )

    val = stmt.val_item
    # value argument tables, in call order
    if val.call is not None:
        vargs = val.call.args
    else:
        vargs = [val.col] if val.col is not None else []
    for a in vargs:
        if a.table not in rels:
            raise SQLError(f"unknown table {a.table!r} in value expression",
                           code="unknown-table",
                           hint=f"tables in scope: {sorted(rels)}")
        if not _is_value_attr(rels[a.table], a.attr):
            raise SQLError(
                f"{a.table}.{a.attr} is a key, not a value",
                code="key-as-value",
                hint="kernel arguments must be value attributes; key "
                     "columns only join, select, and group",
            )

    if len(order) == 1:
        return _compile_single(stmt, rels, order[0], vargs)
    return _compile_join(stmt, rels, order, vargs)


def _compile_single(stmt, rels, t, vargs) -> _Rel:
    rel = rels[t]
    arity = rel.node.key_arity
    val = stmt.val_item

    # σ predicate from WHERE (key = literal only, single table)
    eqs = []
    for lhs, rhs in stmt.conds:
        if not isinstance(rhs, int):
            raise SQLError("single-table WHERE must compare a key to an integer")
        eqs.append((_key_pos(rel, lhs.attr, t), rhs))
    pred = SelPred(tuple(eqs))

    # kernel
    if val.call is not None:
        kname = _kernel_name(val.call.fn)
        if kname not in _UNARY:
            raise SQLError(f"{val.call.fn} is binary; single-table SELECT "
                           "needs a unary kernel")
        kern = unary(kname)
    else:
        kern = IDENT

    # projection from the key items
    comps = tuple(In(_key_pos(rel, c.attr, t)) for c, _ in stmt.key_items)
    out_attrs = tuple(
        alias or c.attr for c, alias in stmt.key_items
    )

    if val.aggfn is None:
        if not stmt.key_items:   # keep all keys
            comps = tuple(In(i) for i in range(arity))
            out_attrs = rel.key_attrs
        node = fra.Select(pred, KeyFn(comps), kern, rel.node)
        return _Rel(node, out_attrs)

    # aggregation: optional σ first (for kernel/pred), then Σ
    child = rel.node
    if not pred.always_true or kern is not IDENT:
        child = fra.Select(pred, KeyFn(tuple(In(i) for i in range(arity))),
                           kern, child)
    grp_cols = stmt.group_by or []
    if [c.attr for c in grp_cols] != [c.attr for c, _ in stmt.key_items]:
        raise SQLError(
            f"GROUP BY columns {[c.attr for c in grp_cols]} must match the "
            f"SELECT key columns {[c.attr for c, _ in stmt.key_items]}",
            code="group-by-mismatch",
            hint="list the same key columns, in the same order, in both "
                 "the SELECT items and the GROUP BY clause",
        )
    grp = KeyFn(tuple(In(_key_pos(rel, c.attr, t)) for c in grp_cols))
    node = fra.Agg(grp, agg(val.aggfn), child)
    return _Rel(node, out_attrs)


def _compile_join(stmt, rels, order, vargs) -> _Rel:
    val = stmt.val_item
    if val.call is None or len(vargs) != 2:
        raise SQLError("two-table SELECT needs a binary kernel call")
    kname = _kernel_name(val.call.fn)
    if kname not in _BIN:
        raise SQLError(f"{val.call.fn} is not a binary kernel")
    kern = bin_kernel(kname)

    # left = table of the first kernel argument (paper: ⊗(valL, valR))
    lt = vargs[0].table
    rt = vargs[1].table
    if {lt, rt} != set(order):
        raise SQLError("value expression must use both joined tables")
    lrel, rrel = rels[lt], rels[rt]

    def side_comp(c: ColRef):
        if c.table == lt:
            return L(_key_pos(lrel, c.attr, lt))
        if c.table == rt:
            return R(_key_pos(rrel, c.attr, rt))
        raise SQLError(f"unknown table {c.table!r}")

    eqs = []
    for lhs, rhs in stmt.conds:
        if isinstance(rhs, int):
            eqs.append((side_comp(lhs), Lit(rhs)))
        else:
            eqs.append((side_comp(lhs), side_comp(rhs)))
    pred = JoinPred(tuple(eqs))

    out_attrs = tuple(alias or c.attr for c, alias in stmt.key_items)

    if val.aggfn is None:
        comps = tuple(side_comp(c) for c, _ in stmt.key_items)
        node: fra.Node = fra.Join(pred, JoinProj(comps), kern,
                                  lrel.node, rrel.node)
        return _Rel(node, out_attrs)

    # Aggregated join — compile exactly as the paper does for its matmul
    # SQL: the join proj keeps the full keyL plus every keyR component not
    # already determined by keyL through the join predicate, and the Σ grp
    # projects the SELECT keys out of that composite key.
    grp_cols = stmt.group_by or []
    if [c.attr for c in grp_cols] != [c.attr for c, _ in stmt.key_items]:
        raise SQLError(
            f"GROUP BY columns {[c.attr for c in grp_cols]} must match the "
            f"SELECT key columns {[c.attr for c, _ in stmt.key_items]}",
            code="group-by-mismatch",
            hint="list the same key columns, in the same order, in both "
                 "the SELECT items and the GROUP BY clause",
        )

    from .keys import join_equiv_classes

    al, ar = lrel.node.key_arity, rrel.node.key_arity
    uf = join_equiv_classes(pred, al, ar)
    left_roots = {uf.find(L(i)) for i in range(al)}
    proj_comps: List[object] = [L(i) for i in range(al)]
    pos_of: Dict[object, int] = {L(i): i for i in range(al)}
    for j in range(ar):
        if uf.find(R(j)) in left_roots:
            # equivalent to some left component — record that position
            for i in range(al):
                if uf.find(L(i)) == uf.find(R(j)):
                    pos_of[R(j)] = i
                    break
        else:
            pos_of[R(j)] = len(proj_comps)
            proj_comps.append(R(j))

    grp_comps = tuple(In(pos_of[side_comp(c)]) for c, _ in stmt.key_items)
    node = fra.Join(pred, JoinProj(tuple(proj_comps)), kern,
                    lrel.node, rrel.node)
    node = fra.Agg(KeyFn(grp_comps), agg(val.aggfn), node)
    return _Rel(node, out_attrs)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def compile_sql(
    script: str,
    schema: Dict[str, Sequence[str]],
    inputs: Sequence[str] = (),
) -> fra.Query:
    """Compile a SQL script to an FRA ``Query``.

    ``schema`` maps base-relation names to their key attribute names.
    ``inputs`` names the relations to treat as differentiable variable
    inputs (TableScan leaves); all other relations are constants
    (⋈_const operands / training data).
    """
    stmts = _Parser(_tokenize(script)).script()
    env: Dict[str, _Rel] = {}
    for name, attrs in schema.items():
        arity = len(attrs)
        leaf = (
            fra.scan(name, arity) if name in inputs else fra.const(name, arity)
        )
        env[name] = _Rel(leaf, tuple(attrs))

    last: Optional[_Rel] = None
    for i, (name, stmt) in enumerate(stmts):
        label = f"stmt[{i}]" if name is None else f"stmt[{i}]:{name}"
        token = _CURRENT_STMT.set(label)
        try:
            rel = _compile_select(stmt, env)
            if name is not None:
                if name in env:
                    raise SQLError(
                        f"view {name!r} shadows an existing relation",
                        code="view-shadows-relation",
                        hint="pick a view name outside the schema: "
                             f"{sorted(schema)}",
                    )
                env[name] = rel
        finally:
            _CURRENT_STMT.reset(token)
        last = rel
    assert last is not None
    missing = set(inputs) - {s.name for s in last.node.table_scans()}
    if missing:
        raise SQLError(
            f"declared inputs never scanned: {missing}",
            code="unused-input",
            hint="every wrt= input must appear in a FROM clause that "
                 "reaches the final statement",
        )
    return fra.Query(last.node, inputs=tuple(inputs))


def sql_autodiff(script: str, schema, inputs):
    """compile_sql + ra_autodiff in one call."""
    from .autodiff import ra_autodiff

    return ra_autodiff(compile_sql(script, schema, inputs))
