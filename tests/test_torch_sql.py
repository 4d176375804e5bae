"""The port's SQL front door (repro_torch.core.sql, Database.sql / check /
explain) against the JAX package's: the same FRA trees from the same SQL,
the same structured errors, the same forward values and gradients through
``db.sql``, the quickstart's training curve, ``Database.check``'s codes on
the typed-checker cases that need no mesh, and ``explain``'s text. Inputs
come from numpy with a seed; JAX arrays are pinned to float32 and int32
(other test modules flip JAX's x64 switch at import)."""

import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import fra as jfra
from repro.core import keys as jkeys
from repro.core import kernels as jkernels
from repro.core.relation import CooRelation as JCoo
from repro.core.relation import DenseRelation as JDense
from repro.core.sql import SQLError as JSQLError
from repro.core.sql import compile_sql as jcompile_sql

import repro_torch
from repro_torch.core import fra as tfra
from repro_torch.core import keys as tkeys
from repro_torch.core import kernels as tkernels
from repro_torch.core.relation import CooRelation as TCoo
from repro_torch.core.sql import SQLError, compile_sql, sql_autodiff
from repro_torch.examples import quickstart
from torch_tiers import map_tiers

ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]

MATMUL_SQL = """
SELECT A.row, B.col, SUM(matrix_multiply(A.mat, B.mat))
FROM A, B WHERE A.col = B.row
GROUP BY A.row, B.col
"""
MATMUL_SCHEMA = {"A": ("row", "col"), "B": ("row", "col")}
LOGREG_SCHEMA = {"Rx": ("row", "col"), "theta": ("col",), "Ry": ("row",)}
LOGREG_SQL = quickstart.LOGREG_SQL

# (script, schema, inputs) that compile: every script of tests/test_sql.py,
# and the grammar's other forms
SCRIPTS = {
    "paper matmul": (MATMUL_SQL, MATMUL_SCHEMA, ("A", "B")),
    "logreg views": (LOGREG_SQL, LOGREG_SCHEMA, ("theta",)),
    "selection with a literal": ("SELECT T.i, relu(T.v) FROM T WHERE T.i = 1", {"T": ("i",)}, ("T",)),
    "single-table Σ": ("SELECT A.row, SUM(A.val) FROM A GROUP BY A.row", MATMUL_SCHEMA, ("A",)),
    "MAX aggregate": ("SELECT A.col, MAX(A.val) AS m FROM A GROUP BY A.col", MATMUL_SCHEMA, ("A",)),
    "unaggregated join": ("SELECT A.row, B.col, multiply(A.val, B.val) FROM A, B "
                          "WHERE A.col = B.row", MATMUL_SCHEMA, ("A", "B")),
    "join with a literal, aliases, comment": (
        "-- one row of A against B\n"
        "SELECT a.row, SUM(multiply(a.val, b.val)) FROM A a, B b "
        "WHERE a.col = b.row AND a.row = 1 GROUP BY a.row", MATMUL_SCHEMA, ("A",)),
    "kernel by its registered name": (
        "SELECT A.row, B.col, SUM(matmul(A.mat, B.mat)) FROM A, B WHERE A.col = B.row "
        "GROUP BY A.row, B.col;", MATMUL_SCHEMA, ("B",)),
}

_S = {"A": ("row", "col"), "B": ("row", "col")}

# (script, schema, inputs) that fail: every error case of tests/test_sql.py,
# and the frontend's other errors
ERRORS = {
    "unknown kernel": ("SELECT frobnicate(T.v) FROM T", {"T": ("i",)}, ("T",)),
    "three tables": ("SELECT SUM(multiply(A.v, B.v)) FROM A, B, C",
                     {"A": ("i",), "B": ("i",), "C": ("i",)}, ("A",)),
    "key as value": ("SELECT logistic(T.i) FROM T", {"T": ("i",)}, ("T",)),
    "group by mismatch (join)": ("SELECT A.row, SUM(multiply(A.v, B.v)) FROM A, B "
                                 "WHERE A.col = B.col GROUP BY A.col",
                                 {"A": ("row", "col"), "B": ("col",)}, ("A",)),
    "unknown relation": ("SELECT Foo.row, SUM(Foo.val) FROM Foo GROUP BY Foo.row", _S, ()),
    "unknown key column": ("SELECT A.bogus, SUM(A.val) FROM A GROUP BY A.bogus", _S, ("A",)),
    "unknown table in value": ("SELECT A.row, SUM(multiply(A.val, C.val)) FROM A, B "
                               "WHERE A.col = B.row GROUP BY A.row", _S, ("A",)),
    "AVG": ("SELECT A.row, AVG(A.val) FROM A GROUP BY A.row", _S, ("A",)),
    "unknown kernel (single table)": ("SELECT A.row, frobnicate(A.val) FROM A", _S, ("A",)),
    "join on a value": ("SELECT A.row, B.col, SUM(multiply(A.val, B.val)) "
                        "FROM A, B WHERE A.val = B.row GROUP BY A.row, B.col", _S, ("A",)),
    "key as kernel argument": ("SELECT A.col, SUM(multiply(A.row, B.val)) FROM A, B "
                               "WHERE A.col = B.row GROUP BY A.col", _S, ("A",)),
    "group by mismatch": ("SELECT A.row, SUM(A.val) FROM A GROUP BY A.col", _S, ("A",)),
    "duplicate alias": ("SELECT x.row, SUM(multiply(x.val, x.val)) FROM A x, B x "
                        "WHERE x.col = x.row GROUP BY x.row", _S, ("A",)),
    "ghost relation": ("SELECT SUM(Ghost.val) FROM Ghost", LOGREG_SCHEMA, ()),
    "error in the second statement": (
        "mm := SELECT Rx.row, SUM(multiply(Rx.val, theta.val)) "
        "FROM Rx, theta WHERE Rx.col = theta.col GROUP BY Rx.row;\n"
        "SELECT SUM(mm.val) FROM mm GROUP BY mm.nope", LOGREG_SCHEMA, ()),
    "Σ over a key": ("SELECT Rx.row, SUM(Rx.col) FROM Rx GROUP BY Rx.row", LOGREG_SCHEMA, ()),
    "empty script": ("  -- nothing\n", _S, ()),
    "cannot tokenize": ("SELECT A.row, SUM(A.val) FROM A $", _S, ()),
    "no value expression": ("SELECT A.row FROM A", _S, ()),
    "view shadows a relation": ("A := SELECT A.row, SUM(A.val) FROM A GROUP BY A.row; "
                                "SELECT SUM(A.val) FROM A", _S, ()),
    "input never scanned": ("SELECT A.row, SUM(A.val) FROM A GROUP BY A.row", _S, ("B",)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_compile_sql_builds_the_reference_tree(name):
    script, schema, inputs = SCRIPTS[name]
    jq = jcompile_sql(script, schema, inputs)
    tq = compile_sql(script, schema, inputs)
    assert tq.pretty() == jq.pretty()
    assert tq.inputs == jq.inputs
    assert tq.root.key_arity == jq.root.key_arity


_LISTING = re.compile(r"\(registered: (\[.*?\])\)")


def _listing(text: str):
    """The kernel names an "unknown kernel" text lists (None without)."""
    m = _LISTING.search(text)
    return None if m is None else re.findall(r"'([^']*)'", m.group(1))


def _errors(name):
    """Each package's error on ERRORS[name], the reference's first: its
    severity, code, node path, message, hint and text, and whether it is a
    ValueError."""
    script, schema, inputs = ERRORS[name]
    out = []
    for compile_, err in ((jcompile_sql, JSQLError), (compile_sql, SQLError)):
        with pytest.raises(err) as e:
            compile_(script, schema, inputs)
        d = e.value.diagnostic
        out.append([str(d.severity), str(d.code), str(d.node_path), d.message, d.hint, str(e.value),
                    isinstance(e.value, ValueError)])
    return out


def _errors_after_the_same_queries():
    """Every ERRORS case's ``_errors``, after both packages built and
    stepped the same SQL queries (the logistic regression's step and the
    matrix product's gradient), which register the same derived kernels
    (``vjp1[...]``, ``partiall[...]``) in each package's registry."""
    test_db_sql_logreg_step_matches_the_reference()
    test_db_sql_matmul_forward_and_grad_match_the_reference()
    return {name: _errors(name) for name in ERRORS}


@pytest.fixture(scope="module")
def fresh_errors():
    """``_errors_after_the_same_queries()`` from a fresh process, where no
    other test module has built a query."""
    code = "import json, test_torch_sql as t; print(json.dumps(t._errors_after_the_same_queries()))"
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": path})
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_sql_errors_match_the_reference(name, fresh_errors):
    """The same error, word for word, in a fresh process where both
    packages built the same queries first. In this process too, but for
    the "(registered: [...])" listing of an unknown kernel: it lists the
    process's kernel registry, which also holds the kernels that the
    queries built so far derived, and those differ between the packages
    with the test modules that ran before in the process; there each
    listing must be its own package's registry."""
    jerr, terr = fresh_errors[name]
    assert terr == jerr
    listed = _listing(terr[3])
    if listed is not None:
        assert {"vjp1[logistic]", "partiall[xent]"} <= set(listed)
    (*jfields, jtext, jvalue), (*tfields, ttext, tvalue) = _errors(name)
    cut = lambda text: _LISTING.sub("(registered: [...])", text)  # noqa: E731
    assert tfields[:3] == jfields[:3]
    assert (cut(tfields[3]), tfields[4]) == (cut(jfields[3]), jfields[4])
    assert cut(ttext) == cut(jtext)
    assert tvalue and jvalue
    tl, jl = _listing(tfields[3]), _listing(jfields[3])
    assert (tl is None) == (jl is None)
    if tl is not None:
        assert tl == sorted(set(tkernels._BIN) | set(tkernels._UNARY))
        assert jl == sorted(set(jkernels._BIN) | set(jkernels._UNARY))


def test_sql_errors_match_the_reference_after_the_mesh_tests_queries_ran(fresh_errors):
    """tests/test_torch_mesh.py's query built and stepped first in this
    process (as when both files run in one worker), which registers derived
    kernels in the port's registry only; the error texts still match."""
    import torch_mesh_workers

    torch_mesh_workers.query_step(repro_torch.Database(device="cpu"), torch_mesh_workers.problem()[0])
    assert set(tkernels._UNARY) | set(tkernels._BIN) != set(jkernels._UNARY) | set(jkernels._BIN)
    for name in ("unknown kernel", "unknown kernel (single table)"):
        test_sql_errors_match_the_reference(name, fresh_errors)


def test_sql_error_is_exported():
    assert repro_torch.SQLError is SQLError
    assert isinstance(SQLError("x").diagnostic, repro_torch.Diagnostic)


def _dbs(arrays, keys):
    jdb = repro.Database()
    tdb = repro_torch.Database(device="cpu")
    for name, a in arrays.items():
        jdb.put(name, jnp.asarray(a, jnp.float32), keys=keys[name])
        tdb.put(name, torch.tensor(a), keys=keys[name])
    return jdb, tdb


def test_db_sql_matmul_forward_and_grad_match_the_reference():
    rng = np.random.default_rng(7)
    arrays = {n: rng.normal(size=(2, 3, 4, 4)).astype(np.float32) for n in "A"}
    arrays["B"] = rng.normal(size=(3, 2, 4, 5)).astype(np.float32)
    jdb, tdb = _dbs(arrays, MATMUL_SCHEMA)
    jh, th = jdb.sql(MATMUL_SQL, wrt=("A", "B")), tdb.sql(MATMUL_SQL, wrt=("A", "B"))
    jout, tout = jh.forward(), th.forward()
    np.testing.assert_allclose(tout.data.numpy(), np.asarray(jout.data), atol=ATOL)
    seed = rng.normal(size=tuple(tout.data.shape)).astype(np.float32)
    jg = jh.grad(seed=jnp.asarray(seed, jnp.float32))
    tg = th.grad(seed=torch.tensor(seed))
    for name in ("A", "B"):
        np.testing.assert_allclose(tg[name].data.numpy(), np.asarray(jg[name].data), atol=ATOL)
    assert th.lower_count == 2  # the forward query and the gradient program


def test_db_sql_logreg_step_matches_the_reference():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(32, 6)).astype(np.float32)
    arrays = {"Rx": X, "Ry": (rng.uniform(size=32) > 0.5).astype(np.float32),
              "theta": (rng.normal(size=6) * 0.1).astype(np.float32)}
    jdb, tdb = _dbs(arrays, LOGREG_SCHEMA)
    jl, jg = jdb.sql(LOGREG_SQL, wrt=("theta",)).step()
    tl, tg = tdb.sql(LOGREG_SQL, wrt=("theta",)).step()
    np.testing.assert_allclose(float(tl.data), float(jl.data), atol=ATOL)
    np.testing.assert_allclose(tg["theta"].data.numpy(), np.asarray(jg["theta"].data), atol=ATOL)


def _numbered(text):
    """``text`` with the forward-node ids of ``__fwd_<id>`` references
    renumbered in order of appearance: the ids count the nodes each
    process has built, which differ between the packages."""
    ids = {}
    return re.sub(r"__fwd_(\d+)", lambda m: f"__fwd_#{ids.setdefault(m.group(1), len(ids))}", text)


def test_sql_autodiff_gives_the_reference_gradient_queries():
    from repro.core.sql import sql_autodiff as jsql_autodiff

    jp = jsql_autodiff(LOGREG_SQL, LOGREG_SCHEMA, ("theta",))
    tp = sql_autodiff(LOGREG_SQL, LOGREG_SCHEMA, ("theta",))
    assert tp.forward.pretty() == jp.forward.pretty()
    assert "__fwd_" in tp.grads["theta"].pretty()
    assert _numbered(tp.grads["theta"].pretty()) == _numbered(jp.grads["theta"].pretty())


def test_quickstart_matches_the_reference_step_for_step():
    """The quickstart's SQL and update (step 1/n on theta from zero) in
    both packages on the same data: five equal losses."""
    ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    assert quickstart.LOGREG_SQL == ref["LOGREG_SQL"]
    assert quickstart.logreg_query().pretty() == ref["logreg_query"]().pretty()

    rng = np.random.default_rng(0)
    n, m = 256, 16
    X = rng.normal(size=(n, m)).astype(np.float32)
    y = (X @ rng.normal(size=m) > 0).astype(np.float32)

    tdb = repro_torch.Database(device="cpu")
    quickstart.load(tdb, torch.tensor(X), torch.tensor(y))
    handle = tdb.sql(LOGREG_SQL, wrt=("theta",))
    t_losses, theta = quickstart.train(tdb, handle, 5)

    jdb = repro.Database()
    jdb.put("Rx", jnp.asarray(X, jnp.float32), keys=("row", "col"))
    jdb.put("Ry", jnp.asarray(y, jnp.float32), keys=("row",))
    jdb.put("theta", jnp.zeros((m,), jnp.float32), keys=("col",))
    jh = jdb.sql(ref["LOGREG_SQL"], wrt=("theta",))
    j_losses = []
    for _ in range(5):
        loss, grads = jh.step()
        jdb.put("theta", jdb.get("theta").data - (1.0 / n) * grads["theta"].data)
        j_losses.append(float(loss.data))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jdb.get("theta").data), atol=ATOL)
    assert t_losses[-1] < t_losses[0]
    assert handle.lower_count == 1


def test_quickstart_main_trains_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "train accuracy" in out and "graph lowerings over 50 steps: 1" in out
    assert "kernel certification:" in out


# ---------------------------------------------------------------------------
# Database.check on the typed-checker cases of tests/test_check.py that need
# no mesh, built in both packages from the same description
# ---------------------------------------------------------------------------


def _z(*shape, dtype=np.float32):
    return ("dense", np.zeros(shape, dtype=dtype))


def _coo(nnz, *extents):
    return ("coo", nnz, extents)


def _matmul_join(fra, K, k):
    return fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1), K.R(1)), k.MATMUL,
                    fra.scan("A", 2), fra.scan("B", 2))


# name -> (query maker (fra, keys, kernels), tables {name: spec}, wrt)
CHECK_CASES = {
    "unknown_relation": (lambda fra, K, k: fra.scan("Ghost", 2), {"A": _z(3, 4)}, ()),
    "arity_mismatch": (lambda fra, K, k: fra.scan("A", 3), {"A": _z(3, 4)}, ()),
    "join_extent_mismatch": (
        lambda fra, K, k: fra.Query(fra.Agg(K.project_key(0, 2), k.ADD, _matmul_join(fra, K, k)),
                                    inputs=("A", "B")),
        {"A": _z(3, 4), "B": _z(5, 6)}, ()),
    "dtype_promotion": (
        lambda fra, K, k: fra.Query(fra.Agg(K.project_key(0, 2), k.ADD, _matmul_join(fra, K, k)),
                                    inputs=("A", "B")),
        {"A": _z(3, 4), "B": _z(4, 6, dtype=np.float64)}, ()),
    "non_permutation_select": (
        lambda fra, K, k: fra.Select(K.TRUE, K.KeyFn((K.In(0),)), k.IDENT, fra.scan("A", 2)),
        {"A": _z(3, 4)}, ()),
    "projects_fixed": (
        lambda fra, K, k: fra.Select(K.SelPred(((0, 1),)), K.identity_key(2), k.IDENT,
                                     fra.scan("A", 2)),
        {"A": _z(3, 4)}, ()),
    "duplicate_group": (
        lambda fra, K, k: fra.Agg(K.KeyFn((K.In(0), K.In(0))), k.ADD, fra.scan("A", 2)),
        {"A": _z(3, 4)}, ()),
    "non_additive_agg": (
        lambda fra, K, k: fra.Agg(K.project_key(0), k.MAX, fra.scan("A", 2)),
        {"A": _z(3, 4)}, ()),
    "coo_coo_join": (
        lambda fra, K, k: fra.Agg(K.identity_key(2), k.ADD, fra.Join(
            K.eq_pred((0, 0)), K.jproj(K.L(0), K.L(1)), k.MUL, fra.scan("E", 2), fra.scan("F", 2))),
        {"E": _coo(8, 5, 5), "F": _coo(8, 5, 5)}, ()),
    "coo_predicate": (
        lambda fra, K, k: fra.Select(K.SelPred(((0, 1),)), K.identity_key(2), k.IDENT,
                                     fra.scan("E", 2)),
        {"E": _coo(8, 5, 5)}, ()),
    "join_drops_class": (
        lambda fra, K, k: fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0)), k.MUL,
                                   fra.scan("A", 2), fra.scan("B", 2)),
        {"A": _z(3, 4), "B": _z(4, 6)}, ()),
    "partial_rjp": (
        lambda fra, K, k: fra.Agg(K.identity_key(1), k.ADD, fra.Join(
            K.eq_pred((1, 0)), K.jproj(K.R(1)), k.MUL, fra.scan("A", 2), fra.scan("B", 2))),
        {"A": _z(3, 4), "B": _z(4, 6)}, ("A",)),
    "empty_selection": (
        lambda fra, K, k: fra.Select(K.SelPred(((0, 99),)), K.KeyFn((K.In(1),)), k.IDENT,
                                     fra.scan("A", 2)),
        {"A": _z(3, 4)}, ()),
    "clean matmul": (
        lambda fra, K, k: fra.Query(fra.Agg(K.project_key(0, 2), k.ADD, _matmul_join(fra, K, k)),
                                    inputs=("A", "B")),
        {"A": _z(3, 4), "B": _z(4, 6)}, ()),
}

CHECK_SCHEMA = {"A": ("row", "col"), "B": ("row", "col"), "E": ("src", "dst"), "F": ("src", "dst")}


def _checked_dbs(tables):
    jdb = repro.Database()
    tdb = repro_torch.Database(device="cpu")
    for name, spec in tables.items():
        keys = CHECK_SCHEMA[name]
        if spec[0] == "dense":
            # the JAX relation holds the numpy array itself, as in
            # tests/test_check.py: f64 stays f64 whatever JAX's x64 switch
            a = spec[1]
            jdb.put(name, JDense(a, a.ndim), keys=keys)
            tdb.put(name, torch.tensor(a), keys=keys)
        else:
            _, nnz, extents = spec
            k = np.zeros((nnz, len(extents)), np.int32)
            v = np.zeros((nnz,), np.float32)
            jdb.put(name, JCoo(jnp.asarray(k, jnp.int32), jnp.asarray(v, jnp.float32), extents),
                    keys=keys)
            tdb.put(name, TCoo(torch.tensor(k), torch.tensor(v), extents), keys=keys)
    return jdb, tdb


@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_db_check_gives_the_reference_diagnostics(name):
    make, tables, wrt = CHECK_CASES[name]
    jdb, tdb = _checked_dbs(tables)
    jrep = jdb.check(make(jfra, jkeys, jkernels), wrt=wrt)
    trep = tdb.check(make(tfra, tkeys, tkernels), wrt=wrt)
    assert trep.codes() == jrep.codes()
    assert trep.ok == jrep.ok
    assert [d.node_path for d in trep.diagnostics] == [d.node_path for d in jrep.diagnostics]
    assert [d.severity for d in trep.diagnostics] == [d.severity for d in jrep.diagnostics]
    if name != "clean matmul":
        assert trep.diagnostics


def test_query_handle_check_defaults_to_its_gradient_targets():
    _, tables, _ = CHECK_CASES["partial_rjp"]
    jdb, tdb = _checked_dbs(tables)
    make = CHECK_CASES["partial_rjp"][0]
    jh = jdb.query(make(jfra, jkeys, jkernels), wrt=("A",))
    th = tdb.query(make(tfra, tkeys, tkernels), wrt=("A",))
    assert th.check().codes() == jh.check().codes()
    assert "partial-rjp" in " ".join(th.check().codes())


# ---------------------------------------------------------------------------
# explain: every section the port has is the reference's text
# ---------------------------------------------------------------------------


def _sections(text):
    """explain's text up to its kernel-certification section, and that
    section."""
    head, _, tail = text.partition("kernel certification:")
    return head, tail


def _chain3(fra, K, k):
    j1 = fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1), K.R(1)), k.MUL,
                  fra.scan("A", 2), fra.scan("B", 2))
    j2 = fra.Join(K.eq_pred((2, 0)), K.jproj(K.L(0), K.L(1), K.L(2), K.R(1)), k.MUL,
                  j1, fra.scan("C", 2))
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, fra.Agg(K.project_key(0, 3), k.ADD, j2)),
                     inputs=("A", "B", "C"))


@pytest.mark.parametrize("rewrite", [True, False])
@pytest.mark.parametrize("case", ["sql logreg", "sql matmul", "Σ pushdown fires", "extent mismatch"])
def test_explain_matches_the_reference_text(case, rewrite):
    rng = np.random.default_rng(11)
    if case == "sql logreg":
        arrays = {"Rx": rng.normal(size=(8, 3)), "Ry": rng.uniform(size=8), "theta": rng.normal(size=3)}
        keys = LOGREG_SCHEMA
    elif case == "sql matmul":
        arrays = {"A": rng.normal(size=(2, 2, 3, 3)), "B": rng.normal(size=(2, 2, 3, 3))}
        keys = MATMUL_SCHEMA
    elif case == "Σ pushdown fires":
        arrays = {n: rng.normal(size=(6, 6)) for n in "ABC"}
        keys = {n: ("i", "j") for n in "ABC"}
    else:
        arrays = {"A": rng.normal(size=(3, 4)), "B": rng.normal(size=(5, 6))}
        keys = MATMUL_SCHEMA
    arrays = {n: a.astype(np.float32) for n, a in arrays.items()}
    jdb, tdb = repro.Database(rewrite=rewrite), repro_torch.Database(device="cpu", rewrite=rewrite)
    for name, a in arrays.items():
        jdb.put(name, jnp.asarray(a, jnp.float32), keys=keys[name])
        tdb.put(name, torch.tensor(a), keys=keys[name])
    if case.startswith("sql"):
        sql = LOGREG_SQL if case == "sql logreg" else MATMUL_SQL
        jq = jdb.sql(sql, wrt=tuple(arrays)[-1:]).query
        tq = tdb.sql(sql, wrt=tuple(arrays)[-1:]).query
    elif case == "Σ pushdown fires":
        jq, tq = _chain3(jfra, jkeys, jkernels), _chain3(tfra, tkeys, tkernels)
    else:
        jq = CHECK_CASES["join_extent_mismatch"][0](jfra, jkeys, jkernels)
        tq = CHECK_CASES["join_extent_mismatch"][0](tfra, tkeys, tkernels)
    jtext, ttext = jdb.explain(jq), tdb.explain(tq)
    assert _sections(ttext)[0] == _sections(jtext)[0]
    # the kernel section: the reference's, its tier names mapped to the
    # port's (test_torch_kernelcheck.TIER_NAMES)
    assert _sections(ttext)[1] == map_tiers(_sections(jtext)[1])
    assert "dispatch site(s): ok" in ttext or "(skipped: typed check failed)" in ttext
    if case == "Σ pushdown fires":
        # the gate's verdicts show either way; with the stage off the plan
        # stays as it was
        assert "FIRED" in ttext
        assert ("rewrite stage is OFF" in ttext) == (not rewrite)
    if case == "extent mismatch":
        assert "join-extent-mismatch" in ttext
