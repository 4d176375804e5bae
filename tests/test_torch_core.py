"""The port's engine core (repro_torch.core) against the JAX package's.

Covers the dispatch table (defaults per device type, forced tiers, a dtype
the cuda tier's predicate refuses falling through and being recorded), the
interpreter and RA auto-diff on queries of tests/test_core_autodiff.py, the
chunked compiler's forward and gradients against
``repro.core.engine.RAEngine(...).eager(env, dispatch="ref")``, the
mandatory validate stage, and the rewrite stage. Inputs come from numpy
with a seed; JAX arrays are pinned to float32 (other test modules flip
JAX's x64 switch at import).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fra as jfra
from repro.core import keys as jkeys
from repro.core import kernels as jkernels
from repro.core.autodiff import ra_autodiff as jax_ra_autodiff
from repro.core.engine import RAEngine as JaxEngine
from repro.core.interpreter import run_query as jax_run_query
from repro.core.relation import CooRelation as JCoo
from repro.core.relation import DenseRelation as JDense

import repro_torch
from repro_torch import convert
from repro_torch.analysis.typecheck import ValidationError
from repro_torch.core import compiler
from repro_torch.core import fra as tfra
from repro_torch.core import keys as tkeys
from repro_torch.core import kernels as tkernels
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.engine import RAEngine, _meta, engine_for
from repro_torch.core.interpreter import run_query
from repro_torch.core.relation import CooRelation, DenseRelation

ATOL = 1e-5

# Each query maker takes (fra, keys, kernels) so the same code builds the
# query in both packages.


def logreg_query(fra, K, k):
    mm = fra.Agg(
        K.project_key(0), k.ADD,
        fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1)), k.MUL,
                 fra.const("Rx", 2), fra.scan("theta", 1)),
    )
    pred = fra.Select(K.TRUE, K.identity_key(1), k.LOGISTIC, mm)
    loss = fra.Agg(
        K.EMPTY_KEY, k.ADD,
        fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(0)), k.XENT, pred, fra.const("Ry", 1)),
    )
    return fra.Query(loss, inputs=("theta",))


def matmul_loss_query(fra, K, k):
    join = fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1), K.R(1)), k.MUL,
                    fra.scan("A", 2), fra.scan("B", 2))
    prod = fra.Agg(K.project_key(0, 2), k.ADD, join)
    sq = fra.Select(K.TRUE, K.identity_key(2), k.SQUARE, prod)
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, sq), inputs=("A", "B"))


def fanout_query(fra, K, k):
    xs = fra.scan("X", 1)
    join = fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(0)), k.MUL, xs, xs)
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, join), inputs=("X",))


def finite_diff_query(fra, K, k):
    sq = fra.Select(K.TRUE, K.identity_key(2), k.SQUARE, fra.scan("W", 2))
    rowsum = fra.Agg(K.project_key(0), k.ADD, sq)
    sig = fra.Select(K.TRUE, K.identity_key(1), k.LOGISTIC, rowsum)
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, sig), inputs=("W",))


def gcn_query(fra, K, k):
    join = fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(1)), k.MUL,
                    fra.scan("Edge", 2), fra.scan("Node", 1))
    conv = fra.Agg(K.identity_key(1), k.ADD, join)
    sq = fra.Select(K.TRUE, K.identity_key(1), k.SUM_CHUNK,
                    fra.Select(K.TRUE, K.identity_key(1), k.SQUARE, conv))
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, sq), inputs=("Edge", "Node"))


def blocked_matmul_query(fra, K, k):
    join = fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1), K.R(1)), k.MATMUL,
                    fra.scan("X", 2), fra.scan("W", 2))
    prod = fra.Agg(K.project_key(0, 2), k.ADD, join)
    sq = fra.Select(K.TRUE, K.identity_key(2), k.SUM_CHUNK,
                    fra.Select(K.TRUE, K.identity_key(2), k.SQUARE, prod))
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, sq), inputs=("X", "W"))


def both(make_query):
    return make_query(jfra, jkeys, jkernels), make_query(tfra, tkeys, tkernels)


# ---------------------------------------------------------------------------
# Dispatch table
# ---------------------------------------------------------------------------


def test_default_tables_follow_the_device_type():
    cuda = tkernels.make_table(None, backend="cuda")
    cpu = tkernels.make_table(None, backend="cpu")
    for op in tkernels.DISPATCH_OPS:
        assert cuda.tiers(op) == ("cuda", "torch")
        assert cpu.tiers(op) == ("torch",)
    assert tkernels.make_table(cuda) is cuda
    with pytest.raises(ValueError, match="pinned"):
        tkernels.make_table(cuda, backend="cpu")


def test_forced_tiers_and_refusals():
    info = {"m": 4, "k": 3, "n": 2, "dtype": torch.float32}
    ref = tkernels.make_table("ref", backend="cpu")
    assert tkernels.resolve_impl("blocked_matmul", info, ref).tier == "ref"
    mixed = tkernels.make_table({"segment_sum": "ref"}, backend="cuda")
    assert mixed.tiers("segment_sum") == ("ref",)
    assert mixed.tiers("gather_join") == ("cuda", "torch")
    # the cuda tier exists only on a CUDA device: forcing it elsewhere raises
    forced = tkernels.make_table("cuda", backend="cpu")
    with pytest.raises(tkernels.KernelDispatchError):
        tkernels.resolve_impl("blocked_matmul", info, forced)
    with pytest.raises(ValueError, match="unknown tier"):
        tkernels.make_table("pallas", backend="cpu")


def test_dtype_outside_the_cuda_predicate_falls_through_and_is_recorded():
    """An f64 site resolves to torch under the cuda table, an f32 site to
    cuda; the lowering walk (meta tensors: nothing launches) records both."""
    table = tkernels.make_table(None, backend="cuda")
    f64 = {"m": 4, "k": 3, "n": 2, "dtype": torch.float64}
    assert tkernels.resolve_impl("blocked_matmul", f64, table).tier == "torch"
    _, q = both(gcn_query)
    rng = np.random.default_rng(0)
    keys = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    for dtype, tier in ((torch.float32, "cuda"), (torch.float64, "torch")):
        env = {
            "Edge": CooRelation(torch.tensor(keys), torch.ones(3, dtype=dtype), (3, 3)),
            "Node": DenseRelation(torch.tensor(rng.normal(size=(3, 4)), dtype=dtype), 1),
        }
        log = tkernels.ResolutionLog()
        meta_env = {n: _meta(r) for n, r in env.items()}
        compiler._execute_graph(q.root, meta_env, dispatch=table, resolutions=log)
        assert set(log.values()) == {tier}
        assert {s.op for s in log.sites} == {"gather_join", "segment_sum"}


# ---------------------------------------------------------------------------
# Interpreter and RA auto-diff
# ---------------------------------------------------------------------------


def _dict_rel(x):
    x = np.asarray(x, np.float64)
    return {tuple(int(i) for i in k): float(x[k]) for k in np.ndindex(*x.shape)}


@pytest.mark.parametrize(
    "make_query,arrays",
    [
        (logreg_query, {"Rx": (6, 4), "Ry": (6,), "theta": (4,)}),
        (matmul_loss_query, {"A": (3, 4), "B": (4, 2)}),
        (fanout_query, {"X": (4,)}),
        (finite_diff_query, {"W": (3, 3)}),
    ],
)
def test_interpreter_and_autodiff_match_reference(make_query, arrays):
    rng = np.random.default_rng(len(arrays))
    data = {n: rng.normal(size=s) * 0.5 for n, s in arrays.items()}
    if "Ry" in data:
        data["Ry"] = (data["Ry"] > 0).astype(np.float64)
    env = {n: _dict_rel(v) for n, v in data.items()}
    jq, tq = both(make_query)
    # Python floats: the port computes them in f64; JAX in f32 unless
    # another module switched x64 on — hence an f32-sized tolerance
    want = jax_run_query(jq, env)
    got = run_query(tq, env)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, abs=1e-6)
    jout, jgrads = jax_ra_autodiff(jq).eval(env)
    tout, tgrads = ra_autodiff(tq).eval(env)
    assert float(tout[()]) == pytest.approx(float(jout[()]), rel=1e-6)
    assert set(tgrads) == set(jgrads)
    for name in jgrads:
        assert set(tgrads[name]) == set(jgrads[name])
        for k, v in jgrads[name].items():
            assert float(tgrads[name][k]) == pytest.approx(float(v), rel=1e-6, abs=1e-6)


# ---------------------------------------------------------------------------
# Compiler parity against the reference compiler (forward + gradients)
# ---------------------------------------------------------------------------


def _envs(spec, seed):
    """(jax env, torch env) from {name: ("dense", array, arity) |
    ("coo", keys, values, extents)}."""
    jenv, tenv = {}, {}
    for name, s in spec.items():
        if s[0] == "dense":
            _, arr, arity = s
            jenv[name] = JDense(jnp.asarray(arr, jnp.float32), arity)
            tenv[name] = convert.dense_relation(arr, arity, "cpu")
        else:
            _, keys, vals, ext = s
            jenv[name] = JCoo(jnp.asarray(keys, jnp.int32), jnp.asarray(vals, jnp.float32), ext)
            tenv[name] = convert.coo_relation(keys, vals, ext, "cpu")
    return jenv, tenv


def _payload(rel):
    if hasattr(rel, "data"):
        return np.asarray(rel.data)
    return np.asarray(rel.values)


def _graph(rng, n, e, d):
    flat = rng.choice(n * n, size=e, replace=False)
    keys = np.stack([flat // n, flat % n], 1).astype(np.int32)
    return keys, rng.normal(size=e).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)


def _case(name, rng):
    f32 = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    if name == "dense_logreg":
        spec = {
            "Rx": ("dense", f32(12, 5), 2),
            "Ry": ("dense", (rng.uniform(size=12) > 0.5).astype(np.float32), 1),
            "theta": ("dense", f32(5), 1),
        }
        return logreg_query, spec
    if name == "coo_gcn_conv":
        keys, w, h = _graph(rng, 9, 30, 6)
        # a padded row (COO_PAD_KEY) rides along: it must stay inert
        keys = np.concatenate([keys, np.full((1, 2), -1, np.int32)])
        w = np.concatenate([w, np.zeros(1, np.float32)])
        return gcn_query, {"Edge": ("coo", keys, w, (9, 9)), "Node": ("dense", h, 1)}
    if name == "arity2_blocked_matmul":
        return blocked_matmul_query, {
            "X": ("dense", f32(2, 3, 4, 5), 2), "W": ("dense", f32(3, 2, 5, 3), 2),
        }
    raise KeyError(name)


@pytest.mark.parametrize("name", ["dense_logreg", "coo_gcn_conv", "arity2_blocked_matmul"])
@pytest.mark.parametrize("dispatch", ["ref", "torch"])
def test_compiler_matches_reference(name, dispatch):
    rng = np.random.default_rng(7)
    make_query, spec = _case(name, rng)
    jq, tq = both(make_query)
    jenv, tenv = _envs(spec, 0)
    jout, jgrads = JaxEngine(jax_ra_autodiff(jq)).eager(jenv, dispatch="ref")
    prog = ra_autodiff(tq)
    for tout, tgrads in (
        RAEngine(prog).eager(tenv, dispatch=dispatch),
        RAEngine(prog).lower(tenv, dispatch=dispatch, rewrite=True).compile()(tenv),
    ):
        np.testing.assert_allclose(_payload(tout), _payload(jout), atol=ATOL, rtol=1e-6)
        assert set(tgrads) == set(jgrads)
        for n in jgrads:
            assert type(tgrads[n]).__name__ == type(jgrads[n]).__name__
            np.testing.assert_allclose(_payload(tgrads[n]), _payload(jgrads[n]), atol=ATOL, rtol=1e-6)


def test_restricted_join_gradient_matches_reference():
    """∂loss/∂Edge of a GCN conv is the restricted join g[dst]·h[src],
    evaluated only at the edge key set (a COO gradient in edge order)."""
    rng = np.random.default_rng(3)
    keys, w, h = _graph(rng, 8, 20, 5)
    spec = {"Edge": ("coo", keys, w, (8, 8)), "Node": ("dense", h, 1)}
    jq, tq = both(gcn_query)
    jenv, tenv = _envs(spec, 0)
    _, jgrads = JaxEngine(jax_ra_autodiff(jq, wrt=("Edge",))).eager(jenv, dispatch="ref")
    low = RAEngine(ra_autodiff(tq, wrt=("Edge",))).lower(tenv, dispatch="ref")
    assert any(k.startswith("gather_join") for k in low.resolutions)
    _, tgrads = low.compile()(tenv)
    assert isinstance(tgrads["Edge"], CooRelation)
    np.testing.assert_array_equal(tgrads["Edge"].keys.numpy(), keys)
    np.testing.assert_allclose(
        tgrads["Edge"].values.numpy(), np.asarray(jgrads["Edge"].values), atol=ATOL
    )


def test_matmul_rjp_queries_resolve_as_the_reference():
    """dX = g·Wᵀ and dW = Xᵀ·g of the arity-0 relational matmul join with
    the Fig. 4 RJP chunk kernels. Like the reference, the port routes only
    the MatMul chunk kernel through blocked_matmul and leaves these two
    products to einsum: the same (empty) resolutions, the same values."""
    from repro.relational.linear import _linear_prog as jax_linear_prog

    from repro_torch.relational.linear import _linear_prog

    rng = np.random.default_rng(11)
    arrays = {"X": rng.normal(size=(5, 3)), "W": rng.normal(size=(3, 4)),
              "__seed": rng.normal(size=(5, 4))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    jprog, jscans = jax_linear_prog()
    tprog, tscans = _linear_prog()
    jenv = {k: JDense(jnp.asarray(v, jnp.float32), 0) for k, v in arrays.items()}
    tenv = {k: convert.dense_relation(v, 0, "cpu") for k, v in arrays.items()}
    jenv.update({f"__fwd_{jscans[n]}": jenv[n] for n in ("X", "W")})
    tenv.update({f"__fwd_{tscans[n]}": tenv[n] for n in ("X", "W")})
    for name in ("X", "W"):
        jlow = JaxEngine(jprog.grads[name]).lower(jenv, dispatch="ref")
        tlow = RAEngine(tprog.grads[name]).lower(tenv, dispatch="ref")
        assert dict(tlow.resolutions) == dict(jlow.resolutions) == {}
        np.testing.assert_allclose(
            _payload(tlow.compile()(tenv)), _payload(jlow.eager(jenv)), atol=ATOL
        )


# ---------------------------------------------------------------------------
# Validate stage and rewrite stage
# ---------------------------------------------------------------------------


def test_validate_stage_rejects_a_malformed_query():
    rng = np.random.default_rng(1)
    keys, w, h = _graph(rng, 5, 6, 3)
    edge = convert.coo_relation(keys, w, (5, 5), "cpu")
    # COO ⋈ COO is not compilable: the typed check refuses it before any walk
    bad = tfra.Join(tkeys.eq_pred((0, 0)), tkeys.jproj(tkeys.L(1)), tkernels.MUL,
                    tfra.scan("E1", 2), tfra.scan("E2", 2))
    q = tfra.Query(tfra.Agg(tkeys.identity_key(1), tkernels.ADD, bad), inputs=("E1", "E2"))
    eng = RAEngine(q)
    with pytest.raises(ValidationError, match="coo-coo-join"):
        eng.lower({"E1": edge, "E2": edge})
    assert eng.lower_count == 0
    # a scan whose arity disagrees with the stored relation
    q2 = tfra.Query(tfra.Agg(tkeys.EMPTY_KEY, tkernels.ADD, tfra.scan("Node", 2)), inputs=("Node",))
    with pytest.raises(ValidationError, match="arity-mismatch"):
        RAEngine(q2).lower({"Node": convert.dense_relation(h, 1, "cpu")})


def _chain3(fra, K, k):
    j1 = fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1), K.R(1)), k.MUL,
                  fra.scan("A", 2), fra.scan("B", 2))
    j2 = fra.Join(K.eq_pred((2, 0)), K.jproj(K.L(0), K.L(1), K.L(2), K.R(1)), k.MUL,
                  j1, fra.scan("C", 2))
    return fra.Query(fra.Agg(K.project_key(0, 3), k.ADD, j2), inputs=("A", "B", "C"))


def test_rewrite_on_and_off_give_equal_results():
    rng = np.random.default_rng(5)
    arrays = {n: (rng.normal(size=(6, 6)) / 6 ** 0.5).astype(np.float32) for n in "ABC"}
    jq, tq = both(_chain3)
    outs = []
    for rewrite in (True, False):
        db = repro_torch.Database(device="cpu", rewrite=rewrite)
        for n, a in arrays.items():
            db.put(n, a, keys=("i", "j"))
        handle = db.query(tq)
        outs.append(handle.forward().data.numpy())
        (low,) = [
            lw for lw in engine_for(tq)._lowered.values()
            if (lw.rewrite_report is not None) == rewrite
        ]
        if rewrite:
            assert low.rewrite_report.changed, "the Σ-pushdown gate should fire here"
    np.testing.assert_allclose(outs[0], outs[1], atol=ATOL)
    jenv = {n: JDense(jnp.asarray(a, jnp.float32), 2) for n, a in arrays.items()}
    want = JaxEngine(jq).eager(jenv, dispatch="ref")
    np.testing.assert_allclose(outs[0], np.asarray(want.data), atol=ATOL)
