"""The planner's mesh half, the typed checker's mesh diagnostics and
``launch/mesh.py`` against the reference, on the CPU with no ranks.

The planner is pure Python once given a ``MeshGeometry``, so both
packages plan the same queries — the GCN program of
benchmarks/coo_scale.py, the gcn_conv, rel_matmul_blocked (NNMF) and
rel_embed (KGE) programs, the quickstart's SQL logistic regression and the
reference planner tests' queries, each forward query and every gradient
graph — on the same relation shapes (``jax.ShapeDtypeStruct``s and
``meta`` tensors: nothing is allocated), over every geometry below, three
plan budgets, with and without catalog statistics and committed layouts.
Every ``JoinPlan`` field must be equal, each cost within 1e-12 relative,
and every input spec equal as a tuple.
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.core.fra as jfra
import repro.core.keys as jkeys
import repro.core.kernels as jkern
import repro_torch.core.fra as tfra
import repro_torch.core.keys as tkeys
import repro_torch.core.kernels as tkern
from repro.analysis.typecheck import check_query as jax_check_query
from repro.core import planner as jplanner
from repro.core.autodiff import ra_autodiff as jax_autodiff
from repro.core.relation import CooRelation as JCoo, DenseRelation as JDense
from repro.core.sql import compile_sql as jax_compile_sql
from repro.launch import mesh as jmesh
from repro.relational import embedding as jembed, gcn as jgcn, linear as jlinear
from repro_torch.analysis.typecheck import check_query
from repro_torch.core import planner
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.relation import CooRelation, DenseRelation
from repro_torch.core.sql import compile_sql
from repro_torch.examples.quickstart import LOGREG_SQL, SCHEMA
from repro_torch.launch import mesh as tmesh
from repro_torch.relational import embedding as tembed, gcn as tgcn, linear as tlinear

#: (model axis, model size, data axes, data size) — the geometries planned
GEOMETRIES = {
    "1": ("model", 1, (), 1),
    "model2": ("model", 2, (), 1),
    "model4": ("model", 4, (), 1),
    "model8": ("model", 8, (), 1),
    "data2": ("model", 1, ("data",), 2),
    "data4": ("model", 1, ("data",), 4),
    "data8": ("model", 1, ("data",), 8),
    "2x2": ("model", 2, ("data",), 2),
    "4x2": ("model", 2, ("data",), 4),
    "pod2x2x2": ("model", 2, ("pod", "data"), 4),
    "production16x16": ("model", 16, ("data",), 16),
}
#: the reference's default, one that flips the big relations' plans, and
#: one no relation fits
BUDGETS = (jplanner.DEFAULT_MEM_BUDGET, 2e8, 1.0)

NODES, EDGES, FEAT = 169_343, 1_335_586, 128


class _Ns(types.SimpleNamespace):
    pass


def _ns(fra, keys, kern):
    ns = _Ns(fra=fra, kern=kern)
    for name in ("L", "R", "eq_pred", "jproj", "identity_key", "project_key",
                 "EMPTY_KEY", "TRUE"):
        setattr(ns, name, getattr(keys, name))
    return ns


J = _ns(jfra, jkeys, jkern)
T = _ns(tfra, tkeys, tkern)


def gcn_loss(m, n=NODES):
    """benchmarks/coo_scale.py's GCN program."""
    conv = m.fra.Agg(m.identity_key(1), m.kern.ADD, m.fra.Join(
        m.eq_pred((0, 0)), m.jproj(m.L(1)), m.kern.MUL,
        m.fra.scan("Edge", 2), m.fra.scan("Node", 1)))
    sq = m.fra.Select(m.TRUE, m.identity_key(1), m.kern.SQUARE, conv)
    loss = m.fra.Agg(m.EMPTY_KEY, m.kern.ADD,
                     m.fra.Select(m.TRUE, m.identity_key(1), m.kern.SUM_CHUNK, sq))
    mean = m.fra.Select(m.TRUE, m.identity_key(0), m.kern.scale_kernel(1.0 / n), loss)
    return m.fra.Query(mean, inputs=("Edge", "Node"))


def matmul_query(m):
    join = m.fra.Join(m.eq_pred((1, 0)), m.jproj(m.L(0), m.L(1), m.R(1)), m.kern.MATMUL,
                      m.fra.scan("A", 2), m.fra.scan("B", 2))
    return m.fra.Query(m.fra.Agg(m.project_key(0, 2), m.kern.ADD, join), inputs=("A", "B"))


def logreg_loss(m):
    """tests/test_planner_2d.py's logistic-regression loss."""
    f_matmul = m.fra.Agg(m.project_key(0), m.kern.ADD, m.fra.Join(
        m.eq_pred((1, 0)), m.jproj(m.L(0), m.L(1)), m.kern.MUL,
        m.fra.const("Rx", 2), m.fra.scan("theta", 1)))
    f_predict = m.fra.Select(m.TRUE, m.identity_key(1), m.kern.LOGISTIC, f_matmul)
    f_loss = m.fra.Agg(m.EMPTY_KEY, m.kern.ADD, m.fra.Join(
        m.eq_pred((0, 0)), m.jproj(m.L(0)), m.kern.XENT, f_predict, m.fra.const("Ry", 1)))
    return m.fra.Query(f_loss, inputs=("theta",))


def _programs(query, autodiff):
    """The query and each of its gradient graphs, as queries."""
    prog = autodiff(query)
    return [prog.forward] + [type(query)(prog.grads[n], ()) for n in sorted(prog.grads)]


def _op_programs(prog):
    return [prog.forward] + [type(prog.forward)(prog.grads[n], ()) for n in sorted(prog.grads)]


#: relation shapes per query group: ("dense", shape, arity) or
#: ("coo", nnz, extents, chunk, owner_dim)
SHAPES = {
    "coo_scale_gcn": {"Edge": ("coo", EDGES, (NODES, NODES), (), None),
                      "Node": ("dense", (NODES, FEAT), 1)},
    "coo_scale_gcn_owner": {"Edge": ("coo", EDGES, (NODES, NODES), (), 1),
                            "Node": ("dense", (NODES, FEAT), 1)},
    "gcn_conv": {"Edge": ("coo", EDGES, (NODES, NODES), (), None),
                 "Node": ("dense", (NODES, 256), 1)},
    "logreg_sql": {"Rx": ("dense", (1 << 20, 64), 2), "theta": ("dense", (64,), 1),
                   "Ry": ("dense", (1 << 20,), 1)},
    "logreg_2d": {"Rx": ("dense", (4096, 1024), 2), "theta": ("dense", (1024,), 1),
                  "Ry": ("dense", (4096,), 1)},
    "nnmf": {"X": ("dense", (128, 1, 256, 256), 2), "W": ("dense", (1, 128, 256, 256), 2)},
    "matmul": {"A": ("dense", (64, 64, 128, 128), 2), "B": ("dense", (64, 8, 128, 128), 2)},
    "kge": {"Ids": ("coo", 1024 * 201, (1024 * 201, 20_000), (), None),
            "Table": ("dense", (20_000, 100), 2 - 1)},
}


def _queries(group):
    if group.startswith("coo_scale_gcn"):
        return _programs(gcn_loss(J), jax_autodiff), _programs(gcn_loss(T), ra_autodiff)
    if group == "gcn_conv":
        return _op_programs(jgcn._gcn_prog()[0]), _op_programs(tgcn._gcn_prog()[0])
    if group == "logreg_sql":
        return (_programs(jax_compile_sql(LOGREG_SQL, schema=SCHEMA, inputs=("theta",)), jax_autodiff),
                _programs(compile_sql(LOGREG_SQL, schema=SCHEMA, inputs=("theta",)), ra_autodiff))
    if group == "logreg_2d":
        return _programs(logreg_loss(J), jax_autodiff), _programs(logreg_loss(T), ra_autodiff)
    if group == "nnmf":
        return _op_programs(jlinear._blocked_prog()[0]), _op_programs(tlinear._blocked_prog()[0])
    if group == "matmul":
        return _programs(matmul_query(J), jax_autodiff), _programs(matmul_query(T), ra_autodiff)
    return _op_programs(jembed._embed_prog()[0]), _op_programs(tembed._embed_prog()[0])


def _envs(group):
    jenv, tenv = {}, {}
    for name, spec in SHAPES[group].items():
        if spec[0] == "dense":
            _, shape, arity = spec
            jenv[name] = JDense(jax.ShapeDtypeStruct(shape, jnp.float32), arity)
            tenv[name] = DenseRelation(torch.empty(shape, device="meta"), arity)
        else:
            _, nnz, extents, chunk, owner = spec
            k = len(extents)
            jenv[name] = JCoo(jax.ShapeDtypeStruct((nnz, k), jnp.int32),
                              jax.ShapeDtypeStruct((nnz,) + chunk, jnp.float32), extents, owner)
            tenv[name] = CooRelation(torch.empty((nnz, k), dtype=torch.int32, device="meta"),
                                     torch.empty((nnz,) + chunk, device="meta"), extents, owner)
    return jenv, tenv


def _stats(group, mod):
    """Catalog statistics per relation (distinct counts below the extents,
    so that they differ from the stats-less heuristics)."""
    out = {}
    for name, spec in SHAPES[group].items():
        if spec[0] == "dense":
            ext = spec[1][: spec[2]]
            size = 1
            for e in ext:
                size *= e
            out[name] = mod.RelationStats(tuple(ext), tuple(ext), size, 1.0)
        else:
            _, nnz, extents, _, _ = spec
            distinct = tuple(max(1, min(e, nnz) // 3) for e in extents)
            out[name] = mod.RelationStats(distinct, tuple(extents), nnz, nnz / (extents[0] * extents[1]))
    return out


def _committed(group, geo, spec_cls):
    """A committed layout per relation that is not the plan's first choice:
    the COO's nnz rows and a dense relation's dim 0 on the data axes (the
    model axis without any), its dim 1 on the model axis."""
    data = planner.fold_axes(geo[2]) or geo[0]
    out = {}
    for name, spec in SHAPES[group].items():
        if spec[0] == "coo":
            out[name] = spec_cls(data)
        elif spec[2] >= 2:
            out[name] = spec_cls(data, geo[0])
        else:
            out[name] = spec_cls(geo[0])
    return out


FIELDS = ("kind", "left_shard_dim", "right_shard_dim", "needs_psum", "left_batch_dim",
          "right_batch_dim", "model_axis", "data_axes", "data_kind", "needs_data_psum",
          "coo_sides")


def _same_plans(jplans, tplans, what):
    assert len(jplans) == len(tplans), what
    for (jid, jp), (tid, tp) in zip(sorted(jplans.items()), sorted(tplans.items())):
        for f in FIELDS:
            assert getattr(jp, f) == getattr(tp, f), (what, f, getattr(jp, f), getattr(tp, f))
        assert set(jp.costs) == set(tp.costs), (what, jp.costs, tp.costs)
        for k, v in jp.costs.items():
            assert tp.costs[k] == pytest.approx(v, rel=1e-12, abs=0.0), (what, k)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("group", sorted(SHAPES))
def test_plans_and_input_specs_equal_the_reference(group, geometry):
    geo = GEOMETRIES[geometry]
    jgeo, tgeo = jplanner.MeshGeometry(*geo), planner.MeshGeometry(*geo)
    jqueries, tqueries = _queries(group)
    jenv, tenv = _envs(group)
    cases = 0
    for budget in BUDGETS:
        for with_stats in (False, True):
            for with_committed in (False, True):
                kw_j = {"stats": _stats(group, jplanner) if with_stats else None,
                        "committed": _committed(group, geo, JP) if with_committed else None}
                kw_t = {"stats": _stats(group, planner) if with_stats else None,
                        "committed": _committed(group, geo, planner.P) if with_committed else None}
                for i, (jq, tq) in enumerate(zip(jqueries, tqueries)):
                    what = (group, geometry, budget, with_stats, with_committed, i)
                    try:
                        jplans = jplanner.plan_query(jq, jenv, geo[1], budget, geometry=jgeo, **kw_j)
                    except ValueError as exc:
                        with pytest.raises(ValueError, match="no feasible plan"):
                            planner.plan_query(tq, tenv, geo[1], budget, geometry=tgeo, **kw_t)
                        assert "no feasible plan" in str(exc)
                        continue
                    tplans = planner.plan_query(tq, tenv, geo[1], budget, geometry=tgeo, **kw_t)
                    _same_plans(jplans, tplans, what)
                    jspecs = jplanner.input_pspecs(jq, jplans)
                    tspecs = planner.input_pspecs(tq, tplans)
                    assert _by_rank(jspecs) == _by_rank(tspecs), what
                    cases += 1
    assert cases > 0


def _by_rank(specs):
    """``specs`` with each engine-internal ``__fwd_<node id>`` name as
    ``__fwd_#<rank>``, the id's rank among the dict's own ids, and each
    spec a tuple. Node ids come from a process-wide counter in each
    package, so the two packages' ids of one query agree only while both
    have built as many nodes; their order within a query is the one the
    query builds them in, the same in both."""
    ids = sorted(int(k[len("__fwd_"):]) for k in specs if k.startswith("__fwd_"))
    rank = {i: r for r, i in enumerate(ids)}
    return {(f"__fwd_#{rank[int(k[len('__fwd_'):])]}" if k.startswith("__fwd_") else k): tuple(v)
            for k, v in specs.items()}


def test_specs_compare_after_the_mesh_tests_queries_ran():
    """tests/test_torch_mesh.py's queries built first in this process (as
    when both files run in one worker), which moves the port's node ids
    past the reference's; then the comparison, whose ``__fwd_<id>`` names
    then differ between the packages, holds entry by entry."""
    import repro_torch
    import torch_mesh_workers

    torch_mesh_workers.query_step(repro_torch.Database(device="cpu"), torch_mesh_workers.problem()[0])
    for _ in range(3):
        torch_mesh_workers.gcn_query(torch_mesh_workers.N)
    assert next(tfra._ids) != next(jfra._ids)
    for geometry in sorted(GEOMETRIES):
        test_plans_and_input_specs_equal_the_reference("coo_scale_gcn", geometry)


def test_relation_stats_edge_cut_equals_the_reference():
    for distinct, shards in (((100, 7), 4), ((3, 5000), 16), ((1, 1), 1), ((40, 40), 2)):
        j = jplanner.RelationStats(distinct, (100, 5000), 10)
        t = planner.RelationStats(distinct, (100, 5000), 10)
        for dim in (0, 1):
            assert t.edge_cut(dim, shards) == j.edge_cut(dim, shards)


def test_geometry_from_a_mesh_equals_the_reference():
    """``MeshGeometry.from_mesh`` reads a DeviceMesh's dim names and sizes
    as the reference reads a jax Mesh's axes (stand-ins for both)."""
    for names, shape, axis in ((("model",), (1,), None), (("data", "model"), (4, 2), None),
                               (("pod", "data", "model"), (2, 16, 16), None),
                               (("data", "model"), (2, 2), "data"), (("x",), (8,), None)):
        jm = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
        tm = types.SimpleNamespace(mesh_dim_names=names, mesh=torch.empty(shape))
        assert planner.MeshGeometry.from_mesh(tm, axis) == planner.MeshGeometry(
            *vars(jplanner.MeshGeometry.from_mesh(jm, axis)).values())
    for names, axis in ((("data", "pod"), None), (("data", "model"), "tensor")):
        jm = types.SimpleNamespace(axis_names=names, shape=dict.fromkeys(names, 2))
        tm = types.SimpleNamespace(mesh_dim_names=names, mesh=torch.empty((2, 2)))
        with pytest.raises(ValueError) as want:
            jplanner.MeshGeometry.from_mesh(jm, axis)
        with pytest.raises(ValueError) as got:
            planner.MeshGeometry.from_mesh(tm, axis)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# typecheck: the non-divisible-shard warning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_non_divisible_shard_diagnostics_equal_the_reference(model):
    shapes = {"Rx": ((6, 10), 2), "theta": ((10,), 1), "Ry": ((6,), 1)}
    jenv = {n: JDense(jnp.zeros(s, jnp.float32), a) for n, (s, a) in shapes.items()}
    tenv = {n: DenseRelation(torch.zeros(s), a) for n, (s, a) in shapes.items()}
    jq = jax_compile_sql(LOGREG_SQL, schema=SCHEMA, inputs=("theta",))
    tq = compile_sql(LOGREG_SQL, schema=SCHEMA, inputs=("theta",))
    geo = ("model", model, (), 1)
    want = jax_check_query(jq, jenv, schema=SCHEMA, geometry=jplanner.MeshGeometry(*geo))
    got = check_query(tq, tenv, schema=SCHEMA, geometry=planner.MeshGeometry(*geo))
    key = lambda r: [(d.severity, d.code, d.node_path, d.message, d.hint) for d in r.diagnostics]
    assert key(got) == key(want)
    assert any(d.code == "non-divisible-shard" for d in got.diagnostics) == (model in (4, 8))


# ---------------------------------------------------------------------------
# launch/mesh.py: spec strings and the reference's errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["bogus", "production:triple", "host:x", "nothing:1"])
def test_resolve_mesh_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError) as want:
        jmesh.resolve_mesh(spec)
    with pytest.raises(ValueError) as got:
        tmesh.resolve_mesh(spec)
    assert str(got.value) == str(want.value)


def test_make_host_mesh_errors_equal_the_reference():
    for model in (0, -1, 3):
        with pytest.raises(ValueError) as want:
            jmesh.make_host_mesh(model=model)
        with pytest.raises(ValueError) as got:
            tmesh.make_host_mesh(model=model)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs 256 ranks; the process group has 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.resolve_mesh("production:multipod")
    # a mesh spans the ranks of a process group: none is initialised here
    with pytest.raises(RuntimeError, match="start_ranks"):
        tmesh.make_host_mesh()
    assert tmesh.resolve_mesh(None) is None
    stand_in = object()
    assert tmesh.resolve_mesh(stand_in) is stand_in


def test_batch_axes_and_data_parallel_size():
    for names, shape, axes, size in (
        (("model",), (4,), (), 1),
        (("data", "model"), (4, 2), ("data",), 4),
        (("pod", "data", "model"), (2, 16, 16), ("pod", "data"), 32),
    ):
        m = types.SimpleNamespace(mesh_dim_names=names, mesh=torch.empty(shape))
        assert tmesh.batch_axes(m) == axes
        assert tmesh.data_parallel_size(m) == size
