"""The reference API the port gained in slice 16, through both packages on
the same numpy inputs from a seed:

- ``core/compiler.py``'s eager wrappers ``execute``, ``run_query``,
  ``execute_with_cache`` and ``grad_eval`` on the logistic regression
  (paper §2.3) and a GCN convolution, against the reference's (atol 1e-5);
  ``compiler.grad_eval(prog, env)`` as ``benchmarks/logreg.py`` calls it;
- ``Lowered.eager`` against the staged step, and ``StreamedCompiled.mesh``;
- ``Database.put(key_arity=)``, ``put(refresh_stats=False)`` and
  ``Catalog.put(refresh_stats=)`` against the reference's arities and
  ``db.stats``;
- ``Database.execute(donate=)``: the catalog entry marked, a read raising;
- ``register_impl(priority=)``: a bucket tried in decreasing priority,
  registration order among equals, as the reference resolves it;
- ``Endpoint(gather_window=)`` and ``Endpoint.warmup(decode=False)`` on the
  reduced olmoe-1b-7b in both packages (the reference on
  ``dispatch="interpret"``);
- ``examples/gcn_train.py --mesh host:2 --device cpu``: two gloo ranks
  train through ``Database(mesh=...)`` and their losses are the mesh-less
  run's within 1e-5 relative (phase 23's loss limit of ``chip_smoke.py``).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.configs import get_config as jax_get_config
from repro.core import compiler as jcompiler
from repro.core import fra as jfra
from repro.core import keys as jkeys
from repro.core import kernels as jkernels
from repro.core.autodiff import ra_autodiff as jax_ra_autodiff
from repro.core.engine import RAEngine as JaxEngine
from repro.core.relation import CooRelation as JCoo
from repro.core.relation import DenseRelation as JDense
from repro.models import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import compiler
from repro_torch.core import fra as tfra
from repro_torch.core import keys as tkeys
from repro_torch.core import kernels as tkernels
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.engine import RAEngine, StreamedCompiled
from repro_torch.core.relation import CooRelation, DenseRelation
from repro_torch.core.session import CatalogError
from repro_torch.examples import gcn_train
from repro_torch.models import build_model

ATOL = 1e-5


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


def gcn_query(fra, K, k):
    join = fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(1)), k.MUL,
                    fra.scan("Edge", 2), fra.scan("Node", 1))
    conv = fra.Agg(K.identity_key(1), k.ADD, join)
    sq = fra.Select(K.TRUE, K.identity_key(1), k.SUM_CHUNK,
                    fra.Select(K.TRUE, K.identity_key(1), k.SQUARE, conv))
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, sq), inputs=("Edge", "Node"))


def _case(name, seed=0):
    """(query maker, {name: ("dense", array, arity) | ("coo", keys,
    values, extents)}) from a seed."""
    rng = np.random.default_rng(seed)
    if name == "logreg":
        return logreg_query, {
            "Rx": ("dense", rng.normal(size=(16, 8)).astype(np.float32), 2),
            "Ry": ("dense", (rng.uniform(size=16) > 0.5).astype(np.float32), 1),
            "theta": ("dense", (rng.normal(size=8) * 0.1).astype(np.float32), 1),
        }
    n, e = 9, 30
    flat = rng.choice(n * n, size=e, replace=False)
    keys = np.stack([flat // n, flat % n], 1).astype(np.int32)
    return gcn_query, {
        "Edge": ("coo", keys, rng.normal(size=e).astype(np.float32), (n, n)),
        "Node": ("dense", rng.normal(size=(n, 6)).astype(np.float32), 1),
    }


def _envs(spec):
    jenv, tenv = {}, {}
    for name, s in spec.items():
        if s[0] == "dense":
            jenv[name] = JDense(jnp.asarray(s[1], jnp.float32), s[2])
            tenv[name] = convert.dense_relation(s[1], s[2], "cpu")
        else:
            jenv[name] = JCoo(jnp.asarray(s[1], jnp.int32), jnp.asarray(s[2], jnp.float32), s[3])
            tenv[name] = convert.coo_relation(s[1], s[2], s[3], "cpu")
    return jenv, tenv


def _payload(rel):
    return np.asarray(rel.data if hasattr(rel, "data") else rel.values)


def _close(got, want):
    np.testing.assert_allclose(_payload(got), _payload(want), atol=ATOL, rtol=1e-6)


def _built(name):
    """(reference query, port query, reference env, port env)."""
    make, spec = _case(name)
    jenv, tenv = _envs(spec)
    return make(jfra, jkeys, jkernels), make(tfra, tkeys, tkernels), jenv, tenv


CASES = ("logreg", "gcn")


# ---------------------------------------------------------------------------
# core/compiler.py's eager wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", (None, "ref"))
@pytest.mark.parametrize("name", CASES)
def test_run_query_and_execute_match_the_reference(name, dispatch):
    jq, tq, jenv, tenv = _built(name)
    want = jcompiler.run_query(jq, jenv, dispatch="ref")
    _close(compiler.run_query(tq, tenv, dispatch=dispatch), want)
    _close(compiler.execute(tq.root, tenv, dispatch=dispatch), want)
    _close(compiler.execute(tq.root, tenv, fuse_join_agg=False, dispatch=dispatch), want)


@pytest.mark.parametrize("fuse", (True, False))
@pytest.mark.parametrize("name", CASES)
def test_execute_with_cache_matches_the_reference(name, fuse):
    """The output, and the cache: one ``__fwd_<id>`` entry per node the
    reference caches, each node's equal to the reference's node at the
    same place in the graph's topological order."""
    jq, tq, jenv, tenv = _built(name)
    jout, jcache = jcompiler.execute_with_cache(jq.root, jenv, fuse_join_agg=fuse, dispatch="ref")
    tout, tcache = compiler.execute_with_cache(tq.root, tenv, fuse_join_agg=fuse)
    _close(tout, jout)
    jpos = {f"__fwd_{n.id}": i for i, n in enumerate(jq.root.topo())}
    tpos = {f"__fwd_{n.id}": i for i, n in enumerate(tq.root.topo())}
    assert sorted(tpos[k] for k in tcache) == sorted(jpos[k] for k in jcache)
    jby = {jpos[k]: v for k, v in jcache.items()}
    for k, v in tcache.items():
        _close(v, jby[tpos[k]])


@pytest.mark.parametrize("name", CASES)
def test_grad_eval_matches_the_reference(name):
    jq, tq, jenv, tenv = _built(name)
    jout, jgrads = jcompiler.grad_eval(jax_ra_autodiff(jq), jenv, dispatch="ref")
    prog = ra_autodiff(tq)
    tout, tgrads = compiler.grad_eval(prog, tenv)   # as benchmarks/logreg.py calls it
    _close(tout, jout)
    assert set(tgrads) == set(jgrads)
    for k in jgrads:
        assert type(tgrads[k]).__name__ == type(jgrads[k]).__name__
        _close(tgrads[k], jgrads[k])
    # a seed cotangent, and another tier: the same gradients
    seed = DenseRelation(torch.full((), 2.0), 0)
    _, twice = compiler.grad_eval(prog, tenv, seed, dispatch="ref", fuse_join_agg=True)
    for k in jgrads:
        np.testing.assert_allclose(_payload(twice[k]), 2 * _payload(jgrads[k]), atol=2 * ATOL, rtol=1e-6)


def test_execute_registers_no_engine():
    from repro_torch.core import engine

    _, tq, _, tenv = _built("logreg")
    before = dict(engine._ENGINES)
    compiler.execute(tq.root, tenv)
    compiler.run_query(tq, tenv)
    assert engine._ENGINES == before


def test_the_table_follows_the_environments_device():
    """A tier that names no CPU implementation of an op is refused for an
    environment on the CPU, as the session's table is."""
    _, tq, _, tenv = _built("gcn")
    with pytest.raises(Exception, match="cuda"):
        compiler.execute(tq.root, tenv, dispatch="cuda")


# ---------------------------------------------------------------------------
# Lowered.eager, StreamedCompiled.mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_lowered_eager_equals_the_staged_step(name):
    jq, tq, jenv, tenv = _built(name)
    jlow = JaxEngine(jax_ra_autodiff(jq)).lower(jenv, dispatch="ref")
    jout, jgrads = jlow.eager(jenv)
    low = RAEngine(ra_autodiff(tq)).lower(tenv, rewrite=True)
    out, grads = low.eager(tenv)
    sout, sgrads = low.compile()(tenv)
    assert np.array_equal(_payload(out), _payload(sout))
    for k in sgrads:
        assert np.array_equal(_payload(grads[k]), _payload(sgrads[k]))
    _close(out, jout)
    for k in jgrads:
        _close(grads[k], jgrads[k])


def test_a_streamed_step_reports_its_inner_mesh():
    """``StreamedCompiled.mesh``: None before the first wave, then the
    inner ``Compiled``'s (None: waves run on one device)."""
    _, tq, _, tenv = _built("logreg")
    db = repro_torch.Database(device="cpu", memory_budget=256)
    for n, rel in tenv.items():
        db.put(n, rel)
    handle = db.query(tq)
    handle.step()
    assert isinstance(handle.last, StreamedCompiled)
    assert handle.last._inner is not None and handle.last.mesh is handle.last._inner.mesh is None


# ---------------------------------------------------------------------------
# Database.put / Catalog.put keywords
# ---------------------------------------------------------------------------


def _stats_tuple(st):
    return (tuple(st.distinct), tuple(st.extents), int(st.nnz), float(st.density),
            tuple(tuple(int(v) for v in h) for h in st.hist))


def test_put_key_arity_matches_the_reference():
    x = np.random.default_rng(0).normal(size=(6, 4, 3)).astype(np.float32)
    jdb, tdb = repro.Database(), repro_torch.Database(device="cpu")
    for arity in (1, 2):
        jdb.put("X", jnp.asarray(x), key_arity=arity)
        tdb.put("X", x, key_arity=arity)
        assert tdb.get("X").key_arity == jdb.get("X").key_arity == arity
        assert tdb.schema("X") == jdb.schema("X")
        assert _stats_tuple(tdb.stats("X")) == _stats_tuple(jdb.stats("X"))
    # keys= wins over key_arity=, as in the reference
    jdb.put("X", jnp.asarray(x), keys=("a",), key_arity=2)
    tdb.put("X", x, keys=("a",), key_arity=2)
    assert tdb.get("X").key_arity == jdb.get("X").key_arity == 1
    assert tdb.schema("X") == jdb.schema("X") == ("a",)


def test_put_refresh_stats_false_keeps_the_statistics_as_the_reference():
    """A COO relation put again with other edges: ``refresh_stats=False``
    keeps the earlier statistics, the default measures the new ones; the
    port's ``db.stats`` equals the reference's at every step."""
    rng = np.random.default_rng(1)
    n = 10

    def edges(e):
        flat = rng.choice(n * n, size=e, replace=False)
        return np.stack([flat // n, flat % n], 1).astype(np.int32), rng.normal(size=e).astype(np.float32)

    jdb, tdb = repro.Database(), repro_torch.Database(device="cpu")
    seen = []
    for e, refresh in ((20, True), (40, False), (40, True)):
        k, v = edges(e)
        jdb.put("E", JCoo(jnp.asarray(k), jnp.asarray(v), (n, n)), refresh_stats=refresh)
        tdb.put("E", CooRelation(torch.as_tensor(k), torch.as_tensor(v), (n, n)), refresh_stats=refresh)
        assert _stats_tuple(tdb.stats("E")) == _stats_tuple(jdb.stats("E"))
        seen.append(_stats_tuple(tdb.stats("E")))
    assert seen[1] == seen[0] and seen[2] != seen[0]
    assert int(tdb.get("E").nnz) == 40
    # the catalog's own keyword
    tdb.catalog.put("E", CooRelation(*map(torch.as_tensor, edges(5)), (n, n)), refresh_stats=False)
    assert _stats_tuple(tdb.stats("E")) == seen[2]


# ---------------------------------------------------------------------------
# Database.execute(donate=)
# ---------------------------------------------------------------------------


def test_execute_donate_marks_the_entry_and_a_read_raises():
    jq, tq, jenv, tenv = _built("logreg")
    db = repro_torch.Database(device="cpu")
    for n, rel in tenv.items():
        db.put(n, rel)
    prog = ra_autodiff(tq)
    env = {n: db.get(n) for n in tenv}
    kept_out, kept = db.execute(prog, env)
    out, grads = db.execute(prog, env, donate=("theta",))
    assert torch.equal(out.data, kept_out.data) and torch.equal(grads["theta"].data, kept["theta"].data)
    jout, jgrads = repro.Database().execute(jax_ra_autodiff(jq), jenv)
    _close(out, jout)
    _close(grads["theta"], jgrads["theta"])
    assert db.catalog.entry("theta").donated and not db.catalog.entry("Rx").donated
    with pytest.raises(CatalogError, match="donated"):
        db.get("theta")
    db.put("theta", env["theta"])
    assert db.get("theta") is not None
    with pytest.raises(KeyError, match="cannot donate"):
        db.execute(prog, env, donate=("nope",))


def test_execute_donate_of_an_anonymous_relation_leaves_the_catalog():
    _, tq, _, tenv = _built("logreg")
    db = repro_torch.Database(device="cpu")
    for n, rel in tenv.items():
        db.put(n, rel)
    anon = dict(tenv, theta=DenseRelation(tenv["theta"].data.clone(), 1))
    db.execute(ra_autodiff(tq), anon, donate=("theta",))
    assert not db.catalog.entry("theta").donated


# ---------------------------------------------------------------------------
# register_impl(priority=)
# ---------------------------------------------------------------------------


@pytest.fixture
def bucket():
    """A fresh ``(segment_sum, ref)`` registration space in both packages,
    restored after the test."""
    saved = (list(jkernels._IMPLS[("segment_sum", "ref")]), list(tkernels._IMPLS[("segment_sum", "ref")]))
    yield
    jkernels._IMPLS[("segment_sum", "ref")] = saved[0]
    tkernels._IMPLS[("segment_sum", "ref")] = saved[1]


def test_register_impl_priority_orders_a_bucket_as_the_reference(bucket):
    """Entries of one bucket are tried in decreasing priority, in
    registration order among equals: the same order, and the same entry
    resolved, in both packages."""
    order = (("a", 0), ("b", 10), ("c", 0), ("d", 10), ("e", -1))
    got = {}
    for pkg, K, table in ((jkernels, jkernels, jkernels.make_table("ref", backend="cpu")),
                          (tkernels, tkernels, tkernels.make_table("ref", backend="cpu"))):
        base = K._IMPLS[("segment_sum", "ref")][0].fn
        mine = {}
        for tag, prio in order:
            mine[id(K.register_impl("segment_sum", "ref", base, priority=prio))] = tag
        bucket_ = K._IMPLS[("segment_sum", "ref")]
        tags = [mine.get(id(i), "old") for i in bucket_]
        resolved = mine[id(K.resolve_impl("segment_sum", {"nnz": 4, "dim": 2, "num_segments": 3,
                                                          "dtype": "float32"}, table))]
        got[pkg.__name__.split(".")[0]] = (tags, resolved, [i.priority for i in bucket_])
    assert got["repro_torch"] == got["repro"]
    tags, resolved, prios = got["repro_torch"]
    assert [t for t in tags if t != "old"] == ["b", "d", "a", "c", "e"] and resolved == "b"
    assert prios == sorted(prios, reverse=True)


def test_a_higher_priority_entry_that_refuses_the_site_falls_through(bucket):
    """The case of the reference's ``tests/test_kernelcheck.py``: a
    priority-10 entry whose predicate refuses gives way to the next."""
    for K in (jkernels, tkernels):
        table = K.make_table("ref", backend="cpu")
        base = K._IMPLS[("segment_sum", "ref")][0]
        impl = K.register_impl("segment_sum", "ref", base.fn, priority=10, predicate=lambda info: False)
        assert K._IMPLS[("segment_sum", "ref")][0] is impl
        assert K.resolve_impl("segment_sum", {"nnz": 4, "dim": 2, "num_segments": 3,
                                              "dtype": "float32"}, table) is base


# ---------------------------------------------------------------------------
# Endpoint(gather_window=), warmup(decode=False), on the reduced olmoe
# ---------------------------------------------------------------------------

SEQ, CACHE_LEN, BUCKETS = 8, 12, [(1, 8), (2, 8), (4, 8)]


@pytest.fixture(scope="module")
def olmoe():
    """(reference model, its params, port model with those params)."""
    jmodel = jax_build_model(jax_get_config("olmoe-1b-7b").reduced())
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = convert.lm_params(build_model(get_config("olmoe-1b-7b").reduced(), device="cpu", seed=1),
                              params)
    return jmodel, params, model


def _endpoint(pkg, olmoe, **kw):
    jmodel, params, model = olmoe
    if pkg == "jax":
        db = repro.Database(dispatch="interpret")
        db.register_model("lm", jmodel, jax.tree.map(jnp.asarray, params))
    else:
        db = repro_torch.Database(device="cpu")
        db.register_model("lm", model, {k: p.detach() for k, p in model.named_parameters()})
    return db, db.endpoint("lm", cache_len=CACHE_LEN, buckets=BUCKETS, **kw)


def _staggered(ep, prompts, gap):
    """Submit ``prompts`` ``gap`` seconds apart, each for 2 new tokens."""
    async def one(i, p):
        await asyncio.sleep(i * gap)
        return await ep.submit(p, max_new_tokens=2)

    async def go():
        return await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])

    return asyncio.run(go())


def test_gather_window_coalesces_staggered_submits_in_both_packages(olmoe):
    """Three requests submitted 20 ms apart, under a 0.5 s gather window:
    one batch of three in both packages, the same tokens and the same
    serve counters."""
    vocab = olmoe[2].cfg.vocab
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, vocab, size=SEQ).astype(np.int32) for _ in range(3)]
    got = {}
    for pkg in ("jax", "torch"):
        db, ep = _endpoint(pkg, olmoe, gather_window=0.5)
        with db.activate():
            ep.warmup()
            outs = _staggered(ep, prompts, 0.02)
        c = db.counters()["serve"]
        got[pkg] = ([o.token_ids.tolist() for o in outs], c)
        assert c["batches"] == 1 and c["batched_requests"] == 3, pkg
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]


def test_warmup_without_decode_builds_the_prefill_buckets_only(olmoe):
    """``warmup(decode=False)`` builds every prefill bucket and no decode
    step, in both packages; traffic then builds its decode buckets."""
    vocab = olmoe[2].cfg.vocab
    prompts = [np.random.default_rng(3).integers(0, vocab, size=SEQ).astype(np.int32)] * 2
    got = {}
    for pkg in ("jax", "torch"):
        db, ep = _endpoint(pkg, olmoe)
        with db.activate():
            ep.warmup(decode=False)
            c = db.counters()["serve"]
            warm = (c["prefill"]["compiles"], c["decode"]["compiles"], c["decode"]["traces"])

            async def go():
                return await asyncio.gather(*[ep.submit(p, max_new_tokens=3) for p in prompts])

            outs = asyncio.run(go())
        c = db.counters()["serve"]
        got[pkg] = (warm, (c["prefill"]["compiles"], c["decode"]["compiles"]),
                    [o.token_ids.tolist() for o in outs])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (len(BUCKETS), 0, 0)
    assert got["torch"][1][0] == len(BUCKETS) and got["torch"][1][1] >= 1


# ---------------------------------------------------------------------------
# examples/gcn_train.py --mesh
# ---------------------------------------------------------------------------

GCN_ARGS = ["--nodes", "48", "--edges", "192", "--feat", "8", "--labels", "4", "--hidden", "16",
            "--epochs", "4", "--device", "cpu"]


def test_gcn_train_on_a_two_rank_mesh_matches_the_mesh_less_run(capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # a CPU rank runs one thread; sum as it does
    try:
        one = gcn_train.run(gcn_train.parse_args(GCN_ARGS))
    finally:
        torch.set_num_threads(threads)
    capsys.readouterr()
    two = gcn_train.run(gcn_train.parse_args(GCN_ARGS + ["--mesh", "host:2"]))
    assert len(two) == len(one) == 4
    for (l2, a2), (l1, a1) in zip(two, one):
        assert abs(l2 - l1) <= 1e-5 * abs(l1)
        assert a2 == a1


def test_gcn_train_mesh_spec_without_ranks_to_start_raises():
    with pytest.raises(ValueError, match="host"):
        gcn_train.run(gcn_train.parse_args(GCN_ARGS + ["--mesh", "production"]))
