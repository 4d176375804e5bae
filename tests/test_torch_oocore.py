"""Out-of-core chunk waves in the port against the JAX package.

Every case runs the same numpy-seeded inputs (explicit float32 / int32)
through ``repro.Database(memory_budget=...)`` and
``repro_torch.Database(device="cpu", memory_budget=...)``: the wave plans
(count, boundaries, stream and co-streams, owner alignment), the lowering
counts, the spill counters and the error texts must be equal, and losses
and gradients agree at atol 1e-5 with each other and with the in-core
step (plus 4 f32 roundings of the value, ``RTOL``). The cases are those of ``tests/test_oocore.py`` that need one
device, the chunk-manifest helpers, and three findings where the port
differs from the reference by design:

1. a ``put`` or ``drop`` of a name drops its spilled chunks, so a step
   after a re-``put`` streams the new data (the reference streams the old
   chunks again);
2. ``gcn_conv``'s backward does not stream in either package (the same
   ``OutOfCoreError``);
3. where the largest relation cannot stream (a GCN whose node features
   outweigh its edges), the port streams the largest one that can; the
   reference raises.

Two planted faults — a merge that drops the last wave, a cut moved one row
into an owner run — must fail the same comparison.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import fra as jfra
from repro.core import keys as jkeys
from repro.core import kernels as jkernels
from repro.core import relation as jrel
from repro.core.chunkstore import ChunkStore as JChunkStore
from repro.core.chunkstore import OutOfCoreError as JOutOfCoreError
from repro.core.engine import StreamedCompiled as JStreamed
from repro.core.engine import engine_for as jengine_for
from repro.core.planner import plan_waves as jplan_waves
from repro.relational import gcn_conv as jgcn_conv
from repro.relational.gcn import partitioned_edges as jpartitioned_edges
from repro_torch.core import fra as tfra
from repro_torch.core import keys as tkeys
from repro_torch.core import kernels as tkernels
from repro_torch.core import planner as tplanner
from repro_torch.core import relation as trel
from repro_torch.core.chunkstore import ChunkStore, OutOfCoreError
from repro_torch.core.engine import StreamedCompiled
from repro_torch.core.planner import _rel_bytes, plan_waves
from repro_torch.relational import gcn_conv
from repro_torch.relational.gcn import partitioned_edges

ATOL = 1e-5
#: plus a few f32 roundings of the value's own size: the GCN loss (≈ 83)
#: sums 60 rows in another order in each package, and 1e-5 there is
#: below two units in the last place
RTOL = 4 * 2.0 ** -24

LOGREG_SQL = """
mm   := SELECT Rx.row, SUM(multiply(Rx.val, theta.val))
        FROM Rx, theta WHERE Rx.col = theta.col GROUP BY Rx.row;
pred := SELECT mm.row, logistic(mm.val) FROM mm;
SELECT SUM(xent(pred.val, Ry.val)) FROM pred, Ry WHERE pred.row = Ry.row
"""


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


class Pkg:
    """One package's entry points, so each query and data maker below runs in both."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.fra, self.K, self.k = jfra, jkeys, jkernels
            self.partitioned_edges = jpartitioned_edges
            self.Streamed = JStreamed
        else:
            self.fra, self.K, self.k = tfra, tkeys, tkernels
            self.partitioned_edges = partitioned_edges
            self.Streamed = StreamedCompiled

    def db(self, **kw):
        if self.name == "jax":
            return repro.Database(**kw)
        return repro_torch.Database(device="cpu", **kw)

    def array(self, a):
        if self.name == "jax":
            return jnp.asarray(a)
        return torch.as_tensor(a)

    def coo(self, keys, vals, extents):
        return (jrel if self.name == "jax" else trel).CooRelation(
            self.array(keys.astype(np.int32)), self.array(vals), extents
        )


JAX, TORCH = Pkg("jax"), Pkg("torch")


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def lower_count(h):
    """Lowerings made for a handle's programs: the port's
    ``QueryHandle.lower_count``; the entries of the reference's engines'
    lowering caches (its ``trace_count`` also counts jit traces)."""
    if isinstance(h, repro_torch.QueryHandle):
        return h.lower_count
    progs = [h.query, *h._grad_progs.values()]
    if h._full_prog is not None:
        progs.append(h._full_prog)
    return sum(len(jengine_for(p, fuse_join_agg=h.db.fuse_join_agg)._lowered) for p in progs)


def logreg_fill(pkg, db, n=64, m=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    y = ((rng.uniform(size=n) > 0.5) * 0.98 + 0.01).astype(np.float32)
    theta = (rng.normal(size=m) * 0.1).astype(np.float32)
    db.put("Rx", pkg.array(X), keys=("row", "col"))
    db.put("Ry", pkg.array(y), keys=("row",))
    db.put("theta", pkg.array(theta), keys=("col",))
    return db


def logreg_bytes(n=64, m=8):
    return n * m * 4 + n * 4 + m * 4


def gcn_query(pkg, n):
    fra, K, k = pkg.fra, pkg.K, pkg.k
    conv = fra.Agg(
        K.identity_key(1), k.ADD,
        fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(1)), k.MUL,
                 fra.scan("Edge", 2), fra.scan("Node", 1)),
    )
    sq = fra.Select(K.TRUE, K.identity_key(1), k.SQUARE, conv)
    loss = fra.Agg(K.EMPTY_KEY, k.ADD, fra.Select(K.TRUE, K.identity_key(1), k.SUM_CHUNK, sq))
    mean = fra.Select(K.TRUE, K.identity_key(0), k.scale_kernel(1.0 / n), loss)
    return fra.Query(mean, inputs=("Edge", "Node"))


def gcn_fill(pkg, db, n=60, e=500, d=8, seed=1, shards=4):
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    db.put("Edge", pkg.partitioned_edges(keys, w, n, shards))
    db.put("Node", pkg.array(rng.normal(size=(n, d)).astype(np.float32)), keys=("node",))
    return db


def gcn_bytes(n=60, e=500, d=8, shards=4):
    nnz = -(-e // shards) * shards
    return nnz * 12 + n * d * 4


def kge_query(pkg):
    fra, K, k = pkg.fra, pkg.K, pkg.k
    conv = fra.Agg(
        K.identity_key(1), k.ADD,
        fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(1)), k.MUL,
                 fra.scan("Triple", 2), fra.scan("Ent", 1)),
    )
    pair = fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(0)), k.MUL, conv, fra.scan("Ent", 1))
    sc = fra.Select(K.TRUE, K.identity_key(1), k.SUM_CHUNK, pair)
    return fra.Query(fra.Agg(K.EMPTY_KEY, k.ADD, sc), inputs=("Triple", "Ent"))


def kge_fill(pkg, db, n=40, e=300, d=6, seed=3, partition=True):
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    vals = (rng.normal(size=e) * 0.3).astype(np.float32)
    triple = pkg.partitioned_edges(keys, vals, n, 4) if partition else pkg.coo(keys, vals, (n, n))
    db.put("Triple", triple)
    db.put("Ent", pkg.array(rng.normal(size=(n, d)).astype(np.float32)), keys=("ent",))
    return db


def leaves(out, grads):
    """(name, array) of a step's loss and gradients, COO keys included."""
    got = [("loss", np_of(out.data))]
    for name in sorted(grads):
        g = grads[name]
        if hasattr(g, "values"):
            got += [(name + ".keys", np_of(g.keys)), (name + ".values", np_of(g.values))]
        else:
            got.append((name, np_of(g.data)))
    return got


def assert_close(a, b, atol=ATOL):
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        if name.endswith(".keys"):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, atol=atol, rtol=RTOL if atol else 0, err_msg=name)


def reference_spill(db):
    """The port's spill counters that the reference keeps too (the port
    also counts the bytes it merges back to the host)."""
    return {k: v for k, v in db.counters()["spill"].items() if k != "merged_bytes"}


def plan_tuple(plan):
    return (plan.stream, plan.co_streams, plan.num_waves, plan.boundaries,
            plan.axis_of, plan.owner_aligned, plan.budget)


# ---------------------------------------------------------------------------
# the differential harness: chunked ≡ in-core ≡ the reference
# ---------------------------------------------------------------------------


def _logreg_step(pkg, budget, wrt=("theta", "Rx", "Ry")):
    db = logreg_fill(pkg, pkg.db(memory_budget=budget))
    h = db.sql(LOGREG_SQL, wrt=wrt)
    out, grads = h.step()
    return db, h, leaves(out, grads)


@pytest.mark.parametrize("frac,waves", [(0.7, 2), (0.15, 8)])
def test_logreg_waves_match_reference_and_incore(frac, waves):
    budget = logreg_bytes() * frac
    jdb, jh, jgot = _logreg_step(JAX, budget)
    tdb, th, tgot = _logreg_step(TORCH, budget)
    _, _, incore = _logreg_step(TORCH, None)
    assert isinstance(th.last, StreamedCompiled) and isinstance(jh.last, JStreamed)
    assert plan_tuple(th.last.plan) == plan_tuple(jh.last.plan)
    assert th.last.num_waves == waves
    assert th.last.plan.stream == "Rx" and th.last.plan.co_streams == ("Ry",)
    assert_close(tgot, jgot)
    assert_close(tgot, incore)
    assert reference_spill(tdb) == jdb.counters()["spill"]
    assert tdb.counters()["spill"]["fetched_chunks"] == 2 * waves
    assert lower_count(th) == lower_count(jh)
    assert set(th.resolutions.values()) == {"torch"}


def _gcn_step(pkg, budget, n=60, **kw):
    db = gcn_fill(pkg, pkg.db(memory_budget=budget), n=n, **kw)
    h = db.query(gcn_query(pkg, n))
    out, grads = h.step(wrt=("Edge", "Node"))
    return db, h, leaves(out, grads)


@pytest.mark.parametrize("div", [3, 6])
def test_gcn_waves_match_reference_and_incore(div):
    # resident Node plus an edge wave of at most 1/div of the edges
    budget = 60 * 8 * 4 + (gcn_bytes() - 60 * 8 * 4) / div
    jdb, jh, jgot = _gcn_step(JAX, budget)
    tdb, th, tgot = _gcn_step(TORCH, budget)
    _, _, incore = _gcn_step(TORCH, None)
    assert isinstance(th.last, StreamedCompiled)
    assert th.last.num_waves >= div and th.last.plan.owner_aligned
    assert plan_tuple(th.last.plan) == plan_tuple(jh.last.plan)
    assert_close(tgot, jgot)
    assert_close(tgot, incore)
    assert reference_spill(tdb) == jdb.counters()["spill"]
    assert lower_count(th) == lower_count(jh)


@pytest.mark.parametrize("partition", [True, False])
def test_kge_waves_match_reference_and_incore(partition):
    def step(pkg, budget):
        db = kge_fill(pkg, pkg.db(memory_budget=budget), partition=partition)
        h = db.query(kge_query(pkg))
        out, grads = h.step(wrt=("Triple", "Ent"))
        return db, h, leaves(out, grads)

    budget = _rel_bytes(kge_fill(TORCH, TORCH.db(), partition=partition).get("Triple"))
    budget = (budget + 40 * 6 * 4) / 2.5
    jdb, jh, jgot = step(JAX, budget)
    tdb, th, tgot = step(TORCH, budget)
    _, _, incore = step(TORCH, None)
    assert isinstance(th.last, StreamedCompiled) and th.last.num_waves >= 2
    assert th.last.plan.owner_aligned is partition
    assert plan_tuple(th.last.plan) == plan_tuple(jh.last.plan)
    assert_close(tgot, jgot)
    assert_close(tgot, incore)
    assert reference_spill(tdb) == jdb.counters()["spill"]
    assert lower_count(th) == lower_count(jh)


def test_forward_only_query_streams_too():
    outs = {}
    for pkg in (JAX, TORCH):
        for budget in (None, gcn_bytes() / 3):
            db = gcn_fill(pkg, pkg.db(memory_budget=budget))
            h = db.query(gcn_query(pkg, 60))
            outs[pkg.name, budget] = np_of(h.forward().data)
            if budget is not None:
                assert isinstance(h.last, pkg.Streamed)
                outs[pkg.name, "plan"] = plan_tuple(h.last.plan)
    assert outs["jax", "plan"] == outs["torch", "plan"]
    np.testing.assert_allclose(outs["torch", gcn_bytes() / 3], outs["torch", None], atol=ATOL)
    np.testing.assert_allclose(outs["torch", gcn_bytes() / 3], outs["jax", gcn_bytes() / 3], atol=ATOL)


def test_const_data_relations_stream_when_only_params_are_wrt():
    budget = logreg_bytes() * 0.5
    jdb, jh, jgot = _logreg_step(JAX, budget, wrt=("theta",))
    tdb, th, tgot = _logreg_step(TORCH, budget, wrt=("theta",))
    _, _, incore = _logreg_step(TORCH, None, wrt=("theta",))
    assert isinstance(th.last, StreamedCompiled)
    assert th.last.plan.stream == "Rx" and th.last.plan.co_streams == ("Ry",)
    assert plan_tuple(th.last.plan) == plan_tuple(jh.last.plan)
    assert_close(tgot, jgot)
    assert_close(tgot, incore)
    assert lower_count(th) == lower_count(jh)


def test_steps_repeat_from_the_store_and_lower_once_per_signature():
    budget = gcn_bytes() / 3
    tdb = gcn_fill(TORCH, TORCH.db(memory_budget=budget))
    jdb = gcn_fill(JAX, JAX.db(memory_budget=budget))
    th, jh = tdb.query(gcn_query(TORCH, 60)), jdb.query(gcn_query(JAX, 60))
    first = leaves(*th.step(wrt=("Edge", "Node")))
    jh.step(wrt=("Edge", "Node"))
    spilled = tdb.counters()["spill"]["spilled_bytes"]
    for _ in range(2):
        again = leaves(*th.step(wrt=("Edge", "Node")))
        jh.step(wrt=("Edge", "Node"))
        assert_close(again, first, atol=0)
    waves = th.last.num_waves
    assert tdb.counters()["spill"]["fetched_chunks"] == 3 * waves
    assert tdb.counters()["spill"]["spilled_bytes"] == spilled
    assert reference_spill(tdb) == jdb.counters()["spill"]
    assert lower_count(th) == lower_count(jh) == 2  # the full shapes, one wave signature


# ---------------------------------------------------------------------------
# bit-identity with no / an unconstraining budget (the in-core path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["logreg", "gcn"])
def test_no_budget_and_a_fitting_budget_are_bit_identical(workload):
    def run(**kw):
        if workload == "logreg":
            db = logreg_fill(TORCH, repro_torch.Database(device="cpu", **kw))
            h = db.sql(LOGREG_SQL, wrt=("theta",))
            return db, h, leaves(*h.step())
        db = gcn_fill(TORCH, repro_torch.Database(device="cpu", **kw))
        h = db.query(gcn_query(TORCH, 60))
        return db, h, leaves(*h.step(wrt=("Edge", "Node")))

    _, h0, base = run()
    for kw in ({"memory_budget": None}, {"memory_budget": 1 << 30}):
        db, h, got = run(**kw)
        assert not isinstance(h.last, StreamedCompiled)
        assert h.resolutions == h0.resolutions
        assert_close(got, base, atol=0)
        c = db.counters()
        assert set(c) == {"cache", "reshard", "spill", "serve"}
        assert c["reshard"]["bytes_moved"] == 0
        assert c["spill"] == {
            "spilled_relations": 0, "spilled_bytes": 0,
            "fetched_chunks": 0, "fetched_bytes": 0,
            "merged_bytes": 0,
        }
        assert c["cache"] == {"hits": 0, "misses": 0, "evictions": 0}


def test_counters_are_a_snapshot():
    db = logreg_fill(TORCH, TORCH.db(memory_budget=logreg_bytes() * 0.5))
    h = db.sql(LOGREG_SQL, wrt=("theta",))
    h.step()
    snap = db.counters()
    snap["spill"]["fetched_chunks"] = -1
    assert db.counters()["spill"]["fetched_chunks"] == 2 * h.last.num_waves


# ---------------------------------------------------------------------------
# error paths: the reference's texts, word for word
# ---------------------------------------------------------------------------


def _error(pkg, run):
    exc = JOutOfCoreError if pkg is JAX else OutOfCoreError
    with pytest.raises(exc) as info:
        run(pkg)
    return str(info.value)


def _budget_smaller_than_resident(pkg):
    db = gcn_fill(pkg, pkg.db(memory_budget=64.0))
    db.query(gcn_query(pkg, 60)).step(wrt=("Node",))


def _more_waves_than_rows(pkg):
    db = logreg_fill(pkg, pkg.db(memory_budget=18.0), n=16, m=2)
    db.sql(LOGREG_SQL, wrt=("theta", "Rx", "Ry")).step()


def _donation(pkg):
    db = logreg_fill(pkg, pkg.db(memory_budget=logreg_bytes() * 0.5))
    db.sql(LOGREG_SQL, wrt=("theta", "Rx", "Ry")).step(donate=("theta",))


def _unstreamable(pkg):
    fra, K, k = pkg.fra, pkg.K, pkg.k
    sq = fra.Agg(K.EMPTY_KEY, k.ADD, fra.Select(K.TRUE, K.identity_key(1), k.SUM_CHUNK, fra.scan("X", 1)))
    q = fra.Query(fra.Select(K.TRUE, K.identity_key(0), k.EXP, sq), inputs=("X",))
    db = pkg.db(memory_budget=32 * 4 * 8 * 0.5)
    db.put("X", pkg.array(np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32)), keys=("i",))
    db.query(q).forward()


@pytest.mark.parametrize("case,match", [
    (_budget_smaller_than_resident, "too small"),
    (_more_waves_than_rows, "waves"),
    (_donation, "donate"),
    (_unstreamable, "exp"),
], ids=["resident", "rows", "donate", "unstreamable"])
def test_errors_match_reference(case, match):
    got = _error(TORCH, case)
    assert got == _error(JAX, case)
    assert match in got


# ---------------------------------------------------------------------------
# chunk store and planner mechanics
# ---------------------------------------------------------------------------


def test_chunkstore_spill_fetch_counters_and_idempotence():
    data = np.random.default_rng(5).normal(size=(12, 3)).astype(np.float32)
    stores = {"jax": JChunkStore(), "torch": ChunkStore(device="cpu")}
    rels = {"jax": jrel.DenseRelation(jnp.asarray(data), 1),
            "torch": trel.DenseRelation(torch.as_tensor(data), 1)}
    stats = {}
    for name, store in stores.items():
        mani = store.spill("A", rels[name], 3)
        assert mani.num_chunks == 3 and "A" in store
        store.spill("A", rels[name], mani)  # same manifest: a no-op
        parts = [store.fetch("A", w) for w in range(3)]
        if name == "torch":
            parts = [p.wait() for p in parts]
        np.testing.assert_array_equal(np.concatenate([np_of(p.data) for p in parts]), data)
        stats[name] = dict(store.stats)
        store.drop("A")
        assert "A" not in store and store.stats["spilled_bytes"] == 0
    assert stats["jax"] == {
        "spilled_relations": 1, "spilled_bytes": 144, "fetched_chunks": 3, "fetched_bytes": 144,
    }
    assert stats["torch"] == {**stats["jax"], "merged_bytes": 0}


def test_a_cpu_store_pins_nothing_and_fetches_the_host_chunk():
    rel = trel.DenseRelation(torch.arange(12.0).reshape(6, 2), 1)
    store = ChunkStore(device="cpu")
    store.spill("A", rel, 2)
    f = store.fetch("A", 1)
    assert f.event is None and not f.relation.data.is_pinned()
    assert f.wait() is f.relation is store.host_chunk("A", 1)


def test_plan_waves_none_without_budget_or_pressure():
    for pkg, plan in ((JAX, jplan_waves), (TORCH, plan_waves)):
        db = logreg_fill(pkg, pkg.db())
        env = {n: db.get(n) for n in ("Rx", "Ry", "theta")}
        q = db.sql(LOGREG_SQL, wrt=("theta", "Rx", "Ry")).query
        assert plan(q, env, None) is None
        assert plan(q, env, 1e12) is None
        wp = plan(q, env, logreg_bytes() * 0.5)
        assert wp is not None and wp.num_waves >= 2
        assert wp.streamed_names == ("Rx", "Ry")


# ---------------------------------------------------------------------------
# chunk manifests and owner partitions against the reference's
# ---------------------------------------------------------------------------


def _dense(pkg, shape, seed=0):
    data = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    mod = jrel if pkg is JAX else trel
    return mod.DenseRelation(pkg.array(data), 2)


def _owner_coo(pkg, n=30, e=200, shards=4, seed=2, heavy=False):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    if heavy:  # one owner with a third of the rows
        dst[rng.permutation(e)[: e // 3]] = 7
    keys = np.stack([rng.integers(0, n, e), dst], 1).astype(np.int32)
    return pkg.partitioned_edges(keys, rng.normal(size=e).astype(np.float32), n, shards)


def _plain_coo(pkg, n=30, e=97, seed=4):
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    return pkg.coo(keys, rng.normal(size=e).astype(np.float32), (n, n))


MANIFEST_CASES = {
    "dense-axis0": (lambda pkg: _dense(pkg, (10, 4, 3)), 3, 0),
    "dense-axis1": (lambda pkg: _dense(pkg, (5, 7, 2)), 2, 1),
    "coo-plain": (_plain_coo, 4, 0),
    "coo-owner": (_owner_coo, 4, 0),
    "coo-owner-heavy": (lambda pkg: _owner_coo(pkg, heavy=True), 8, 0),
    "coo-owner-one-shard": (lambda pkg: _owner_coo(pkg, shards=1, e=57), 5, 0),
    # owner runs of thousands of rows: a cut's run start lies several
    # doubling windows before it
    "coo-owner-long-runs": (lambda pkg: _owner_coo(pkg, n=3, e=9000, shards=2), 4, 0),
    "coo-owner-long-heavy": (lambda pkg: _owner_coo(pkg, n=40, e=9000, shards=1, heavy=True), 6, 0),
}


@pytest.mark.parametrize("case", sorted(MANIFEST_CASES))
def test_manifest_split_assemble_rechunk_match_reference(case):
    make, chunks, axis = MANIFEST_CASES[case]
    jr, tr = make(JAX), make(TORCH)
    jm, tm = jrel.make_manifest(jr, chunks, axis), trel.make_manifest(tr, chunks, axis)
    assert (tm.axis, tm.boundaries, tm.owner_aligned) == (jm.axis, jm.boundaries, jm.owner_aligned)
    assert tm.num_chunks == jm.num_chunks and tm.max_rows == jm.max_rows
    jc, tc = jrel.split_chunks(jr, jm), trel.split_chunks(tr, tm)
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        for x, y in zip(trel_tensors(a), trel_tensors(b)):
            assert x.device.type == "cpu" and x.is_contiguous()
            np.testing.assert_array_equal(np_of(x), np_of(y))
    whole = trel.assemble_chunks(tc, tm)
    for x, y in zip(trel_tensors(whole), trel_tensors(tr)):
        np.testing.assert_array_equal(np_of(x), np_of(y))
    # rechunk to one chunk and back: pure row movement
    one = trel.ChunkManifest(tm.axis, (0, tm.boundaries[-1]))
    back = trel.rechunk(trel.rechunk(tc, tm, one), one, tm)
    for a, b in zip(back, tc):
        for x, y in zip(trel_tensors(a), trel_tensors(b)):
            assert torch.equal(x, y)


def trel_tensors(rel):
    return [rel.data] if hasattr(rel, "data") else [rel.keys, rel.values]


@pytest.mark.parametrize("shards", [1, 3, 4, 8, 64])
def test_owner_partition_matches_reference(shards):
    jr, tr = _owner_coo(JAX, shards=shards, e=50), _owner_coo(TORCH, shards=shards, e=50)
    np.testing.assert_array_equal(np_of(tr.keys), np_of(jr.keys))
    np.testing.assert_array_equal(np_of(tr.values), np_of(jr.values))
    assert tr.shard_offsets == jr.shard_offsets and tr.owner_dim == jr.owner_dim == 1
    assert tr.keys.dtype == torch.int32


@pytest.mark.parametrize("shape,block", [((6, 8), (2, 4)), ((4, 6, 9), (2, 3, 3))])
def test_from_blocked_to_blocked_match_reference(shape, block):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jb, tb = jrel.from_blocked(jnp.asarray(x), block), trel.from_blocked(torch.as_tensor(x), block)
    assert tb.key_arity == jb.key_arity
    np.testing.assert_array_equal(np_of(tb.data), np_of(jb.data))
    np.testing.assert_array_equal(np_of(trel.to_blocked(tb)), x)


def _manifest_errors(mod, pkg):
    rel = _dense(pkg, (4, 3, 2))
    yield lambda: mod.make_manifest(rel, 0)
    yield lambda: mod.make_manifest(rel, 2, axis=2)
    yield lambda: mod.make_manifest(rel, 5)
    a, b = mod.ChunkManifest(0, (0, 2, 4)), mod.ChunkManifest(0, (0, 5))
    yield lambda: mod.rechunk(mod.split_chunks(rel, a), a, b)
    yield lambda: mod.owner_partition(_plain_coo(pkg), 0)


@pytest.mark.parametrize("i", range(5))
def test_manifest_errors_match_reference(i):
    msgs = []
    for mod, pkg in ((jrel, JAX), (trel, TORCH)):
        with pytest.raises(ValueError) as info:
            next(itertools.islice(_manifest_errors(mod, pkg), i, None))()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# findings: where the port differs from the reference, by design
# ---------------------------------------------------------------------------


def test_finding1_a_reput_streams_the_new_data():
    """The reference's store keeps a name's chunks across a ``put`` of new
    data under the same manifest, so the second step streams the old data
    again; the port drops the chunks on ``put`` and equals the in-core
    step."""
    budget = logreg_bytes() * 0.5
    losses = {}
    for pkg in (JAX, TORCH):
        for b in (None, budget):
            db = logreg_fill(pkg, pkg.db(memory_budget=b))
            h = db.sql(LOGREG_SQL, wrt=("theta",))
            first = float(np_of(h.step()[0].data))
            db.put("Rx", 2 * db.get("Rx").data, keys=("row", "col"))
            losses[pkg.name, b] = (first, float(np_of(h.step()[0].data)))
    jfirst, jsecond = losses["jax", budget]
    assert jsecond == jfirst  # the reference's stale chunks
    assert abs(losses["jax", None][1] - jfirst) > 1e-2
    np.testing.assert_allclose(losses["torch", budget], losses["torch", None], atol=ATOL)
    np.testing.assert_allclose(losses["torch", None], losses["jax", None], atol=ATOL)


def test_finding1_drop_empties_the_store():
    db = logreg_fill(TORCH, TORCH.db(memory_budget=logreg_bytes() * 0.5))
    h = db.sql(LOGREG_SQL, wrt=("theta",))
    h.step()
    assert db.counters()["spill"]["spilled_relations"] == 2
    db.drop("Ry")
    assert db.counters()["spill"]["spilled_relations"] == 1 and "Ry" not in db
    db.put("Rx", db.get("Rx").data, keys=("row", "col"))
    assert db.counters()["spill"] == {
        "spilled_relations": 0, "spilled_bytes": 0,
        "fetched_chunks": 2 * h.last.num_waves, "fetched_bytes": 64 * 9 * 4,
        "merged_bytes": 0,
    }


def test_finding2_gcn_conv_backward_does_not_stream_in_either_package():
    n, e, d = 60, 500, 8
    rng = np.random.default_rng(1)
    keys = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    budget = 13000.0  # the forward fits; the backward's environment does not
    je = jpartitioned_edges(keys, w, n, 4)
    with repro.Database(memory_budget=budget).activate():
        import jax

        f = lambda h, ww: jnp.sum(jgcn_conv(h, je.keys, ww) ** 2)  # noqa: E731
        with pytest.raises(JOutOfCoreError) as jinfo:
            jax.grad(f, argnums=(0, 1))(jnp.asarray(x), je.values)
    te = partitioned_edges(keys, w, n, 4)
    h = torch.tensor(x, requires_grad=True)
    ww = te.values.clone().requires_grad_(True)
    with repro_torch.Database(device="cpu", memory_budget=budget).activate():
        loss = (gcn_conv(h, te.keys, ww) ** 2).sum()
        with pytest.raises(OutOfCoreError) as tinfo:
            loss.backward()
    # the same text, but for the node id in the engine-internal name
    same = [re.sub(r"__fwd_\d+", "__fwd_<id>", str(i.value)) for i in (tinfo, jinfo)]
    assert same[0] == same[1]
    assert "restriction reference depends on the stream" in same[0]


def test_finding3_features_heavier_than_edges_stream_the_edges():
    """Node features of 32 floats outweigh 600 edges: the reference picks
    Node, which cannot stream, and raises; the port streams Edge,
    owner-aligned, and equals the in-core step."""
    kw = dict(n=200, e=600, d=32, shards=1)
    budget = _rel_bytes(gcn_fill(TORCH, TORCH.db(), **kw).get("Node")) + 600 * 12 / 4
    with pytest.raises(JOutOfCoreError, match="cannot stream 'Node'"):
        _gcn_step(JAX, budget, **kw)
    _, jh, jincore = _gcn_step(JAX, None, **kw)
    _, th, got = _gcn_step(TORCH, budget, **kw)
    _, _, incore = _gcn_step(TORCH, None, **kw)
    plan = th.last.plan
    assert plan.stream == "Edge" and plan.owner_aligned and plan.num_waves >= 4
    assert_close(got, incore)
    assert_close(got, jincore)


# ---------------------------------------------------------------------------
# planted faults: the comparison must catch them
# ---------------------------------------------------------------------------


def _differs(a, b):
    for (name, x), (_, y) in zip(a, b):
        if x.shape != y.shape or not np.allclose(x, y, atol=ATOL, rtol=RTOL):
            return True
    return False


def test_planted_fault_a_merge_that_drops_the_last_wave(monkeypatch):
    merge = StreamedCompiled._merge

    def drop_last(self, outs, want):
        return merge(self, itertools.islice(outs, self.num_waves - 1), want)

    _, _, incore = _gcn_step(TORCH, None)
    monkeypatch.setattr(StreamedCompiled, "_merge", drop_last)
    _, h, got = _gcn_step(TORCH, gcn_bytes() / 3)
    assert h.last.num_waves >= 2 and _differs(got, incore)


def test_planted_fault_b_a_cut_moved_one_row_into_an_owner_run(monkeypatch):
    import dataclasses

    plan = tplanner.plan_waves

    def moved(query, env, budget, **kw):
        p = plan(query, env, budget, **kw)
        owners = env["Edge"].keys[:, 1]
        for w in range(1, p.num_waves):
            c = p.boundaries[w]
            if owners[c] == owners[c + 1] and p.boundaries[w + 1] > c + 1:
                cut = p.boundaries[:w] + (c + 1,) + p.boundaries[w + 1:]
                return dataclasses.replace(p, boundaries=cut)
        raise AssertionError("no owner run of two rows at a cut")

    _, _, incore = _gcn_step(TORCH, None)
    _, _, honest = _gcn_step(TORCH, gcn_bytes() / 3)
    assert not _differs(honest, incore)
    monkeypatch.setattr(tplanner, "plan_waves", moved)
    _, h, got = _gcn_step(TORCH, gcn_bytes() / 3)
    assert h.last.plan.boundaries != plan(
        h.query, {"Edge": h.db.get("Edge"), "Node": h.db.get("Node")}, gcn_bytes() / 3
    ).boundaries
    assert _differs(got, incore)
