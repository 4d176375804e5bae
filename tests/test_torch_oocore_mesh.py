"""A memory budget on a mesh: out-of-core chunk waves on 4 ``gloo`` ranks on
the CPU, against the JAX package.

The reference's acceptance gate (tests/test_oocore.py,
``test_gcn_4x_budget_waves_on_host_mesh``): a GCN query step (n = 200,
e = 4,000, d = 16) whose edge relation is ≥ 4× its headroom under the
budget (node bytes + edge bytes / 4) runs in ≥ 4 owner-aligned waves on the
4 × 1 and the 2 × 2 host mesh, and its loss and gradients match the
reference's in-core ``repro.Database()`` step and its mesh-less budgeted
step. The wave plan equals the reference's ``plan_waves`` on the same
environment and budget (the budget is the session's, not divided by the
ranks). Every rank is bit-equal to rank 0, a second run to the first, and a
one-rank mesh to the port's mesh-less budgeted step. The SQL logistic
regression streams ``Rx`` with its co-stream ``Ry`` on a mesh; a budgeted
but fitting session whose layouts ``catalog_shardings`` committed moves 0
bytes (tests/test_oocore.py's other mesh test); a relation committed to
another layout is moved and warned about once; a wave left out of one
rank's merge is caught.

The tolerance is test_torch_oocore.py's: atol 1e-5, plus 4 f32 roundings of
the value (a mesh wave sums each rank's share of a wave's rows, then the
shares, then the waves: f32 sums of the same terms in another order).

The ranks start once for the module (``launch.mesh.start_ranks``) and run
``tests/torch_oocore_mesh_workers.run_checks``, which imports no JAX; the
one-rank mesh runs in a group of its own (``one_rank``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
import torch_oocore_mesh_workers as W
from repro.core import fra as jfra
from repro.core import keys as jkeys
from repro.core import kernels as jkernels
from repro.core.engine import StreamedCompiled as JStreamed
from repro.core.planner import plan_waves as jplan_waves
from repro.relational.gcn import partitioned_edges as jpartitioned_edges
from repro_torch.launch.mesh import start_ranks

ATOL = 1e-5
RTOL = 4 * 2.0 ** -24


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of ``run_checks`` (4 gloo ranks on the CPU)."""
    return start_ranks(W.run_checks, 4, backend="gloo", device="cpu")


@pytest.fixture(scope="module")
def one_rank():
    return start_ranks(W.one_rank, 1, backend="gloo", device="cpu")[0]


def jax_gcn_query(n):
    conv = jfra.Agg(jkeys.identity_key(1), jkernels.ADD, jfra.Join(
        jkeys.eq_pred((0, 0)), jkeys.jproj(jkeys.L(1)), jkernels.MUL,
        jfra.scan("Edge", 2), jfra.scan("Node", 1)))
    sq = jfra.Select(jkeys.TRUE, jkeys.identity_key(1), jkernels.SQUARE, conv)
    loss = jfra.Agg(jkeys.EMPTY_KEY, jkernels.ADD,
                    jfra.Select(jkeys.TRUE, jkeys.identity_key(1), jkernels.SUM_CHUNK, sq))
    mean = jfra.Select(jkeys.TRUE, jkeys.identity_key(0), jkernels.scale_kernel(1.0 / n), loss)
    return jfra.Query(mean, inputs=("Edge", "Node"))


def jax_gcn_db(**kw):
    keys, w, x = W.gcn_data()
    db = repro.Database(**kw)
    db.put("Edge", jpartitioned_edges(keys, w, W.N, W.SHARDS))
    db.put("Node", jnp.asarray(x), keys=("node",))
    return db


def jax_leaves(out, grads):
    got = [("loss", np.asarray(out.data))]
    for name in sorted(grads):
        g = grads[name]
        if hasattr(g, "values"):
            got += [(name + ".keys", np.asarray(g.keys)), (name + ".values", np.asarray(g.values))]
        else:
            got.append((name, np.asarray(g.data)))
    return got


@pytest.fixture(scope="module")
def reference():
    """The reference's in-core GCN step, its mesh-less budgeted step and
    plan, and its logistic regression's in-core steps and wave plan."""
    budget = W.gcn_budget()
    incore = jax_leaves(*jax_gcn_db().query(jax_gcn_query(W.N)).step(wrt=("Edge", "Node")))
    bdb = jax_gcn_db(memory_budget=budget)
    h = bdb.query(jax_gcn_query(W.N))
    budgeted = jax_leaves(*h.step(wrt=("Edge", "Node")))
    assert isinstance(h.last, JStreamed)
    env = {n: bdb.get(n) for n in ("Edge", "Node")}
    plan = jplan_waves(h.query, env, budget)
    X, y, theta = W.logreg_data()
    logreg = {}
    for wrt in (("theta",), ("theta", "Rx", "Ry")):
        db = repro.Database()
        db.put("Rx", jnp.asarray(X), keys=("row", "col"))
        db.put("Ry", jnp.asarray(y), keys=("row",))
        db.put("theta", jnp.asarray(theta), keys=("col",))
        hl = db.sql(W.LOGREG_SQL, wrt=wrt)
        logreg[wrt] = jax_leaves(*hl.step())
    lb = repro.Database(memory_budget=(W.ROWS * W.COLS + W.ROWS + W.COLS) * 4 * 0.5)
    lb.put("Rx", jnp.asarray(X), keys=("row", "col"))
    lb.put("Ry", jnp.asarray(y), keys=("row",))
    lb.put("theta", jnp.asarray(theta), keys=("col",))
    hl = lb.sql(W.LOGREG_SQL, wrt=("theta",))
    hl.step()
    return {"budget": budget, "incore": incore, "budgeted": budgeted, "plan": W.plan_tuple(plan),
            "logreg": logreg, "logreg_plan": W.plan_tuple(hl.last.plan)}


def assert_close(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, x), (_, y) in zip(got, want):
        if name.endswith(".keys"):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL, err_msg=name)


def differs(got, want) -> bool:
    for (_, x), (_, y) in zip(got, want):
        if x.shape != y.shape or not np.allclose(x, y, atol=ATOL, rtol=RTOL):
            return True
    return False


def bit_equal(a, b) -> bool:
    return [n for n, _ in a] == [n for n, _ in b] and all(
        np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


@pytest.mark.parametrize("model", W.MODELS)
def test_plan_waves_on_a_mesh_equals_the_reference(ranks, reference, model):
    rec = ranks[0][model]["gcn"]
    assert ranks[0]["budget"] == reference["budget"]
    assert rec["streamed"] and rec["plan"] == reference["plan"]
    stream, co, waves, bounds, _, owner_aligned, budget = rec["plan"]
    assert stream == "Edge" and co == () and waves >= 4 and owner_aligned
    assert budget == reference["budget"]  # the session's budget, not divided by the ranks
    assert bounds[0] == 0 and bounds[-1] == W.E


@pytest.mark.parametrize("model", W.MODELS)
def test_gcn_waves_on_a_mesh_match_the_reference(ranks, reference, model):
    got = ranks[0][model]["gcn"]
    assert got["waves"] >= 4 and got["mesh"] == (4 // model, model)
    assert_close(got["leaves"], reference["incore"])
    assert_close(got["leaves"], reference["budgeted"])


@pytest.mark.parametrize("model", W.MODELS)
def test_every_rank_is_bit_equal_to_rank_0(ranks, model):
    for r in ranks[1:]:
        for part in ("gcn", "again", "use_mesh"):
            assert bit_equal(r[model][part]["leaves"], ranks[0][model][part]["leaves"]), (r, part)


@pytest.mark.parametrize("model", W.MODELS)
def test_a_second_run_and_use_mesh_are_bit_equal_to_the_first(ranks, model):
    rec = ranks[0][model]
    assert bit_equal(rec["again"]["leaves"], rec["gcn"]["leaves"])
    # use_mesh on a budgeted session plans on the mesh as mesh= does
    assert rec["use_mesh"]["mesh"] == rec["gcn"]["mesh"]
    assert bit_equal(rec["use_mesh"]["leaves"], rec["gcn"]["leaves"])


@pytest.mark.parametrize("model", W.MODELS)
def test_each_wave_is_one_mesh_step_on_the_ranks_rows(ranks, model):
    """Every wave keeps one signature: one lowering of the wave (its mesh
    executable's reshard counters count each wave's call), its COO rows
    padded to the largest chunk rounded up to the ranks (nothing more
    padded by the mesh step) and cut in equal shares."""
    rec = ranks[0][model]["gcn"]
    bounds = rec["plan"][3]
    widest = max(b - a for a, b in zip(bounds, bounds[1:]))
    padded = -(-widest // 4) * 4
    data = 4 // model
    assert rec["pad_nnz"] == {}
    assert rec["edge_rows"] == padded // data
    assert rec["planned_edge"] is None and rec["planned_node"] is not None
    assert rec["reshard"]["calls"] == rec["waves"] and rec["reshard"]["bytes_moved"] == 0
    assert rec["spill"]["fetched_chunks"] == rec["waves"] and rec["spill"]["spilled_relations"] == 1
    assert rec["lower_count"] == 2  # the wave and the full env on meta
    assert any(kind.startswith("data:shard_nnz") for _, kind in rec["plans"])
    assert rec["resolutions"] == ["torch"]


def test_a_one_rank_mesh_is_bit_equal_to_the_meshless_budgeted_step(one_rank, reference):
    assert one_rank["mesh_shape"] == (1,)
    assert one_rank["mesh"]["streamed"] and one_rank["mesh"]["mesh"] == (1,)
    assert one_rank["mesh"]["plan"] == one_rank["one"]["plan"] == reference["plan"]
    assert bit_equal(one_rank["mesh"]["leaves"], one_rank["one"]["leaves"])
    assert_close(one_rank["mesh"]["leaves"], reference["incore"])


@pytest.mark.parametrize("part,wrt", [("logreg", ("theta",)), ("logreg_all", ("theta", "Rx", "Ry"))])
def test_logreg_streams_rx_with_its_costream_on_a_mesh(ranks, reference, part, wrt):
    rec = ranks[0][part]
    assert rec["streamed"] and rec["plan"] == reference["logreg_plan"]
    assert rec["plan"][0] == "Rx" and rec["plan"][1] == ("Ry",)
    assert_close(rec["leaves"], reference["logreg"][wrt])
    for r in ranks[1:]:
        assert bit_equal(r[part]["leaves"], rec["leaves"])


def test_a_fitting_budget_commits_layouts_and_moves_nothing(ranks):
    c = ranks[0]["committed"]
    assert not c["streamed"] and c["layouts"] and c["committed_types"] == ["DTensor"]
    assert c["warnings"] == []
    assert c["counters"]["bytes_moved"] == 0 and c["counters"]["last_call_bytes"] == 0
    assert c["db_counters"]["bytes_moved"] == 0
    assert c["losses"][0] == c["losses"][1]


def test_a_table_committed_to_another_layout_is_moved_and_warned_once(ranks):
    p = ranks[0]["committed"]["planted"]
    assert p["planned"] == ("data", "model")
    assert p["warnings"] == [p["rx_bytes"]]            # once, not per call
    assert p["moved"] == 2 * p["rx_bytes"]
    assert p["losses"] == [ranks[0]["committed"]["losses"][0]] * 2


def test_a_wave_left_out_is_caught(ranks, reference):
    # rank 1's merge left its last wave out; the other ranks' did not
    assert differs(ranks[1]["planted"]["leaves"], reference["incore"])
    assert not differs(ranks[0]["planted"]["leaves"], reference["incore"])


def test_release_drops_the_chunks(ranks):
    assert ranks[0]["release"] == (1, 0)


def test_a_budget_on_a_mesh_no_longer_raises():
    db = repro_torch.Database(device="cpu", mesh="host:2", memory_budget=1 << 20)
    assert db.memory_budget == 1 << 20 and db._mesh_spec == "host:2"
    budgeted = repro_torch.Database(device="cpu", memory_budget=1 << 20)
    assert budgeted.use_mesh("host") is budgeted and budgeted._mesh_spec == "host"
