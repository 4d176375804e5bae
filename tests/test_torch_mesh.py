"""The relational engine on a mesh, on 4 ``gloo`` ranks on the CPU: the
GCN training step (gcn_conv + rel_linear), the GCN query's step through
``Database(mesh=...).query(...).step()`` and an NNMF-shaped product
(rel_matmul_blocked) on 4×1, 1×4 and 2×2 host meshes, held to the
one-process step and to the reference's one-device step; the ranks held
to each other bit for bit; a planted missing reduction; the non-divisible
fallback, COO padding, committed layouts and the mesh half of the
certifier.

The ranks start once for the module (``launch.mesh.start_ranks``) and run
``tests/torch_mesh_workers.run_checks``; each test reads its part.

The bound. A mesh step sums the same f32 terms as the one-process step
in another order: each rank sums its share, then the shares are added.
Reordering a sum of K terms moves it by at most about K·u·Σ|a_i| (u =
2⁻²⁴), and by about √K·u·Σ|a_i| for rounding errors of random sign. The
product is held entrywise to 8·u·√K·Σ|a_i| from its own terms; a value
whose terms the test does not see (a GCN weight gradient, ∂/∂Node) to
64·u·√K·max|value| of the one-process step's, K the longest sum the mesh
step reorders (the N nodes, the E edges), a limit the planted missing
reduction must exceed. The loss: 1e-5 relative, as chip_smoke.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
import torch_mesh_workers as W
from repro.relational import gcn_conv as jax_gcn_conv
from repro.relational import rel_linear as jax_rel_linear
from repro_torch.launch.mesh import start_ranks

U = 2.0 ** -24


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of ``run_checks`` (4 gloo ranks on the CPU)."""
    return start_ranks(W.run_checks, 4, backend="gloo", device="cpu")


def _limit(terms_abs_sum, k):
    return 8.0 * U * np.sqrt(k) * terms_abs_sum


def _close(got, want, k) -> bool:
    """Within 64·u·√K·max|want| (module docstring)."""
    return np.abs(got - want).max() <= 64.0 * U * np.sqrt(k) * np.abs(want).max()


@pytest.mark.parametrize("model", W.MODELS)
def test_gcn_step_equals_the_one_process_step(ranks, model):
    one, rec = ranks[0]["one"]["gcn"], ranks[0][model]
    for got in (rec["gcn"], rec["gcn_tight"]):
        assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        for k in ("w1", "w2"):
            assert _close(got[k], one[k], W.N), k


@pytest.mark.parametrize("model", W.MODELS)
def test_ranks_are_bit_equal(ranks, model):
    for r in ranks[1:]:
        for part in ("gcn", "gcn_tight", "query", "product"):
            a, b = ranks[0][model][part], r[model][part]
            for k, v in a.items():
                if isinstance(v, np.ndarray):
                    assert np.array_equal(v, b[k]), (part, k)
                elif k == "loss":
                    assert v == b[k], (part, k)


@pytest.mark.parametrize("model", W.MODELS)
def test_two_runs_on_one_mesh_are_bit_equal(ranks, model):
    a, b = ranks[0][model]["query"], ranks[0][model]["again"]
    assert a["loss"] == b["loss"]
    assert np.array_equal(a["dnode"], b["dnode"]) and np.array_equal(a["dedge"], b["dedge"])


@pytest.mark.parametrize("model", W.MODELS)
def test_gcn_query_step_plans_and_equals_the_one_process_step(ranks, model):
    one, got = ranks[0]["one"]["query"], ranks[0][model]["query"]
    g, _, _ = W.problem()
    rows = g["edge_keys"].shape[0]
    assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    # ∂/∂Node: a sum over the edges into each node (K ≤ E terms)
    assert _close(got["dnode"], one["dnode"], rows)
    # ∂/∂Edge: one product per edge, gathered whole, its pad rows cut off
    assert got["dedge"].shape == one["dedge"].shape == (rows,)
    assert np.abs(got["dedge"] - one["dedge"]).max() <= 1e-6 * np.abs(one["dedge"]).max()
    data = {1: 4, 4: 1, 2: 2}[model]
    (kind, data_kind, psum, data_psum), = got["plans"].values()
    if data > 1:
        # the edge relation's nnz rows split over the data ranks, padded
        assert data_kind == "data:shard_nnz_left" and data_psum and not psum
        assert got["placements"]["Edge"] == {"data": 0, "model": None}
        padded = -(-rows // data) * data
        assert got["pad_nnz"] == {"Edge": padded}
        assert got["edge_rows"] == padded // data
    else:
        assert data_kind == "none" and got["pad_nnz"] == {} and got["edge_rows"] == rows


@pytest.mark.parametrize("model", W.MODELS)
def test_product_equals_the_one_process_product(ranks, model):
    one, got = ranks[0]["one"]["product"], ranks[0][model]["product"]
    x, w = W.product_problem()
    k = W.BK * W.B
    xa = np.abs(x).transpose(0, 2, 1, 3).reshape(W.BI * W.B, k)
    wa = np.abs(w).transpose(0, 2, 1, 3).reshape(k, W.BJ * W.B)
    limit = _limit(xa @ wa, k).reshape(W.BI, W.B, W.BJ, W.B).transpose(0, 2, 1, 3)
    assert (np.abs(got["out"] - one["out"]) <= limit).all()
    for d in ("dx", "dw"):
        assert _close(got[d], one[d], k)
    if model > 1:
        # a budget no block grid fits: co-partitioned on the contraction key
        assert any(kind == "copartition" for kind, _ in ranks[0][model]["product_plans"])


def test_gcn_step_equals_the_reference_one_device_step(ranks):
    g, y, params = W.problem()
    jx, jkeys = jnp.asarray(g["x"], jnp.float32), jnp.asarray(g["edge_keys"], jnp.int32)
    jw, jy = jnp.asarray(g["edge_w"], jnp.float32), jnp.asarray(y, jnp.int32)

    def loss(p):
        h = jax.nn.relu(jax_rel_linear(jax_gcn_conv(jx, jkeys, jw), p["w1"]))
        logp = jax.nn.log_softmax(jax_rel_linear(jax_gcn_conv(h, jkeys, jw), p["w2"]))
        return -jnp.mean(jnp.take_along_axis(logp, jy[:, None], axis=1))

    with repro.Database(dispatch="ref").activate():
        want, grads = jax.value_and_grad(loss)({k: jnp.asarray(v) for k, v in params.items()})
    for model in W.MODELS:
        got = ranks[0][model]["gcn"]
        assert abs(got["loss"] - float(want)) <= 1e-5 * abs(float(want))
        for k in ("w1", "w2"):
            ref = np.asarray(grads[k])
            assert np.abs(got[k] - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-7, (model, k)


def test_product_equals_the_reference_one_device_product(ranks):
    from repro.relational.linear import rel_matmul_blocked as jax_rel_matmul_blocked

    x, w = W.product_problem()

    def loss(xw):
        out = jax_rel_matmul_blocked(*xw)
        return jnp.sum(out * out), out

    with repro.Database(dispatch="ref").activate():
        (_, out), (dx, dw) = jax.value_and_grad(loss, has_aux=True)(
            (jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)))
    k = W.BK * W.B
    for model in W.MODELS:
        got = ranks[0][model]["product"]
        for name, ref in (("out", out), ("dx", dx), ("dw", dw)):
            assert _close(got[name], np.asarray(ref), k), (model, name)


def test_a_missing_reduction_fails_the_bound(ranks):
    one, bad = ranks[0]["one"]["query"], ranks[0]["planted"]
    rows = W.problem()[0]["edge_keys"].shape[0]
    assert abs(bad["loss"] - one["loss"]) > 1e-5 * abs(one["loss"])
    assert not _close(bad["dnode"], one["dnode"], rows)


def test_collectives_are_recorded_where_the_plan_puts_them(ranks):
    # 4×1: each gcn_conv's Σ-scatter is a reduce-scatter over the data
    # ranks, and its output is gathered whole: 3 convolutions per step
    # (two forward, one backward: the first layer's input needs no gradient)
    rec = ranks[0][1]["gcn_collectives"]
    assert set(rec) == {"reduce_scatter/data", "all_gather/data"}
    assert rec["reduce_scatter/data"]["calls"] == 3 and rec["all_gather/data"]["calls"] == 3
    # the whole (N, D) grid in, a quarter of it out, at D = 8, 16, 16
    grid = W.N * (W.FEAT + 2 * W.HIDDEN) * 4
    assert rec["reduce_scatter/data"]["bytes"] == grid
    assert rec["all_gather/data"]["bytes"] == grid // 4
    assert ranks[0][4]["gcn_collectives"] == {}   # 1×4: nothing sharded by default


def test_non_divisible_dim_falls_back_to_replication(ranks):
    fb = ranks[0]["fallback"]
    assert fb["warnings"] and all(c == "ShardFallbackWarning" for c, _, _ in fb["warnings"])
    assert ("ShardFallbackWarning", "X", 1) in fb["warnings"]
    assert np.abs(fb["out"] - fb["want"]).max() <= 1e-5 * np.abs(fb["want"]).max()


def test_committed_layouts_reshard_counters_and_certificates(ranks):
    c = ranks[0]["committed"]
    node_bytes = W.N * W.FEAT * 4
    assert c["clean_ok"] and c["clean"]["reshard"]["proven_zero_unplanned"]
    assert c["clean"]["divisibility"]["ok"]
    nnz = c["clean"]["divisibility"]["relations"]["Edge"][0]
    assert nnz["divisor"] == 4 and nnz["padded"] % 4 == 0 and nnz["ok"]
    assert not c["bad_ok"]
    node = c["bad_reshard"]["relations"]["Node"]
    assert node["status"] == "unplanned" and node["bytes"] == node_bytes
    assert c["reshard_warnings"] == [node_bytes]           # once, not per call
    assert c["counters"] == {"calls": 2, "resharded_calls": 2, "bytes_moved": 2 * node_bytes,
                             "last_call_bytes": node_bytes, "planned_bytes": 0}
    assert c["losses"] == [c["want"], c["want"]]
    assert c["kernels_ok"] and c["kernel_sites"] > 0


def test_memory_budget_on_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="memory budget on a mesh"):
        repro_torch.Database(device="cpu", mesh="host:2", memory_budget=1 << 20)
    db = repro_torch.Database(device="cpu", memory_budget=1 << 20)
    with pytest.raises(NotImplementedError, match="memory budget on a mesh"):
        db.use_mesh("host")


def test_the_ambient_mesh_and_the_session_mesh():
    from repro_torch.core import engine

    class Mesh:   # a stand-in: nothing here plans on it
        pass

    outer, inner = Mesh(), Mesh()
    db = repro_torch.Database(device="cpu")
    assert engine.default_mesh() is None and db._step_mesh() is None
    with engine._use_mesh(outer):
        with engine._use_mesh(inner):
            assert engine.default_mesh() is inner and db._step_mesh() is inner
        assert engine._ambient_mesh() is outer
        own = repro_torch.Database(device="cpu", mesh=inner)
        assert own.mesh is inner and own._step_mesh() is inner
        assert own.use_mesh(None)._step_mesh() is outer
    assert engine.default_mesh() is None
