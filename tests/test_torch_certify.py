"""The static plan certifier in the port (``repro_torch.analysis.certify``),
held to the reference's (``tests/test_certify.py`` and the wave
certificates of ``tests/test_oocore.py``): certificates *prove* plan
properties off the compile records — COO owner-partition soundness, wave
soundness of a streamed plan, RJP grad-derivability and the kernel sites —
before any execution pays for them.

Each parity case feeds the same numpy-seeded inputs (explicit float32 /
int32) to both packages, the reference as its own tests run it, the port on
``Database(device="cpu")``, and compares the certificates' ``coo``,
``waves``, ``grad`` and ``kernels`` sections.

The reference's two mesh tests (``test_certify.py:142``, ``:194``:
zero-unplanned-reshard on an 8-device mesh, and a session step on a mesh)
wait for multi-device planning (ROADMAP.md, queue 1 item 4): the port has
no mesh yet, and ``certify`` of a plan on one raises.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro
import repro_torch
from repro.analysis import certify as jcertify
from repro.analysis.certify import certify_grad as jcertify_grad
from repro.core.engine import engine_for as jengine_for
from repro_torch.analysis import Certificate, certify
from repro_torch.analysis.certify import _certify_waves, certify_grad
from repro_torch.core.engine import StreamedCompiled, engine_for
from repro_torch.core.relation import COO_PAD_KEY
from test_torch_oocore import (
    JAX,
    LOGREG_SQL,
    TORCH,
    gcn_bytes,
    gcn_fill,
    gcn_query,
    logreg_bytes,
    logreg_fill,
)


def _matmul_query(pkg):
    fra, K, k = pkg.fra, pkg.K, pkg.k
    join = fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1), K.R(1)), k.MATMUL,
                    fra.scan("A", 2), fra.scan("B", 2))
    return fra.Query(fra.Agg(K.project_key(0, 2), k.ADD, join), inputs=("A", "B"))


def _matmul_env(pkg, n=4, m=8, seed=0):
    rng = np.random.default_rng(seed)
    rel = (repro.core.relation if pkg is JAX else repro_torch.core.relation).DenseRelation
    return {name: rel(pkg.array(rng.normal(size=(n, n, m, m)).astype(np.float32)), 2)
            for name in ("A", "B")}


def _compiled(pkg, q, env):
    return (jengine_for if pkg is JAX else engine_for)(q).lower(env).compile()


def _sections(cert):
    d = cert.to_dict()
    return {k: d[k] for k in ("kind", "ok", "coo", "waves", "grad", "kernels")}


# ---------------------------------------------------------------------------
# mesh-less certificates: trivially proven, still structured
# ---------------------------------------------------------------------------


def test_meshless_plan_certifies_trivially():
    q, env = _matmul_query(TORCH), _matmul_env(TORCH)
    cert = certify(_compiled(TORCH, q, env), env, query=q)
    assert isinstance(cert, Certificate)
    assert cert.kind == "in-core"
    assert cert.ok and cert.zero_unplanned_reshard
    assert "mesh-less" in cert.reshard["reason"]
    assert cert.grad is not None and cert.grad["full_rjp"]
    d = cert.to_dict()
    assert d["ok"] and d["kind"] == "in-core"
    assert "OK" in cert.render()
    jq, jenv = _matmul_query(JAX), _matmul_env(JAX)
    jcert = jcertify(_compiled(JAX, jq, jenv), jenv, query=jq)
    assert _sections(cert) == _sections(jcert)
    assert cert.reshard == jcert.reshard
    assert cert.render() == jcert.render()


def test_certify_rejects_non_compiled():
    with pytest.raises(TypeError, match="cannot certify"):
        certify(object(), {})


def test_a_plan_on_a_mesh_waits_for_multi_device_planning():
    q, env = _matmul_query(TORCH), _matmul_env(TORCH)
    with pytest.raises(NotImplementedError, match="item 4"):
        certify(SimpleNamespace(mesh=object()), env)
    with pytest.raises(NotImplementedError, match="item 4"):
        certify(_compiled(TORCH, q, env), env, committed={"A": ("x",)})


# ---------------------------------------------------------------------------
# grad derivability, pre-compile
# ---------------------------------------------------------------------------


def test_certify_grad_full_vs_partial():
    # matmul: both input keys solvable from the Σ∘⋈ output → full RJP
    g = certify_grad(_matmul_query(TORCH), ("A", "B"))
    assert g["full_rjp"]
    assert set(g["joins"]) == {"Σ/⋈"}
    assert g["joins"]["Σ/⋈"] == {"left": "solvable", "right": "solvable"}
    assert g == jcertify_grad(_matmul_query(JAX), ("A", "B"))

    # a ⋈ whose output keeps only B's free key: A's key is unsolvable
    def partial(pkg):
        fra, K, k = pkg.fra, pkg.K, pkg.k
        join = fra.Join(K.eq_pred((1, 0)), K.jproj(K.R(1)), k.MUL, fra.scan("A", 2), fra.scan("B", 2))
        return fra.Query(fra.Agg(K.identity_key(1), k.ADD, join), inputs=("A", "B"))

    g = certify_grad(partial(TORCH), ("A",))
    assert not g["full_rjp"]
    assert g["joins"]["Σ/⋈"]["left"] == "partial"
    assert g["joins"]["Σ/⋈"]["right"] == "n/a"  # B is not a wrt input
    assert g == jcertify_grad(partial(JAX), ("A",))


# ---------------------------------------------------------------------------
# COO owner-partition soundness (no mesh needed)
# ---------------------------------------------------------------------------


def _owner_coo(pkg, offsets, owners, extent=8):
    rel = repro.core.relation if pkg is JAX else repro_torch.core.relation
    keys = np.stack([np.asarray(owners, np.int32), np.zeros(len(owners), np.int32)], axis=1)
    return rel.CooRelation(pkg.array(keys), pkg.array(np.ones((len(owners),), np.float32)),
                           (extent, extent), owner_dim=0, shard_offsets=tuple(offsets))


@pytest.mark.parametrize("offsets,owners,ok", [
    ((0, 4), (0, 2, 4, 6), True),     # sound: owner-sorted, offsets = first keys
    ((0, 3), (0, 2, 4, 6), False),    # shard 1 claims first owner 3 but holds 4
    ((0, 1), (0, 5, 1, 6), False),    # monotone offsets, rows out of owner order
])
def test_coo_owner_partition_soundness_proof(offsets, owners, ok):
    certs = []
    for pkg in (TORCH, JAX):
        q, env = _matmul_query(pkg), _matmul_env(pkg)
        comp = _compiled(pkg, q, env)
        env = dict(env, E=_owner_coo(pkg, offsets, owners))
        certs.append((jcertify if pkg is JAX else certify)(comp, env))
    cert, jcert = certs
    assert cert.coo["relations"]["E"]["ok"] is ok and cert.ok is ok
    assert cert.coo == jcert.coo


# ---------------------------------------------------------------------------
# static wave certification (tests/test_oocore.py:478-562)
# ---------------------------------------------------------------------------


def _logreg_streamed(pkg):
    db = logreg_fill(pkg, pkg.db(memory_budget=logreg_bytes() * 0.7))
    env = {n: db.get(n) for n in ("Rx", "Ry", "theta")}  # before spill
    h = db.sql(LOGREG_SQL, wrt=("theta", "Rx", "Ry"))
    h.step()
    return env, h


def test_streamed_logreg_plan_certifies():
    """The certifier re-derives wave soundness for a streamed plan:
    boundary coverage, budget sizing and grad derivability — proven off
    the plan record — and so does the reference, to the same section."""
    env, h = _logreg_streamed(TORCH)
    assert isinstance(h.last, StreamedCompiled)
    cert = certify(h.last, env, query=h.query, wrt=("theta",))
    assert cert.kind == "streamed"
    assert cert.waves["boundaries_ok"] and cert.waves["budget_ok"]
    assert cert.waves["num_waves"] == h.last.num_waves == 2
    assert cert.waves["max_wave_bytes"] <= cert.waves["budget"]
    assert cert.ok
    assert cert.grad is not None and cert.grad["full_rjp"]
    assert "waves: ok" in cert.render()
    jenv, jh = _logreg_streamed(JAX)
    jcert = jcertify(jh.last, jenv, query=jh.query, wrt=("theta",))
    assert _sections(cert) == _sections(jcert)


def _gcn_streamed(pkg, n=60):
    total = gcn_bytes(n=n)
    db = gcn_fill(pkg, pkg.db(memory_budget=total / 3), n=n)
    env = {"Edge": db.get("Edge"), "Node": db.get("Node")}
    h = db.query(gcn_query(pkg, n))
    h.step(wrt=("Edge", "Node"))
    return env, h


def test_streamed_gcn_plan_certifies_owner_alignment():
    """Owner-partitioned COO streams certify end to end: the wave cuts
    never straddle an owner run, and the edge relation's shard offsets are
    consistent with its owner column; the kernel sites certify clean."""
    env, h = _gcn_streamed(TORCH)
    assert h.last.plan.owner_aligned
    cert = certify(h.last, env)
    assert cert.ok
    assert cert.waves["owner_aligned_ok"]
    assert cert.coo["relations"]["Edge"]["ok"]
    assert cert.kernels["ok"] and cert.kernels["sites"] > 0
    jenv, jh = _gcn_streamed(JAX)
    assert _sections(cert) == _sections(jcertify(jh.last, jenv))


def test_wave_certifier_rejects_tampered_plans():
    """Negative control: the certifier is an independent checker, so a
    corrupted plan record must fail it — non-covering boundaries, a cut
    through an owner run, and an over-budget wave count all flag."""
    env, h = _logreg_streamed(TORCH)
    plan = h.last.plan
    assert _certify_waves(h.last, env)["ok"]  # sanity: genuine plan passes

    short = dataclasses.replace(plan, boundaries=plan.boundaries[:-1] + (63,))
    assert not _certify_waves(SimpleNamespace(plan=short), env)["boundaries_ok"]

    crowded = dataclasses.replace(plan, num_waves=1, boundaries=(0, 64))
    assert not _certify_waves(SimpleNamespace(plan=crowded), env)["budget_ok"]

    # owner-run straddle: a GCN edge plan with a cut moved off its
    # owner-aligned snap point
    env2, h2 = _gcn_streamed(TORCH)
    owners = env2["Edge"].keys[:, env2["Edge"].owner_dim].numpy()
    cut = next(c for c in range(1, owners.shape[0] - 1)
               if owners[c - 1] == owners[c] != COO_PAD_KEY)
    bad = dataclasses.replace(h2.last.plan, boundaries=(0, cut, int(owners.shape[0])), num_waves=2)
    assert not _certify_waves(SimpleNamespace(plan=bad), env2)["owner_aligned_ok"]


# ---------------------------------------------------------------------------
# the kernels section: a seeded bad contract fails the certificate
# ---------------------------------------------------------------------------


def test_a_bad_kernel_contract_fails_the_certificate(monkeypatch):
    from repro_torch.core import kernels as K
    from repro_torch.kernels.segsum import ops as segsum_ops

    env, h = _gcn_streamed(TORCH)
    low = h.last.lowered
    model = segsum_ops.CONTRACT.grid_model

    def short(info, **concrete):
        # the sum kernel's grid one column slab short
        m = model(info, **concrete)
        first = m[1] if isinstance(m, tuple) else m
        return dataclasses.replace(first, grid=(first.grid[0] - 1,) + first.grid[1:])

    monkeypatch.setattr(segsum_ops, "CONTRACT", dataclasses.replace(segsum_ops.CONTRACT, grid_model=short))
    low._kernel_report = None
    cert = certify(h.last, env)
    assert not cert.ok and not cert.kernels["ok"]
    assert "grid-uncovered" in cert.kernels["codes"]
    assert isinstance(K.kernel_contract("segment_sum"), K.KernelContract)
