"""Kernel contract certification in the port (``repro_torch.analysis.
kernelcheck``) and its ``sanitizer`` dispatch tier, held to the reference's
(``tests/test_kernelcheck.py``, case for case).

Three layers, as in the reference: golden-file diagnostics for seeded
contract violations (a racy grid, an out-of-bounds index map, an unpaired
VJP, a dtype-domain gap; the port's rendered reports equal the reference's
``tests/golden/kernelcheck/*.txt`` and the reference's own live reports,
with the tier names mapped by ``torch_tiers.map_tiers``), the acceptance
bar (the real registry certifies clean; a seeded racy or out-of-bounds
model is rejected through ``certify_kernels`` at a plan's dispatch sites,
the same GCN program lowered by both packages giving the same sites, codes
and report; a stateful predicate is caught by the resolution replay), and
the dynamic twin (the sanitizer raises ``SanitizerError`` whose ``kind`` is
the static verdict, and agrees with the ``ref`` tier through the engine,
forward and gradient).

Then what the port adds: each contract's launch model is the launch its
``plan()`` mirrors (the grids, blocks and kernel variants the C entry points
record on the card — ``tests/test_torch_cuda.py`` reads that record), the
CUDA hazards the models check (a reduction over a launched axis, a
workspace tile read before any launch wrote it, CUDA's grid limits), and the
sorted segment sum's routing on concrete ids.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathlib import Path

from repro.analysis import certify_kernels as jcertify_kernels
from repro.analysis import kernelcheck as jkernelcheck
from repro.core import fra as jfra
from repro.core import kernels as jK
from repro.core.autodiff import ra_autodiff as jra_autodiff
from repro.core.engine import RAEngine as JRAEngine
from repro.core import keys as jkeys
from repro.core.relation import CooRelation as JCoo
from repro.core.relation import DenseRelation as JDense
from repro_torch.analysis import certify_kernels, certify_registry
from repro_torch.analysis import kernelcheck
from repro_torch.analysis.diagnostics import CheckReport
from repro_torch.core import fra, keys
from repro_torch.core import kernels as K
from repro_torch.core.autodiff import ra_autodiff
from repro_torch.core.engine import RAEngine
from repro_torch.core.kernels import (
    AccumModel,
    BlockModel,
    GridModel,
    Interval,
    SanitizerError,
    VjpPair,
)
from repro_torch.core.relation import CooRelation, DenseRelation
from repro_torch.kernels.gather import ops as gather_ops
from repro_torch.kernels.gather.ref import gather_rows_ref
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.kernels.segsum import ops as segsum_ops
from repro_torch.kernels.segsum.ref import segment_sum_ref
from torch_tiers import map_tiers

GOLDEN = Path(__file__).parent / "golden" / "kernelcheck"

F32, I32 = torch.float32, torch.int32
SEG_INFO = {"nnz": 512, "dim": 128, "num_segments": 128, "dtype": F32}
JSEG_INFO = {"nnz": 512, "dim": 128, "num_segments": 128, "dtype": jnp.dtype("float32")}


# ---------------------------------------------------------------------------
# Seeded contract violations (shared by goldens, acceptance, sanitizer)
# ---------------------------------------------------------------------------


def _racy_grid_model(info, **concrete):
    """Output map ignores a non-reduction axis and there is no
    accumulator: every output block is stored grid[1] times."""
    return GridModel(
        grid=(2, 2),
        inputs=(BlockModel("msg", (256, 128), (128, 128), lambda i, j: (j, 0)),),
        output=BlockModel("out", (256, 128), (128, 128), lambda i, j: (i, 0)),
        accumulator=None,
    )


def _oob_grid_model(info, **concrete):
    """Input index map walks one block past the array."""
    return GridModel(
        grid=(2,),
        inputs=(BlockModel("msg", (256, 128), (128, 128), lambda i: (i + 1, 0)),),
        output=BlockModel("out", (256, 128), (128, 128), lambda i: (i, 0)),
        accumulator=None,
    )


def _jax_model(model_fn):
    """The same seeded model in the reference's vocabulary."""
    m = model_fn(None)
    blk = lambda b: jK.BlockModel(b.name, b.array_shape, b.block_shape, b.index_map)  # noqa: E731
    return lambda info, **c: jK.GridModel(m.grid, tuple(blk(b) for b in m.inputs), blk(m.output))


def _contract_with(grid_model, **overrides):
    base = K.kernel_contract("segment_sum")
    return dataclasses.replace(base, grid_model=grid_model, **overrides)


def _jcontract_with(grid_model, **overrides):
    return dataclasses.replace(jK.kernel_contract("segment_sum"), grid_model=grid_model, **overrides)


# ---------------------------------------------------------------------------
# Golden-file diagnostics, and the reference's live reports
# ---------------------------------------------------------------------------


def case_racy_grid(pkg):
    if pkg == "jax":
        c = _jcontract_with(_jax_model(_racy_grid_model))
        return jkernelcheck.CheckReport(tuple(jkernelcheck.check_contract_grid("segment_sum", c, [JSEG_INFO])))
    diags = kernelcheck.check_contract_grid("segment_sum", _contract_with(_racy_grid_model), [SEG_INFO])
    return CheckReport(tuple(diags))


def case_oob_index_map(pkg):
    if pkg == "jax":
        c = _jcontract_with(_jax_model(_oob_grid_model))
        return jkernelcheck.CheckReport(tuple(jkernelcheck.check_contract_grid("segment_sum", c, [JSEG_INFO])))
    diags = kernelcheck.check_contract_grid("segment_sum", _contract_with(_oob_grid_model), [SEG_INFO])
    return CheckReport(tuple(diags))


def case_unpaired_vjp(pkg):
    if pkg == "jax":
        impl = jK.KernelImpl("segment_sum", "pallas", lambda *a: None, ("tpu",), 0, jK._is_float)
        c = _jcontract_with(jK.kernel_contract("segment_sum").grid_model,
                            vjp_pairs=(jK.VjpPair("scatter_add", lambda info: dict(info)),))
        return jkernelcheck.CheckReport(tuple(jkernelcheck.check_impl(impl, c, [JSEG_INFO])))
    impl = K.KernelImpl("segment_sum", "cuda", lambda *a: None, ("cuda",), K._is_f32_bf16_f16)
    contract = _contract_with(
        K.kernel_contract("segment_sum").grid_model,
        vjp_pairs=(VjpPair("scatter_add", lambda info: dict(info)),),
    )
    return CheckReport(tuple(kernelcheck.check_impl(impl, contract, [SEG_INFO])))


def case_dtype_domain(pkg):
    # a hardware-tier impl with no floating predicate admits int32
    if pkg == "jax":
        impl = jK.KernelImpl("segment_sum", "interpret", lambda *a: None, (), 0, None)
        info = {"nnz": 1024, "dim": 64, "num_segments": 256, "dtype": jnp.dtype("int32")}
        return jkernelcheck.CheckReport(
            tuple(jkernelcheck.check_impl(impl, jK.kernel_contract("segment_sum"), [info])))
    impl = K.KernelImpl("segment_sum", "cuda", lambda *a: None, (), None)
    info = {"nnz": 1024, "dim": 64, "num_segments": 256, "dtype": I32}
    # the reference's segsum contract pairs no backward op; the port's pairs
    # gather_join (its backward is the gather kernel), whose cuda tier also
    # refuses int32 — a second, consequent error (vjp-domain-gap) that the
    # reference's case cannot show. The case takes the contract without it.
    contract = _contract_with(K.kernel_contract("segment_sum").grid_model, vjp_pairs=())
    return CheckReport(tuple(kernelcheck.check_impl(impl, contract, [info])))


CASES = {
    name[len("case_"):]: fn
    for name, fn in sorted(globals().items())
    if name.startswith("case_")
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    """The port's report is the reference's golden text, tier names mapped,
    and the reference's live report on the same seeded case."""
    got = CASES[name]("torch").render() + "\n"
    golden = (GOLDEN / f"{name}.txt").read_text()
    assert got == map_tiers(golden)
    assert got == map_tiers(CASES[name]("jax").render() + "\n")


def test_the_ports_own_contract_reports_the_consequent_vjp_gap():
    impl = K.KernelImpl("segment_sum", "cuda", lambda *a: None, (), None)
    info = {"nnz": 1024, "dim": 64, "num_segments": 256, "dtype": I32}
    report = CheckReport(tuple(kernelcheck.check_impl(impl, K.kernel_contract("segment_sum"), [info])))
    assert report.codes() == ("dtype-domain", "vjp-domain-gap")


def test_every_seeded_case_is_an_error_with_a_node_path():
    for name, fn in CASES.items():
        report = fn("torch")
        assert report.errors, name
        assert all(d.node_path for d in report.diagnostics), name
        assert report.codes() == fn("jax").codes(), name


# ---------------------------------------------------------------------------
# The acceptance bar: real registry clean, seeded violations rejected
# ---------------------------------------------------------------------------


def test_registry_certifies_clean():
    report = certify_registry()
    assert report.ok, report.render()
    assert report.render() == "ok (no diagnostics)" == jkernelcheck.certify_registry().render()


def test_cli_exits_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.kernelcheck"],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "kernelcheck: 3 dispatch op(s), 12 registered impl(s), 4 contract(s)" in proc.stdout
    assert "ok" in proc.stdout


def _gcn_prog_env(pkg):
    """COO conv: exercises gather_join + segment_sum sites, fwd + grad — the
    reference's program, in either package, on the same numpy inputs."""
    F, Ks, k = (jfra, jkeys, jK) if pkg == "jax" else (fra, keys, K)
    join = F.Join(Ks.eq_pred((0, 0)), Ks.jproj(Ks.L(1)), k.MUL, F.const("Edge", 2), F.scan("Node", 1))
    q = F.Query(F.Agg(Ks.identity_key(1), k.ADD, join), inputs=("Node",))
    sq = F.Select(Ks.TRUE, Ks.identity_key(1), k.SQUARE, q.root)
    loss = F.Agg(Ks.EMPTY_KEY, k.ADD, F.Select(Ks.TRUE, Ks.identity_key(1), k.SUM_CHUNK, sq))
    prog = (jra_autodiff if pkg == "jax" else ra_autodiff)(F.Query(loss, inputs=("Node",)))
    rng = np.random.default_rng(7)
    n, nnz, d = 16, 40, 8
    ids = np.stack([rng.integers(0, n, nnz), rng.integers(0, n, nnz)], 1).astype(np.int32)
    w = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if pkg == "jax":
        env = {"Edge": JCoo(jnp.asarray(ids, jnp.int32), jnp.asarray(w, jnp.float32), (n, n)),
               "Node": JDense(jnp.asarray(x, jnp.float32), 1)}
    else:
        env = {"Edge": CooRelation(torch.tensor(ids), torch.tensor(w), (n, n)),
               "Node": DenseRelation(torch.tensor(x), 1)}
    return prog, env


def test_certified_plan_reports_clean_kernels():
    prog, env = _gcn_prog_env("torch")
    low = RAEngine(prog).lower(env)
    report = certify_kernels(low)
    assert getattr(low.resolutions, "sites", ()), "no dispatch site recorded"
    assert report.ok, report.render()
    # cached on the Lowered: the second call is the same object
    assert certify_kernels(low) is report
    # the reference's lowering of the same program: the same sites, codes
    # and report
    jprog, jenv = _gcn_prog_env("jax")
    jlow = JRAEngine(jprog).lower(jenv)
    jreport = jcertify_kernels(jlow)
    assert [(r.op, r.site) for r in low.resolutions.sites] == [
        (r.op, r.site) for r in jlow.resolutions.sites]
    assert report.codes() == jreport.codes()
    assert report.render() == map_tiers(jreport.render())


@pytest.mark.parametrize(
    "bad_model,code",
    [(_racy_grid_model, "grid-race"), (_oob_grid_model, "grid-oob-index")],
)
def test_seeded_bad_blockspec_rejected_at_dispatch_sites(monkeypatch, bad_model, code):
    """A racy / out-of-bounds model in the segsum contract is statically
    rejected at the plan's actual dispatch sites, as in the reference."""
    import repro.kernels.segsum.ops as jsegsum_ops

    prog, env = _gcn_prog_env("torch")
    low = RAEngine(prog).lower(env)
    monkeypatch.setattr(segsum_ops, "CONTRACT", _contract_with(bad_model))
    report = certify_kernels(low, recheck=True)
    assert not report.ok
    hits = [d for d in report.errors if d.code == code]
    assert hits, report.render()
    assert all(d.node_path.startswith("dispatch:segment_sum[") for d in hits)
    jprog, jenv = _gcn_prog_env("jax")
    jlow = JRAEngine(jprog).lower(jenv)
    monkeypatch.setattr(jsegsum_ops, "CONTRACT", _jcontract_with(_jax_model(bad_model)))
    jreport = jcertify_kernels(jlow, recheck=True)
    assert report.render() == map_tiers(jreport.render())


def test_stateful_predicate_rejected():
    """A predicate that answers differently on replay flips the resolved
    tier between lowering and replay — certify_kernels replays every
    recorded site and reports ``flappy-predicate``."""
    state = {"accept": True}

    def stateful(info):
        return state["accept"]  # reads mutable state, not the site info

    # on the CPU the real cuda impl is device-gated out, so this is the
    # only eligible cuda entry: rejecting on replay falls to torch
    impl = K.register_impl("segment_sum", "cuda", K._IMPLS[("segment_sum", "ref")][0].fn,
                           predicate=stateful)
    try:
        prog, env = _gcn_prog_env("torch")
        low = RAEngine(prog).lower(env, dispatch=("cuda", "torch"))
        state["accept"] = False  # the state drifts before the replay
        report = certify_kernels(low, recheck=True)
    finally:
        K._IMPLS[("segment_sum", "cuda")].remove(impl)
    flappy = [d for d in report.errors if d.code == "flappy-predicate"]
    assert flappy, report.render()
    assert any(d.node_path.startswith("dispatch:") for d in flappy)


# ---------------------------------------------------------------------------
# Sanitizer tier: dynamic twin of the static certifier
# ---------------------------------------------------------------------------


def test_sanitizer_agrees_with_static_verdict(monkeypatch):
    """On the same seeded-bad contract, the sanitizer raises the exact
    code the static certifier reports."""
    rng = np.random.default_rng(0)
    msg = torch.tensor(rng.normal(size=(512, 128)).astype(np.float32))
    seg = torch.tensor(rng.integers(0, 128, 512).astype(np.int32))
    for bad_model in (_racy_grid_model, _oob_grid_model):
        contract = _contract_with(bad_model)
        monkeypatch.setattr(segsum_ops, "CONTRACT", contract)
        static = kernelcheck.check_contract_grid("segment_sum", contract, [SEG_INFO])
        with pytest.raises(SanitizerError) as exc:
            K._segsum_sanitizer(msg, seg, 128)
        assert exc.value.kind == static[0].code
    monkeypatch.undo()
    # dtype-domain dynamically (direct call bypasses the float predicate)
    with pytest.raises(SanitizerError) as exc:
        K._segsum_sanitizer(torch.ones((8, 4), dtype=torch.int32), seg[:8], 5)
    assert exc.value.kind == "dtype-domain"


@pytest.mark.parametrize("nnz", [100, 6000])  # the scan path; the sorted path
def test_sanitizer_clean_sites_match_ref_oracle(nnz):
    rng = np.random.default_rng(1)
    msg = torch.tensor(rng.normal(size=(nnz, 24)).astype(np.float32))
    seg = torch.tensor(rng.integers(-1, 30, nnz).astype(np.int32))  # pad ids too
    torch.testing.assert_close(K._segsum_sanitizer(msg, seg, 30), segment_sum_ref(msg, seg, 30),
                               atol=1e-5, rtol=0)
    table = torch.tensor(rng.normal(size=(30, 24)).astype(np.float32))
    rows = torch.tensor(rng.integers(-1, 31, 64).astype(np.int32))  # invalid rows
    torch.testing.assert_close(K._gather_sanitizer(table, rows), gather_rows_ref(table, rows),
                               atol=1e-5, rtol=0)
    x = torch.tensor(rng.normal(size=(5, 700)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(700, 9)).astype(np.float32))
    torch.testing.assert_close(K._matmul_sanitizer(x, y), x @ y, atol=1e-4, rtol=1e-5)


def test_sanitizer_tier_smoke_segsum_gather_fwd_grad():
    """The reference's smoke test: segsum + gather_join forward and
    gradient through the engine under the sanitizer tier agree with the
    ref tier; every site recorded under sanitizer, and certified."""
    prog, env = _gcn_prog_env("torch")
    eng = RAEngine(prog)
    out_r, grads_r = eng.lower(env, dispatch="ref").compile()(env)
    out_s, grads_s = eng.lower(env, dispatch="sanitizer").compile()(env)
    torch.testing.assert_close(out_s.data, out_r.data, rtol=1e-5, atol=1e-5)
    for name in grads_r:
        gr, gs = grads_r[name], grads_s[name]
        lr = gr.values if isinstance(gr, CooRelation) else gr.data
        ls = gs.values if isinstance(gs, CooRelation) else gs.data
        torch.testing.assert_close(ls, lr, rtol=1e-5, atol=1e-5)
    low = eng.lower(env, dispatch="sanitizer")
    assert certify_kernels(low).ok
    assert {rec.tier for rec in low.resolutions.sites} == {"sanitizer"}


# ---------------------------------------------------------------------------
# Property: certified-clean shape classes agree with the ref oracle
# ---------------------------------------------------------------------------


def _certify_and_run(nnz, dim, num_segments, seed):
    info = {"nnz": nnz, "dim": dim, "num_segments": num_segments, "dtype": F32}
    diags = kernelcheck.check_contract_grid("segment_sum", K.kernel_contract("segment_sum"), [info])
    assert diags == [], [d.render() for d in diags]
    rng = np.random.default_rng(seed)
    msg = torch.tensor(rng.normal(size=(nnz, dim)).astype(np.float32))
    seg = torch.tensor(rng.integers(-1, num_segments, nnz).astype(np.int32))
    torch.testing.assert_close(K._segsum_sanitizer(msg, seg, num_segments),
                               segment_sum_ref(msg, seg, num_segments), atol=1e-5, rtol=0)


def test_random_shape_classes_certify_clean_and_match_oracle():
    """Seeded-random fallback for environments without hypothesis."""
    rng = np.random.default_rng(42)
    for trial in range(20):
        nnz = int(rng.integers(1, 1500))
        dim = int(rng.integers(1, 160))
        num_segments = int(rng.integers(1, 400))
        _certify_and_run(nnz, dim, num_segments, seed=trial)


def test_hypothesis_shape_classes_certify_clean_and_match_oracle():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(nnz=st.integers(1, 6000), dim=st.integers(1, 200), num_segments=st.integers(1, 500))
    def prop(nnz, dim, num_segments):
        _certify_and_run(nnz, dim, num_segments, seed=nnz * 31 + dim)

    prop()


# ---------------------------------------------------------------------------
# The port's own: each model is the launch its plan() mirrors
# ---------------------------------------------------------------------------

#: sites of the chip's checks, plus edges: the GCN at ogbn-arxiv size, the
#: LM embedding's scan path, KGE's D = 50 (element units), the ragged
#: n = 14,576 of zamba2's in_proj, the skinny and split-K products, the
#: scan at falcon-mamba's prefill and its reverse walk
SEGSUM_SITES = [(1335586, 128, 169343, F32), (4096, 3584, 32000, F32), (5000, 50, 3, F32),
                (2048, 7168, 2048, torch.bfloat16), (7, 3, 5, F32), (0, 4, 3, F32)]
GATHER_SITES = [(1335586, 169343, 128, F32), (1024, 20000, 50, F32), (2, 65024, 4096, F32),
                (7, 5, 3, torch.float16)]
MATMUL_SITES = [(169343, 128, 256), (169343, 256, 40), (2, 3584, 14576), (2048, 3584, 14576),
                (16, 1048576, 1), (1, 0, 5), (100, 2000, 300), (7, 5, 3)]
SSM_SITES = [(2, 1024, 8192, 16, False), (4, 1024, 8192, 16, True), (3, 7, 5, 2, False)]


def _launches(op, info):
    return K.model_launches(K.kernel_contract(op).grid_model(info))


@pytest.mark.parametrize("e,d,s,dtype", SEGSUM_SITES)
def test_segsum_model_is_the_plans_launch(e, d, s, dtype):
    info = {"nnz": e, "dim": d, "num_segments": s, "dtype": dtype}
    p = segsum_ops.plan(e, d, s, segsum_ops.ELEM_BYTES[dtype])
    got = _launches("segment_sum", info)
    unit = f".{p.unit * segsum_ops.ELEM_BYTES[dtype]}"
    block = (segsum_ops.THREADS, 1, 1)
    if p.path == "scan":
        assert got == (("segsum_scan" + unit, p.grid + (1,), block),)
    else:
        assert got == (
            ("segsum_starts.0", (-(-(s + 1) // 256), 1, 1), block),
            ("segsum_chunk" + unit, p.grid + (1,), block),
            ("segsum_combine.0", p.combine_grid + (1,), block),
        )
    assert K.simulate_grid(K.kernel_contract("segment_sum").grid_model(info)) == []


@pytest.mark.parametrize("e,n,d,dtype", GATHER_SITES)
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_model_is_the_plans_launch(e, n, d, dtype, aligned):
    info = {"rows": e, "num_rows": n, "dim": d, "dtype": dtype}
    p = gather_ops.plan(e, d, gather_ops.ELEM_BYTES[dtype], aligned)
    model = K.kernel_contract("gather_join").grid_model(info, aligned=aligned)
    assert K.model_launches(model) == ((f"gather.{p.unit}", p.grid + (1,), (p.lanes, p.slots, 1)),)
    assert K.simulate_grid(model) == []


@pytest.mark.parametrize("m,k,n", MATMUL_SITES)
def test_matmul_model_is_the_plans_launch(m, k, n):
    p = matmul_ops.plan(m, k, n)
    got = _launches("blocked_matmul", {"m": m, "k": k, "n": n, "dtype": F32})
    kinds = [g[0].split(".")[0] for g in got]
    if p.path == "tiled":
        tn = 64 if n <= 64 else 128
        assert got[0] == (f"matmul_tiled.{tn}", p.grid, (256, 1, 1))
    elif k:
        assert got[0] == ("matmul_skinny.0", p.grid, (128, 1, 1))
    if p.split:
        lanes = 32 if p.n_segments > matmul_ops.REDUCE_LONG_CHAIN else 1
        assert got[-1] == (f"matmul_reduce.{lanes}", (p.reduce_blocks, 1, 1), (256, 1, 1))
    assert kinds.count("matmul_reduce") == int(p.split)
    assert K.simulate_grid(K.kernel_contract("blocked_matmul").grid_model(
        {"m": m, "k": k, "n": n, "dtype": F32})) == []


@pytest.mark.parametrize("b,s,c,n,rev", SSM_SITES)
def test_ssm_scan_model_is_the_plans_launch(b, s, c, n, rev):
    from repro_torch.kernels.ssm_scan.ops import plan as ssm_plan

    info = {"batch": b, "seq": s, "channels": c, "state": n, "dtype": F32, "reverse": rev}
    assert _launches("ssm_scan", info) == (
        (f"ssm_scan.{int(rev)}", (ssm_plan(b, s, c * n).blocks, 1, 1), (128, 1, 1)),)
    assert K.simulate_grid(K.kernel_contract("ssm_scan").grid_model(info)) == []


def test_a_model_with_one_slab_too_few_is_rejected():
    """The planted mismatch of the card's check, statically: the gather's
    grid one column slab short leaves output tiles uncovered, and its
    launches no longer equal the plan's."""
    info = {"rows": 1000, "num_rows": 300, "dim": 4096, "dtype": F32}
    good = K.kernel_contract("gather_join").grid_model(info)
    short = dataclasses.replace(good, grid=(good.grid[0], good.grid[1] - 1))
    assert good.grid[1] > 1
    assert [k for k, _ in K.simulate_grid(short)] == ["grid-uncovered"]
    assert K.model_launches(short) != K.model_launches(good)


def test_cuda_hazards_the_models_check():
    """A reduction over a launched blockIdx axis races (its blocks run
    concurrently); a launch beyond CUDA's limits; a workspace tile that a
    later launch reads but no earlier one wrote."""
    racy = GridModel(
        grid=(2, 4),
        inputs=(BlockModel("x", (2, 4), (1, 1), lambda i, k: (i, k)),),
        output=BlockModel("out", (2,), (1,), lambda i, k: (i,)),
        accumulator=AccumModel(axis=1), kernel="sum.0", block=(32, 1, 1), loops=0,
    )
    assert [k for k, _ in K.simulate_grid(racy)] == ["grid-race"]
    assert K.simulate_grid(dataclasses.replace(racy, loops=1)) == []
    wide = dataclasses.replace(racy, grid=(2, 70000), loops=0, accumulator=None,
                               output=BlockModel("out", (2, 70000), (1, 1), lambda i, k: (i, k)))
    assert "launch-limit" in [k for k, _ in K.simulate_grid(wide)]
    # split-K: the product one segment short; the ordered sum reads it all
    info = {"m": 100, "k": 2000, "n": 300, "dtype": F32}
    product, reduce = K.kernel_contract("blocked_matmul").grid_model(info)
    short = dataclasses.replace(product, grid=product.grid[:2] + (product.grid[2] - 1,))
    kinds = [k for k, _ in K.simulate_grid((short, reduce))]
    assert kinds == ["grid-uncovered", "uninit-accumulator"]


def test_gather_rows_sharpen_the_table_interval():
    info = {"rows": 2000, "num_rows": 50, "dim": 8, "dtype": F32}
    p = gather_ops.plan(2000, 8)
    per_block = p.slots * p.rows_per_thread
    assert p.grid[0] == 2 and per_block == 1024
    rows = torch.full((2000,), -1, dtype=torch.int32)
    rows[:per_block] = torch.arange(per_block, dtype=torch.int32) % 50
    model = K.kernel_contract("gather_join").grid_model(info, rows=rows)
    table = model.inputs[1]
    assert table.index_map(0, 0) == (Interval(0, 49), 0)
    assert table.index_map(1, 0) is None  # a group of padding ids reads no table row
    assert K.simulate_grid(model) == []


def test_sorted_path_routing_on_concrete_ids(monkeypatch):
    """The sorted path's writes, as its kernels route them: every output row
    once, every workspace row the combine reads written once — also where
    segments run longer than a chunk; a routing that writes a row twice is
    a race."""
    info = {"nnz": 6000, "dim": 16, "num_segments": 40, "dtype": F32}
    rng = np.random.default_rng(3)
    for ids in (rng.integers(-1, 40, 6000), np.repeat(np.arange(3), 2000)):
        seg = torch.tensor(ids.astype(np.int32))
        r = segsum_ops.routing(seg, 40)
        assert (r["out"] == 1).all() and (r["ws_written"] <= 1).all()
        assert ((r["ws_read"] == 0) | (r["ws_written"] == 1)).all()
        assert segsum_ops._routing_check(info, seg=seg) == []
    assert r["ws_read"].sum() > 0  # long segments combine through the workspace
    real = segsum_ops.routing

    def doubled(seg, s):
        out = real(seg, s)
        out["out"][0] += 1
        return out

    monkeypatch.setattr(segsum_ops, "routing", doubled)
    with pytest.raises(SanitizerError) as exc:
        K._segsum_sanitizer(torch.ones((6000, 16)), seg, 40)
    assert exc.value.kind == "grid-race"
