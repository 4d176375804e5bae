"""LM training in the JAX package and in the port: the loss, the synthetic
pipeline, one ``make_train_step`` step of the reduced olmoe-1b-7b (2
layers, d_model 256, 4 experts, top-2, vocab 512) and of the reduced
falcon-mamba-7b (2 Mamba-1 layers, d_model 256, vocab 512, the scan kernel's
path: its VJP's reverse walk) from the same weights and batch, donation,
rematerialization under the "nothing" and the "dots" policy, checkpoints
across the two packages, and the two training examples (``lm_train``,
``gcn_train``).

The JAX side runs under ``repro.Database(dispatch="interpret")``; the
port's under ``repro_torch.Database(device="cpu")``, where every kernel
wrapper takes its plain version. Every JAX input is an explicit
float32/int32 array.
"""

import dataclasses
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data import synthetic_lm_batches as jax_synthetic_lm_batches
from repro.models import build_model as jax_build_model
from repro.optim import adam_init as jax_adam_init
from repro.train import lm_loss as jax_lm_loss
from repro.train import make_train_step as jax_make_train_step
from repro_torch import convert, kernels
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.engine import engine_for
from repro_torch.data import synthetic_lm_batches
from repro_torch.examples import gcn_train, lm_train
from repro_torch.models import build_model
from repro_torch.relational.linear import _linear_prog
from repro_torch.train import init_train_state, lm_loss, make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "olmoe-1b-7b"
#: the architectures of the one-step parity tests: olmoe, and falcon-mamba
#: through ssm_scan (``ssm_pallas=True``)
TRAIN_ARCHS = ("olmoe-1b-7b", "falcon-mamba-7b")
BATCH, SEQ = 2, 40
#: the loss and the aux loss, absolute and relative: a mean over 80 tokens
#: of f32 log-sum-exps of logits that agree to a few roundings (see
#: tests/test_torch_olmoe.py)
TOL = 1e-5
#: a parameter or Adam moment after one step, relative in the 2-norm. The
#: gradients sum ≤ 80 tokens × ≤ 512 terms in other f32 orders on the two
#: sides, ≈ √K·u ≈ 1e-6 of their size; the first Adam step divides m̂ by
#: √v̂ (about sign(g)·lr), so each updated tensor keeps that relative gap.
#: 1e-5 allows 10 times it.
STATE_TOL = 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _reduced(arch):
    kw = {"ssm_pallas": True} if arch == "falcon-mamba-7b" else {}
    jcfg, cfg = jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jmodel = jax_build_model(jcfg)
    params = _np(jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, params, cfg


@pytest.fixture(scope="module")
def lm():
    return _reduced(ARCH)


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def arch_lm(request):
    """``lm`` of each of TRAIN_ARCHS."""
    return _reduced(request.param)


def _port(cfg, params, **changes):
    """A port model of ``cfg`` (with ``changes``) holding the reference's
    weights."""
    return convert.lm_params(build_model(dataclasses.replace(cfg, **changes), device="cpu", seed=1), params)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


def _flat_ref(tree):
    """A reference pytree as {"a/b/c": array}, the checkpoint's keys."""
    return {
        "/".join(str(getattr(k, "key", getattr(k, "idx", "?"))) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _flat_port(named):
    """A port name → tensor dict under the checkpoint's keys, repeats
    stacked (``checkpoint.ckpt``'s layout)."""
    from repro_torch.checkpoint.ckpt import _arrays

    return _arrays(named, "")


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# The loss and the pipeline
# ---------------------------------------------------------------------------


def test_lm_loss_matches_jax_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(BATCH, SEQ, 512)) * 3).astype(np.float32)
    labels = rng.integers(0, 512, size=(BATCH, SEQ)).astype(np.int32)
    labels[0, :7] = -100
    labels[1, 30:] = -100
    want = jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = lm_loss(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)
    # every label ignored: 0, not a division by zero
    none = np.full_like(labels, -100)
    assert float(lm_loss(torch.tensor(logits), torch.tensor(none))) == 0.0 == float(
        jax_lm_loss(jnp.asarray(logits), jnp.asarray(none)))


def test_synthetic_lm_batches_equal_the_references(lm):
    _, _, cfg = lm
    jit = jax_synthetic_lm_batches(jax_get_config(ARCH).reduced(), 3, 17, seed=4)
    it = synthetic_lm_batches(cfg, 3, 17, seed=4, device="cpu")
    for _ in range(4):
        want, got = next(jit), next(it)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_synthetic_lm_batches_run_on_cuda_unless_asked(lm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(synthetic_lm_batches(lm[2], 1, 4))


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_step(arch_lm):
    """(reference params, opt state, metrics) and the port's after one step
    from the same weights and batch."""
    jmodel, params, cfg = arch_lm
    jbatch = next(jax_synthetic_lm_batches(jmodel.cfg, BATCH, SEQ, seed=0))
    with repro.Database(dispatch="interpret").activate():
        jp, jo, jm = jax_make_train_step(jmodel, jit=False)(
            jax.tree.map(jnp.asarray, params), jax_adam_init(params), jbatch)
    model = _port(cfg, params)
    state = init_train_state(model)
    batch = next(synthetic_lm_batches(cfg, BATCH, SEQ, seed=0, device="cpu"))
    step = make_train_step(model, database=repro_torch.Database(device="cpu"))
    p, o, m = step(state.params, state.opt_state, batch)
    return (_np(jp), _np(jo), jm), (p, o, m)


def test_train_step_loss_matches_jax(one_step):
    (_, _, jm), (_, _, m) = one_step
    assert sorted(m) == sorted(jm) == ["aux", "loss", "total"]
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("part", ["params", "mu", "nu"])
def test_train_step_updates_every_tensor_as_jax(one_step, part):
    (jp, jo, _), (p, o, _) = one_step
    want = _flat_ref(jp if part == "params" else jo[part])
    got = _flat_port(p if part == "params" else o[part])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= STATE_TOL, (k, _rel(got[k], want[k]))
    assert int(o["step"]) == int(jo["step"]) == 1


def test_donated_step_is_bit_equal_and_updates_in_place(arch_lm):
    """``donate=True`` writes the step's results into the given tensors:
    the same bits as ``donate=False``, which leaves its inputs alone."""
    _, params, cfg = arch_lm
    batch = next(synthetic_lm_batches(cfg, BATCH, SEQ, seed=1, device="cpu"))
    db = repro_torch.Database(device="cpu")
    out = {}
    for donate in (False, True):
        model = _port(cfg, params)
        state = init_train_state(model)
        before = {k: v.clone() for k, v in state.params.items()}
        ptr = {k: v.data_ptr() for k, v in state.params.items()}
        step = make_train_step(model, donate=donate, database=db)
        p, o, m = step(state.params, state.opt_state, batch)
        p, o, m = step(p, o, batch)
        same_storage = all(p[k].data_ptr() == ptr[k] for k in p)
        changed = not all(torch.equal(state.params[k], before[k]) for k in before)
        assert same_storage == changed == donate
        if donate:  # the module's own parameters are the donated tensors
            assert all(torch.equal(t, p[k]) for k, t in model.named_parameters())
        out[donate] = (p, o, m)
    (p0, o0, m0), (p1, o1, m1) = out[False], out[True]
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    for moment in ("mu", "nu"):
        assert all(torch.equal(o0[moment][k], o1[moment][k]) for k in o0[moment])
    assert o0["step"] == o1["step"] == 2


def _grads(model, batch, params=None):
    params = {k: v.detach().requires_grad_(True) for k, v in
              (params or dict(model.named_parameters())).items()}
    logits, aux = model.train_logits(batch, params)
    total = lm_loss(logits, batch["labels"]) + 0.01 * aux
    return total, params


def test_remat_gradients_equal_the_plain_ones_bit_for_bit(arch_lm):
    """``cfg.remat`` runs each superblock under ``torch.utils.checkpoint``:
    the backward recomputes its forward, with the same bits, so the
    gradients equal those without remat bit for bit. The recomputation
    runs in the session that ran the forward (here the backward runs
    outside ``activate``, where the process default would be a CUDA
    session) and lowers nothing new."""
    _, params, cfg = arch_lm
    batch = next(synthetic_lm_batches(cfg, BATCH, SEQ, seed=2, device="cpu"))
    # a table no other test uses (lowerings are cached per table)
    db = repro_torch.Database(device="cpu", dispatch={"blocked_matmul": "ref", "segment_sum": "ref"})
    engine = engine_for(_linear_prog()[0].forward)
    got = {}
    for remat in (False, True):
        model = _port(cfg, params, remat=remat)
        with db.activate():
            total, leaves = _grads(model, batch)
        lowered = engine.lower_count
        grads = torch.autograd.grad(total, list(leaves.values()))
        assert engine.lower_count == lowered
        got[remat] = dict(zip(leaves, grads))
    assert all(torch.equal(got[False][k], got[True][k]) for k in got[False])


class _ProductCount:
    """Counts the forward queries of ``rel_linear`` that a session executes
    (its product: the blocked_matmul site, a kernel launch on the card)."""

    def __init__(self, monkeypatch):
        forward, real = _linear_prog()[0].forward, repro_torch.Database.execute
        self.n = 0

        def execute(db, prog, *args, **kw):
            self.n += prog is forward
            return real(db, prog, *args, **kw)

        monkeypatch.setattr(repro_torch.Database, "execute", execute)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_remat_policy_dots_keeps_the_products_and_the_gradients_bit_for_bit(arch, monkeypatch):
    """``remat_policy="dots"`` (the reference's ``dots_saveable``) keeps the
    superblocks' product outputs from the forward: its backward runs no
    ``rel_linear`` forward query again, where "nothing" runs each one a
    second time, and its gradients equal those of "nothing" and of no remat
    bit for bit."""
    _, params, cfg = _reduced(arch)
    batch = next(synthetic_lm_batches(cfg, BATCH, SEQ, seed=3, device="cpu"))
    count = _ProductCount(monkeypatch)
    got, forwards, again = {}, {}, {}
    for policy in (None, "nothing", "dots"):
        model = _port(cfg, params, remat=policy is not None, remat_policy=policy or "nothing")
        count.n = 0
        with repro_torch.Database(device="cpu").activate():
            total, leaves = _grads(model, batch)
            forwards[policy] = count.n
            grads = torch.autograd.grad(total, list(leaves.values()))
        again[policy] = count.n - forwards[policy]
        got[policy] = dict(zip(leaves, grads))
    # the superblocks' projections run once more under "nothing"; the
    # head, outside them, never
    assert forwards == dict.fromkeys(forwards, forwards[None])
    assert again == {None: 0, "nothing": forwards[None] - 1, "dots": 0}
    for policy in ("nothing", "dots"):
        assert all(torch.equal(got[policy][k], got[None][k]) for k in got[None]), policy


def test_train_step_on_a_one_rank_mesh_is_the_step():
    """``make_train_step(mesh=...)`` (and the serving steps, and an
    endpoint) on a one-rank ("model",) mesh of a gloo group give the
    mesh-less step's loss, gradients and parameters bit for bit, for olmoe
    and llama3 reduced (``tests/torch_lm_mesh_workers.one_rank``; the
    4-rank meshes are tests/test_torch_lm_mesh.py's)."""
    import torch_lm_mesh_workers as W
    from repro_torch.launch.mesh import start_ranks

    (equal,) = start_ranks(W.one_rank, 1, backend="gloo", device="cpu")
    assert equal and all(equal.values()), equal


def test_train_step_on_a_mesh_outside_the_slice_raises():
    """whisper's encoder and decoder layers are placed on a mesh
    (tests/test_torch_lm_mesh_whisper.py), so the step builds on a
    mesh given by its axis sizes; such a mesh has no ranks, and its
    shape-only collectives refuse tensors with values: the step raises
    rather than summing nothing (``launch/dryrun.py`` walks it on
    ``meta``)."""
    model = build_model(get_config("whisper-small").reduced(), device="cpu")
    step = make_train_step(model, mesh={"model": 2})
    state = init_train_state(model)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    frames = torch.zeros((2, model.cfg.enc_seq, model.cfg.d_model))
    with pytest.raises(ValueError, match="meta tensors only"):
        with repro_torch.Database(device="cpu").activate():
            step(state.params, state.opt_state, {"tokens": tokens, "labels": tokens, "frames": frames})


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_a_reference_checkpoint_restores_in_the_port(lm, tmp_path):
    jmodel, params, cfg = lm
    opt = _np(jax_adam_init(params))
    opt["mu"] = jax.tree.map(lambda a: a + 1, opt["mu"])
    path = jax_save_checkpoint(str(tmp_path), 7, params, opt)
    assert Path(path).name == "step_00000007_shard_0.npz"
    model = build_model(cfg, device="cpu", seed=3)
    state = init_train_state(model)
    got_p, got_o = restore_checkpoint(path, state.params, state.opt_state)
    assert got_o["step"] == 0
    for tree, want in ((got_p, params), (got_o["mu"], opt["mu"]), (got_o["nu"], opt["nu"])):
        flat, ref = _flat_port(tree), _flat_ref(want)
        assert sorted(flat) == sorted(ref) and all(np.array_equal(flat[k], ref[k]) for k in ref)
    # the restored weights give the reference's logits
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    with repro.Database(dispatch="interpret").activate():
        want, _ = jmodel.train_logits(params, {"tokens": jnp.asarray(tokens)})
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        got, _ = model.train_logits({"tokens": torch.tensor(tokens)}, got_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_a_port_checkpoint_restores_in_the_reference(lm, tmp_path):
    jmodel, params, cfg = lm
    model = _port(cfg, params)
    state = init_train_state(model)
    batch = next(synthetic_lm_batches(cfg, BATCH, SEQ, seed=6, device="cpu"))
    p, o, _ = make_train_step(model, database=repro_torch.Database(device="cpu"))(
        state.params, state.opt_state, batch)
    path = save_checkpoint(str(tmp_path), 1, p, o)
    jp, jo = jax_restore_checkpoint(path, params, jax_adam_init(params))
    assert int(jo["step"]) == 1
    for tree, want in ((jp, p), (jo["mu"], o["mu"]), (jo["nu"], o["nu"])):
        flat, ref = _flat_ref(tree), _flat_port(want)
        assert sorted(flat) == sorted(ref) and all(np.array_equal(flat[k], ref[k]) for k in ref)
    with repro.Database(dispatch="interpret").activate():
        want, _ = jmodel.train_logits(jp, {"tokens": jnp.asarray(batch["tokens"].numpy())})
    with repro_torch.Database(device="cpu").activate(), torch.no_grad():
        got, _ = model.train_logits({"tokens": batch["tokens"]}, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_restore_checks_shapes(lm, tmp_path):
    _, params, cfg = lm
    state = init_train_state(_port(cfg, params))
    path = save_checkpoint(str(tmp_path), 0, state.params, state.opt_state)
    bigger = init_train_state(build_model(dataclasses.replace(cfg, vocab=640), device="cpu"))
    with pytest.raises(ValueError, match="params/embed"):
        restore_checkpoint(path, bigger.params, bigger.opt_state)


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------


def test_lm_train_smoke_preset_on_the_cpu_lowers_its_loss(tmp_path, capsys):
    """The reference's preset and defaults (20 steps of 8 × 128 tokens)."""
    losses = lm_train.main(["--preset", "smoke", "--device", "cpu", "--ckpt-every", "10",
                            "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000010_shard_0.npz", "step_00000020_shard_0.npz"]
    assert "ok." in capsys.readouterr().out


GCN_ARGS = ["--nodes", "96", "--edges", "400", "--feat", "8", "--labels", "4", "--hidden", "16",
            "--epochs", "40"]


@pytest.mark.parametrize("mode", ["full", "minibatch"])
def test_gcn_train_matches_the_reference_example(monkeypatch, mode):
    """The port's ``examples/gcn_train.py`` against the reference's, run as
    a script: the loss and accuracy of every step (read off the
    reference's jitted step) within 1e-5."""
    args = GCN_ARGS + ["--mode", mode, "--batch", "32"]
    real_jit, ref = jax.jit, []

    def recording_jit(f=None, **kw):
        jitted = real_jit(f, **kw)
        if getattr(f, "__qualname__", "") != "main.<locals>.step":
            return jitted

        def step(*a):
            out = jitted(*a)
            ref.append((float(out[2]), float(out[3])))
            return out

        return step

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(sys, "argv", ["gcn_train.py"] + args)
    runpy.run_path(str(ROOT / "examples" / "gcn_train.py"), run_name="__main__")
    monkeypatch.setattr(jax, "jit", real_jit)
    got = gcn_train.train(gcn_train.parse_args(args + ["--device", "cpu"]))
    assert len(got) == len(ref) == 40 * (1 if mode == "full" else 3)
    np.testing.assert_allclose(np.array(got), np.array(ref), rtol=TOL, atol=TOL)
