"""The language models on a mesh, on 4 ``gloo`` ranks on the CPU: the
reduced olmoe-1b-7b (``moe``) and llama3-405b (``attn``) served (a prefill
of 4 × 8 tokens and 2 decode steps) tensor- and expert-parallel on
a 1 × 4 (data × model) mesh, and one Adam step on a 2 × 2 mesh (FSDP on
"data", tensor and expert parallelism on "model", the global norm), held
to the one-process port step and to the reference's one-device step; the
ranks held to each other bit for bit; a planted missing all-reduce; the
kinds outside the slice refused.

The ranks start once for the module (``launch.mesh.start_ranks``) and run
``tests/torch_lm_mesh_workers.run_checks`` on the reference's weights,
while this process runs the reference's steps; each test reads its part.

The bound. A mesh step sums the same f32 terms as the one-process step
in another order: each model rank's partial of ``wo``'s contraction, of
the experts' combine and of the embedding's lookup, then the ranks' sums
added; the data ranks' gradients added. The logits and each gradient are
held to TOL = 1e-5 of their tensor's largest entry (at least 1), the bound
the parity tests hold the port to the reference by (tests/torch_lm_parity.py:
``close_scaled``); the losses to TOL relative. Reordering a sum of K ≤ 512
f32 terms moves it by about √K·u ≈ 1.3e-6 of its terms' sizes, and the two
layers add a few of those. A missing all-reduce leaves three quarters of a
sum out and fails the bound by orders of magnitude. One Adam step moves a
parameter by at most lr in either direction, so the new parameters are
held to 2·lr everywhere, and to 1e-3·lr where the gradient is at least
1e-4 of its leaf's largest entry (clear of the gradients' rounding, where
Adam's first step is lr·sign(g) to f32).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import torch_lm_mesh_workers as W
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train import lm_loss as jax_lm_loss
from repro_torch.launch.mesh import start_ranks

TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """The reference's weights of each arch (numpy), from PRNGKey(0)."""
    out = {}
    for arch in W.ARCHS:
        jm = jax_build_model(jax_get_config(arch).reduced())
        out[arch] = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def both(weights):
    """(every rank's results of ``run_checks`` on 4 gloo ranks on the CPU,
    the reference's steps), the two computed at once."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        started = pool.submit(start_ranks, W.run_checks, 4, backend="gloo", device="cpu",
                              args=(weights,))
        reference = _reference(weights)
        return started.result(), reference


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def reference(both):
    return both[1]


def _reference(weights):
    """The reference's one-device prefill and decode, loss and gradients,
    per arch."""
    out = {}
    for arch in W.ARCHS:
        cfg = jax_get_config(arch).reduced()
        model = jax_build_model(cfg)
        params = jax.tree.map(jnp.asarray, weights[arch])
        tokens, labels, fed = W.batch(cfg)
        with repro.Database(dispatch="ref").activate():
            logits, caches = model.prefill(params, {"tokens": jnp.asarray(tokens)}, W.CACHE)
            steps = [np.asarray(logits)]
            for i in range(W.DECODE):
                logits, caches = model.decode_step(params, jnp.asarray(fed[:, i:i + 1]), caches, W.S + i)
                steps.append(np.asarray(logits))

            def loss_fn(p):
                lg, aux = model.train_logits(p, {"tokens": jnp.asarray(tokens)})
                return jax_lm_loss(lg, jnp.asarray(labels)) + 0.01 * aux

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        out[arch] = {"logits": np.stack(steps), "loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads)}
    return out


def _close(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() <= TOL * max(1.0, np.abs(want).max())


def _reference_grad(grads, name):
    """The reference's gradient of the port parameter ``name``."""
    from repro_torch.convert import reference_leaf

    path, repeat, _ = reference_leaf(name)
    node = grads
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node if repeat is None else node[repeat]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_serving_on_1x4_equals_the_one_process_step(ranks, arch):
    rec = ranks[0][arch]
    assert _close(rec["mesh"]["logits"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_serving_on_1x4_equals_the_reference(ranks, reference, arch):
    assert _close(ranks[0][arch]["mesh"]["logits"], reference[arch]["logits"])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_a_missing_all_reduce_fails_the_bound(ranks, arch):
    rec = ranks[0][arch]
    one = rec["one"]["serve"]["logits"]
    assert not _close(rec["planted"], one)
    assert np.abs(rec["planted"] - one).max() > 1e3 * TOL * max(1.0, np.abs(one).max())


@pytest.mark.parametrize("arch", W.ARCHS)
def test_ranks_and_runs_are_bit_equal(ranks, arch):
    r0 = ranks[0][arch]
    assert np.array_equal(r0["again"], r0["mesh"]["logits"])
    for r in ranks[1:]:
        assert np.array_equal(r[arch]["mesh"]["logits"], r0["mesh"]["logits"])
        t0, t = r0["train22"], r[arch]["train22"]
        assert t["loss"] == t0["loss"]
        for part in ("grads", "params"):
            for k, v in t0[part].items():
                assert np.array_equal(t[part][k], v), (part, k)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_the_caches_hold_the_heads_the_rank_attends_over(ranks, arch):
    """At 1 × 4 the reduced configs' 2 KV heads of 64 split mid-head (32
    columns a rank): k and v are gathered whole and every rank attends
    over, and caches, both heads; decode placed the parameters once."""
    rec = ranks[0][arch]
    assert rec["mesh"]["k0"] == rec["cache_k"] == (W.B, W.CACHE, 2, 64)
    assert rec["mesh"]["placed"] == 1
    assert rec["one"]["serve"]["placed"] is None
    assert rec["collectives"]["all_reduce/model"]["calls"] > 0


@pytest.mark.parametrize("arch", W.ARCHS)
def test_a_model_built_on_the_mesh_holds_the_shards_of_the_mesh_less_model(ranks, arch):
    assert all(r[arch]["built_shards"] for r in ranks)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_train_step_on_2x2_equals_the_one_process_step(ranks, arch):
    one, mesh = ranks[0][arch]["one"]["train"], ranks[0][arch]["train22"]
    assert abs(mesh["loss"] - one["loss"]) <= TOL * abs(one["loss"])
    assert abs(mesh["total"] - one["total"]) <= TOL * abs(one["total"])
    assert sorted(mesh["grads"]) == sorted(one["grads"])
    for k, g in one["grads"].items():
        assert _close(mesh["grads"][k], g), k
        dp = np.abs(mesh["params"][k] - one["params"][k])
        assert dp.max() <= 2 * W.LR, k
        clear = np.abs(g) >= 1e-4 * np.abs(g).max()
        assert (dp[clear] <= 1e-3 * W.LR).all(), k


@pytest.mark.parametrize("arch", W.ARCHS)
def test_train_step_on_2x2_equals_the_reference(ranks, reference, arch):
    mesh, ref = ranks[0][arch]["train22"], reference[arch]
    assert abs(mesh["total"] - ref["loss"]) <= TOL * abs(ref["loss"])
    for k, g in mesh["grads"].items():
        assert _close(g, _reference_grad(ref["grads"], k)), k


def test_specs_become_dtensor_placements(ranks):
    r0 = ranks[0]
    # the reduced embedding is 512 KiB, under FSDP's 1 MiB; an expert
    # weight's 2 layers are 4 MiB: experts on "model", d_ff on "data"
    assert r0["specs"]["embed"] == ("model", None)
    assert r0["placements"]["embed"] == ["R", "S(0)"]
    assert r0["specs"]["stages.0.scan.0.0:moe.moe.wi_gate"] == ("model", None, "data")
    assert r0["placements"]["stages.0.scan.0.0:moe.moe.wi_gate"] == ["S(2)", "S(0)"]
    assert r0["placements"]["stages.0.scan.0.0:moe.attn.wq"] == ["R", "S(1)"]
    assert r0["placements"]["ln_f"] == ["R", "R"]


@pytest.mark.parametrize("name", ("reduce_from", "copy_to", "gather_from", "scatter_to", "all_gather",
                                  "reduce_scatter"))
def test_autograd_collectives_and_their_transposes(ranks, name):
    """Each autograd collective over the 4 model ranks: its forward, and
    its backward the transposed collective (reduce_from/copy_to,
    gather_from/scatter_to, all_gather/reduce_scatter)."""
    assert all(r["collectives"][name] for r in ranks)


def test_shard_params_cuts_each_ranks_shard(ranks):
    """``shard_params(whole, specs, mesh)`` gives each rank the shard a
    placement cuts, of the shape its specs give."""
    assert all(r["shard_params"] for r in ranks)


def test_catalog_shardings_are_the_committed_layouts(ranks):
    """The GCN query's step on the 1 × 4 mesh commits its catalog
    relations to the plan's layouts (``Database.layout``);
    ``catalog_shardings`` gives them as DTensor placements."""
    r0 = ranks[0]
    assert set(r0["catalog"]) == {k for k, v in r0["layouts"].items() if v is not None}
    assert r0["catalog"]
    for name, (spec, placements) in r0["catalog"].items():
        assert spec == tuple(r0["layouts"][name])
        assert len(placements) == 2


@pytest.mark.parametrize("arch", ("falcon-mamba-7b", "gemma2-9b", "whisper-small", "qwen2-vl-72b",
                                  "deepseek-v3-671b"))
def test_kinds_outside_the_slice_raise_naming_the_roadmap(ranks, arch):
    assert "ROADMAP.md" in ranks[0]["refusals"][arch]


def test_a_train_step_outside_the_slice_raises_naming_the_roadmap(ranks):
    assert "ROADMAP.md" in ranks[0]["train_refusal"]
