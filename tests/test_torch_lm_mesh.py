"""The language models on a mesh, on 4 ``gloo`` ranks on the CPU: the
reduced olmoe-1b-7b (``moe``) and llama3-405b (``attn``) served (a prefill
of 4 × 8 tokens and 2 decode steps) tensor- and expert-parallel on
a 1 × 4 (data × model) mesh, and one Adam step on a 2 × 2 mesh (FSDP on
"data", tensor and expert parallelism on "model", the global norm), held
to the one-process port step and to the reference's one-device step; the
ranks held to each other bit for bit; a planted missing all-reduce; the
kinds a placement once refused (whisper's, qwen2-vl's) placed.

The ranks start once for the module (``launch.mesh.start_ranks``) and run
``tests/torch_lm_mesh_workers.run_checks`` on the reference's weights,
while this process runs the reference's steps; each test reads its part.

The bound (tests/torch_lm_mesh_parity.py): the logits and each gradient
within TOL = 1e-5 of their tensor's largest entry, the losses within TOL
relative; a missing all-reduce fails it by orders of magnitude. One Adam
step moves a parameter by at most lr in either direction, so the new
parameters are held to 2·lr everywhere, and to 1e-3·lr where the gradient
is at least 1e-4 of its leaf's largest entry (clear of the gradients'
rounding, where Adam's first step is lr·sign(g) to f32).
"""

import numpy as np
import pytest

import torch_lm_mesh_parity as P
import torch_lm_mesh_workers as W

TOL = P.TOL


@pytest.fixture(scope="module")
def weights():
    """The reference's weights of each arch (numpy), from PRNGKey(0)."""
    return P.weights(W.LM)


@pytest.fixture(scope="module")
def both(weights):
    """(every rank's results of ``run_checks`` on 4 gloo ranks on the CPU,
    the reference's steps), the two computed at once."""
    return P.start("lm", weights)[:2]


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def reference(both):
    return both[1]


_close = P.close
_reference_grad = P.reference_grad


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
    """``Placement.shard`` of olmoe's whole parameters on the 2 × 2 mesh
    gives each rank its block of every dimension its spec splits
    (``shard_by_hand``), of the shape ``local_shape`` gives."""
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


@pytest.mark.parametrize("arch", W.REFUSED)
def test_kinds_outside_the_slice_raise_naming_the_roadmap(ranks, arch):
    """The last kinds a placement refused, naming ROADMAP.md (whisper's
    ``enc``/``dec``, qwen2-vl's vision prefix), are placed: no arch is
    outside the slice now, and the placement builds on the 1 × 4 mesh
    (tests/test_torch_lm_mesh_{whisper,qwen2_vl}.py run them)."""
    assert ranks[0]["refusals"][arch] is None


def test_a_train_step_outside_the_slice_raises_naming_the_roadmap(ranks):
    """whisper's train step on the 2 × 2 mesh, once refused, builds."""
    assert ranks[0]["train_refusal"] is None
