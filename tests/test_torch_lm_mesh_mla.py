"""MLA on a mesh, on 4 ``gloo`` ranks on the CPU: the reduced
deepseek-v3-671b (2 layers: ``mla``, then ``mla_moe`` with 4 routed
experts and the shared one; 4 heads) served (a prefill of 4 × 8 tokens
and 2 decode steps) on a 1 × 4 (data × model) mesh, through
``make_prefill_step(mesh=)`` and ``BucketedPrefill(mesh=)``, and trained
one Adam step on a 2 × 2 mesh with FSDP on "data" (a 32 KiB threshold, so
that the reduced leaves gather as the full ones do), held to the
one-process port step and to the reference's one-device step
(tests/torch_lm_mesh_parity.py's bound); the ranks to each other bit for
bit; the latent cache whole on every rank; and the planted faults: layer
0's wo all-reduce left out, the q latent gathered with a slicing
backward, c_kv fed to the rank's heads without ``copy_to``. A one-rank
group runs the steps bit for bit as the mesh-less ones.

The ranks start once for the module (``launch.mesh.start_ranks``, the
suite "mla" of ``tests/torch_lm_mesh_workers.py``) while this process
runs the reference's steps.
"""

import numpy as np
import pytest

import torch_lm_mesh_parity as P
import torch_lm_mesh_workers as W

SUITE = W.SUITES["mla"]
ARCH = SUITE.archs[0]
MLA = "stages.0.scan.0.0:mla.attn."


@pytest.fixture(scope="module")
def runs():
    """(the 4 ranks' records, the reference's steps, the one-rank record)."""
    return P.start("mla", P.weights(SUITE), one_rank=True)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def rec(ranks):
    return ranks[0][ARCH]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1][ARCH]


def test_serving_on_1x4_equals_the_one_process_step(rec):
    assert P.close(rec["mesh"]["logits"], rec["one"]["serve"]["logits"])


def test_serving_on_1x4_equals_the_reference(rec, reference):
    assert P.close(rec["mesh"]["logits"], reference["logits"])


def test_bucketed_prefill_on_the_mesh_equals_the_prefill_step(ranks):
    """``BucketedPrefill(mesh=)`` on a mesh-less session runs its bucket's
    step on the keyword's mesh: bit for bit the prefill of
    ``make_prefill_step(mesh=)``, on every rank."""
    for r in ranks:
        assert np.array_equal(r[ARCH]["bucketed"], r[ARCH]["mesh"]["logits"][0])


def test_a_missing_wo_all_reduce_fails_the_bound(rec):
    assert P.far(rec["wo_dropped"], rec["one"]["serve"]["logits"])


def test_ranks_and_runs_are_bit_equal(ranks, rec):
    assert np.array_equal(rec["again"], rec["mesh"]["logits"])
    for r in ranks[1:]:
        assert np.array_equal(r[ARCH]["mesh"]["logits"], rec["mesh"]["logits"])
        t0, t = rec["train22"], r[ARCH]["train22"]
        assert (t["loss"], t["norm"]) == (t0["loss"], t0["norm"])
        for part in ("grads", "params"):
            for k, v in t0[part].items():
                assert np.array_equal(t[part][k], v), (part, k)


def test_the_latent_cache_is_whole_on_every_rank(ranks, rec):
    """Every head reads the latent cache, so each rank keeps it whole
    (``init_cache(place=)`` sizes it so), every rank writes the same
    rows, and they are the one-process prefill's within the bound."""
    cfg = W.config(ARCH, SUITE)
    want = {"kv/c": (SUITE.b, SUITE.cache, cfg.kv_lora_rank),
            "kv/r": (SUITE.b, SUITE.cache, cfg.rope_head_dim)}
    assert rec["mesh"]["cache0"] == rec["cache0"] == rec["one"]["serve"]["cache0"] == want
    for r in ranks:
        for k, v in rec["latent"].items():
            assert np.array_equal(r[ARCH]["latent"][k], v)
    for k, v in rec["latent_one"].items():
        assert P.close(rec["latent"][k], v)


@pytest.mark.parametrize("mesh", ("1x4", "2x2"))
def test_placement_shard_gives_each_rank_its_block(ranks, mesh):
    assert all(r[ARCH]["shard"][mesh] for r in ranks)


def test_a_model_built_on_the_mesh_holds_the_shards_of_the_mesh_less_model(ranks):
    assert all(r[ARCH]["built_shards"] for r in ranks)
    assert all(r[ARCH]["whole_of_cut"] for r in ranks)


def test_train_step_on_2x2_equals_the_one_process_step(rec):
    assert P.train_misses(rec["train22"], rec["one"]["train"]) == []


def test_train_step_on_2x2_equals_the_reference(rec, reference):
    assert P.reference_misses(rec["train22"], reference) == []


def test_the_q_latent_gathered_with_a_slicing_backward_fails_the_gradient_bound(rec):
    """Each rank's use of the whole q latent gives part of its gradient: a
    gather whose backward keeps the rank's slice of its own part only
    leaves ``wq_a``'s gradient far off."""
    got, one = rec["plants"]["q_slicing"], rec["one"]["train"]["grads"]
    bad = [k for k in one if P.far(got[k], one[k], 10)]
    assert MLA + "wq_a" in bad


def test_c_kv_without_copy_to_fails_the_gradient_bound(rec):
    """Without ``copy_to``'s backward sum, ``wkv_a``'s and ``kv_norm``'s
    gradients are each rank's heads' part."""
    got, one = rec["plants"]["latent_unsummed"], rec["one"]["train"]["grads"]
    bad = [k for k in one if P.far(got[k], one[k], 10)]
    assert MLA + "wkv_a" in bad
    assert MLA + "kv_norm" in bad


@pytest.mark.parametrize("part", ("admitted", "serve", "train", "endpoint"))
def test_a_one_rank_group_runs_the_mesh_less_steps_bit_for_bit(runs, part):
    assert runs[2][ARCH, part]
