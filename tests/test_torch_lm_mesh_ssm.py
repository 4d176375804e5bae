"""The SSM block kinds on a mesh, on 4 ``gloo`` ranks on the CPU: the
reduced falcon-mamba-7b (``mamba1``) and zamba2-7b at 6 layers (5
``mamba2`` and a ``mamba2_attn`` with the shared attention+MLP block), on
the scan kernel's path (``ssm_pallas``), served (a prefill of 4 × 8
tokens and 2 decode steps) on a 1 × 4 (data × model) mesh and trained one
Adam step on a 2 × 2 mesh, held to the one-process port step and to the
reference's one-device step (tests/torch_lm_mesh_parity.py's bound); the
ranks to each other bit for bit; each rank's state of its channels
(heads); the segment cut of ``in_proj`` and the conv, against a cut by
hand; and the planted
faults: a missing all-reduce, ``x_proj``'s backward sum left out, B and C
gathered with a slicing backward, the gated norm's Σy² not summed, a
replicated leaf counted on every rank in the global norm. A one-rank
group runs the steps bit for bit as the mesh-less ones.

The ranks start once for the module (``launch.mesh.start_ranks``, the
suite "ssm" of ``tests/torch_lm_mesh_workers.py``) while this process
runs the reference's steps.
"""

import numpy as np
import pytest

import torch_lm_mesh_parity as P
import torch_lm_mesh_workers as W

SUITE = W.SUITES["ssm"]
ARCHS = SUITE.archs


@pytest.fixture(scope="module")
def runs():
    """(the 4 ranks' records, the reference's steps, the one-rank record)."""
    return P.start("ssm", P.weights(SUITE), one_rank=True)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_1x4_equals_the_one_process_step(ranks, arch):
    rec = ranks[0][arch]
    assert P.close(rec["mesh"]["logits"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_1x4_equals_the_reference(ranks, reference, arch):
    assert P.close(ranks[0][arch]["mesh"]["logits"], reference[arch]["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_missing_all_reduce_fails_the_bound(ranks, arch):
    rec = ranks[0][arch]
    assert P.far(rec["planted"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_and_runs_are_bit_equal(ranks, arch):
    r0 = ranks[0][arch]
    assert np.array_equal(r0["again"], r0["mesh"]["logits"])
    for r in ranks[1:]:
        assert np.array_equal(r[arch]["mesh"]["logits"], r0["mesh"]["logits"])
        t0, t = r0["train22"], r[arch]["train22"]
        assert (t["loss"], t["norm"]) == (t0["loss"], t0["norm"])
        for part in ("grads", "params"):
            for k, v in t0[part].items():
                assert np.array_equal(t[part][k], v), (part, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_state_is_the_ranks_channels(ranks, arch):
    """At 1 × 4 a mamba1 rank carries its 512 / 4 channels' conv window
    and state; a mamba2 rank its 8 / 4 heads' state and the conv window of
    its x, B and C columns (128 + 2 · 64 / 4); ``init_cache(place=)``
    sizes them so."""
    rec = ranks[0][arch]
    b = SUITE.b
    want = ({"ssm1/conv": (b, 3, 128), "ssm1/ssm": (b, 128, 16)} if arch == "falcon-mamba-7b" else
            {"ssm2/conv": (b, 3, 160), "ssm2/ssm": (b, 2, 64, 64)})
    assert rec["mesh"]["cache0"] == rec["cache0"] == want
    assert rec["one"]["serve"]["cache0"] != want


@pytest.mark.parametrize("arch", ARCHS)
def test_the_segmented_leaves_are_cut_by_segment(ranks, arch):
    """The leaves whose model-axis dimension concatenates segments, one
    per layer; ``Placement.whole`` gives back every whole parameter from
    the ranks' cuts."""
    rec = ranks[0][arch]
    leaves = {n.rsplit(".", 1)[1] for n in rec["segments"]}
    layers = W.config(arch, SUITE).n_layers
    assert leaves == ({"in_proj"} if arch == "falcon-mamba-7b" else {"in_proj", "conv_w", "conv_b"})
    assert len(rec["segments"]) == layers * len(leaves)
    assert rec["whole_of_cut"]


@pytest.mark.parametrize("mesh", ("1x4", "2x2"))
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_shard_gives_each_rank_its_slice_of_every_segment(ranks, arch, mesh):
    """``Placement.shard`` of the whole parameters gives each rank, of a
    leaf that concatenates segments (``in_proj``, ``mamba2``'s conv), its
    block of each segment, and of every other split dimension its block,
    cut by hand from the blocks' layouts."""
    assert all(r[arch]["shard"][mesh] for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_model_built_on_the_mesh_holds_the_shards_of_the_mesh_less_model(ranks, arch):
    assert all(r[arch]["built_shards"] for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_2x2_equals_the_one_process_step(ranks, arch):
    rec = ranks[0][arch]
    assert P.train_misses(rec["train22"], rec["one"]["train"]) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_2x2_equals_the_reference(ranks, reference, arch):
    assert P.reference_misses(ranks[0][arch]["train22"], reference[arch]) == []


def test_x_proj_without_its_backward_sum_fails_the_gradient_bound(ranks):
    """``reduce_from`` alone around ``x_proj``'s output keeps each rank's
    part of dL/d(dt, B, C): the layers below miss the bound by far."""
    rec = ranks[0]["falcon-mamba-7b"]
    got, one = rec["plants"]["x_proj_backward"]["grads"], rec["one"]["train"]["grads"]
    bad = [k for k in one if P.far(got[k], one[k], 10)]
    assert "stages.0.scan.0.0:mamba1.ssm.in_proj" in bad
    assert "stages.0.scan.0.0:mamba1.ssm.conv_w" in bad


def test_b_and_c_gathered_with_a_slicing_backward_fail_the_gradient_bound(ranks):
    rec = ranks[0]["zamba2-7b"]
    got, one = rec["plants"]["bc_slicing"]["grads"], rec["one"]["train"]["grads"]
    bad = [k for k in one if P.far(got[k], one[k], 10)]
    assert "stages.0.scan.0.0:mamba2.ssm.in_proj" in bad


def test_the_gated_norm_without_its_sum_fails_the_logit_bound(ranks):
    rec = ranks[0]["zamba2-7b"]
    assert P.far(rec["plants"]["norm_unsummed"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_replicated_leaf_counted_on_every_rank_fails_the_norm(ranks, arch):
    rec = ranks[0][arch]
    got, want = rec["plants"]["norm_overcount"]["norm"], rec["one"]["train"]["norm"]
    assert abs(got - want) > 1e3 * P.TOL * want


@pytest.mark.parametrize("part", ("admitted", "serve", "train", "endpoint"))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_rank_mesh_runs_the_mesh_less_steps(runs, arch, part):
    assert runs[2][arch, part]
