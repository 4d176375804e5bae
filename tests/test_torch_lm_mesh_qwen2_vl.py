"""qwen2-vl on a mesh, on 4 ``gloo`` ranks on the CPU: the reduced
qwen2-vl-72b (2 layers, 4 heads over 2 KV heads, M-RoPE over t/h/w
positions) served — a prefill of 4 prompts of 8 patches and 8 tokens, then
2 decode steps at ``length = seq + vis_seq`` — and trained one Adam step
on a 2 × 2 (data × model) mesh (FSDP on "data" at a 32 KiB threshold),
held to the one-process port steps and to the reference's one-device
steps (tests/torch_lm_mesh_parity.py's bound); the ranks to each other bit
for bit; and the planted faults of the vision prefix: its patches and
positions cut over the model axis instead of the tokens' batch fold, and
its positions cut on the sequence axis instead of the batch axis (the
step then fails outright: the positions no longer fit the rank's rows).
A one-rank group runs the steps bit for bit as the mesh-less ones.
"""

import numpy as np
import pytest

import torch_lm_mesh_parity as P
import torch_lm_mesh_zoo_parity as ZP
import torch_lm_mesh_zoo_workers as Z

SUITE = Z.SUITES["qwen2_vl"]
ARCH = SUITE.archs[0]
MESH = SUITE.meshes[0][0]


@pytest.fixture(scope="module")
def runs():
    return ZP.start("qwen2_vl", ZP.weights(SUITE), one_rank=True)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def rec(ranks):
    return ranks[0][ARCH]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1][ARCH]


def test_serving_equals_the_one_process_step(rec):
    assert P.close(rec[MESH]["serve"]["logits"], rec["one"]["serve"]["logits"])


def test_serving_equals_the_reference(rec, reference):
    assert P.close(rec[MESH]["serve"]["logits"], reference["logits"])


def test_train_step_equals_the_one_process_step(rec):
    assert P.train_misses(rec[MESH]["train"], rec["one"]["train"]) == []


def test_train_step_equals_the_reference(rec, reference):
    assert P.reference_misses(rec[MESH]["train"], reference) == []


def test_ranks_are_bit_equal(ranks, rec):
    for r in ranks[1:]:
        got = r[ARCH][MESH]
        assert np.array_equal(got["serve"]["logits"], rec[MESH]["serve"]["logits"])
        t0, t = rec[MESH]["train"], got["train"]
        assert (t["loss"], t["norm"]) == (t0["loss"], t0["norm"])
        for k, v in t0["grads"].items():
            assert np.array_equal(t["grads"][k], v), k


def test_a_rank_caches_its_rows_of_the_prefix_and_the_text(ranks):
    """The cache holds the patches and the text: its rows of the batch,
    ``vis_seq + seq + decode`` positions, its KV heads."""
    cfg = Z.config(ARCH, SUITE)
    want = (SUITE.b // 2, SUITE.cache(cfg), cfg.n_kv_heads // 2, cfg.hd())
    for r in ranks:
        assert r[ARCH][MESH]["shard"]
        assert r[ARCH][MESH]["cache0"]["kv/k"] == want == r[ARCH][MESH]["serve"]["cache0"]["kv/k"]


def test_a_model_built_on_the_mesh_holds_the_shards_of_the_mesh_less_model(ranks):
    assert all(r[ARCH]["built_shards"] for r in ranks)


def test_the_prefix_cut_over_the_model_axis_fails_the_bound(rec):
    """A rank whose model coordinate differs from its data coordinate
    reads another rank's patches beside its own tokens."""
    assert P.far(rec["plants"]["prefix_on_model"], rec["one"]["serve"]["logits"])


def test_positions_cut_on_the_sequence_axis_fail_the_step(rec):
    """Positions cut on another axis than the tokens fit no rank's rows:
    the step raises rather than rotating by the wrong positions."""
    assert rec["plants"]["positions_on_sequence"] == "RuntimeError"


@pytest.mark.parametrize("part", ("serve", "train"))
def test_a_one_rank_group_runs_the_mesh_less_steps_bit_for_bit(runs, part):
    assert runs[2][ARCH, part]
