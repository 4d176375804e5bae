"""whisper on a mesh, on 4 ``gloo`` ranks on the CPU: the reduced
whisper-small (2 encoder and 2 decoder layers, 4 heads over 4 KV heads as
the published model's, vocab 512) served — a prefill of 4 × 8 tokens over
4 × 16 frames, then 2 decode steps on ``make_encode_step(mesh=)``'s
encoder output — and trained one Adam step on a 1 × 4 and a 2 × 2 (data ×
model) mesh (FSDP on "data" at a 32 KiB threshold), held to the
one-process port steps and to the reference's one-device steps
(tests/torch_lm_mesh_parity.py's bound); the ranks to each other bit for
bit; and the planted faults: the cross-attention fed the encoder's output
without ``copy_to`` (its gradient then each rank's heads' part) and one
decoder layer's model all-reduce left out (the encoder runs whole on
every rank, its leaves replicated: ROADMAP.md §3). A one-rank group runs
the steps bit for bit as the mesh-less ones.

The ranks start once for the module (``launch.mesh.start_ranks``, the
suite "whisper" of ``tests/torch_lm_mesh_zoo_workers.py``) while this
process runs the reference's steps.
"""

import numpy as np
import pytest

import torch_lm_mesh_parity as P
import torch_lm_mesh_zoo_parity as ZP
import torch_lm_mesh_zoo_workers as Z

SUITE = Z.SUITES["whisper"]
ARCH = SUITE.archs[0]
MESHES = [name for name, _ in SUITE.meshes]


@pytest.fixture(scope="module")
def runs():
    """(the 4 ranks' records, the reference's steps, the one-rank record)."""
    return ZP.start("whisper", ZP.weights(SUITE), one_rank=True)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def rec(ranks):
    return ranks[0][ARCH]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1][ARCH]


@pytest.mark.parametrize("mesh", MESHES)
def test_serving_equals_the_one_process_step(rec, mesh):
    assert P.close(rec[mesh]["serve"]["logits"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("mesh", MESHES)
def test_serving_equals_the_reference(rec, reference, mesh):
    assert P.close(rec[mesh]["serve"]["logits"], reference["logits"])


@pytest.mark.parametrize("mesh", MESHES)
def test_the_mesh_encode_step_gives_the_whole_encoder_output(rec, mesh):
    """``make_encode_step(mesh=)`` returns every row of the batch, as the
    mesh-less step does, for a mesh decode step to cut."""
    got, want = rec[mesh]["serve"]["enc_out"], rec["one"]["serve"]["enc_out"]
    assert got.shape == want.shape and P.close(got, want)


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_equals_the_one_process_step(rec, mesh):
    assert P.train_misses(rec[mesh]["train"], rec["one"]["train"]) == []


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_equals_the_reference(rec, reference, mesh):
    assert P.reference_misses(rec[mesh]["train"], reference) == []


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_are_bit_equal(ranks, rec, mesh):
    for r in ranks[1:]:
        got = r[ARCH][mesh]
        assert np.array_equal(got["serve"]["logits"], rec[mesh]["serve"]["logits"])
        t0, t = rec[mesh]["train"], got["train"]
        assert (t["loss"], t["norm"]) == (t0["loss"], t0["norm"])
        for part in ("grads", "params"):
            for k, v in t0[part].items():
                assert np.array_equal(t[part][k], v), (part, k)


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_shards_and_cache(ranks, mesh):
    """``Placement.shard`` gives each rank its block of every leaf (the
    encoder's whole), and a rank's decoder cache holds its rows and its
    KV heads."""
    cfg = Z.config(ARCH, SUITE)
    m = dict(SUITE.meshes)[mesh][1]
    want = (SUITE.b // (4 // m), SUITE.cache(cfg), cfg.n_kv_heads // m, cfg.hd())
    for r in ranks:
        assert r[ARCH][mesh]["shard"]
        assert r[ARCH][mesh]["cache0"]["kv/k"] == want == r[ARCH][mesh]["serve"]["cache0"]["kv/k"]


def test_a_model_built_on_the_mesh_holds_the_shards_of_the_mesh_less_model(ranks):
    assert all(r[ARCH]["built_shards"] for r in ranks)


def test_the_cross_attention_without_copy_to_fails_the_gradient_bound(rec):
    """Each rank's heads read the whole encoder output and give part of
    its gradient: without ``copy_to``'s sum the encoder's gradients are
    far off."""
    got, one = rec["plants"]["xattn_uncopied"], rec["one"]["train"]["grads"]
    bad = [k for k in one if P.far(got[k], one[k], 10)]
    assert bad and all(k.startswith(("encoder.", "enc_ln")) for k in bad)


def test_a_decoder_layers_missing_all_reduce_fails_the_bound(rec):
    assert P.far(rec["plants"]["dec_reduce_dropped"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("mesh", MESHES)
def test_the_encoder_runs_whole_on_every_rank(ranks, mesh):
    """The encoder's leaves are replicated: each rank holds every one of
    them whole, and the encoder step (``make_encode_step(mesh=)``) calls
    no collective but the gather of the batch's rows."""
    for r in ranks:
        assert r[ARCH][mesh]["encoder_whole"]
        assert set(r[ARCH][mesh]["serve"]["collectives"][1]) <= {"all_gather/data"}


@pytest.mark.parametrize("part", ("serve", "train"))
def test_a_one_rank_group_runs_the_mesh_less_steps_bit_for_bit(runs, part):
    assert runs[2][ARCH, part]
