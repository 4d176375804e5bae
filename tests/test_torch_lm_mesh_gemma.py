"""The window and tied-embedding kinds on a mesh, on 4 ``gloo`` ranks on
the CPU: the reduced gemma2-9b and gemma3-4b (``local``/``global`` layers,
softcaps, QK-norm in gemma3, ``embed_scale``, the head tied to the
embedding table on the vocabulary's shards), served (a prefill of 4 × 20
tokens, past the reduced window of 16, and 2 decode steps that shift the
window cache) on a 1 × 4 (data × model) mesh, where the 2 KV heads are
gathered whole, and on a 2 × 2 mesh, where each rank keeps its KV head's
window cache; one Adam step on the 2 × 2 mesh. Held to the one-process
port step and to the reference's one-device step
(tests/torch_lm_mesh_parity.py's bound); the ranks to each other bit for
bit; a planted missing all-reduce. A one-rank group runs the steps bit
for bit as the mesh-less ones.

The ranks start once for the module (``launch.mesh.start_ranks``, the
suite "gemma" of ``tests/torch_lm_mesh_workers.py``) while this process
runs the reference's steps.
"""

import numpy as np
import pytest

import torch_lm_mesh_parity as P
import torch_lm_mesh_workers as W

SUITE = W.SUITES["gemma"]
ARCHS = SUITE.archs


@pytest.fixture(scope="module")
def runs():
    """(the 4 ranks' records, the reference's steps, the one-rank record)."""
    return P.start("gemma", P.weights(SUITE), one_rank=True)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def test_the_prompt_is_longer_than_the_window():
    for arch in ARCHS:
        assert W.config(arch, SUITE).window == 16 < SUITE.s


@pytest.mark.parametrize("mesh", ("mesh", "mesh22"))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_equals_the_one_process_step(ranks, arch, mesh):
    rec = ranks[0][arch]
    assert P.close(rec[mesh]["logits"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("mesh", ("mesh", "mesh22"))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_equals_the_reference(ranks, reference, arch, mesh):
    assert P.close(ranks[0][arch][mesh]["logits"], reference[arch]["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_missing_all_reduce_fails_the_bound(ranks, arch):
    rec = ranks[0][arch]
    assert P.far(rec["planted"], rec["one"]["serve"]["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_and_runs_are_bit_equal(ranks, arch):
    r0 = ranks[0][arch]
    assert np.array_equal(r0["again"], r0["mesh"]["logits"])
    for r in ranks[1:]:
        for mesh in ("mesh", "mesh22"):
            assert np.array_equal(r[arch][mesh]["logits"], r0[mesh]["logits"]), mesh
        t0, t = r0["train22"], r[arch]["train22"]
        assert (t["loss"], t["norm"]) == (t0["loss"], t0["norm"])
        for part in ("grads", "params"):
            for k, v in t0[part].items():
                assert np.array_equal(t[part][k], v), (part, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_window_caches_hold_the_heads_the_rank_attends_over(ranks, arch):
    """Layer 0 is ``local``: its cache is the window's 16 slots. At 1 × 4
    the 2 KV heads of 64 split mid-head, are gathered, and every rank
    caches both; at 2 × 2 each rank keeps its own KV head of its 2 rows'
    (``init_cache(place=)`` sizes them so)."""
    rec = ranks[0][arch]
    b = SUITE.b
    assert rec["mesh"]["k0"] == rec["cache_k"] == (b, 16, 2, 64)
    assert rec["mesh22"]["k0"] == rec["cache22"]["kv/k"] == (b // 2, 16, 1, 64)
    assert rec["one"]["serve"]["k0"] == (b, 16, 2, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_head_is_tied_to_the_vocabulary_shards(ranks, arch):
    """No ``out_embed``: the table's gradient (lookup and head) is held
    with the others by the train tests; nothing is cut by segment."""
    rec = ranks[0][arch]
    assert "embed" in rec["train22"]["grads"] and "out_embed" not in rec["train22"]["grads"]
    assert rec["segments"] == [] and rec["whole_of_cut"]
    assert rec["collectives"]["all_gather/model"]["calls"] > 0


@pytest.mark.parametrize("mesh", ("1x4", "2x2"))
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_shard_gives_each_rank_its_blocks(ranks, arch, mesh):
    """``Placement.shard`` of the whole parameters gives each rank its
    block of every dimension the specs split (the tied table's vocabulary
    rows among them), cut by hand."""
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


@pytest.mark.parametrize("part", ("admitted", "serve", "train", "endpoint"))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_rank_mesh_runs_the_mesh_less_steps(runs, arch, part):
    assert runs[2][arch, part]
