"""An endpoint on a mesh whose batch fold has more than one rank:
``db.endpoint`` on 2 × 2 (data × model), 4 × 1 and 2 × 1 × 2 (pod × data ×
model) meshes of 4 ``gloo`` ranks on the CPU, rank 0 serving and ranks 1-3
in ``Endpoint.follow()``; against the mesh-less port endpoint and the
reference's ``repro`` endpoint on the same prompts and weights (the
reference's, carried by ``convert.lm_params``). The reference's endpoint
on a host mesh does not run (ROADMAP.md §3), so the mesh-less endpoints
are the oracle.

A rank holds b/D cache rows of a b-row decode bucket where the batch
fold's D ranks divide b, else all b; the slot pool's moves
(``serving.serve.move_cache_rows``) gather the rows over the fold. The
traffic (``tests/torch_serving_mesh_workers.py``) compacts 4 → 2, keeping
old rows 2 and 3 (the second data rank's on a fold of 2), then 2 → 1, the
rows going from cut to whole. Reduced olmoe-1b-7b on each mesh, gemma3-4b
(6 layers: window caches) and zamba2-7b (6 layers: SSM state and the
shared block) on 2 × 2.

The tokens must equal the mesh-less endpoints'; each step's logits lie
within TOL = 1e-5 of the largest logit (at least 1) of the mesh-less
endpoint's; every rank's logits are bit-equal to rank 0's, and its step
counters equal. A compaction that keeps each rank's own rows and
exchanges nothing across the fold is caught by the logit limit. A
``BucketedPrefill(mesh=)`` of 3 prompts in the bucket of 4 on 2 × 2 ends
with the 3 rows (2 ∤ 3: whole on every rank) and decodes as off the mesh.
Off a mesh the mover is ``t[rows]`` / ``pad_rows`` bit for bit, on every
cache kind.
"""

import asyncio
import concurrent.futures
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
import torch_serving_data_mesh_workers as D
import torch_serving_mesh_workers as W
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.launch.mesh import start_ranks
from repro_torch.serving import init_cache

serve_mod = importlib.import_module("repro_torch.serving.serve")

TOL = 1e-5


def jax_config(arch):
    return jax_get_config(arch).reduced(**({"n_layers": D.LAYERS[arch]} if arch in D.LAYERS else {}))


def jax_traffic(arch, weights, eos):
    """The reference's endpoint through the same traffic: its completions."""
    model = jax_build_model(jax_config(arch))
    db = repro.Database(dispatch="ref")
    db.register_model("lm", model, jax.tree.map(jnp.asarray, weights))
    ep = db.endpoint("lm", cache_len=W.CACHE_LEN, buckets=W.BUCKETS, gather_window=W.GATHER_WINDOW,
                     eos_token=eos)
    swapped = jax.tree.map(jnp.asarray, W.swapped(weights))

    async def run():
        with db.activate():
            ep.warmup()
            got = await W.traffic(ep, lambda: db.register_model("lm", model, swapped),
                                  W.prompts(model.cfg.vocab))
        await ep.aclose()
        return got

    return asyncio.run(run())


def f32_tree(tree):
    """Every float leaf of ``tree`` as an explicit float32 numpy array."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), tree)


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, {arch: the mesh-less port endpoint's run},
    {arch: the reference's completions}, the mesh-less BucketedPrefill
    case), the ranks running meanwhile."""
    weights, eos = {}, {}
    for arch in D.ARCHS:
        jm = jax_build_model(jax_config(arch))
        weights[arch] = f32_tree(jm.init(jax.random.PRNGKey(0)))
        model, params = W.params_of(D.config(arch), weights[arch])
        eos[arch] = W.eos_token(model, params, W.prompts(model.cfg.vocab)[0])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        started = pool.submit(start_ranks, D.run_checks, 4, backend="gloo", device="cpu",
                              args=(weights, eos))
        one, ref = {}, {}
        for arch in D.ARCHS:
            model, params = W.params_of(D.config(arch), weights[arch])
            _, params_v2 = W.params_of(D.config(arch), W.swapped(weights[arch]))
            one[arch] = W.serve(repro_torch.Database(device="cpu"), model, params, params_v2,
                                W.prompts(model.cfg.vocab), eos[arch])
            ref[arch] = jax_traffic(arch, weights[arch], eos[arch])
        model, params = W.params_of(D.config("olmoe-1b-7b"), weights["olmoe-1b-7b"])
        alone = D.prefill_case(model, params, None)
        return started.result(), one, ref, alone


def close(got, want) -> bool:
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("mesh,arch", D.RUNS)
def test_tokens_equal_the_meshless_endpoint_and_the_reference(runs, mesh, arch):
    ranks, one, ref, _ = runs
    got = ranks[0][(mesh, arch)]["completions"]
    assert got == one[arch]["completions"]
    assert [(list(map(int, t)), m) for t, m in got] == [(list(map(int, t)), m) for t, m in ref[arch]]


@pytest.mark.parametrize("mesh,arch", D.RUNS)
def test_the_traffic_compacts_across_the_fold(runs, mesh, arch):
    ranks, _, _, _ = runs
    r0 = ranks[0][(mesh, arch)]
    serve = r0["serve"]
    assert serve["decode"]["rebuckets"] >= 2 and serve["decode"]["eos_stops"] >= 1
    assert serve["completed"] == len(W.BURST) + len(W.PAIR) and serve["failed"] == 0
    # the moves gathered cache rows over the batch fold: bucket 4's, a
    # rank's share whole, at the compaction 4 → 2 (and, on a fold of 2,
    # bucket 2's at 2 → 1)
    fold = 4 if mesh == "4x1" else 2
    assert (4 // fold, 4) in r0["gathers"]
    assert ((1, 2) in r0["gathers"]) == (fold == 2)
    assert r0["collectives"]["all_gather/batch" if mesh == "2x1x2" else "all_gather/data"]["calls"] > 0


@pytest.mark.parametrize("mesh,arch", D.RUNS)
def test_each_steps_logits_are_within_the_limit_of_the_meshless_endpoint(runs, mesh, arch):
    ranks, one, _, _ = runs
    got, want = ranks[0][(mesh, arch)]["log"], one[arch]["log"]
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) > 0
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and close(g, w)


@pytest.mark.parametrize("mesh,arch", D.RUNS)
def test_every_ranks_logits_and_step_counters_equal_rank_0s(runs, mesh, arch):
    ranks, one, _, _ = runs
    r0 = ranks[0][(mesh, arch)]
    assert r0["counters"] == one[arch]["counters"]
    for r in ranks[1:]:
        rec = r[(mesh, arch)]
        assert rec["counters"] == r0["counters"]
        assert len(rec["log"]) == len(r0["log"])
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(rec["log"], r0["log"]))
        followed = rec["followed"]
        assert followed["failed"] == 0 and followed["compact"] == r0["counters"]["decode"]["rebuckets"]
        assert followed["decode"] == r0["counters"]["decode"]["steps"]


@pytest.mark.parametrize("mesh,arch", D.RUNS)
def test_a_compaction_that_exchanges_nothing_is_caught(runs, mesh, arch):
    ranks, one, _, _ = runs
    bad, want = ranks[0][(mesh, arch)]["planted_log"], one[arch]["log"]
    assert len(bad) == len(want)
    assert any(not close(g, w) for (_, g), (_, w) in zip(bad, want))


def test_bucketed_prefill_on_a_data_mesh_ends_with_the_request_rows(runs):
    """3 prompts in the bucket of 4 on 2 × 2: the slice back to 3 rows
    makes them whole on every rank (2 ∤ 3), and 4 decode steps follow the
    mesh-less run."""
    ranks, _, _, alone = runs
    assert alone["error"] is None
    for r in ranks:
        case = r["prefill"]
        assert case["error"] is None, case["error"]
        assert len(case["logits"]) == len(alone["logits"]) == 1 + D.DECODE
        for g, w in zip(case["logits"], alone["logits"]):
            assert g.shape == w.shape == (D.PREFILL_ROWS, w.shape[-1])
            assert close(g, w) and (g.argmax(-1) == w.argmax(-1)).all()
        assert all(np.array_equal(a, b) for a, b in zip(case["logits"], ranks[0]["prefill"]["logits"]))


# ---------------------------------------------------------------------------
# the mover off a mesh, one process
# ---------------------------------------------------------------------------

#: one arch per cache kind: K/V (attn), window K/V (local), mamba1 state,
#: mamba2 state with the shared block's K/V, MLA's latent, whisper's
#: decoder K/V
KIND_ARCHS = ("olmoe-1b-7b", "gemma3-4b", "falcon-mamba-7b", "zamba2-7b", "deepseek-v3-671b",
              "whisper-small")


def _filled(arch, b, cache_len=6):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(11)
    return serve_mod.map_cache(
        lambda t: torch.as_tensor(rng.standard_normal(t.shape).astype(np.float32)).to(t.dtype),
        init_cache(cfg, b, cache_len, device="cpu"))


def _leaves(tree):
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


P = serve_mod.PAD
#: (old rows, the new rows, what a leaf becomes today)
MOVES = {
    "pad": (3, [0, 1, 2, P], lambda t: serve_mod.pad_rows(t, 4)),
    "take": (4, [2, 0, 2, 1], lambda t: t[[2, 0, 2, 1]]),
    "compact": (4, [2, 3], lambda t: t[[2, 3]]),
    "slice": (4, [0, 1, 2], lambda t: t[:3]),
    "take_then_pad": (4, [3, 1, P, P], lambda t: serve_mod.pad_rows(t[[3, 1]], 4)),
    "identity": (4, [0, 1, 2, 3], lambda t: t),
}


@pytest.mark.parametrize("arch", KIND_ARCHS)
@pytest.mark.parametrize("move", sorted(MOVES))
def test_the_mover_off_a_mesh_is_todays_row_surgery_bit_for_bit(arch, move):
    old_b, rows, today = MOVES[move]
    caches = _filled(arch, old_b)
    got = serve_mod.move_cache_rows(caches, rows, old_b, len(rows))
    g, c = _leaves(got), _leaves(caches)
    assert len(g) == len(c) > 0
    for a, t in zip(g, c):
        want = today(t)
        assert a.dtype == want.dtype and a.shape == want.shape and torch.equal(a, want)
    assert (got is caches) == (move == "identity")


def test_a_leaf_that_matches_no_layout_raises():
    caches = _filled("olmoe-1b-7b", 3)
    with pytest.raises(ValueError, match="does not hold"):
        serve_mod.move_cache_rows(caches, [0, 1], 4, 2)
    with pytest.raises(ValueError, match="rows in"):
        serve_mod.move_cache_rows(caches, [0, 3], 3, 2)
    with pytest.raises(ValueError, match="then PAD"):
        serve_mod.move_cache_rows(caches, [P, 0], 3, 2)
    # a leaf with no axis passes through
    tree = {"n": torch.tensor(5.0), "k": torch.arange(6.0).reshape(3, 2)}
    moved = serve_mod.move_cache_rows(tree, [2, P], 3, 2)
    assert moved["n"] is tree["n"] and torch.equal(moved["k"], torch.tensor([[4.0, 5.0], [0.0, 0.0]]))
