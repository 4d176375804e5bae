"""An endpoint over several ranks: ``db.endpoint`` on a 1 × 4 mesh of 4
``gloo`` ranks on the CPU, rank 0 admitting the requests and broadcasting
each step's header, ranks 1-3 in ``Endpoint.follow()``; against the
mesh-less port endpoint and the reference's ``repro`` endpoint on the same
prompts and weights (the reference's, carried by ``convert.lm_params``).

The traffic (``tests/torch_serving_mesh_workers.py``): warmup, a burst of
4 requests whose slots free in turn (the decode bucket drops 4 → 2 → 1,
with a compaction that moves rows), an EOS stop, a hot swap of the
registered parameters, and a staggered pair within ``gather_window`` that
forms one batch; reduced olmoe-1b-7b and gemma3-4b (6 layers).

The tokens must equal the mesh-less endpoint's and the reference's; each
step's logits lie within TOL = 1e-5 of the largest logit (at least 1) of
the mesh-less endpoint's (tests/torch_lm_mesh_parity.py says why); every
rank's logits are bit-equal to rank 0's, and its step counters equal. A
follower that keeps its cache rows at a compaction is caught by the logit
limit: every logit is a collective's sum on a tensor-parallel mesh, so a
follower's fault reaches rank 0's logits too, and the ranks stay
bit-equal. A withheld header makes the followers raise ``FollowTimeout``
within their stated wait; a quiet spell longer than that wait does not,
as rank 0's scheduler sends "idle" headers while it waits.
"""

import asyncio
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
import torch_serving_mesh_workers as W
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.launch.mesh import start_ranks

TOL = 1e-5


def jax_config(arch):
    return jax_get_config(arch).reduced(**({"n_layers": W.LAYERS[arch]} if arch in W.LAYERS else {}))


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


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, {arch: the mesh-less port endpoint's run},
    {arch: the reference's completions}), the ranks running meanwhile."""
    weights, eos = {}, {}
    for arch in W.ARCHS:
        jm = jax_build_model(jax_config(arch))
        weights[arch] = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        model, params = W.params_of(W.config(arch), weights[arch])
        eos[arch] = W.eos_token(model, params, W.prompts(model.cfg.vocab)[0])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        started = pool.submit(start_ranks, W.run_checks, 4, backend="gloo", device="cpu",
                              args=(weights, eos))
        one, ref = {}, {}
        for arch in W.ARCHS:
            model, params = W.params_of(W.config(arch), weights[arch])
            _, params_v2 = W.params_of(W.config(arch), W.swapped(weights[arch]))
            one[arch] = W.serve(repro_torch.Database(device="cpu"), model, params, params_v2,
                                W.prompts(model.cfg.vocab), eos[arch])
            ref[arch] = jax_traffic(arch, weights[arch], eos[arch])
        return started.result(), one, ref


def close(got, want) -> bool:
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("arch", W.ARCHS)
def test_tokens_equal_the_meshless_endpoint_and_the_reference(runs, arch):
    ranks, one, ref = runs
    got = ranks[0][arch]["completions"]
    assert got == one[arch]["completions"]
    assert [(list(map(int, t)), m) for t, m in got] == [(list(map(int, t)), m) for t, m in ref[arch]]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_the_traffic_rebuckets_stops_at_eos_swaps_and_gathers(runs, arch):
    ranks, _, _ = runs
    got = ranks[0][arch]["completions"]
    serve = ranks[0][arch]["serve"]
    assert [m for _, m in got] == ["lm@v1"] * len(W.BURST) + ["lm@v2"] * len(W.PAIR)
    assert len(got[0][0]) < W.BURST[0] and serve["decode"]["eos_stops"] >= 1
    assert serve["batches"] == 2 and serve["batched_requests"] == len(W.BURST) + len(W.PAIR)
    assert serve["decode"]["rebuckets"] >= 2
    assert serve["completed"] == len(W.BURST) + len(W.PAIR) and serve["failed"] == 0


@pytest.mark.parametrize("arch", W.ARCHS)
def test_each_steps_logits_are_within_the_limit_of_the_meshless_endpoint(runs, arch):
    ranks, one, _ = runs
    got, want = ranks[0][arch]["log"], one[arch]["log"]
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) > 0
    for (_, g), (_, w) in zip(got, want):
        assert close(g, w)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_every_ranks_logits_and_step_counters_equal_rank_0s(runs, arch):
    ranks, one, _ = runs
    r0 = ranks[0][arch]
    assert r0["counters"] == one[arch]["counters"]
    for r in ranks[1:]:
        assert r[arch]["counters"] == r0["counters"]
        assert len(r[arch]["log"]) == len(r0["log"])
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(r[arch]["log"], r0["log"]))


@pytest.mark.parametrize("arch", W.ARCHS)
def test_follow_returns_on_aclose_with_the_steps_rank_0_ran(runs, arch):
    ranks, _, _ = runs
    c = ranks[0][arch]["counters"]
    for r in ranks[1:]:
        followed = r[arch]["followed"]
        assert followed["failed"] == 0
        assert followed["prefill"] == c["prefill"]["steps"] and followed["decode"] == c["decode"]["steps"]
        assert followed["compact"] == c["decode"]["rebuckets"]
        assert followed["warm_prefill"] == len(W.BUCKETS) and followed["warm_decode"] == 1
    # one header a step, broadcast to the mesh (a prefill's batch beside it)
    assert ranks[0][arch]["collectives"]["broadcast/mesh"]["calls"] > c["decode"]["steps"]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_a_follower_that_skips_a_compaction_is_caught(runs, arch):
    ranks, one, _ = runs
    bad, want = ranks[0][arch]["planted_log"], one[arch]["log"]
    assert any(not close(g, w) for (_, g), (_, w) in zip(bad, want))
    # the fault reaches every rank through the step's collectives alike
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(ranks[3][arch]["planted_log"], bad))


def test_a_withheld_header_makes_the_followers_raise_within_their_wait(runs):
    ranks, _, _ = runs
    assert ranks[0]["withheld"]["raised"] is None
    for r in ranks[1:]:
        w = r["withheld"]
        assert w["raised"] and "waited" in w["raised"]
        assert W.SHORT_WAIT <= w["seconds"] < W.SHORT_WAIT + 5.0


def test_a_quiet_spell_longer_than_the_wait_keeps_the_followers_following(runs):
    ranks, _, _ = runs
    q0 = ranks[0]["quiet"]
    assert q0["tokens"][0] == q0["tokens"][1] and q0["left"]
    for r in ranks[1:]:
        q = r["quiet"]
        assert q["raised"] is None and q["left"]
        assert q["followed"]["idle"] >= 2 and q["followed"]["prefill"] == 2
        assert q["followed"]["failed"] == 0


def test_rank_0_is_the_front_door(runs):
    ranks, _, _ = runs
    assert set(ranks[0]["refused"]) == {"follow", "data_axes"}
    for r in ranks[1:]:
        assert set(r["refused"]) == {"submit", "warmup", "data_axes"}
        assert "rank 0" in r["refused"]["submit"]
    assert "data axes" in ranks[0]["refused"]["data_axes"]
