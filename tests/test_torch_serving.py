"""The serving front door in the JAX package and in the port: the model
registry and executable cache of the session (``core/session.py``),
``BucketedPrefill`` (``serving/serve.py``) and the async ``Endpoint``
(``serving/service.py``).

Every behaviour of ``tests/test_serving.py`` (but the mesh-only
``_PlacedParamsCache``), the ``BucketedPrefill`` cases of
``tests/test_session.py`` and the budgeted session's of
``tests/test_oocore.py`` run through both packages on the same seeded
traffic: the completions must be equal token for token, error texts word
for word, and the ``cache`` and ``serve`` counter subtrees value for value;
the reference's own assertions are then made of the port. The toy LM is
``tests/test_serving.py``'s ``_TinyLM`` (copied here) and its twin in
torch, which keeps the port's cache layout: a ``scan`` list with one entry
per repeat, the batch on axis 0 of every leaf.

Then two real models, reduced, with the JAX weights carried across by
``convert.lm_params``: olmoe-1b-7b (K/V caches) and falcon-mamba-7b
(conv and SSM state caches). Through both packages' endpoints they give
equal token ids; prefill at a padded bucket and decode at decode buckets
give logits within TOL = 1e-5 (``tests/test_torch_olmoe.py`` says why that
bound holds). The JAX side runs them under
``repro.Database(dispatch="interpret")``, the port under
``repro_torch.Database(device="cpu")``, where each kernel wrapper takes its
plain version.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro
import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import BucketedPrefill as JBucketedPrefill
from repro.serving import make_decode_step as jax_make_decode_step
from repro.serving import service as jservice
from repro_torch import convert, kernels
from repro_torch.configs import get_config
from repro_torch.models import build_model, ffn
from repro_torch.serving import (
    BucketedPrefill,
    DeadlineExceeded,
    Endpoint,
    EndpointClosed,
    Overloaded,
    init_cache,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.serving import service

V = 11  # toy vocab
TOL = 1e-5
JAX, TORCH = "jax", "torch"


class _JaxTinyLM:
    """``tests/test_serving.py``'s toy LM: each row's next token is a pure
    function of its own running token sum, so batched serving must match
    solo serving bit for bit, and a cross-slot leak changes the output.
    The cache carries a stacked ``scan`` subtree (batch on axis 1) and a
    flat leaf (batch on axis 0)."""

    cfg = None

    def prefill(self, params, batch, cache_len):
        t = batch["tokens"]
        s = jnp.sum(t, axis=1, keepdims=True)
        nxt = (s * params).astype(jnp.int32) % V
        caches = {
            "scan": {"h": jnp.tile(s.astype(jnp.float32)[None], (2, 1, 1))},
            "state": s.astype(jnp.float32),
        }
        return jax.nn.one_hot(nxt, V), caches

    def decode_step(self, params, token, caches, length, enc_out=None):
        tok = token.astype(jnp.float32)
        state = caches["state"] + tok
        scan = caches["scan"]["h"] + tok[None]
        s = (state + scan[0]) / 2.0
        nxt = (s.astype(jnp.int32) * params.astype(jnp.int32) + length) % V
        return jax.nn.one_hot(nxt, V), {"scan": {"h": scan}, "state": state}


class _TinyLM:
    """The twin of ``_JaxTinyLM`` in torch, in the port's cache layout: the
    two repeats of ``scan`` are two entries, batch on axis 0 in each."""

    cfg = None

    def prefill(self, batch, cache_len, params=None):
        s = batch["tokens"].sum(1, keepdim=True).float()
        nxt = (s * params).to(torch.int32) % V
        caches = {"scan": [{"h": s}, {"h": s}], "state": s}
        return F.one_hot(nxt.long(), V).float(), caches

    def decode_step(self, token, caches, length, params=None):
        tok = token.float()
        state = caches["state"] + tok
        scan = [{"h": e["h"] + tok} for e in caches["scan"]]
        s = (state + scan[0]["h"]) / 2.0
        nxt = (s.to(torch.int32) * params.to(torch.int32) + length) % V
        return F.one_hot(nxt.long(), V).float(), {"scan": scan, "state": state}


def _oracle(tokens, p, n_new, seq):
    """What the toy LM greedily generates for one row, in plain numpy."""
    s = int(np.sum(tokens))
    out = [(s * p) % V]
    length = seq
    for _ in range(n_new - 1):
        s += out[-1]
        out.append((s * p + length) % V)
        length += 1
    return out


def _db(pkg, **kw):
    if pkg == JAX:
        return repro.Database(**kw)
    return repro_torch.Database(device="cpu", **kw)


def _tiny(pkg):
    return _JaxTinyLM() if pkg == JAX else _TinyLM()


def _scalar(pkg, v):
    return jnp.asarray(v) if pkg == JAX else torch.tensor(v)


def _endpoint(pkg, db=None, p=3.0, **kw):
    db = db or _db(pkg)
    db.register_model("lm", _tiny(pkg), _scalar(pkg, p))
    kw.setdefault("cache_len", 16)
    kw.setdefault("buckets", [(1, 8), (2, 8), (4, 8)])
    return db, db.endpoint("lm", **kw)


def _prompts(n, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=seq).astype(np.int64) for _ in range(n)]


def _summary(outs):
    """What a completion must equal across the packages (not its latency;
    an error by its class name and text)."""
    return [
        (type(o).__name__, str(o)) if isinstance(o, Exception)
        else (o.token_ids.tolist(), o.token_ids.dtype.name, o.prompt_len, o.model)
        for o in outs
    ]


def _both(run):
    """``run(pkg) → (db, outs)`` in each package: equal completions and
    equal ``cache``/``serve`` counters. Returns the port's (db, outs)."""
    jdb, jouts = run(JAX)
    tdb, touts = run(TORCH)
    assert _summary(touts) == _summary(jouts)
    tc, jc = tdb.counters(), jdb.counters()
    assert tc["cache"] == jc["cache"]
    assert tc["serve"] == jc["serve"]
    return tdb, touts


def _burst(ep, prompts, budgets, **kw):
    async def go():
        return await asyncio.gather(
            *[ep.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)], **kw
        )

    return asyncio.run(go())


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


# ---------------------------------------------------------------------------
# coalescing + correctness
# ---------------------------------------------------------------------------


def test_concurrent_requests_coalesce_and_match_solo_oracle():
    prompts, budgets = _prompts(4), [3, 5, 2, 4]

    def run(pkg):
        db, ep = _endpoint(pkg)
        return db, _burst(ep, prompts, budgets)

    db, outs = _both(run)
    c = db.counters()["serve"]
    assert c["batches"] == 1 and c["batched_requests"] == 4
    assert c["prefill"]["steps"] == 1
    assert c["completed"] == 4 and c["failed"] == 0
    assert c["decode"]["slot_releases"] == 4
    assert c["decode"]["rebuckets"] >= 1
    for out, p, n in zip(outs, prompts, budgets):
        assert out.model == "lm@v1" and out.prompt_len == 8
        assert out.token_ids.dtype == np.int32
        np.testing.assert_array_equal(out.token_ids, _oracle(p, 3, n, seq=8))


def test_group_larger_than_max_bucket_chunks():
    def run(pkg):
        db, ep = _endpoint(pkg)
        return db, _burst(ep, _prompts(6), [2] * 6)

    db, outs = _both(run)
    assert len(outs) == 6
    c = db.counters()["serve"]
    assert c["batches"] == 2 and c["batched_requests"] == 6


def test_endpoint_survives_consecutive_event_loops():
    def run(pkg):
        db, ep = _endpoint(pkg)
        return db, [asyncio.run(ep.submit(_prompts(1)[0], max_new_tokens=2)) for _ in range(2)]

    db, (a, b) = _both(run)
    np.testing.assert_array_equal(a.token_ids, b.token_ids)
    assert db.counters()["serve"]["completed"] == 2


def test_serve_is_the_endpoint_front_door():
    def run(pkg):
        db = _db(pkg)
        db.register_model("lm", _tiny(pkg), _scalar(pkg, 2.0))
        ep = (repro if pkg == JAX else repro_torch).serve(db, "lm", cache_len=16, buckets=[(2, 8)])
        assert isinstance(ep, jservice.Endpoint if pkg == JAX else Endpoint)
        return db, [asyncio.run(ep.submit(_prompts(1)[0], max_new_tokens=2))]

    _, (out,) = _both(run)
    assert out.token_ids.shape == (2,)


# ---------------------------------------------------------------------------
# decode bucketing: warm vs cold step builds, reuse across requests
# ---------------------------------------------------------------------------


def test_warmup_compiles_every_bucket_and_traffic_adds_none():
    warm = {}

    def run(pkg):
        db, ep = _endpoint(pkg)
        assert ep.decode_buckets == [1, 2, 4]
        ep.warmup()
        c = db.counters()["serve"]
        assert c["prefill"]["compiles"] == 3 and c["decode"]["compiles"] == 3
        warm[pkg] = (c["prefill"]["compiles"], c["decode"]["compiles"], c["decode"]["traces"])
        outs = []
        for n in (3, 2, 4, 1):
            outs += _burst(ep, _prompts(n, seed=n), [3] * n)
        return db, outs

    db, _ = _both(run)
    c = db.counters()["serve"]
    # a warmed endpoint builds (and first-calls) nothing on the request path
    assert (c["prefill"]["compiles"], c["decode"]["compiles"], c["decode"]["traces"]) == warm[TORCH]
    assert warm[TORCH] == warm[JAX] == (3, 3, 3)
    assert c["decode"]["steps"] > 0


def test_cold_endpoint_compiles_on_request_path_once_per_bucket():
    def run(pkg):
        db, ep = _endpoint(pkg)
        outs = _burst(ep, _prompts(2, seed=1), [2, 2])
        c = db.counters()["serve"]
        assert c["prefill"]["compiles"] == 1 and c["decode"]["compiles"] == 1
        outs += _burst(ep, _prompts(2, seed=2), [2, 2])  # same bucket: reused
        return db, outs

    db, _ = _both(run)
    c = db.counters()["serve"]
    assert c["prefill"]["compiles"] == 1
    assert c["decode"]["compiles"] == 1
    assert c["decode"]["traces"] == 1


def test_decode_step_counts_a_trace_at_its_first_call_only():
    seen = []
    step = make_decode_step(_TinyLM(), on_trace=lambda: seen.append(1))
    caches = {"scan": [{"h": torch.zeros(2, 1)}], "state": torch.zeros(2, 1)}
    for length in range(3):
        step(torch.zeros(2, 1, dtype=torch.int32), caches, length, torch.tensor(3.0))
    assert seen == [1]


# ---------------------------------------------------------------------------
# load shedding + lifecycle
# ---------------------------------------------------------------------------


def test_queue_full_sheds_with_overloaded():
    def run(pkg):
        db, ep = _endpoint(pkg, max_queue=2)
        return db, _burst(ep, _prompts(6), [2] * 6, return_exceptions=True)

    db, outs = _both(run)
    shed = [o for o in outs if isinstance(o, Overloaded)]
    served = [o for o in outs if not isinstance(o, Exception)]
    assert len(shed) == 4 and len(served) == 2
    c = db.counters()["serve"]
    assert c["shed_queue_full"] == 4
    assert c["admitted"] == 2 and c["completed"] == 2
    assert c["queue_peak"] == 2


def test_expired_deadline_sheds_at_batch_formation():
    def run(pkg):
        db, ep = _endpoint(pkg)

        async def go():
            return await asyncio.gather(
                ep.submit(_prompts(1)[0], max_new_tokens=2),
                ep.submit(_prompts(1, seed=1)[0], max_new_tokens=2, deadline=0.0),
                return_exceptions=True,
            )

        ok, dead = asyncio.run(go())
        # the text carries the measured queueing time: compare the class
        assert isinstance(dead, jservice.DeadlineExceeded if pkg == JAX else DeadlineExceeded)
        return db, [ok]

    db, _ = _both(run)
    c = db.counters()["serve"]
    assert c["shed_deadline"] == 1 and c["completed"] == 1


def test_closed_endpoint_rejects_submits():
    def run(pkg):
        db, ep = _endpoint(pkg)
        closed = jservice.EndpointClosed if pkg == JAX else EndpointClosed

        async def go():
            async with ep:
                out = await ep.submit(_prompts(1)[0], max_new_tokens=1)
            with pytest.raises(closed) as info:
                await ep.submit(_prompts(1)[0])
            return [out, info.value]

        return db, asyncio.run(go())

    _both(run)


# ---------------------------------------------------------------------------
# serving edge cases
# ---------------------------------------------------------------------------


def test_unservable_requests_rejected_at_submit():
    bad = [
        (np.zeros(9, np.int64), {}, "no bucket fits"),
        (np.zeros(0, np.int64), {}, "zero-length prompt"),
        (np.zeros((2, 8), np.int64), {}, "1-D token ids"),
        (np.zeros(8, np.int64), {"max_new_tokens": 0}, "max_new_tokens"),
    ]

    def run(pkg):
        db, ep = _endpoint(pkg)

        async def go():
            errs = []
            for tokens, kw, match in bad:
                with pytest.raises(ValueError, match=match) as info:
                    await ep.submit(tokens, **kw)
                errs.append(info.value)
            return errs

        return db, asyncio.run(go())

    db, _ = _both(run)
    c = db.counters()["serve"]
    assert c["admitted"] == 0 and c["batches"] == 0


def test_oversized_batch_never_forms():
    def run(pkg):
        if pkg == JAX:
            pre = JBucketedPrefill(_JaxTinyLM(), cache_len=16, buckets=[(2, 8), (4, 8)])
            tokens, p = jnp.zeros((8, 8), jnp.int32), jnp.asarray(1.0)
        else:
            pre = BucketedPrefill(_TinyLM(), cache_len=16, buckets=[(2, 8), (4, 8)], device="cpu")
            tokens, p = torch.zeros((8, 8), dtype=torch.int32), torch.tensor(1.0)
        with pytest.raises(ValueError, match="no bucket fits") as info:
            pre.prefill(p, {"tokens": tokens})
        assert (pre.max_batch(8), pre.max_batch(5)) == (4, 0)
        return pre.db, [info.value]

    _both(run)


# ---------------------------------------------------------------------------
# per-tenant model versions through the catalog
# ---------------------------------------------------------------------------


def test_tenants_pin_model_versions_and_bare_names_hot_swap():
    p = _prompts(1)[0]

    def run(pkg):
        db = _db(pkg)
        db.register_model("lm", _tiny(pkg), _scalar(pkg, 3.0))   # lm@v1
        db.register_model("lm", _tiny(pkg), _scalar(pkg, 5.0))   # lm@v2 (latest)
        ep = db.endpoint(cache_len=16, buckets=[(2, 8)],
                         tenants={"pinned": "lm@v1", "latest": "lm"})

        async def pair():
            return await asyncio.gather(
                ep.submit(p, tenant="pinned", max_new_tokens=3),
                ep.submit(p, tenant="latest", max_new_tokens=3),
            )

        outs = list(asyncio.run(pair()))
        db.register_model("lm", _tiny(pkg), _scalar(pkg, 7.0))   # lm@v3
        outs.append(asyncio.run(ep.submit(p, tenant="latest", max_new_tokens=3)))

        async def unknown():
            await ep.submit(p, tenant="nobody")

        with pytest.raises(ValueError, match="no model mapping") as info:
            asyncio.run(unknown())
        return db, outs + [info.value]

    db, (a, b, c, _) = _both(run)
    assert a.model == "lm@v1" and b.model == "lm@v2" and c.model == "lm@v3"
    np.testing.assert_array_equal(a.token_ids, _oracle(p, 3, 3, 8))
    np.testing.assert_array_equal(b.token_ids, _oracle(p, 5, 3, 8))
    np.testing.assert_array_equal(c.token_ids, _oracle(p, 7, 3, 8))
    # different versions never share a batch
    assert db.counters()["serve"]["batches"] == 3
    assert db.catalog.models() == {"lm": ("v1", "v2", "v3")}


def test_model_registry_errors():
    def run(pkg):
        db = _db(pkg)
        catalog_error = repro.CatalogError if pkg == JAX else repro_torch.CatalogError
        errs = []
        with pytest.raises(catalog_error) as info:
            db.model("ghost")
        errs.append(info.value)
        db.register_model("lm", _tiny(pkg), _scalar(pkg, 1.0))
        with pytest.raises(catalog_error) as info:
            db.model("lm@v9")
        errs.append(info.value)
        with pytest.raises(ValueError, match="params=") as info:
            db.endpoint(_tiny(pkg), cache_len=8)
        errs.append(info.value)
        ep = db.endpoint(cache_len=16, buckets=[(1, 8)])
        with pytest.raises(ValueError, match="no default model") as info:
            asyncio.run(ep.submit(np.zeros(8, np.int64)))
        errs.append(info.value)
        return db, errs

    _, errs = _both(run)
    assert str(errs[0]).startswith("model 'ghost' is not registered")


def test_endpoint_auto_registers_a_model_instance():
    def run(pkg):
        db = _db(pkg)
        ep = db.endpoint(_tiny(pkg), params=_scalar(pkg, 3.0), name="tiny", cache_len=16,
                         buckets=[(2, 8)])
        return db, [asyncio.run(ep.submit(_prompts(1)[0], max_new_tokens=2))]

    db, (out,) = _both(run)
    assert out.model == "tiny@v1" and db.model("tiny").version == "v1"


# ---------------------------------------------------------------------------
# the telemetry tree
# ---------------------------------------------------------------------------


def test_counters_tree_shape_and_snapshot_semantics():
    def run(pkg):
        db, ep = _endpoint(pkg)
        c = db.counters()
        assert set(c["cache"]) == {"hits", "misses", "evictions"}
        c["serve"]["requests"] = 999   # a snapshot, not the live tree
        c["cache"]["hits"] = 999
        c["serve"]["decode"]["steps"] = 999
        assert db.counters()["serve"]["requests"] == 0
        assert db.counters()["serve"]["decode"]["steps"] == 0
        assert db.counters()["cache"]["hits"] == 0
        return db, [asyncio.run(ep.submit(_prompts(1)[0], max_new_tokens=1))]

    db, _ = _both(run)
    c = db.counters()
    assert set(c) == set(repro.Database().counters()) == {"cache", "reshard", "spill", "serve"}
    assert set(c["reshard"]) == set(repro.Database().counters()["reshard"])
    assert set(c["serve"]) == set(repro.Database().counters()["serve"])
    assert c["serve"]["completed"] == 1
    assert c["cache"]["misses"] >= 1   # serving shares the session cache


# ---------------------------------------------------------------------------
# EOS early stop
# ---------------------------------------------------------------------------


def test_eos_token_releases_slot_early_with_identical_prefix():
    budget, p = 8, _prompts(1)[0]
    base = {}

    def run(pkg):
        db0, ep0 = _endpoint(pkg)
        base[pkg] = (asyncio.run(ep0.submit(p, max_new_tokens=budget)),
                     db0.counters()["serve"]["decode"]["steps"])
        eos = int(base[pkg][0].token_ids[2])  # a mid-sequence token
        db, ep = _endpoint(pkg, eos_token=eos)
        return db, [asyncio.run(ep.submit(p, max_new_tokens=budget))]

    db, (out,) = _both(run)
    first, base_steps = base[TORCH]
    assert _summary([first]) == _summary([base[JAX][0]])
    eos = int(first.token_ids[2])
    k = list(first.token_ids).index(eos)
    np.testing.assert_array_equal(out.token_ids, first.token_ids[: k + 1])
    assert len(out.token_ids) < budget
    c = db.counters()["serve"]["decode"]
    assert c["steps"] < base_steps
    assert c["eos_stops"] == 1 and c["slot_releases"] == 1


def test_eos_absent_decodes_full_budget():
    p = _prompts(1)[0]

    def run(pkg):
        _, ep0 = _endpoint(pkg)
        base = asyncio.run(ep0.submit(p, max_new_tokens=4))
        db, ep = _endpoint(pkg, eos_token=V + 1)  # never emitted
        return db, [base, asyncio.run(ep.submit(p, max_new_tokens=4))]

    db, (base, out) = _both(run)
    np.testing.assert_array_equal(out.token_ids, base.token_ids)
    assert db.counters()["serve"]["decode"]["eos_stops"] == 0


# ---------------------------------------------------------------------------
# BucketedPrefill over the session's executable cache
# ---------------------------------------------------------------------------


class _JaxStubModel:
    """``tests/test_session.py``'s stand-in: prefill returns per-token
    logits."""

    cfg = None

    def prefill(self, params, batch, cache_len):
        t = batch["tokens"]
        return t[..., None].astype(jnp.float32) * params, {"len": cache_len}


class _StubModel:
    cfg = None

    def prefill(self, batch, cache_len, params=None):
        return batch["tokens"][..., None].float() * params, {"len": cache_len}


def _bucketed(pkg, **kw):
    """A BucketedPrefill of the stub model; without ``db=``, on a private
    session (on the CPU in the port)."""
    if pkg == JAX:
        return JBucketedPrefill(_JaxStubModel(), **kw)
    return BucketedPrefill(_StubModel(), device="cpu", **kw)


def _ones(pkg, b, s):
    return jnp.ones((b, s), jnp.int32) if pkg == JAX else torch.ones((b, s), dtype=torch.int32)


def test_bucketed_prefill_buckets_hits_and_evictions():
    def run(pkg):
        srv = _bucketed(pkg, cache_len=64, buckets=[(2, 16), (4, 32), (8, 64)], max_entries=2)
        p = _scalar(pkg, 2.0)
        srv.warmup(p, buckets=[(2, 16), (4, 32)])
        assert srv.db.counters()["cache"] == {"hits": 0, "misses": 2, "evictions": 0}
        logits, _ = srv.prefill(p, {"tokens": _ones(pkg, 1, 16)})
        assert tuple(logits.shape) == (1, 16, 1)
        assert srv.db.counters()["cache"]["hits"] == 1
        np.testing.assert_allclose(np.asarray(logits), 2.0)
        logits, _ = srv.prefill(p, {"tokens": _ones(pkg, 5, 64)})
        assert tuple(logits.shape) == (5, 64, 1)
        assert srv.db.counters()["cache"] == {"hits": 1, "misses": 3, "evictions": 1}
        srv.prefill(p, {"tokens": _ones(pkg, 4, 32)})
        errs = []
        for shape, match in (((16, 64), "no bucket fits"), ((2, 10), "seq must match exactly")):
            with pytest.raises(ValueError, match=match) as info:
                srv.prefill(p, {"tokens": _ones(pkg, *shape)})
            errs.append(info.value)
        return srv.db, errs

    db, _ = _both(run)
    assert db.counters()["cache"] == {"hits": 1, "misses": 4, "evictions": 2}


def test_bucketed_prefill_shares_session_cache():
    def run(pkg):
        db = _db(pkg, max_cache_entries=8)
        srv = _bucketed(pkg, cache_len=8, db=db)
        zeros = jnp.zeros((1, 4), jnp.int32) if pkg == JAX else torch.zeros((1, 4), dtype=torch.int32)
        srv.prefill(_scalar(pkg, 1.0), {"tokens": zeros})
        return db, []

    db, _ = _both(run)
    assert db.counters()["cache"]["misses"] == 1


def test_bucketed_prefill_warmup_with_spilled_relations():
    sql = """
mm   := SELECT Rx.row, SUM(multiply(Rx.val, theta.val))
        FROM Rx, theta WHERE Rx.col = theta.col GROUP BY Rx.row;
pred := SELECT mm.row, logistic(mm.val) FROM mm;
SELECT SUM(xent(pred.val, Ry.val)) FROM pred, Ry WHERE pred.row = Ry.row
"""
    n, m = 64, 8
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, m)).astype(np.float32)
    y = ((rng.uniform(size=n) > 0.5) * 0.98 + 0.01).astype(np.float32)
    theta = (rng.normal(size=m) * 0.1).astype(np.float32)

    def run(pkg):
        db = _db(pkg, memory_budget=(n * m * 4 + n * 4 + m * 4) * 0.5)
        arr = jnp.asarray if pkg == JAX else torch.as_tensor
        db.put("Rx", arr(X), keys=("row", "col"))
        db.put("Ry", arr(y), keys=("row",))
        db.put("theta", arr(theta), keys=("col",))
        # a training step spills + streams through the same session…
        db.sql(sql, wrt=("theta", "Rx", "Ry")).step()
        assert db.counters()["spill"]["spilled_relations"] == 2
        # …and the serving cache on top of it behaves as unbudgeted
        srv = _bucketed(pkg, cache_len=16, db=db, buckets=[(2, 8), (4, 16)])
        srv.warmup(_scalar(pkg, 2.0))
        assert db.counters()["cache"] == {"hits": 0, "misses": 2, "evictions": 0}
        logits, _ = srv.prefill(_scalar(pkg, 2.0), {"tokens": _ones(pkg, 1, 8)})
        assert tuple(logits.shape) == (1, 8, 1)
        return db, []

    db, _ = _both(run)
    c = db.counters()
    assert c["cache"] == {"hits": 1, "misses": 2, "evictions": 0}
    assert c["spill"]["spilled_relations"] == 2


def test_session_cache_is_an_lru_with_counters():
    db = repro_torch.Database(device="cpu", max_cache_entries=2)
    built = []

    def get(key):
        return db.cached_executable(key, lambda: built.append(key) or key)

    for key in ("a", "b", "a", "c", "b"):
        assert get(key) == key
    # "a" was used after "b", so "c" evicts "b"; "b" is then built again
    assert built == ["a", "b", "c", "b"]
    assert db.counters()["cache"] == {"hits": 1, "misses": 4, "evictions": 2}


# ---------------------------------------------------------------------------
# the cache-batch rule of the port's layout, on both cache kinds
# ---------------------------------------------------------------------------


def _cfg(arch):
    kw = {"ssm_pallas": True} if arch in ("falcon-mamba-7b", "zamba2-7b") else {}
    return get_config(arch).reduced(**kw), jax_get_config(arch).reduced(**kw)


def _filled(jcfg, batch, cache_len):
    """A cache of the reference's ``init_cache`` layout whose every entry
    is distinct, so that a row moved along the wrong axis shows, and the
    same cache in the port's layout (``convert.lm_caches``)."""
    from repro.serving.serve import init_cache as jax_init_cache

    counter = iter(range(1, 10 ** 6))
    jc = jax.tree.map(
        lambda a: jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) + next(counter) * 10.0 ** 4,
        jax_init_cache(jcfg, batch, cache_len),
    )
    return convert.lm_caches(jax.tree.map(np.asarray, jc), "cpu"), jc


def _leaves(tree):
    """The tensors of a cache tree, dict keys in sorted order (the order of
    the reference's trees after ``jax.tree.map``)."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b"])
def test_cache_batch_surgery_takes_axis_0_of_the_ports_layout(arch):
    """Pad, compaction and the bucket slice move rows of the batch axis
    only, on K/V and on (conv, ssm) caches, as the reference's helpers do
    on its stacked layout — also where ``cache_len`` equals the bucket,
    where a copy of the reference's rule (axis 1 under ``scan``) would cut
    the cache positions instead."""
    cfg, jcfg = _cfg(arch)
    bucket = cache_len = 4
    tc, jc = _filled(jcfg, 3, cache_len)
    layout = _leaves(init_cache(cfg, 3, cache_len, device="cpu"))
    assert [t.shape for t in layout] == [t.shape for t in _leaves(tc)]
    assert all(t.shape[0] == 3 for t in layout)

    def same(got, want):
        want = convert.lm_caches(jax.tree.map(np.asarray, want), "cpu")
        g, w = _leaves(got), _leaves(want)
        assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w))

    tp, jp = service._pad_cache_batch(tc, 3, bucket), jservice._pad_cache_batch(jc, 3, bucket)
    same(tp, jp)
    for leaf, orig in zip(_leaves(tp), _leaves(tc)):
        assert leaf.shape == (bucket, *orig.shape[1:])
        assert torch.equal(leaf[:3], orig) and not leaf[3:].any()
    idx = [2, 0, 2, 1]
    same(service._take_cache_batch(tp, idx, bucket), jservice._take_cache_batch(jp, idx, bucket))
    for leaf, orig in zip(_leaves(service._take_cache_batch(tp, idx, bucket)), _leaves(tp)):
        assert torch.equal(leaf, orig[idx])
    same(BucketedPrefill._slice_cache_batch(tp, 3, bucket),
         JBucketedPrefill._slice_cache_batch(jp, 3, bucket))
    # planted fault: the reference's rule (axis 1 under "scan") on the
    # port's layout moves cache positions, not rows
    wrong = service.map_cache(lambda t: t.index_select(1 if t.dim() > 1 else 0,
                                                       torch.tensor(idx)), tp)
    with pytest.raises(AssertionError):
        same(wrong, jservice._take_cache_batch(jp, idx, bucket))


# ---------------------------------------------------------------------------
# real models through both endpoints
# ---------------------------------------------------------------------------

SEQ, CACHE_LEN, BUCKETS = 16, 24, [(2, 16), (4, 16)]


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "falcon-mamba-7b"])
def lm(request):
    """(arch, reference model, its params, port model with those params)."""
    cfg, jcfg = _cfg(request.param)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), params)
    return request.param, jmodel, params, model


def _lm_prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=SEQ).astype(np.int32) for _ in range(n)]


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=TOL, atol=TOL,
    )


def _lm_endpoint(pkg, lm):
    _, jmodel, params, model = lm
    if pkg == JAX:
        db = repro.Database(dispatch="interpret")
        db.register_model("lm", jmodel, jax.tree.map(jnp.asarray, params))
    else:
        db = repro_torch.Database(device="cpu")
        db.register_model("lm", model, {k: p.detach() for k, p in model.named_parameters()})
    return db, db.endpoint("lm", cache_len=CACHE_LEN, buckets=BUCKETS)


def test_reduced_models_serve_equal_tokens_through_both_endpoints(lm):
    """Three concurrent requests of mixed budgets: one prefill at the
    padded bucket (3 rows in 4), decode at buckets 4, 2 and 1 with
    compaction: equal token ids and counters in both packages, and the
    port's equal to each request served alone."""
    vocab = lm[3].cfg.vocab
    prompts, budgets = _lm_prompts(3, vocab), [4, 2, 3]

    def run(pkg):
        db, ep = _lm_endpoint(pkg, lm)
        with db.activate():
            ep.warmup()
            return db, _burst(ep, prompts, budgets)

    db, outs = _both(run)
    c = db.counters()["serve"]
    assert c["batches"] == 1 and c["decode"]["rebuckets"] >= 1
    assert (c["prefill"]["compiles"], c["decode"]["compiles"]) == (2, 3)
    model = lm[3]
    prefill = make_prefill_step(model, CACHE_LEN, db=db)
    decode = make_decode_step(model, db=db)
    for out, p, n in zip(outs, prompts, budgets):
        logits, caches = prefill({"tokens": torch.tensor(p)[None]})
        solo = [int(logits[0, -1].argmax())]
        for step in range(n - 1):
            logits, caches = decode(torch.tensor([[solo[-1]]], dtype=torch.int32), caches, SEQ + step)
            solo.append(int(logits[0, -1].argmax()))
        assert out.token_ids.tolist() == solo


def test_reduced_models_bucket_logits_match_jax(lm):
    """The endpoint's pieces with their logits: ``BucketedPrefill`` at a
    padded bucket (3 rows in 4; logits and caches sliced back), the caches
    padded to decode bucket 4 and three decode steps of the endpoint's
    bucket step, in both packages, within TOL."""
    arch, jmodel, params, model = lm
    tokens = np.stack(_lm_prompts(3, model.cfg.vocab, seed=1))
    jdb, jep = _lm_endpoint(JAX, lm)
    tdb, tep = _lm_endpoint(TORCH, lm)
    jentry, tentry = jdb.model("lm"), tdb.model("lm")
    with jdb.activate():
        jlogits, jcaches = jep._prefill_for(jentry).prefill(jentry.params, {"tokens": jnp.asarray(tokens)})
    logits, caches = tep._prefill_for(tentry).prefill(tentry.params, {"tokens": torch.tensor(tokens)})
    assert tuple(logits.shape) == (3, 1, model.cfg.vocab)
    _close(logits, jlogits)
    want = convert.lm_caches(jax.tree.map(np.asarray, jcaches), "cpu")
    for g, w in zip(_leaves(caches), _leaves(want)):
        assert g.shape == w.shape and g.shape[0] == 3
        _close(g, w)
    jcaches, caches = jservice._pad_cache_batch(jcaches, 3, 4), service._pad_cache_batch(caches, 3, 4)
    jstep, step = jax.jit(jax_make_decode_step(jmodel)), tep._decode_exec(tentry, 4)
    for i in range(3):
        token = np.zeros((4, 1), np.int32)
        token[:3, 0] = np.asarray(jnp.argmax(jlogits[:3, -1], axis=-1))
        assert np.array_equal(logits[:3, -1].argmax(-1).numpy(), token[:3, 0])
        with jdb.activate():
            jlogits, jcaches = jstep(jentry.params, jnp.asarray(token), jcaches, jnp.int32(SEQ + i))
        logits, caches = step(torch.tensor(token), caches, SEQ + i, tentry.params)
        _close(logits[:3], jlogits[:3])


def test_registered_versions_serve_their_own_parameters(lm):
    """A second version with its own ``out_embed`` (the hot swap of the
    reference: the same module, other parameters): each tenant's
    completions equal its version solo-served through ``Model.prefill`` /
    ``decode_step`` with that version's params, and the versions differ."""
    _, _, _, model = lm
    own = {k: p.detach() for k, p in model.named_parameters()}
    g = torch.Generator().manual_seed(5)
    v2 = dict(own, out_embed=own["out_embed"] + torch.randn(own["out_embed"].shape, generator=g))
    db = repro_torch.Database(device="cpu")
    db.register_model("lm", model, own)
    db.register_model("lm", model, v2)
    ep = db.endpoint(cache_len=CACHE_LEN, buckets=BUCKETS, tenants={"a": "lm@v1", "b": "lm@v2"})
    prompts = _lm_prompts(2, model.cfg.vocab, seed=2)

    async def go():
        return await asyncio.gather(*[ep.submit(p, tenant=t, max_new_tokens=3)
                                      for t in ("a", "b") for p in prompts])

    outs = asyncio.run(go())
    assert [o.model for o in outs] == ["lm@v1"] * 2 + ["lm@v2"] * 2
    assert db.counters()["serve"]["batches"] == 2
    for params, version_outs in ((own, outs[:2]), (v2, outs[2:])):
        prefill = make_prefill_step(model, CACHE_LEN, db=db)
        decode = make_decode_step(model, db=db)
        for out, p in zip(version_outs, prompts):
            logits, caches = prefill({"tokens": torch.tensor(p)[None]}, params)
            solo = [int(logits[0, -1].argmax())]
            for step in range(2):
                logits, caches = decode(torch.tensor([[solo[-1]]], dtype=torch.int32), caches,
                                        SEQ + step, params)
                solo.append(int(logits[0, -1].argmax()))
            assert out.token_ids.tolist() == solo
    assert [o.token_ids.tolist() for o in outs[:2]] != [o.token_ids.tolist() for o in outs[2:]]


def test_step_params_serve_the_modules_bits(lm):
    """``Model.prefill`` / ``decode_step`` on the params a registered
    version carries, the module's own tensors by name, equal the module's
    own call bit for bit."""
    _, _, _, model = lm
    tree = repro_torch.Database(device="cpu").register_model(
        "lm", model, {k: p.detach() for k, p in model.named_parameters()}).params
    tokens = torch.tensor(np.stack(_lm_prompts(2, model.cfg.vocab, seed=3)))
    with repro_torch.Database(device="cpu").activate(), torch.inference_mode():
        want, wc = model.prefill({"tokens": tokens}, CACHE_LEN)
        got, gc = model.prefill({"tokens": tokens}, CACHE_LEN, params=tree)
        assert torch.equal(got, want)
        token = want[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        want, _ = model.decode_step(token, wc, SEQ)
        got, _ = model.decode_step(token, gc, SEQ, params=tree)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# MoE capacity under batching
# ---------------------------------------------------------------------------


def _dyadic(g, *shape):
    """Small multiples of 1/8: every product and sum of a few hundred of
    them is exact in f32, so a result cannot depend on the order a BLAS
    sums in, only on which terms it sums."""
    return torch.randint(-8, 9, shape, generator=g).float() / 8


@pytest.mark.parametrize("tokens", [16, 1])
def test_padded_batch_keeps_the_real_rows_moe_bits(tokens):
    """Capacity groups are batch rows, as the reference's are: the rows
    that pad a bucket cannot take a real row's expert capacity, so the
    MoE's dispatch (routing, slots, gates, kept flags, expert buffers) and
    its combine give the real rows the bits they get unpadded — at a
    prefill's 16 tokens and a decode step's 1. Inputs are exact in f32
    (``_dyadic``); the expert products between the two halves are row
    local and left out. Planted fault: capacity taken over the whole batch
    (one group) moves real rows' kept assignments."""
    cfg = get_config("olmoe-1b-7b").reduced()
    g = torch.Generator().manual_seed(tokens)
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * tokens * k / e), k)
    # feature 0 is 1 for every token and draws it to expert 0, so that
    # expert 0 overflows and capacity decides what is kept
    x = _dyadic(g, 3, tokens, d)
    x[..., 0] = 1.0
    router = _dyadic(g, d, e)
    router[0, 0] = 4.0
    padded = torch.cat([x, _dyadic(g, 1, tokens, d) * 4])
    with repro_torch.Database(device="cpu").activate():
        xe, meta, aux = ffn._dispatch_group(x, router, top_k=k, capacity=cap, e=e)
        pxe, pmeta, paux = ffn._dispatch_group(padded, router, top_k=k, capacity=cap, e=e)
        assert torch.equal(pxe[:3], xe) and torch.equal(paux[:3], aux)
        for a, b in zip(pmeta, meta):
            assert torch.equal(a[:3], b)
        ye = _dyadic(g, 3, e * cap, d)
        pye = torch.cat([ye, _dyadic(g, 1, e * cap, d)])
        out = ffn._combine_group(ye, meta, t=tokens, dtype=torch.float32)
        pout = ffn._combine_group(pye, pmeta, t=tokens, dtype=torch.float32)
        assert torch.equal(pout[:3], out)
        if tokens > 1:
            assert not bool(meta[3].all()), "capacity dropped nothing: the check is idle"
            # one group over the batch: its capacity grows with the padding
            one = max(int(cfg.capacity_factor * 3 * tokens * k / e), k)
            pone = max(int(cfg.capacity_factor * 4 * tokens * k / e), k)
            _, (_, st, _, keep), _ = ffn._dispatch_group(x.reshape(1, -1, d), router, top_k=k,
                                                         capacity=one, e=e)
            _, (_, pst, _, pkeep), _ = ffn._dispatch_group(padded.reshape(1, -1, d), router,
                                                           top_k=k, capacity=pone, e=e)
            kept = sorted(st[keep].tolist())
            pkept = sorted(t for t in pst[pkeep].tolist() if t < 3 * tokens)
            assert kept != pkept, "the planted fault went unseen"


# ---------------------------------------------------------------------------
# the device the front door runs on
# ---------------------------------------------------------------------------


def test_serving_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Database()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BucketedPrefill(_TinyLM(), cache_len=8)
    # a CPU session's endpoint serves on the CPU: its prompts go to the
    # session's device
    seen = []

    class _Seen(_TinyLM):
        def prefill(self, batch, cache_len, params=None):
            seen.append(batch["tokens"].device)
            return super().prefill(batch, cache_len, params)

    db = repro_torch.Database(device="cpu")
    db.register_model("lm", _Seen(), torch.tensor(3.0))
    asyncio.run(db.endpoint("lm", cache_len=16, buckets=[(1, 8)]).submit(_prompts(1)[0],
                                                                         max_new_tokens=1))
    assert seen == [torch.device("cpu")]


def test_the_endpoint_serves_an_encoder_model():
    """whisper reduced (2 encoder + 2 decoder layers) through the endpoint:
    ``make_batch`` adds the frames, warmup takes them from ``batch_fn`` (and
    without it names what the model reads), and a request's completion is
    its solo run: prefill, the encoder's output, decode steps against it."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import make_decode_step, make_encode_step, make_prefill_step

    cfg = get_config("whisper-small").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    frames = torch.randn(1, cfg.enc_seq, cfg.d_model, generator=torch.Generator().manual_seed(1))

    def make_batch(tokens):
        return {"tokens": tokens, "frames": frames.expand(tokens.shape[0], -1, -1)}

    db = repro_torch.Database(device="cpu")
    db.register_model("enc", model, {k: p.detach() for k, p in model.named_parameters()})
    ep = db.endpoint("enc", cache_len=12, buckets=[(1, 8)], make_batch=make_batch)
    with pytest.raises(ValueError, match="frames"):
        ep.warmup()
    ep.warmup(batch_fn=lambda b, s: make_batch(torch.zeros((b, s), dtype=torch.int32)))
    prompt = _prompts(1, seed=3)[0]
    out = asyncio.run(ep.submit(prompt, max_new_tokens=4))
    logits, caches = make_prefill_step(model, 12, db=db)(make_batch(torch.tensor(prompt)[None]))
    enc = make_encode_step(model, db=db)(frames)
    want = [int(logits[0, -1].argmax())]
    for i in range(3):
        logits, caches = make_decode_step(model, db=db)(
            torch.tensor([[want[-1]]], dtype=torch.int32), caches, 8 + i, enc_out=enc)
        want.append(int(logits[0, -1].argmax()))
    assert out.token_ids.tolist() == want


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b", "deepseek-v3-671b",
                                  "whisper-small", "qwen2-vl-72b"])
def test_serve_batched_example_on_the_cpu(arch, capsys):
    from repro_torch.examples import serve_batched

    outs = serve_batched.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                               "--prompt-len", "8", "--gen", "4"])
    assert [len(o.token_ids) for o in outs] == [4, 3, 2]
    assert "ok." in capsys.readouterr().out
