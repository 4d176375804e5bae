"""The port's spans (``repro_torch.core.spans``) and the counter beside
them: ``repro.plan``, ``repro.walk`` and ``repro.wave.merge`` recorded by
a profiler started through ``torch._C._autograd`` with the host's
operators off (user-scope callbacks only), nothing entered with the
profiler off, the bytes a streamed step merges back to the host, and no
lowering or plan built again once a training step has run."""

import contextlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import engine, fra, spans
from repro_torch.core.engine import StreamedCompiled
from repro_torch.core.kernels import ADD, MUL, SQUARE, SUM_CHUNK, scale_kernel
from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj
from repro_torch.relational import gcn_conv, partitioned_edges, rel_linear

NAMES = (spans.PLAN, spans.WALK, spans.MERGE)


def loss_query(n):
    """mean over nodes of sum_d conv^2, conv = sum_dst w * Node[src]."""
    conv = fra.Agg(identity_key(1), ADD, fra.Join(eq_pred((0, 0)), jproj(L(1)), MUL,
                                                  fra.scan("Edge", 2), fra.scan("Node", 1)))
    sq = fra.Select(TRUE, identity_key(1), SQUARE, conv)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Select(TRUE, identity_key(1), SUM_CHUNK, sq))
    return fra.Query(fra.Select(TRUE, identity_key(0), scale_kernel(1.0 / n), loss),
                     inputs=("Edge", "Node"))


def streamed_db(n=50, e=400, d=6, waves=4, seed=0):
    """A session whose budget holds Node and a ``waves``-th of Edge."""
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    edge = partitioned_edges(keys, rng.normal(size=e).astype(np.float32), n, 1)
    budget = n * d * 4 + edge.nnz * 12 / waves
    db = repro_torch.Database(device="cpu", memory_budget=budget)
    db.put("Edge", edge)
    db.put("Node", torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32)), keys=("node",))
    return db, db.query(loss_query(n)), edge.nnz


@contextlib.contextmanager
def profiled(cuda: bool):
    """The profiler over the block, the host's operators off; the list it
    yields holds its events once the block has ended."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import ProfilerActivity, RecordScope

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    config = torch.autograd.profiler.profile().config()
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    events = []
    try:
        yield events
    finally:
        events.extend(_disable_profiler().events())


def recorded(events):
    """(name, start, end, thread) of the program's spans, in start order."""
    out = []
    for ev in events:
        if ev.name() in NAMES and not str(ev.device_type()).endswith("CUDA"):
            start = int(ev.start_ns())
            out.append((ev.name(), start, start + int(ev.duration_ns()), int(ev.start_thread_id())))
    return sorted(out, key=lambda s: s[1])


def test_a_streamed_step_records_plan_walk_and_merge_spans():
    db, h, _ = streamed_db(waves=4)
    h.step(wrt=("Edge", "Node"))  # builds and spills; the recorded step finds both cached
    with profiled(False) as events:
        h.step(wrt=("Edge", "Node"))
    got = recorded(events)
    assert isinstance(h.last, StreamedCompiled)
    waves = h.last.num_waves
    assert waves == 4
    names = [s[0] for s in got]
    # the handle's lookup, the full shapes' lowering, one compile a wave
    assert names.count(spans.PLAN) == 2 + waves
    assert names.count(spans.WALK) == waves
    # one fold a wave, then the concatenation
    assert names.count(spans.MERGE) == waves + 1
    assert names[-1] == spans.MERGE
    # advancing to the next wave runs its walk outside every merge span
    merges = [(s, e) for n, s, e, _ in got if n == spans.MERGE]
    for n, s, e, _ in got:
        if n != spans.MERGE:
            assert all(e <= ms or s >= me for ms, me in merges), n


def test_the_profiler_off_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(spans, "record_function", lambda name: entered.append(name))
    assert spans.span(spans.PLAN) is spans.span(spans.MERGE) is spans._OFF
    db, h, _ = streamed_db(waves=4)
    for _ in range(2):
        h.step(wrt=("Edge", "Node"))
    assert entered == []


@pytest.mark.parametrize("steps", [1, 3])
def test_merged_bytes_are_the_live_rows_of_both_dedge_leaves(steps):
    db, h, nnz = streamed_db(waves=4)
    for _ in range(steps):
        _, grads = h.step(wrt=("Edge", "Node"))
    spill = db.counters()["spill"]
    dedge = grads["Edge"]
    live = dedge.keys.numel() * dedge.keys.element_size() + dedge.values.numel() * dedge.values.element_size()
    assert dedge.keys.shape[0] == nnz and live == nnz * 12
    # keys and values of each wave's rows, pad rows dropped, every step
    assert spill["merged_bytes"] == steps * live
    # what comes back is what went out: the Edge stream's bytes, two
    # thirds of them the keys the store holds already, in the same order
    assert spill["merged_bytes"] == spill["fetched_bytes"]
    assert torch.equal(dedge.keys, db.get("Edge").keys)


def _train_step(db, x, keys, w, params, y):
    with db.activate():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        h1 = gcn_conv(torch.relu(rel_linear(gcn_conv(x, keys, w), p["w1"])), keys, w)
        z = rel_linear(h1, p["w2"])
        loss = -torch.log_softmax(z, dim=1).gather(1, y[:, None]).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
    return {k: v - 0.1 * g for (k, v), g in zip(params.items(), grads)}


def _train_inputs(n=41, e=233, f=7, hid=13, c=3, seed=4):
    # sizes no other test uses: the engines' caches are the process's
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, n, (e, 2), generator=g, dtype=torch.int32)
    w = torch.rand(e, generator=g)
    x = torch.randn(n, f, generator=g)
    y = torch.randint(0, c, (n,), generator=g)
    params = {"w1": torch.randn(f, hid, generator=g), "w2": torch.randn(hid, c, generator=g)}
    return x, keys, w, params, y


def built():
    """The lowering walks (``RAEngine.lower_count``) and the executables
    the planner made (``Lowered.compile``'s cache) of every engine."""
    engines = list(engine._ENGINES.values())
    return (sum(e.lower_count for e in engines),
            sum(len(low._compiled) for e in engines for low in e._lowered.values()))


def test_a_training_step_builds_nothing_after_its_first():
    db = repro_torch.Database(device="cpu")
    x, keys, w, params, y = _train_inputs()
    before = built()
    params = _train_step(db, x, keys, w, params, y)
    first = built()
    assert first[0] > before[0] and first[1] > before[1]
    for _ in range(2):
        params = _train_step(db, x, keys, w, params, y)
        assert built() == first
    # the engines' caches are the process's: a second session builds nothing
    _train_step(repro_torch.Database(device="cpu"), x, keys, w, params, y)
    assert built() == first


def test_every_execute_of_a_training_step_is_one_walk_and_one_plan():
    db = repro_torch.Database(device="cpu")
    x, keys, w, params, y = _train_inputs(n=43, e=251)
    params = _train_step(db, x, keys, w, params, y)
    with profiled(False) as events:
        _train_step(db, x, keys, w, params, y)
    names = [s[0] for s in recorded(events)]
    # four executes in the forward (two convolutions, two products) and
    # four in the backward (dNode of the second convolution, dW of both
    # products, dX of the second)
    assert names.count(spans.WALK) == names.count(spans.PLAN) == 8
    assert spans.MERGE not in names


@pytest.mark.cuda
def test_the_backward_walks_are_recorded_on_autograds_thread():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: autograd's backward thread exists only for device graphs")
    dev = torch.device("cuda")
    db = repro_torch.Database(device=dev)
    x, keys, w, params, y = (t.to(dev) if torch.is_tensor(t) else {k: v.to(dev) for k, v in t.items()}
                             for t in _train_inputs())
    params = _train_step(db, x, keys, w, params, y)
    torch.cuda.synchronize()
    with profiled(True) as events:
        _train_step(db, x, keys, w, params, y)
        torch.cuda.synchronize()
    got = recorded(events)
    main = next(t for n, _, _, t in got if n == spans.PLAN)
    walks = [t for n, _, _, t in got if n == spans.WALK]
    assert len(walks) == 8
    assert sum(t != main for t in walks) == 4
