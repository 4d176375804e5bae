"""The readers of the program's own spans and of the bytes it merges back
to the host: on a trace made by hand, and on a traced run of each cell
at its tiny size on the CPU (which records no device events)."""

import pytest
import torch

from perfbench import harness, program_spans as ps, timeline as tl
from perfbench.tests import tiny

E = tl.Event
SPAN_READERS = ("plan_host_ms", "walk_host_ms", "merge_host_ms", "merge_idle_ms", "d2h_gib")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _trace():
    # a window of 100 ns and 2 steps: a call into the program 0-90 holds a
    # plan 0-10, walks 10-40 (a launch 20-23 in it) and 60-70 on another
    # thread (autograd's), and merges 40-60 and 75-95 with a plan nested
    # at 80-85 and a blocking copy 45-50; kernels 10-30 and 60-70, a copy
    # 45-55: the device idles 0-10, 30-45, 55-60, 70-100
    return tl.Trace(
        steps=2, window=(0, 100),
        kernels=[E("k1", 10, 30, 7), E("k2", 60, 70, 7)],
        copies=[E("Memcpy DtoH (Device -> Pageable)", 45, 55, 7)],
        host=[E(tl.WINDOW_SPAN, 0, 100), E("port:step", 0, 90, 1),
              E(ps.PLAN, 0, 10, 1), E(ps.WALK, 10, 40, 1), E("cudaLaunchKernel", 20, 23, 1),
              E(ps.WALK, 60, 70, 2), E(ps.MERGE, 40, 60, 1), E("cudaMemcpyAsync", 45, 50, 1),
              E(ps.MERGE, 75, 95, 1), E(ps.PLAN, 80, 85, 1)],
        before={"spill": {"merged_bytes": 0}}, after={"spill": {"merged_bytes": 3 * 2 ** 30}},
        counts={})


def _read(name, t):
    return harness.metric_reader(tiny.ROOT, name)(t)


def test_span_readers_by_hand():
    t = _trace()
    assert _read("plan_host_ms", t) == pytest.approx((10 + 5) / 2 / 1e6)
    assert _read("walk_host_ms", t) == pytest.approx((30 - 3 + 10) / 2 / 1e6)
    # 40-60 less the copy's call, 75-95 less the nested plan
    assert _read("merge_host_ms", t) == pytest.approx((15 + 15) / 2 / 1e6)
    # the idle 30-45 meets 40-60 at 40-45, 55-60 inside it; 70-100 meets 75-95
    assert _read("merge_idle_ms", t) == pytest.approx((5 + 5 + 20) / 2 / 1e6)
    assert _read("d2h_gib", t) == pytest.approx(1.5)


def test_span_readers_find_nothing_where_the_program_opened_none():
    # a parent without the spans and counters, and a run with nothing at all
    t = _trace()
    t.host = [e for e in t.host if not e.name.startswith(ps.PREFIX)]
    t.before = t.after = {"spill": {"fetched_bytes": 0}}
    empty = tl.Trace(steps=1, window=(0, 10), kernels=[], copies=[], host=[], before={}, after={},
                     counts={})
    for name in SPAN_READERS:
        assert _read(name, t) is None and _read(name, empty) is None, name


@pytest.mark.parametrize("name", tiny.CELLS)
def test_traced_run_reads_the_program_spans(name):
    cell = tiny.cell(name)
    r = harness.run_cell(cell, tiny.SEED + 2, 0.2, True, device="cpu")
    assert r["correct"], r["compared"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    want = {m["name"] for m in cell.per_layer} & set(SPAN_READERS)
    # on the CPU no device event exists: merge_idle_ms finds nothing to read
    assert set(got) & set(SPAN_READERS) == want - {"merge_idle_ms"}
    for m in want - {"merge_idle_ms", "d2h_gib"}:
        assert 0 < got[m] < float("inf"), m
    # the program's spans lie inside the benchmark's calls into it
    parts = got["plan_host_ms"] + got["walk_host_ms"] + got.get("merge_host_ms", 0.0)
    assert parts <= got["host_ms"] * 1.02
    if name == "gcn-products.waves8":
        c = cell.config
        assert got["d2h_gib"] == pytest.approx((c["edges"] + c["nodes"]) * 12 / 2 ** 30)
        assert got["d2h_gib"] == pytest.approx(got["h2d_gib"])
        assert parts >= 0.9 * got["host_ms"]
