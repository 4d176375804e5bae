"""The interval arithmetic and the per-layer readers, on a trace made by
hand (the CPU records no device events)."""

import pytest

from perfbench import harness, timeline as tl
from perfbench.tests import tiny

E = tl.Event


def test_intervals():
    assert tl.union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) == [(0, 3), (5, 8)]
    assert tl.subtract([(0, 10)], [(2, 3), (5, 12)]) == [(0, 2), (3, 5)]
    assert tl.subtract([(0, 4), (6, 9)], [(3, 7)]) == [(0, 3), (7, 9)]
    assert tl.gaps([(2, 3)], 0, 5) == [(0, 2), (3, 5)]
    assert tl.clip([(0, 4), (6, 9)], 2, 7) == [(2, 4), (6, 7)]
    assert tl.total([(0, 2), (5, 8)]) == 5


def _trace():
    # a window of 100 ns and 2 steps: kernels on two streams 10-40 and
    # 30-50, a copy 45-70 (20 ns with no kernel), idle 0-10, 70-100; the
    # calls into the program 0-60 and 60-90 on the host, 27 ns of them in
    # CUDA runtime calls (a launch, a synchronise, a wait for the full
    # launch queue, and a copy on another thread)
    return tl.Trace(
        steps=2, window=(0, 100),
        kernels=[E("k1", 10, 40, 7), E("k2", 30, 50, 8)],
        copies=[E("Memcpy DtoH (Device -> Pageable)", 45, 70, 9)],
        host=[E(tl.WINDOW_SPAN, 0, 100), E("port:forward", 0, 60, 1), E("port:backward", 60, 90, 1),
              E("cudaLaunchKernel", 20, 23, 1), E("cudaStreamSynchronize", 50, 60, 1),
              E("Command Buffer Full", 62, 66, 1), E("cudaMemcpyAsync", 80, 90, 2), E("aten::cat", 72, 98, 1)],
        before={"spill": {"fetched_bytes": 0}}, after={"spill": {"fetched_bytes": 3 * 2 ** 30}},
        counts={"device_s": 10e-9, "chip_s": 20e-9})


def _read(name):
    return harness.metric_reader(tiny.ROOT, name)(_trace())


def test_readers_by_hand():
    assert _read("device_idle_share") == pytest.approx(40.0)  # busy 10-70 of 100
    assert _read("copy_exposed_ms") == pytest.approx(20 / 2 / 1e6)
    assert _read("kernel_roofline") == pytest.approx(100 * 10 / (40 / 2))  # union 10-50
    assert _read("host_ms") == pytest.approx((90 - 27) / 2 / 1e6)
    assert _read("h2d_gib") == pytest.approx(1.5)
    assert _read("step_mfu") == pytest.approx(100 * 20 / 50)  # 100 ns over 2 steps


def test_breakdown_names_gaps_by_the_host():
    b = tl.breakdown(_trace())
    assert b["device_ops"][0] == ["k1", 30e-9]
    names = dict((k, v) for k, v in b["idle_gaps"])
    # 70-100: its middle, 85, lies in aten::cat and, innermost, in cudaMemcpyAsync
    assert names["cudaMemcpyAsync"] == pytest.approx(30e-9)
    assert names["port:forward"] == pytest.approx(10e-9)   # 0-10


def test_readers_find_nothing_where_nothing_ran():
    empty = tl.Trace(steps=1, window=(0, 10), kernels=[], copies=[], host=[], before={}, after={},
                     counts={})
    for m in ("device_idle_share", "copy_exposed_ms", "kernel_roofline", "host_ms", "h2d_gib", "step_mfu"):
        assert harness.metric_reader(tiny.ROOT, m)(empty) is None
