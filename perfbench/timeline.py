"""What a traced run recorded, and the interval arithmetic its readers use.

A traced run keeps, from the profiler's record of its traced steps: the
device's operations (kernels, and copies and fills, each with its start,
end and name), the host's events (the benchmark's own spans around its
calls into the program and the CUDA runtime calls, each with its thread;
in the record that names idle gaps, every operator of the program and of
PyTorch too), the traced window's bounds, the program's counters before
and after, and the cell's operation and byte counts. Readers
(``perfbench/metrics/<name>.py``) take their metric from a ``Trace``; the
full profiler trace is not written anywhere.

The steps that the readers measure are recorded with the profiler's
operator callbacks off (``profiled(ops=False)``): the device's activity
and the CUDA runtime calls come from CUPTI, and on the host only the
``record_function`` spans are kept, so the host runs at nearly its
untraced pace. Recording every operator costs the host some microseconds
an operator, which in a short step shows as idle device time; only the
few steps that ``breakdown`` names its idle gaps from pay that.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]  # (start_ns, end_ns)

#: the benchmark's span around the traced steps, and the prefix of its
#: spans around each call into the program
WINDOW_SPAN = "perfbench.window"
STEP_SPAN = "perfbench.step"
CALL_PREFIX = "port:"
#: CUDA runtime and driver calls (``cudaLaunchKernel``, ``cuLaunchKernel``),
#: and CUPTI's records of the host waiting for the device's queue or for
#: the profiler's buffers
_RUNTIME = re.compile(r"cu(da)?[A-Z]")
_CUPTI_WAITS = ("Command Buffer Full", "Activity Buffer Request")
#: device-timeline records that are no device work
_NOT_WORK = ("Context Sync", "Stream Sync", "Event Sync", "Stream Wait Event", "Device Sync")
#: idle gaps that ``breakdown`` names, the longest first
NAMED_GAPS = 200


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged: sorted, disjoint."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def total(merged: Sequence[Interval]) -> int:
    return sum(e - s for s, e in merged)


def clip(merged: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in merged if e > lo and s < hi]


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The parts of merged ``a`` that merged ``b`` does not cover."""
    out = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def gaps(merged: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi) that ``merged`` leaves uncovered."""
    return subtract([(lo, hi)], merged)


@dataclass
class Event:
    name: str
    start: int
    end: int
    thread: int = 0


@dataclass
class Trace:
    """One traced run's record (module docstring)."""

    steps: int
    window: Interval
    kernels: List[Event]
    copies: List[Event]
    host: List[Event]
    before: Dict[str, object]
    after: Dict[str, object]
    counts: Dict[str, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self, events: Iterable[Event]) -> List[Interval]:
        """The merged intervals of ``events`` inside the window."""
        return clip(union((e.start, e.end) for e in events), *self.window)

    def device_busy(self) -> List[Interval]:
        return self.busy(self.kernels + self.copies)


    def in_runtime(self) -> List[Interval]:
        """The merged intervals in which a host thread was inside a CUDA
        runtime or driver call, or waited in one of CUPTI's records."""
        return union((e.start, e.end) for e in self.host if is_runtime(e.name))

    def spans(self, prefix: str) -> List[Event]:
        return [e for e in self.host if e.name.startswith(prefix)]

    def counter_delta(self, *path: str) -> Optional[float]:
        """after - before of a counter at ``path`` (None where absent)."""
        a, b = self.after, self.before
        for k in path:
            if not isinstance(a, dict) or not isinstance(b, dict) or k not in a or k not in b:
                return None
            a, b = a[k], b[k]
        return float(a) - float(b)


def is_runtime(name: str) -> bool:
    return bool(_RUNTIME.match(name)) or name in _CUPTI_WAITS


def _kind(ev) -> str:
    """'device', 'host' or 'skip' for a profiler event."""
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", None)
    if str(ev.device_type()).endswith("CUDA"):
        if (annotation is not None and annotation()) or name.startswith(("perfbench.", CALL_PREFIX)):
            return "skip"
        if name.startswith(_NOT_WORK):
            return "skip"
        return "device"
    return "host"


@contextlib.contextmanager
def profiled(cuda: bool, ops: bool):
    """The profiler over the block; the list it yields holds its events once
    the block has ended. It records the device's activity (with ``cuda``),
    the CUDA runtime calls and the host's ``record_function`` spans, and,
    with ``ops``, every operator's host event too."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import ProfilerActivity, RecordScope
    from torch.autograd.profiler import profile

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    config = profile().config()
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, set() if ops else {RecordScope.USER_SCOPE})
    events: List[object] = []
    try:
        yield events
    finally:
        events.extend(_disable_profiler().events())


def from_events(events, steps: int, before, after, counts) -> Trace:
    """A ``Trace`` of ``profiled``'s events: its window is the benchmark's
    ``WINDOW_SPAN``."""
    kernels, copies, host = [], [], []
    window = None
    for ev in events:
        kind = _kind(ev)
        if kind == "skip":
            continue
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        name = ev.name()
        if kind == "device":
            (copies if name.startswith(("Memcpy", "Memset")) else kernels).append(
                Event(name, start, end, int(ev.device_resource_id())))
            continue
        if name == WINDOW_SPAN:
            window = (start, end)
        host.append(Event(name, start, end, int(ev.start_thread_id())))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    return Trace(steps, window, kernels, copies, host, before, after, counts)


def breakdown(t: Trace, named: Optional[Trace] = None, top: int = 10) -> Dict[str, List[List[object]]]:
    """The device operations that took most time in ``t``'s window, and the
    device's ``NAMED_GAPS`` longest idle gaps in ``named``'s (``t``'s where
    none is given) summed by what the host was doing in each (the innermost
    host event over the gap's middle), in seconds."""
    by_op: Dict[str, int] = {}
    for e in t.kernels + t.copies:
        s, f = max(e.start, t.window[0]), min(e.end, t.window[1])
        if f > s:
            by_op[e.name] = by_op.get(e.name, 0) + (f - s)
    named = t if named is None else named
    by_host: Dict[str, int] = {}
    longest = sorted(gaps(named.device_busy(), *named.window), key=lambda g: g[0] - g[1])[:NAMED_GAPS]
    for s, f in longest:
        mid = (s + f) // 2
        inner = [e for e in named.host if e.start <= mid < e.end and e.name != WINDOW_SPAN]
        name = min(inner, key=lambda e: e.end - e.start).name if inner else "(no host event)"
        by_host[name] = by_host.get(name, 0) + (f - s)

    def best(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": best(by_op), "idle_gaps": best(by_host)}
