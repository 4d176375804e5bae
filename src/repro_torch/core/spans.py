"""Named spans at the boundaries of a step, for the profiler's record.

Three spans split the host's part of a step:

    repro.plan        finding the step's executable: the engine lookup,
                      the wave plan, statistics, the lowering and planner
                      caches (``Database``, ``StreamedCompiled``)
    repro.walk        running a ``Compiled`` on real tensors: the FRA walk,
                      PyTorch's dispatch, the kernel wrappers and launches
    repro.wave.merge  folding a streamed step's waves back into its result:
                      each wave's rows copied to the host, the device-side
                      sums, and the final concatenation on the host

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
records, and a shared no-op context otherwise. There is no switch of its
own: the spans exist exactly while a profiler records, and show beside the
device's kernels and copies on one clock (``torch.profiler.profile``, its
Chrome trace).

The guard reads ``torch._C._autograd._profiler_enabled()`` (≈ 75 ns),
which is true whichever way the profiler was started, through
``torch.profiler.profile`` or through ``torch._C._autograd``'s calls
directly; ``torch.autograd.profiler._is_profiler_enabled`` is set only by
the former. An unguarded ``record_function`` costs some microseconds a
call even with no profiler on. The spans are ``record_function``'s
because a profiler that keeps only user-scope callbacks (the host's
operators off) keeps those and drops ``_RecordFunctionFast``'s.

A span opened on autograd's backward thread is recorded: the autograd
engine carries the profiler's thread-local state onto its threads. A
plain Python thread does not inherit it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

PLAN = "repro.plan"
WALK = "repro.walk"
MERGE = "repro.wave.merge"

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a no-op."""
    return record_function(name) if _recording() else _OFF
