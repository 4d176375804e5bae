"""The program's own spans in a traced run (``repro_torch.core.spans``):
``repro.plan``, ``repro.walk`` and ``repro.wave.merge``, which the
program opens only while a profiler records. A parent without them
records none, and every reader of them then finds nothing."""

from perfbench import timeline as tl

PREFIX = "repro."
PLAN = "repro.plan"
WALK = "repro.walk"
MERGE = "repro.wave.merge"


def intervals(t, name: str):
    """The merged intervals of the spans called ``name`` (any thread)."""
    return tl.union((e.start, e.end) for e in t.host if e.name == name)


def self_host_ms(t, name: str):
    """Host ms a step inside the spans called ``name``, less every CUDA
    runtime or driver call (``Trace.in_runtime``) and every other program
    span nested in one of them on its thread (their self time); None where
    the trace holds none."""
    own = [e for e in t.host if e.name == name]
    if not own or t.steps <= 0:
        return None
    nested = [(o.start, o.end) for o in t.host
              if o.name.startswith(PREFIX) and o.name != name
              and any(e.thread == o.thread and e.start <= o.start and o.end <= e.end for e in own)]
    kept = tl.subtract(intervals(t, name), tl.union(nested))
    return tl.total(tl.subtract(kept, t.in_runtime())) / t.steps / 1e6
