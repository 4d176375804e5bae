"""merge_idle_ms: device time a step in which no kernel and no copy runs
(the gaps in the union over every stream, inside the traced window) while
the host is inside one of the program's ``repro.wave.merge`` spans."""

from perfbench import program_spans
from perfbench import timeline as tl


def read(t):
    merge = tl.clip(program_spans.intervals(t, program_spans.MERGE), *t.window)
    if not merge or not (t.kernels or t.copies) or t.steps <= 0:
        return None
    idle = tl.gaps(t.device_busy(), *t.window)
    return tl.total(tl.subtract(idle, tl.subtract(idle, merge))) / t.steps / 1e6
