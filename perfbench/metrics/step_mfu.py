"""step_mfu: the step's least time on the chip (the least device time, or
its host-link bytes at the link's published rate, whichever is longer)
over the traced step: the length of the traced window in the profiler's
trace (its ``perfbench.window`` span, which closes after a synchronise, so
once the device has ended its last operation) over its steps, idle gaps
and the host's own stretches included, in %."""


def read(t):
    least = t.counts.get("chip_s")
    if not least or t.window_s <= 0 or t.steps <= 0:
        return None
    return 100.0 * least / (t.window_s / t.steps)
