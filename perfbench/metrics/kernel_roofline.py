"""kernel_roofline: the step's least device time (its relational
operations' operations at the f32-input peak, or their bytes at the
memory rate: ``perfbench/counts``) over the device time a step in which
any kernel runs (the union over streams; copies left out), in %."""

from perfbench import timeline as tl


def read(t):
    busy = tl.total(t.busy(t.kernels))
    least = t.counts.get("device_s")
    if not busy or not least or t.steps <= 0:
        return None
    return 100.0 * least / (busy / 1e9 / t.steps)
