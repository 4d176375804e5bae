"""device_idle_share: the share of the traced window in which no kernel and
no copy runs on the device (the union over every stream), in %."""

from perfbench import timeline as tl


def read(t):
    if t.window_s <= 0 or not (t.kernels or t.copies):
        return None
    return 100.0 * (1.0 - tl.total(t.device_busy()) / 1e9 / t.window_s)
