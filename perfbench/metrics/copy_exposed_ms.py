"""copy_exposed_ms: device time a step in which a host<->device copy runs and
no kernel does (the union of the copies' intervals less the union of the
kernels', over every stream)."""

from perfbench import timeline as tl


def read(t):
    copies = t.busy(e for e in t.copies if "HtoD" in e.name or "DtoH" in e.name)
    if not copies or t.steps <= 0:
        return None
    return tl.total(tl.subtract(copies, t.busy(t.kernels))) / t.steps / 1e6
