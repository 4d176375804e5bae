"""host_ms: the host's own time a step inside the benchmark's spans around
its calls into the program (``port:*``): Python, PyTorch's dispatch and the
program's code, with every CUDA runtime or driver call of any thread (such
as autograd's backward thread) taken out. A call that waits for the device
(a synchronise, a blocking copy) is taken out, and so is every enqueuing
call, since the host also waits inside those once the device's launch
queue is full (CUPTI's "Command Buffer Full")."""

from perfbench import timeline as tl


def read(t):
    calls = tl.union((e.start, e.end) for e in t.spans(tl.CALL_PREFIX))
    if not calls or t.steps <= 0:
        return None
    return tl.total(tl.subtract(calls, t.in_runtime())) / t.steps / 1e6
