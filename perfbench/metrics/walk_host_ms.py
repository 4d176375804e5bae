"""walk_host_ms: the host's own time a step in the program's ``repro.walk``
spans, running a compiled step on real tensors (the FRA walk, PyTorch's
dispatch, the kernel wrappers), less the CUDA runtime's calls (the
launches among them) and the other program spans inside them."""

from perfbench import program_spans


def read(t):
    return program_spans.self_host_ms(t, program_spans.WALK)
