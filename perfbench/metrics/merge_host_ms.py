"""merge_host_ms: the host's own time a step in the program's
``repro.wave.merge`` spans, folding a streamed step's waves into its result
(the host's concatenation of the waves' gradient rows among it), less the
CUDA runtime's calls (the blocking device-to-host copies among them) and
the other program spans inside them."""

from perfbench import program_spans


def read(t):
    return program_spans.self_host_ms(t, program_spans.MERGE)
