"""plan_host_ms: the host's own time a step in the program's ``repro.plan``
spans, finding each call's executable (the engine lookup, the wave plan,
statistics, the lowering and planner caches), less the CUDA runtime's
calls and the other program spans inside them."""

from perfbench import program_spans


def read(t):
    return program_spans.self_host_ms(t, program_spans.PLAN)
