"""Kernel, copy and memset launch calls a prefill: the profiler's runtime
calls made inside the program's engine.prefill spans of the profiled
stretch, over their number."""
from portbench.metrics import program


def read(ctx):
    return program.per_span(ctx, "engine.prefill", "launches", "engine.prefill")
