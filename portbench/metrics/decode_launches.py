"""Kernel, copy and memset launch calls a decode step: the profiler's
runtime calls made inside the program's engine.decode spans of the profiled
stretch, over their number."""
from portbench.metrics import program


def read(ctx):
    return program.per_span(ctx, "engine.decode", "launches", "engine.decode")
