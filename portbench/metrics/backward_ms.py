"""Device ms a training step of the backward, the checkpoints' recompute
included: the profiler's time of the kernels, copies and memsets launched
inside the program's train.backward spans of the profiled stretch, over its
train.step spans."""
from portbench.metrics import program


def read(ctx):
    ms = program.per_span(ctx, "train.backward", "device_s", "train.step")
    return None if ms is None else ms * 1e3
