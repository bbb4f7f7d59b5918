"""K4's share of its roofline over the stretch's prefills: their bound from shapes over the profiler's time of K4's kernel, in %."""
from portbench.metrics import common


def read(ctx):
    return common.roofline(ctx, "k4_bound_s")
