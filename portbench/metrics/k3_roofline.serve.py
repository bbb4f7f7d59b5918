"""K3's share of its roofline over the stretch's prefills and decode steps: their bound from shapes over the profiler's time of K3's kernel, in %."""
from portbench.metrics import common


def read(ctx):
    return common.roofline(ctx, "k3_bound_s")
