"""Share of the profiled stretch of a training window in which no operation ran on the card, in %."""
from portbench.metrics import common


def read(ctx):
    return common.idle_share(ctx)
