"""Model FLOPs of the training steps (3 x forward, no recomputation) over the window outside the stretch, as a share of the bf16 peak, in %."""
from portbench.metrics import common


def read(ctx):
    return common.mfu(ctx)
