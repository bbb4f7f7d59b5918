"""Model FLOPs of the served tokens (prompts and decoded tokens) over the window outside the stretch, as a share of the bf16 peak, in %."""
from portbench.metrics import common


def read(ctx):
    return common.mfu(ctx)
