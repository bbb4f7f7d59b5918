"""Host ms of a decode step (engine.step through decode_step, ending in the copy of the tokens to the host), over the untraced steps."""
from portbench.metrics import common


def read(ctx):
    return common.host_ms(ctx, "decode")
