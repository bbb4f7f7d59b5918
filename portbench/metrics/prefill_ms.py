"""Host ms of a prefill (engine.step through transformer.prefill, ending in the first token on the host), over the untraced steps."""
from portbench.metrics import common


def read(ctx):
    return common.host_ms(ctx, "prefill")
