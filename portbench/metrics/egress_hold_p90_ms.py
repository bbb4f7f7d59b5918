"""90th percentile of the hold in the reorder ring, in ms: a request's
egress time less its submit time and the engine's own latency of it (the
moment it completed), over the requests egressed outside the stretch."""
import numpy as np


def read(ctx):
    held = [e["hold_s"] * 1e3 for e in ctx["egress"] if not e["traced"]]
    return float(np.percentile(held, 90)) if held else None
