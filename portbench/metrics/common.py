"""What the readers share.  ``ctx`` holds the window's steps (kind, host
start and end, traced or not, tokens, model FLOPs and the kernels' bounds
in seconds), the egressed requests, the window's seconds, the profiler's
stretch (busy and window seconds, seconds by kernel name, host seconds) and
the family's kernels ({bound key: name needle})."""
from __future__ import annotations

import numpy as np

from portbench.counts import PEAKS


def host_ms(ctx: dict, kind: str):
    """Mean host milliseconds of the untraced steps of ``kind``."""
    t = [s["t1"] - s["t0"] for s in ctx["steps"] if s["kind"] == kind and not s["traced"]]
    return float(np.mean(t)) * 1e3 if t else None


def mfu(ctx: dict):
    """Model FLOPs of the untraced steps over the window outside the
    stretch, as a share of the bf16 peak, in %."""
    flops = sum(s["flops"] for s in ctx["steps"] if not s["traced"])
    seconds = ctx["window_s"] - (ctx["trace"]["host_s"] if ctx["trace"] else 0.0)
    return 100.0 * flops / seconds / PEAKS["bf16_flops_per_s"] if flops else None


def idle_share(ctx: dict):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr and tr["window_s"] else None


def roofline(ctx: dict, bound_key: str):
    """Bound seconds ``bound_key`` of the traced steps over the profiler's
    seconds of the kernels whose name holds the family's needle for it
    (``ctx["kernels"]``), in %; None where the family names no such kernel,
    or where either is nil."""
    tr, needle = ctx["trace"], ctx.get("kernels", {}).get(bound_key)
    if needle is None:
        return None
    spent = sum(v for k, v in tr["kernels"].items() if needle in k) if tr else 0.0
    bound = sum(s.get(bound_key, 0.0) for s in ctx["steps"] if s["traced"])
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
