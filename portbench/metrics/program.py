"""What the readers of the program's own spans share.  ``ctx["spans"]``
holds the records of the program's tracer over the window
(``repro_torch.trace.Record``: name, id, the index of the enclosing span,
start and end in ns, a sample's value, and whether the profiler was on);
``ctx["trace"]["program"]`` the profiled stretch by program span: its
ranges, and the launches and device seconds of what was launched inside
them (``portbench.spans.reduce``)."""
from __future__ import annotations

import numpy as np


def records(ctx: dict) -> list:
    return ctx.get("spans") or []


def p90(values: list):
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90)) if values else None


def per_span(ctx: dict, name: str, key: str, per: str):
    """``key`` (launches or device_s) summed over the stretch's ``name``
    spans, over the number of its ``per`` spans; None where either is
    absent, or where the stretch saw no device work."""
    tr = ctx.get("trace") or {}
    table = tr.get("program") or {}
    if not tr.get("busy_s") or name not in table or not table.get(per, {}).get("spans"):
        return None
    return table[name][key] / table[per]["spans"]
