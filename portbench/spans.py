"""The profiler's stretch read with the program's own spans.

With the program's tracer on (``repro_torch.trace``), each of its spans in a
profiler session is a ``record_function`` range named ``repro_torch.<span>``.
Such a range shows twice in the trace, as the harness's own do: on the host,
and on the device's timeline (from the first to the last kernel launched
inside it on the thread that entered it).  ``reduce`` is ``trace.reduce`` of
the events less those device ranges (a program range is no device work:
neither busy time nor a kernel), with two additions:

- an idle gap is named ``<harness span>/<program span>`` by the innermost
  span of each that covers its midpoint (either alone where the other has
  none, ``untracked`` where neither has);
- each kernel, copy and memset is put down to the program spans open on the
  host when it was launched: the profiler gives the launch call (a runtime
  event, ``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``,
  ...) the kernel's correlation id, and the call's time finds the spans,
  whichever thread made it (a backward pass launches from its device
  thread).  ``program`` sums, for each span name, its ranges in the
  stretch, and the launches and device seconds of everything launched
  inside one (nested spans included); ``innermost`` sums them by the
  innermost span alone.

This module and ``spans_run.py`` go once the harness itself reads the
program's spans (``PERF.md``, Open questions).
"""
from __future__ import annotations

import torch

from .trace import PREFIX as HARNESS, _union
from .trace import reduce as harness_reduce  # before spans_run puts reduce() in its place

PROGRAM = "repro_torch."
CUDA = torch.autograd.DeviceType.CUDA


class Cover:
    """The spans ``(start, end, name)`` open at each of a rising sequence of times."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.i = 0
        self.open: list = []

    def at(self, t: float) -> list:
        """The spans covering ``t``, the innermost last; ``t`` never falls
        from one call to the next."""
        while self.i < len(self.spans) and self.spans[self.i][0] <= t:
            s = self.spans[self.i]
            self.i += 1
            while self.open and self.open[-1][1] < s[0]:
                self.open.pop()
            self.open.append(s)
        while self.open and self.open[-1][1] < t:
            self.open.pop()
        return [s for s in self.open if s[1] >= t]


def _add(table: dict, name: str, launches: int, seconds: float) -> None:
    row = table.setdefault(name, {"spans": 0, "launches": 0, "device_s": 0.0})
    row["launches"] += launches
    row["device_s"] += seconds


def reduce(events) -> dict:
    """``trace.reduce``'s busy and window seconds, seconds and calls by kernel
    name; idle seconds by harness and program span; and the program spans'
    launches and device seconds (``program``, ``innermost``)."""
    events = [ev for ev in events
              if not (ev.device_type == CUDA and ev.name.startswith(PROGRAM))]
    out = harness_reduce(events)
    device, harness, program, launches = [], [], [], []
    by_id: dict = {}  # correlation id -> device seconds of what it launched
    for ev in events:
        name, tr = ev.name, ev.time_range
        if ev.device_type == CUDA:
            if not name.startswith(HARNESS):
                by_id[ev.id] = by_id.get(ev.id, 0.0) + max(tr.end - tr.start, 0) / 1e6
                device.append((tr.start, tr.end))
        elif name == HARNESS + "stretch":
            lo, hi = tr.start, tr.end
        elif name.startswith(HARNESS):
            harness.append((tr.start, tr.end, name[len(HARNESS):]))
        elif name.startswith(PROGRAM):
            program.append((tr.start, tr.end, name[len(PROGRAM):]))
        elif name.startswith("cu"):  # a CUDA API call: cudaLaunchKernel, cuLaunchKernelEx, ...
            launches.append((tr.start, ev.id))

    table: dict = {}
    inner: dict = {}
    for a, b, name in program:
        if lo <= a and b <= hi:
            _add(table, name, 0, 0.0)
            table[name]["spans"] += 1
    cover = Cover(program)
    for t, cid in sorted(launches):
        if cid not in by_id or not lo <= t <= hi:
            continue  # not a launch, or outside the stretch
        open_ = cover.at(t)
        for name in {s[2] for s in open_}:
            _add(table, name, 1, by_id[cid])
        if open_:
            _add(inner, open_[-1][2], 1, by_id[cid])
    for row in inner.values():
        del row["spans"]

    gaps: dict = {}
    busy = _union([(max(a, lo), min(b, hi)) for a, b in device if b > a and b > lo and a < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    hcover, pcover = Cover(harness), Cover(program)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        names = [c[-1][2] for c in (hcover.at(mid), pcover.at(mid)) if c]
        name = "/".join(names) or "untracked"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return dict(out, idle_gaps=gaps, program=table, innermost=inner)


def line(summary: dict, top: int = 12) -> str:
    """Launches and device ms by innermost program span, the busiest first."""
    rows = sorted(summary.get("innermost", {}).items(), key=lambda kv: -kv[1]["device_s"])
    return "stretch spans " + "; ".join(
        f"{name}: {r['launches']} launches, {r['device_s'] * 1e3!r} ms" for name, r in rows[:top])
