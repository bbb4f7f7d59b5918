"""Spans of the benchmark's own calls into the program, and the profiler's
stretch of a traced run.

``Spans`` times every call it wraps on the host clock and, in a traced run,
names it in the profiler's trace (``record_function``), so an idle gap on
the device can be put down to what the host was doing.  ``Stretch`` runs
``torch.profiler`` over part of the window and reduces its events to the
device's busy time, the time of each kernel, and the idle gaps by host span.
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch

PREFIX = "portbench:"


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.records: list = []  # (name, t0, t1, in_stretch)
        self.in_stretch = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(PREFIX + name) if self.traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter(), self.in_stretch))

    def wrap(self, name: str, fn):
        def call(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return call


class Stretch:
    """The profiler over the steps between ``start()`` and ``stop()``."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = self.done = None
        self.active = False
        self.summary: dict = {}

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self._outer = torch.profiler.record_function(PREFIX + "stretch")
        self._outer.__enter__()
        self.spans.in_stretch = True
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._outer.__exit__(None, None, None)
        self.prof.stop()
        self.spans.in_stretch = False
        self.host_s = time.perf_counter() - self._t0
        self.done, self.active = self.prof, False

    def finish(self) -> dict:
        """Reduce the trace, after the window has closed."""
        if self.active:
            self.stop()
        if self.done is None:
            raise RuntimeError("the window closed before the profiled stretch began")
        self.summary = dict(reduce(self.done.events()), host_s=self.host_s)
        self.done = None
        return self.summary


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events) -> dict:
    """Busy seconds, the stretch's seconds, seconds by kernel name, and idle
    seconds by the host span around each gap (``untracked`` where none)."""
    device, spans, whole = [], [], None
    kernels: dict = {}
    calls: dict = {}
    for ev in events:
        tr = ev.time_range
        if ev.name.startswith(PREFIX):  # a host span, also shown on the device's timeline
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                if ev.name == PREFIX + "stretch":
                    whole = (tr.start, tr.end)
                else:
                    spans.append((tr.start, tr.end, ev.name[len(PREFIX):]))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            if tr.end > tr.start:
                device.append((tr.start, tr.end))
                name = ev.name[:96]
                kernels[name] = kernels.get(name, 0.0) + (tr.end - tr.start) / 1e6
                calls[name] = calls.get(name, 0) + 1
    if whole is None:
        raise RuntimeError("the profiler's trace holds no stretch span")
    lo, hi = whole
    busy = _union([(max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi])
    busy_us = sum(b - a for a, b in busy)
    gaps: dict = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans.sort()
    starts = [s for s, _, _ in spans]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = spans[i][2] if i >= 0 and spans[i][1] >= mid else "untracked"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6, "kernels": kernels,
            "calls": calls, "idle_gaps": gaps}


def breakdown(summary: dict) -> dict:
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(summary["kernels"]), "idle_gaps": top(summary["idle_gaps"])}


def kernel_line(summary: dict, needles: tuple) -> str:
    """Calls and seconds of the kernels whose names hold a needle."""
    parts = []
    for n in needles:
        hit = [k for k in summary["kernels"] if n in k]
        parts.append(f"{n}: {sum(summary['calls'][k] for k in hit)} calls, "
                     f"{sum(summary['kernels'][k] for k in hit)!r} s")
    return "stretch kernels " + "; ".join(parts)
