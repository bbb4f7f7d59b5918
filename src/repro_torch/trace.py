"""Spans and counter samples at the port's layer boundaries.

Off by default, and then free: :func:`span` returns one shared no-op
context, with no clock read, no allocation and no profiler call, and
:func:`sample` returns at once.  :func:`enable` and :func:`disable` are the
only switch (:func:`on` reads it); :func:`take` returns what was recorded since the last
``take()`` and clears it (call it between steps, with no span open).

A record is a :class:`Record`: a span's name, the id it was given (a
request's serial, so one request's spans share it), the index in the same
``take()`` list of the span open around it, and its start and end on
``time.perf_counter_ns`` (the clock of ``Request.submitted_at``).  A sample
(:func:`sample`) is a record with a value and no duration.  Spans nest on one
stack for the whole process: the engine and the trainer run on one thread,
and the device thread of a backward pass runs while the thread that called
it waits.

While a ``torch.profiler`` session is on, a span also enters
``record_function(PREFIX + name)``, which puts it on the profiler's timeline,
on the clock of the card's kernels: a kernel can then be put down to the
span whose host call launched it, and an idle stretch of the card to the
span the host was in.  Such records read ``profiled`` true.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

PREFIX = "repro_torch."


class Record(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[int]  # index of the enclosing span in the same take() list
    t0: int  # ns, time.perf_counter_ns
    t1: int
    value: Optional[float] = None  # a sample's value; None for a span
    profiled: bool = False  # recorded while a torch.profiler session was on


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_records: list = []  # [name, id, parent, t0, t1, value, profiled] each
_stack: list = []  # indices into _records of the open spans


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    __slots__ = ("entry", "index", "rf")

    def __init__(self, name: str, id: Optional[int]):
        self.entry = [name, id, None, 0, 0, None, False]

    def __enter__(self):
        entry = self.entry
        self.rf = None
        if _profiling():
            entry[6] = True
            self.rf = torch.autograd.profiler.record_function(PREFIX + entry[0])
            self.rf.__enter__()
        entry[2] = _stack[-1] if _stack else None
        self.index = len(_records)
        _records.append(entry)
        _stack.append(self.index)
        entry[3] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self.entry[4] = time.perf_counter_ns()
        if _stack and _stack[-1] == self.index:
            _stack.pop()
        elif self.index in _stack:  # left out of order, or after a take()
            _stack.remove(self.index)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, id: Optional[int] = None):
    """A context that records ``name`` (with ``id``) from entry to exit
    while tracing is on; the shared no-op context while it is off."""
    if not _on:
        return _OFF
    return _Span(name, id)


def since(name: str, t0_s: float, id: Optional[int] = None) -> None:
    """Record a span from ``t0_s`` (``time.perf_counter`` seconds, such as a
    request's submit) until now, with no enclosing span and not on the
    profiler's timeline."""
    if _on:
        _records.append([name, id, None, round(t0_s * 1e9), time.perf_counter_ns(), None,
                         _profiling()])


def sample(name: str, value: float, id: Optional[int] = None) -> None:
    """Record a counter's value now, inside the open span."""
    if _on:
        t = time.perf_counter_ns()
        _records.append([name, id, _stack[-1] if _stack else None, t, t, value, _profiling()])


def on() -> bool:
    """Whether tracing is on: guards a counter that costs a read to take."""
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`take`."""
    global _on
    _on = False
    _stack.clear()


def take() -> list:
    """The records since the last ``take()``, in the order they were made
    (a span at its entry); clears them."""
    out = [Record(*e) for e in _records]
    _records.clear()
    _stack.clear()
    return out
