# Port copy of src/repro/core/reorder.py (the port imports nothing of the JAX package): keep the two in sync by hand; the port drops NonBlockingReorderBuffer.blocked_time.
"""Output-reordering schemes (paper §3) — the in-thread serial-number
protocol.

Serial-number protocol: every tuple is allotted a monotone serial (starting
at 1, :class:`~.serial.SerialAssigner`) *before* it is handed to concurrent
workers; each serial produces exactly one output bundle (possibly empty —
filtered tuples punch their hole in the sequence instead of stalling it).
Both schemes below order those bundles by serial before sending them
downstream, so concurrent execution is externally indistinguishable from the
single-threaded reference:

- :class:`LockBasedReorderBuffer` — fig. 2: a global lock protects a waiting
  buffer + ``next`` counter. Simple, but adders block while another worker drains.
- :class:`NonBlockingReorderBuffer` — fig. 4: bounded ring buffer indexed by
  ``t mod s``, atomic ``next``, and a try-lock flag. Adders never block; exactly
  one worker drains the contiguous ready prefix at a time.  Ring wire
  format: slot ``t mod s`` holds a one-shot :class:`_Slot` box (payloads are
  wrapped so ``None`` payloads are legal); an occupied slot *is* the
  publish, the drain empties it and bumps ``next``.

``send(t, output)`` returns False when the bounded ring cannot yet accept serial
``t`` (entry condition ``next <= t < next + s``); the caller must retry later —
this is the paper's back-pressure mechanism.

:class:`ParkingReorderBuffer` wraps either scheme with a spin-free overflow
side channel for callers that must never block *or* fail: rejected serials
park in a host-side heap and are re-sent once later traffic advances the
window.  Needed wherever in-flight serials can outrun the ring arbitrarily
(non-FIFO worklists, single-threaded engines, merge fan-in).  Invariant: a
parked serial is *claimed* under the lock before the re-send, so every
serial has exactly one sender — a duplicate send could re-populate a
drained slot and corrupt the sequence one window later.

The cross-process mirror of fig. 4 lives in :mod:`.shm`
(``ShmReorderRing``): same entry condition and hole-punching, plus span
slots (one publish covers a contiguous micro-batch), an in-band EOF marker,
and the crash/replay rules the staged process backend (:mod:`.procrun`)
builds on.  Keep the two in sync when evolving the protocol.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Callable, Optional

from .serial import AtomicFlag, AtomicLong

_EMPTY = None  # ring sentinel; payloads are wrapped so None payloads are legal


class _Slot:
    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value


class ReorderBuffer:
    """Common interface: send(t, output) -> bool; drains via send_downstream."""

    def send(self, t: int, output: Any) -> bool:  # pragma: no cover - interface
        """Admit serial ``t``'s output bundle; False = retry later (back-pressure)."""
        raise NotImplementedError

    def send_blocking(self, t: int, output: Any, spin: float = 1e-6) -> None:
        """Retry send until accepted (workers in the paper 'try again').

        ``spin`` sleeps between retries to yield the GIL — on real hardware this
        would be a PAUSE-loop; under CPython a 0-sleep spin starves the drainer.
        """
        while not self.send(t, output):
            if spin:
                time.sleep(spin)

    def accepts(self, t: int) -> bool:
        """Whether a send of serial ``t`` would be admitted right now."""
        return True  # unbounded schemes always accept


class LockBasedReorderBuffer(ReorderBuffer):
    """Fig. 2 — global lock + waiting dict. Blocking by construction."""

    def __init__(self, send_downstream: Callable[[Any], None], start: int = 1):
        self._send_downstream = send_downstream
        self._next = start  # guarded-by: self._lock
        self._waiting: dict[int, _Slot] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        # Instrumentation: total time workers spent blocked on the lock.
        self.blocked_time = 0.0  # guarded-by: self._lock

    def send(self, t: int, output: Any) -> bool:
        """Admit serial ``t`` under the global lock; always succeeds."""
        t0 = time.perf_counter()
        with self._lock:
            self.blocked_time += time.perf_counter() - t0
            if t == self._next:
                # analysis: ignore[LK202]: fig. 2's deliberate blocking design — each node's buffer emits downstream under its own lock; instance locks nest strictly along the acyclic dataflow, so the order is a DAG
                self._send_downstream(output)
                self._next += 1
                while self._next in self._waiting:
                    # analysis: ignore[LK202]: same fig. 2 strawman as above — the drain loop emits under the instance lock by construction
                    self._send_downstream(self._waiting.pop(self._next).value)
                    self._next += 1
            else:
                self._waiting[t] = _Slot(output)
        return True


class NonBlockingReorderBuffer(ReorderBuffer):
    """Fig. 4 — bounded ring + atomic ``next`` + try-lock drain flag."""

    def __init__(
        self,
        send_downstream: Callable[[Any], None],
        size: int = 1024,
        start: int = 1,
    ):
        if size <= 0:
            raise ValueError("ring size must be positive")
        self._send_downstream = send_downstream
        self._size = size
        self._next = AtomicLong(start)
        # lock-free: fig. 4 — slot ownership via the entry condition (next <= t < next+size) and publish-before-advance; exactly one drainer via the try-lock flag
        self._buffer: list[Optional[_Slot]] = [_EMPTY] * size
        self._flag = AtomicFlag()
        self._rejected = AtomicLong(0)  # entry-condition failures (ring full)

    @property
    def rejected_adds(self) -> int:
        """Entry-condition failures (ring full for the offered serial).
        Atomic: concurrent rejecting senders each count exactly once."""
        return self._rejected.load()

    def accepts(self, t: int) -> bool:
        """Entry condition ``next <= t < next + size`` (no side effects)."""
        n = self._next.load()
        return n <= t < n + self._size

    # -- paper fig. 4 ------------------------------------------------------
    def send(self, t: int, output: Any) -> bool:
        """Try to admit serial ``t`` (entry condition ``next <= t < next+s``),
        then drain the contiguous ready prefix; False = window full, retry."""
        success = self._try_add(t, output)
        self._send_pending_outputs()
        return success

    def _try_add(self, t: int, output: Any) -> bool:
        n = self._next.load()
        if n <= t < n + self._size:
            self._buffer[t % self._size] = _Slot(output)
            return True
        self._rejected.fetch_add(1)
        return False

    def _send_pending_outputs(self) -> None:
        while True:  # tail-recursion of fig. 4 L42 expressed as a loop
            if self._flag.test_and_set():
                return  # another worker is draining; do NOT block (the point)
            i = 0
            while True:
                n = self._next.load()
                i = n % self._size
                slot = self._buffer[i]
                if slot is not _EMPTY:
                    self._send_downstream(slot.value)
                    self._buffer[i] = _EMPTY
                    self._next.fetch_add(1)
                else:
                    self._flag.clear()
                    break
            # Re-check: an add may have raced with the flag clear (fig. 4 L39-42).
            if self._buffer[i] is _EMPTY:
                return


class ParkingReorderBuffer:
    """Reliable, never-blocking facade over a :class:`ReorderBuffer`.

    A bounded ring rejects serials beyond its window; spinning on the reject
    deadlocks as soon as every worker holds a far-future serial (non-FIFO
    worklists make that reachable) or the caller is single threaded.  Here a
    rejected serial parks in a min-heap instead, and :meth:`flush` re-sends
    parked serials once the window reaches them — every successful send calls
    it, so parked output drains as the stream progresses.

    Concurrency: a parked serial is *claimed* (popped) under the lock before
    the re-send, so exactly one thread ever sends a given serial — a duplicate
    send could otherwise re-populate a drained ring slot and corrupt the
    sequence one window later.  If the claimed send is rejected the entry is
    re-parked; the subsequent ``accepts`` check closes the race where the
    window advanced (and its owner's flush missed the re-parked entry) in
    between.
    """

    def __init__(self, inner: ReorderBuffer):
        self._inner = inner
        self._parked: dict[int, Any] = {}  # guarded-by(rw): self._lock
        # min-heap of parked serials (lazy deletes)
        self._heap: list[int] = []  # guarded-by(rw): self._lock
        self._lock = threading.Lock()

    def send(self, t: int, output: Any) -> None:
        """Admit serial ``t``, parking it (never blocking, never failing) if
        the inner ring's window cannot accept it yet."""
        if not self._inner.send(t, output):
            with self._lock:
                self._parked[t] = output
                heapq.heappush(self._heap, t)
        self.flush()

    def flush(self) -> None:
        """Re-send parked serials the advancing window can now accept."""
        while True:
            with self._lock:
                while self._heap and self._heap[0] not in self._parked:
                    heapq.heappop(self._heap)  # claimed by another flusher
                if not self._heap:
                    return
                t = self._heap[0]
                payload = self._parked.pop(t)  # claim: we are t's only sender
            if self._inner.send(t, payload):
                continue
            with self._lock:
                self._parked[t] = payload
                # Re-push: a concurrent flusher may have lazily popped t's
                # heap entry while it was claimed (t absent from the dict);
                # without this the entry would be unreachable forever.
                heapq.heappush(self._heap, t)
            if not self._inner.accepts(t):
                return  # window still short; a later send will flush
            # window advanced during the re-park: retry, we may be last

    def parked_count(self) -> int:
        """How many serials are currently parked (0 = fully drained)."""
        with self._lock:
            return len(self._parked)


def make_reorder_buffer(
    scheme: str, send_downstream: Callable[[Any], None], size: int = 1024
) -> ReorderBuffer:
    """Build the reorder scheme by name: ``non_blocking`` (fig. 4, bounded
    ring of ``size`` serials) or ``lock_based`` (fig. 2)."""
    if scheme == "non_blocking":
        return NonBlockingReorderBuffer(send_downstream, size=size)
    if scheme == "lock_based":
        return LockBasedReorderBuffer(send_downstream)
    raise ValueError(f"unknown reorder scheme: {scheme!r}")
