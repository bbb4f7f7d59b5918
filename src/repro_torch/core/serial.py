# Port copy of src/repro/core/serial.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Atomic primitives and serial-number assignment (paper §3).

Python cannot express lock-free CAS loops, but under the GIL a small lock-guarded
counter has the same linearizable semantics as the paper's ``atomic_long``; the
try-lock flag is expressed with ``Lock.acquire(blocking=False)`` which *is*
test_and_set. These are the only primitives the paper's data structures need.
"""
from __future__ import annotations

import threading


class AtomicLong:
    """Linearizable counter with load / fetch_add / fetch_sub."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0):
        self._value = value
        self._lock = threading.Lock()

    def load(self) -> int:
        """Read the current value (linearizable)."""
        # int reads are atomic under the GIL; take the lock anyway so the
        # semantics do not depend on CPython implementation details.
        with self._lock:
            return self._value

    def fetch_add(self, delta: int = 1) -> int:
        """Atomically add ``delta``; returns the PREVIOUS value."""
        with self._lock:
            old = self._value
            self._value += delta
            return old

    def fetch_sub(self, delta: int = 1) -> int:
        """Atomically subtract ``delta``; returns the PREVIOUS value."""
        return self.fetch_add(-delta)

    def store(self, value: int) -> None:
        """Atomically overwrite the value."""
        with self._lock:
            self._value = value

    def exchange(self, value: int) -> int:
        """Atomically set to ``value`` and return the previous value."""
        with self._lock:
            old = self._value
            self._value = value
            return old


class AtomicFlag:
    """test_and_set / clear, as used by the non-blocking reorder buffer."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()

    def test_and_set(self) -> bool:
        """Returns True if the flag was ALREADY set (i.e. acquisition failed),
        mirroring C++ ``atomic_flag::test_and_set`` semantics."""
        return not self._lock.acquire(blocking=False)

    def clear(self) -> None:
        """Release the flag so the next ``test_and_set`` succeeds."""
        self._lock.release()


class SerialAssigner:
    """Monotone serial numbers starting at 1 (paper: 'starting from 1')."""

    __slots__ = ("_counter",)

    def __init__(self, start: int = 1):
        self._counter = AtomicLong(start)

    def next(self) -> int:
        """Claim and return the next serial number."""
        return self._counter.fetch_add(1)

    def peek(self) -> int:
        """The serial the next :meth:`next` call would return (no claim)."""
        return self._counter.load()
