# Port copy of src/repro/core/hybrid.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Partitioned-parallelism worklist schemes (paper §4).

Three strategies for feeding workers of a partitioned stateful operator:

- :class:`SharedQueueWorklist` (§4.1)      — one MPMC queue + per-key locks
  (dequeue+lock made atomic under a global lock; the naive, blocking scheme).
- :class:`PartitionedQueueWorklist` (§4.2) — one queue per bucket, workers own
  buckets statically (Volcano-style); no concurrency control but poor skew/order
  behaviour.
- :class:`HybridQueueWorklist` (§4.3)      — fig. 7: per-partition queues + a
  master queue of partition ids + per-partition delegation counters. Never
  blocks; processes almost in arrival order; partitions ≫ workers for load
  balance.

All schemes present the same interface:
  ``add(serial, key, tuple)``                    (producer side, addInput)
  ``consume(worker_id, operate, budget) -> int`` (worker side, consumeInputs)
``operate(serial, key, tuple)`` is the operator callback; ``budget`` caps tuples
processed per invocation (the scheduler's time slice); returns #processed.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Hashable

from .serial import AtomicLong

Operate = Callable[[int, Hashable, Any], None]


class Worklist:
    """Interface: add(serial, key, item) enqueues; consume(worker, operate,
    budget) runs up to ``budget`` tuples through ``operate``; len() is the
    queued-tuple count the scheduler reads."""

    def add(self, serial: int, key: Hashable, item: Any) -> None:
        """Enqueue one keyed tuple under its serial."""
        raise NotImplementedError

    def consume(self, worker_id: int, operate: Operate, budget: int) -> int:
        """Process up to ``budget`` queued tuples; returns how many ran."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class SharedQueueWorklist(Worklist):
    """§4.1 — single shared queue; atomicity of (dequeue, acquire key lock)
    ensured by a global lock; workers block if the key is busy."""

    def __init__(self, num_partitions: int, partitioner: Callable[[Hashable], int]):
        # lock-free: deque.append/popleft are atomic under the GIL; §4.1 serializes only the dequeue+key-lock pair (under _global), not the enqueue
        self._queue: collections.deque = collections.deque()
        self._global = threading.Lock()
        self._key_locks = [threading.Lock() for _ in range(num_partitions)]
        self._partitioner = partitioner
        self.blocked_time = 0.0  # guarded-by: self._global

    def add(self, serial, key, item):
        """Enqueue on the single shared queue."""
        self._queue.append((serial, key, item))

    def consume(self, worker_id, operate, budget):
        """Dequeue+key-lock atomically (may block on a busy key — §4.1's flaw)."""
        done = 0
        while done < budget:
            t0 = time.perf_counter()
            with self._global:  # makes dequeue+lock atomic (fig. 5 fix)
                try:
                    serial, key, item = self._queue.popleft()
                except IndexError:
                    self.blocked_time += time.perf_counter() - t0
                    return done
                lock = self._key_locks[self._partitioner(key)]
                # analysis: ignore[LK202]: §4.1's deliberate flaw — the scheme's defining property is that dequeue and key-lock acquisition are one atomic step, so the key wait happens under _global (fig. 5)
                lock.acquire()  # may block while holding _global: the flaw §4.1
                self.blocked_time += time.perf_counter() - t0
            try:
                operate(serial, key, item)
            finally:
                lock.release()
            done += 1
        return done

    def __len__(self):
        return len(self._queue)


class PartitionedQueueWorklist(Worklist):
    """§4.2 — static queue-per-bucket; worker w owns buckets {p : p % W == w}."""

    def __init__(
        self,
        num_partitions: int,
        partitioner: Callable[[Hashable], int],
        num_workers: int,
    ):
        self._queues = [collections.deque() for _ in range(num_partitions)]
        self._partitioner = partitioner
        self._num_workers = num_workers
        self._size = AtomicLong(0)

    def add(self, serial, key, item):
        """Enqueue on the tuple's bucket queue."""
        # Count BEFORE publishing: a consumer may process-and-decrement the
        # moment the tuple is visible, and a transiently negative size makes
        # __len__ raise (len() must be >= 0), killing the worker thread.
        self._size.fetch_add(1)
        self._queues[self._partitioner(key)].append((serial, key, item))

    def consume(self, worker_id, operate, budget):
        """Drain only the buckets this worker statically owns (p % W == w)."""
        done = 0
        my = worker_id % self._num_workers
        for p in range(my, len(self._queues), self._num_workers):
            q = self._queues[p]
            while done < budget:
                try:
                    serial, key, item = q.popleft()
                except IndexError:
                    break
                operate(serial, key, item)
                self._size.fetch_sub(1)
                done += 1
            if done >= budget:
                break
        return done

    def __len__(self):
        return max(self._size.load(), 0)


class HybridQueueWorklist(Worklist):
    """§4.3 / fig. 7 — the paper's contribution.

    ``count[p]`` serves double duty: exclusive access to partition p (the worker
    whose fetch_add observed 0 is the *active* worker) and a delegation counter
    (losers increment it and move on — never blocking).
    """

    def __init__(self, num_partitions: int, partitioner: Callable[[Hashable], int]):
        self._partition_queues = [collections.deque() for _ in range(num_partitions)]
        self._master: collections.deque = collections.deque()
        self._count = [AtomicLong(0) for _ in range(num_partitions)]
        self._partitioner = partitioner
        self._size = AtomicLong(0)
        self.delegated = 0  # instrumentation: tuples processed via delegation

    # fig. 7 addInput
    def add(self, serial, key, item):
        """Enqueue on the tuple's partition queue + the master queue."""
        p = self._partitioner(key)
        self._size.fetch_add(1)  # before publishing (see PartitionedQueue.add)
        self._partition_queues[p].append((serial, key, item))
        self._master.append(p)

    # fig. 7 consumeInputs (+ scheduler budget)
    def consume(self, worker_id, operate, budget):
        """Fig. 7: first worker into a partition becomes its active worker;
        losers delegate their tuple to it and move on (never blocking)."""
        done = 0
        while done < budget:
            try:
                p = self._master.popleft()
            except IndexError:
                return done
            if self._count[p].fetch_add(1) == 0:
                # active worker of p: drain own + delegated tuples
                while True:
                    serial, key, item = self._partition_queues[p].popleft()
                    operate(serial, key, item)
                    self._size.fetch_sub(1)
                    done += 1
                    if self._count[p].fetch_sub(1) <= 1:
                        break
                    if done >= budget:
                        # Time slice exhausted with delegations pending: hand
                        # the partition off instead of overrunning the budget.
                        # exchange(0) releases exclusivity (a future fetch_add
                        # sees 0 and becomes active); one master token per
                        # abandoned tuple restores the token<->tuple invariant.
                        pending = self._count[p].exchange(0)
                        for _ in range(pending):
                            self._master.append(p)
                        return done
            else:
                self.delegated += 1
                # delegated to the active worker; move on (non-blocking)
        return done

    def __len__(self):
        return max(self._size.load(), 0)


def make_worklist(
    scheme: str,
    num_partitions: int,
    partitioner: Callable[[Hashable], int],
    num_workers: int = 1,
) -> Worklist:
    """Build the worklist scheme by name: ``hybrid`` (fig. 7), ``partitioned``
    (§4.2 static bucket ownership), or ``shared`` (§4.1 single queue)."""
    if scheme == "hybrid":
        return HybridQueueWorklist(num_partitions, partitioner)
    if scheme == "partitioned":
        return PartitionedQueueWorklist(num_partitions, partitioner, num_workers)
    if scheme == "shared":
        return SharedQueueWorklist(num_partitions, partitioner)
    raise ValueError(f"unknown worklist scheme: {scheme!r}")
