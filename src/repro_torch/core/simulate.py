# Port copy of src/repro/core/simulate.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Discrete-event simulator of the runtime (virtual time, 1-core container).

Reproduces the paper's *scaling* results (figs. 8-14) faithfully: the real
data-structure logic (worklists, hybrid/partitioned queues, reorder buffers,
scheduling heuristics) drives a W-worker virtual-time simulation where
per-tuple costs are declared. The thread runtime (runtime.py) validates
correctness on real threads; this engine measures concurrency behaviour the
1-core container cannot exhibit. DESIGN.md §7 records which figures use which.

Cost model (defaults match the paper's micro-benchmark scales):
- processing a tuple on operator o: cost_us (deterministic + optional jitter)
- reorder add: add_us; sending one output downstream: send_us
- lock-based scheme: add/drain require the op's lock -> arriving workers
  BLOCK until the holder finishes draining (fig. 3's pathology)
- non-blocking scheme: adds never wait; the drain is done by whoever grabs
  the try-lock flag, others continue immediately
- hybrid queue: delegated tuples are processed by the partition's active
  worker (extends its busy time); the delegating worker moves on (never
  blocks). partitioned-queue: static bucket ownership.
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from .scheduler import HEURISTICS


@dataclass
class SimOp:
    name: str
    kind: str  # stateless | stateful | partitioned
    cost_us: float
    selectivity: float = 1.0
    num_partitions: int = 1
    key_of: Optional[Callable[[int, random.Random], int]] = None  # (serial, rng)


@dataclass
class SimConfig:
    num_workers: int = 4
    heuristic: str = "ct"
    reorder_scheme: str = "non_blocking"  # or lock_based
    worklist_scheme: str = "hybrid"  # or partitioned
    time_slice_us: float = 2000.0
    # serialization costs (µs): lock hold = add+drain work; calibrated to the
    # paper's fig.12 regime where a 10µs op saturates a lock at ~16 workers
    add_us: float = 0.2
    send_us: float = 0.5
    reorder_size: int = 4096
    ct_window_us: float = 50_000.0
    qst_capacity: int = 4096
    jitter: float = 0.25  # ±12.5% processing-cost variation
    seed: int = 0
    marker_interval: int = 64


class _OpState:
    def __init__(self, op: SimOp, cfg: SimConfig):
        self.op = op
        self.cfg = cfg
        self.queue: list = []  # FIFO worklist [(serial, key)]
        self.qhead = 0
        self.next_serial = 1
        self.enqueued = 0
        # reorder buffer
        self.ro_next = 1
        self.ro_waiting: dict[int, int] = {}  # serial -> n_outputs
        self.lock_free_at = 0.0  # lock-based: time the op lock frees
        self.flag_busy = False  # non-blocking: drain flag
        # partitioned state
        self.part_queues: dict[int, list] = {}
        self.part_active: dict[int, bool] = {}
        self.part_delegated: dict[int, int] = {}
        self.part_pending = 0
        # stats for scheduler
        self.workers = 0
        self.busy_us = 0.0
        self.window_busy_us = 0.0
        self.consumed = 0
        self.produced = 0
        self.blocked_us = 0.0

    # -- worklist size
    def size(self) -> int:
        return len(self.queue) - self.qhead + getattr(self, "part_pending", 0)

    def push(self, serial: int, key) -> None:
        self.queue.append((serial, key))

    def pop(self):
        if self.qhead >= len(self.queue):
            return None
        item = self.queue[self.qhead]
        self.qhead += 1
        if self.qhead > 4096 and self.qhead * 2 > len(self.queue):
            del self.queue[: self.qhead]
            self.qhead = 0
        return item

    def max_dop(self) -> int:
        if self.op.kind == "stateful":
            return 1
        if self.op.kind == "partitioned":
            return self.op.num_partitions
        return 1 << 30

    def schedulable(self) -> bool:
        return self.workers < self.max_dop() and self.size() > 0

    def cost(self) -> float:
        return self.op.cost_us


class Simulator:
    def __init__(self, ops: list[SimOp], cfg: SimConfig):
        self.cfg = cfg
        self.ops = [_OpState(o, cfg) for o in ops]
        self.rng = random.Random(cfg.seed)
        self.now = 0.0
        self.events: list = []  # (time, seq, fn)
        self._seq = itertools.count()
        self.egress = 0
        self.ingress = 0
        self.marker_begin: dict[tuple[int, int], float] = {}
        self.latencies: list[float] = []
        self.window_start = 0.0
        self.worker_busy = [0.0] * cfg.num_workers
        self._sel_acc = [0.0] * len(ops)

    # ------------------------------------------------------------- plumbing
    def at(self, t: float, fn) -> None:
        heapq.heappush(self.events, (t, next(self._seq), fn))

    def _n_outputs(self, i: int) -> int:
        s = self.ops[i].op.selectivity
        base = int(s)
        self._sel_acc[i] += s - base
        if self._sel_acc[i] >= 1.0:
            self._sel_acc[i] -= 1.0
            base += 1
        return base

    # -------------------------------------------------------------- enqueue
    def feed(self, i: int, key=None, marker: bool = False) -> int:
        """Enqueue one tuple into op i's worklist; returns its serial."""
        st = self.ops[i]
        serial = st.next_serial
        st.next_serial += 1
        if st.op.kind == "partitioned":
            k = key if key is not None else 0
            p = k % st.op.num_partitions
            st.part_queues.setdefault(p, []).append((serial, k))
            if self.cfg.worklist_scheme == "partitioned":
                st.part_pending = getattr(st, "part_pending", 0) + 1
            else:
                st.push(serial, ("__master__", p))
        else:
            st.push(serial, key)
        return serial

    # ------------------------------------------------------------ scheduler
    def _cum_sel(self) -> list[float]:
        cs, acc = [], 1.0
        for st in self.ops:
            acc *= max(st.op.selectivity, 1e-9)
            cs.append(acc)
        return cs

    def pick_op(self) -> Optional[int]:
        cand = [i for i, st in enumerate(self.ops) if st.schedulable()]
        if not cand:
            return None
        h = self.cfg.heuristic
        if h == "lp":
            return cand[-1]
        if h == "qst":
            cs = self._cum_sel()
            total = sum(cs)
            for i in cand:
                if i + 1 >= len(self.ops):
                    return i
                thr = max(self.cfg.qst_capacity * cs[i] / total, 1.0)
                if self.ops[i + 1].size() < thr:
                    return i
            return cand[0]
        if h == "et":
            return max(
                cand,
                key=lambda i: self.ops[i].size()
                * self.ops[i].cost()
                / (self.ops[i].workers + 1),
            )
        # ct
        if self.now - self.window_start > self.cfg.ct_window_us:
            for st in self.ops:
                st.window_busy_us = 0.0
            self.window_start = self.now
        cs = self._cum_sel()
        return min(
            cand,
            key=lambda i: (
                self.ops[i].window_busy_us
                + self.ops[i].workers * self.cfg.time_slice_us
            )
            / (self.ops[i].cost() * cs[i]),
        )

    # --------------------------------------------------------------- worker
    def worker_ask(self, w: int) -> None:
        i = self.pick_op()
        if i is None:
            self.at(self.now + 20.0, lambda: self.worker_ask(w))  # idle poll
            return
        st = self.ops[i]
        st.workers += 1
        budget = max(1, int(self.cfg.time_slice_us / st.cost()))
        self.work_loop(w, i, budget)

    def work_loop(self, w: int, i: int, budget: int) -> None:
        st = self.ops[i]
        if budget <= 0:
            st.workers -= 1
            self.worker_ask(w)
            return
        if st.op.kind == "partitioned" and self.cfg.worklist_scheme == "partitioned":
            # Volcano-style static ownership: worker w owns buckets p%W==w
            for p in range(w % self.cfg.num_workers, st.op.num_partitions, self.cfg.num_workers):
                q = st.part_queues.get(p)
                if q:
                    tup = q.pop(0)
                    st.part_pending -= 1
                    self.process(w, i, tup[0], p, budget)
                    return
            # own buckets empty (others may not be): idle-poll, NOT recurse
            st.workers -= 1
            self.at(self.now + 20.0, lambda: self.worker_ask(w))
            return
        item = st.pop()
        if item is None:
            st.workers -= 1
            self.worker_ask(w)
            return
        serial, key = item
        if st.op.kind == "partitioned":
            _tag, p = key
            # hybrid queue (fig. 7): delegation instead of blocking
            if st.part_active.get(p):
                st.part_delegated[p] = st.part_delegated.get(p, 0) + 1
                self.at(self.now + 0.05, lambda: self.work_loop(w, i, budget))
                return
            st.part_active[p] = True
            tup = st.part_queues[p].pop(0)
            self.process(w, i, tup[0], p, budget)
        else:
            self.process(w, i, serial, None, budget)

    def process(self, w: int, i: int, serial: int, p, budget: int, extra=None) -> None:
        st = self.ops[i]
        cost = st.cost()
        if self.cfg.jitter:
            cost *= 1.0 + self.cfg.jitter * (self.rng.random() - 0.5)
        if (i, serial) not in self.marker_begin and serial % self.cfg.marker_interval == 0 and i == 0:
            self.marker_begin[(0, serial)] = self.now
        done = self.now + cost
        self.worker_busy[w] += cost
        st.busy_us += cost
        st.window_busy_us += cost
        st.consumed += 1
        self.at(done, lambda: self.finish(w, i, serial, p, budget))

    def finish(self, w: int, i: int, serial: int, p, budget: int) -> None:
        st = self.ops[i]
        n_out = self._n_outputs(i)
        st.produced += n_out
        if st.op.kind == "stateful":
            self.emit(i, serial, n_out)
            self.after_send(w, i, serial, p, budget, 0.0)
            return
        # reorder buffer
        if self.cfg.reorder_scheme == "lock_based":
            start = max(self.now, st.lock_free_at)
            blocked = start - self.now
            st.blocked_us += blocked
            self.worker_busy[w] += blocked
            st.ro_waiting[serial] = n_out
            drained = self._drain(i)
            hold = self.cfg.add_us + drained * self.cfg.send_us
            st.lock_free_at = start + hold
            self.worker_busy[w] += hold
            st.busy_us += hold + blocked
            st.window_busy_us += hold + blocked
            self.after_send(w, i, serial, p, budget, blocked + hold)
        else:
            st.ro_waiting[serial] = n_out
            extra = self.cfg.add_us
            if not st.flag_busy:
                st.flag_busy = True
                drained = self._drain(i)
                extra += drained * self.cfg.send_us
                st.flag_busy = False
            self.worker_busy[w] += extra
            st.busy_us += extra
            st.window_busy_us += extra
            self.after_send(w, i, serial, p, budget, extra)

    def _drain(self, i: int) -> int:
        """Send the contiguous ready prefix downstream; returns #outputs."""
        st = self.ops[i]
        drained = 0
        while st.ro_next in st.ro_waiting:
            n_out = st.ro_waiting.pop(st.ro_next)
            self.emit(i, st.ro_next, n_out)
            st.ro_next += 1
            drained += n_out
        return drained

    def emit(self, i: int, serial: int, n_out: int) -> None:
        begin = self.marker_begin.pop((i, serial), None)
        if i + 1 < len(self.ops):
            nxt = self.ops[i + 1]
            for _ in range(n_out):
                s2 = self.feed(i + 1, key=self.rng.randrange(1 << 30))
                if begin is not None:
                    self.marker_begin[(i + 1, s2)] = begin
                    begin = None
            if begin is not None and n_out == 0:
                self.latencies.append(self.now - begin)
        else:
            self.egress += n_out
            if begin is not None:
                self.latencies.append(self.now - begin)

    def after_send(self, w: int, i: int, serial: int, p, budget: int, delay: float) -> None:
        st = self.ops[i]

        def cont():
            if st.op.kind == "partitioned" and self.cfg.worklist_scheme == "hybrid":
                # drain delegated tuples for partition p before releasing it
                if st.part_delegated.get(p, 0) > 0:
                    st.part_delegated[p] -= 1
                    tup = st.part_queues[p].pop(0)
                    self.process(w, i, tup[0], p, budget - 1)
                    return
                st.part_active[p] = False
            self.work_loop(w, i, budget - 1)

        self.at(self.now + delay, cont)

    # ------------------------------------------------------------------ run
    def run(
        self,
        n_tuples: int,
        key_sampler: Optional[Callable[[random.Random], int]] = None,
        arrival_rate_us: float = 0.0,
    ) -> dict:
        """Feed n_tuples into op 0 (all at t=0, or at a fixed rate), run to
        completion, return metrics."""
        if arrival_rate_us <= 0:
            for t in range(n_tuples):
                k = key_sampler(self.rng) if key_sampler else t
                self.feed(0, key=k)
            self.ingress = n_tuples
        else:
            def arrive(t_idx=0):
                if t_idx >= n_tuples:
                    return
                k = key_sampler(self.rng) if key_sampler else t_idx
                self.feed(0, key=k)
                self.ingress += 1
                self.at(self.now + arrival_rate_us, lambda: arrive(t_idx + 1))
            self.at(0.0, arrive)

        for w in range(self.cfg.num_workers):
            self.at(0.0, lambda w=w: self.worker_ask(w))

        idle_polls = 0
        while self.events:
            t, _, fn = heapq.heappop(self.events)
            self.now = t
            before = len(self.events)
            fn()
            # termination: only idle polls remain and all queues empty
            if all(st.size() == 0 and st.workers == 0 for st in self.ops):
                remaining_real = [
                    e for e in self.events if e[0] > self.now + 1e9
                ]
                drained = all(
                    not st.ro_waiting and not any(st.part_delegated.values())
                    for st in self.ops
                )
                if drained:
                    break

        makespan = self.now
        lats = sorted(self.latencies)
        lo, hi = int(len(lats) * 0.2), max(int(len(lats) * 0.8), 1)
        mid = lats[lo:hi] or lats or [0.0]
        return {
            "makespan_us": makespan,
            "throughput_per_s": self.ingress / makespan * 1e6 if makespan else 0.0,
            "mean_latency_us": sum(mid) / len(mid),
            "p99_latency_us": lats[int(0.99 * (len(lats) - 1))] if lats else 0.0,
            "worker_busy_frac": (
                sum(self.worker_busy) / (self.cfg.num_workers * makespan)
                if makespan
                else 0.0
            ),
            "blocked_us": sum(st.blocked_us for st in self.ops),
            "egress": self.egress,
        }


def simulate(
    ops: list[SimOp],
    n_tuples: int,
    cfg: Optional[SimConfig] = None,
    key_sampler=None,
    **cfg_kw,
) -> dict:
    cfg = cfg or SimConfig(**cfg_kw)
    return Simulator(ops, cfg).run(n_tuples, key_sampler=key_sampler)
