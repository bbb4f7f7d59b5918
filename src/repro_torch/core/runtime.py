# Port copy of src/repro/core/runtime.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Threaded stream runtime (paper §2.2): worker threads + central scheduler.

Workers loop: query scheduler -> work a time slice on the chosen operator ->
update stats -> repeat. Ingress can be driven externally (``pipeline.push``)
or by a source callable pumping tuples at a target rate.

With ``heuristic="adaptive"`` the runtime additionally starts an adaptive
controller thread that periodically calls :meth:`Scheduler.adapt` — it
re-estimates per-operator cost/selectivity from live stats and resizes each
node's effective parallelism cap M_i to its load share, dynamically mapping
the computation's exposed parallelism onto the machine's (paper §2/§6).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from .costmodel import resolve_workers
from .pipeline import CompiledPipeline, GraphPipeline
from .scheduler import Scheduler


@dataclass
class RunReport:
    tuples_in: int
    tuples_out: int
    wall_time: float
    throughput: float  # ingress tuples fully processed per second
    mean_latency: float  # mean processing latency of 20-80pct markers (s)
    p99_latency: float
    worker_busy_frac: float
    # Egress tuples over the active processing window (first push -> last
    # egress).  ``throughput`` divides ingress count by *total* wall time,
    # which understates the sustained rate when drain dominates short runs.
    egress_throughput: float = 0.0

    def __str__(self):
        return (
            f"in={self.tuples_in} out={self.tuples_out} wall={self.wall_time:.3f}s "
            f"thru={self.throughput:,.0f}/s egress={self.egress_throughput:,.0f}/s "
            f"lat(mean)={self.mean_latency*1e3:.3f}ms "
            f"lat(p99)={self.p99_latency*1e3:.3f}ms busy={self.worker_busy_frac:.2f}"
        )


class StreamRuntime:
    """Threaded execution backend: ``num_workers`` worker threads pulling
    (operator, budget) assignments from a central :class:`~.scheduler
    .Scheduler` to drive a compiled :class:`~.pipeline.GraphPipeline`;
    ``heuristic="adaptive"`` adds the controller thread that periodically
    remaps per-operator parallelism caps (paper §2.2/§6)."""

    def __init__(
        self,
        pipeline: GraphPipeline,
        num_workers=4,  # int, or "auto" for one worker per core
        heuristic: str = "ct",
        **sched_kw,
    ):
        num_workers = resolve_workers(num_workers)
        self.pipeline = pipeline
        self.num_workers = num_workers
        sched_kw.setdefault("edges", getattr(pipeline, "sched_edges", None))
        self.scheduler = Scheduler(
            pipeline.nodes, heuristic, num_workers=num_workers, **sched_kw
        )
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._controller: Optional[threading.Thread] = None
        # lock-free: per-worker slot; only worker w writes _busy[w]
        self._busy = [0.0] * num_workers
        # First operator-fn exception seen by any worker.  A raising op kills
        # its worker thread and strands the in-flight tuple, so the pipeline
        # can never drain; recording it lets run()/Session raise a clear
        # error instead of hanging until the drain deadline.
        # lock-free: single racing store per worker; last-exception-wins is acceptable (any recorded error aborts the run)
        self.worker_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ workers
    _IDLE_MIN = 1e-5  # first miss: 10 µs
    _IDLE_MAX = 1e-3  # backoff cap / park interval: 1 ms

    def _worker_loop(self, wid: int) -> None:
        idle = self._IDLE_MIN
        while not self._stop.is_set():
            assignment = self.scheduler.acquire()
            if assignment is None:
                if self.scheduler.idle_hint():
                    # graph drained: park at the cap instead of spinning up
                    time.sleep(self._IDLE_MAX)
                else:
                    time.sleep(idle)
                    idle = min(idle * 2, self._IDLE_MAX)
                continue
            idle = self._IDLE_MIN
            node, budget = assignment
            t0 = time.perf_counter()
            try:
                node.work(wid, budget)
            except BaseException as exc:  # noqa: BLE001 — recorded, not lost
                self.worker_error = exc
                return  # this worker is done; drivers observe worker_error
            finally:
                self.scheduler.release(node)
                self._busy[wid] += time.perf_counter() - t0

    def _controller_loop(self) -> None:
        """Adaptive controller (heuristic="adaptive"): periodically re-estimate
        operator cost/selectivity and resize per-node parallelism caps."""
        while not self._stop.is_set():
            self.scheduler.adapt()
            self._stop.wait(self.scheduler.adapt_interval)

    def start(self) -> None:
        """Start the worker threads (and the adaptive controller, if any)."""
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()
        if self.scheduler.heuristic == "adaptive":
            self._controller = threading.Thread(
                target=self._controller_loop, daemon=True
            )
            self._controller.start()

    def stop(self) -> None:
        """Signal and join every worker thread (idempotent)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._controller is not None:
            self._controller.join(timeout=5.0)
            self._controller = None

    # ------------------------------------------------------------------ drive
    def run(
        self,
        source: Iterable,
        *,
        drain: bool = True,
        drain_timeout: float = 60.0,
    ) -> RunReport:
        """Pump every tuple from ``source`` through the pipeline and report."""
        n_in = 0
        t0 = time.perf_counter()
        self.start()
        try:
            for value in source:
                self.pipeline.push(value)
                n_in += 1
            self.pipeline.flush()  # release any partial ingress micro-batch
            if drain:
                deadline = time.perf_counter() + drain_timeout
                while not self.pipeline.drained():
                    if self.worker_error is not None:
                        raise RuntimeError(
                            f"worker failed: {self.worker_error!r}"
                        ) from self.worker_error
                    if time.perf_counter() > deadline:
                        raise TimeoutError("pipeline failed to drain")
                    time.sleep(1e-4)
        finally:
            self.stop()
        return self.make_report(n_in, time.perf_counter() - t0)

    def make_report(self, n_in: int, wall: float) -> RunReport:
        """Summarize a finished (stopped, drained) run over ``wall`` seconds
        and ``n_in`` ingress tuples.  Factored out of :meth:`run` so the
        streaming :class:`~.api.Session` surface can report on a
        push-driven window with the exact same conventions."""
        lats = self.pipeline.processing_latencies()
        lats_sorted = sorted(lats)
        mean_lat = sum(lats) / len(lats) if lats else 0.0
        p99 = lats_sorted[int(0.99 * (len(lats_sorted) - 1))] if lats_sorted else 0.0
        busy = sum(self._busy) / (self.num_workers * wall) if wall > 0 else 0.0
        n_out = self.pipeline.egress_count
        window = self.pipeline.processing_window() or wall
        # A 0/1-tuple egress has no meaningful first-push→last-egress window
        # (it would divide by ~0 and report an absurd rate): report 0.0.
        return RunReport(
            tuples_in=n_in,
            tuples_out=n_out,
            wall_time=wall,
            throughput=n_in / wall if wall > 0 else 0.0,
            egress_throughput=n_out / window if (window > 0 and n_out > 1) else 0.0,
            mean_latency=mean_lat,
            p99_latency=p99,
            worker_busy_frac=busy,
        )


def _deprecated_one_shot(name: str) -> None:
    import warnings

    warnings.warn(
        f"{name}() is deprecated; use repro.core.Engine — "
        "engine = Engine(EngineConfig(...)); plan = engine.plan(...); "
        "engine.run(plan, source) (or engine.open(plan) for streaming)",
        DeprecationWarning,
        stacklevel=3,
    )


def run_pipeline(specs, source: Iterable, **kw):
    """Deprecated one-shot: compile an operator chain, run to drain, report.

    Thin shim over the :class:`~.api.Engine` path — ``kw`` is parsed by
    :meth:`~.api.EngineConfig.from_kwargs` (unknown or conflicting options
    raise :class:`~.api.ConfigError` instead of being silently swallowed)
    and the run goes through ``Engine.run``.  Returns ``(handle, report)``
    where ``handle`` is a :class:`~.api.JobResult`-backed proxy exposing the
    documented result surface (``outputs``, ``egress_count``, ``markers``)
    identically for both backends, plus pass-through access to the
    underlying executed pipeline/runtime.  New code should call
    :class:`~.api.Engine` directly (``engine.plan`` → ``engine.run`` /
    ``engine.open``).
    """
    from .api import Engine, EngineConfig

    _deprecated_one_shot("run_pipeline")
    engine = Engine(EngineConfig.from_kwargs(**kw))
    result = engine.run(list(specs), source)
    return result.handle(), result.report


def run_graph(nodes, edges, source: Iterable, **kw):
    """Deprecated one-shot for DAG pipelines: compile, run to drain, report.

    Thin shim over the :class:`~.api.Engine` path (see :func:`run_pipeline`
    for the shim contract); ``backend="process"`` cuts the graph's linear
    prefix into process stages exactly as before, and routing nodes left in
    the parent tail still emit :class:`~.procrun.UnstagedGraphWarning`.
    """
    from .api import Engine, EngineConfig

    _deprecated_one_shot("run_graph")
    engine = Engine(EngineConfig.from_kwargs(**kw))
    result = engine.run((dict(nodes), list(edges)), source)
    return result.handle(), result.report
