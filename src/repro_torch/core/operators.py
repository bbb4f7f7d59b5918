# Port copy of src/repro/core/operators.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Operator abstractions and their executable (schedulable) nodes (paper §2, §5).

An :class:`OpSpec` declares an operator; ``compile`` (in pipeline.py) turns each
into an :class:`OperatorNode` — an independently schedulable unit owning its
worklist(s), reorder buffer, and runtime statistics, exactly the decoupled
asynchronous execution model of §2.2.

Operator function signatures:
  stateless:    fn(value) -> list[out]
  stateful:     fn(state, value) -> (state, list[out])
  partitioned:  fn(state, key, value) -> (state, list[out])
  device:       fn(value) -> list[out]   (the NumPy reference; the process
                backend instead batches columnar blocks through the declared
                ``device_kernel`` via :class:`repro.columnar.DeviceExecutor`)

Contract: operator functions must be **deterministic** (same state/value in,
same outputs out) and side-effect-free outside their own state.  The thread
backend merely assumes this for reproducibility, but the process backend
(:mod:`.procrun`) *relies* on it — crash recovery re-executes a dead
worker's uncommitted unit and treats duplicate publishes as idempotent,
which is only sound for deterministic functions.  Functions (and their
closures) must also survive ``fork``-style pickling when they ride
process-backend dispatch units.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Optional

from .hybrid import make_worklist
from .reorder import ParkingReorderBuffer, make_reorder_buffer
from .serial import AtomicLong, SerialAssigner

STATELESS = "stateless"
STATEFUL = "stateful"
PARTITIONED = "partitioned"
DEVICE = "device"


@dataclass
class OpSpec:
    name: str
    kind: str  # stateless | stateful | partitioned | device
    fn: Callable
    key_fn: Optional[Callable[[Any], Hashable]] = None
    num_partitions: int = 1
    partitioner: Optional[Callable[[Hashable], int]] = None
    init_state: Callable[[], Any] = lambda: None
    # Declared priors (used by the scheduler before estimates warm up, and by
    # the discrete-event simulator as ground-truth virtual costs).
    cost_us: float = 1.0
    selectivity: float = 1.0
    # Device-offload declaration (kind == DEVICE only; see repro.columnar).
    # ``fn`` stays the per-value NumPy reference so every non-device path
    # (thread backend, calibration, correctness tests) runs the spec as-is.
    schema: Any = None  # repro.columnar.Schema of the fixed-width rows
    device_kernel: Any = None  # (registry name, frozen params tuple)
    device_batch: int = 0  # rows per device dispatch (0 = runtime knob)
    device_backend: str = "cuda"  # cuda | cpu | numpy

    def __post_init__(self):
        if self.kind not in (STATELESS, STATEFUL, PARTITIONED, DEVICE):
            raise ValueError(f"bad operator kind {self.kind!r}")
        if self.kind == PARTITIONED:
            if self.key_fn is None:
                raise ValueError(f"{self.name}: partitioned operator needs key_fn")
            if self.partitioner is None:
                n = self.num_partitions
                self.partitioner = lambda k, n=n: hash(k) % n
        if self.kind == DEVICE:
            if self.device_kernel is None or self.schema is None:
                raise ValueError(
                    f"{self.name}: device operator needs device_kernel and schema"
                )
            if self.selectivity != 1.0:
                # Elementwise column maps are 1:1 by construction; anything
                # else would make partial-batch flushes change results.
                raise ValueError(f"{self.name}: device operators are 1:1")


class _Marker:
    """Latency probe riding on a tuple (paper §7 'marker wrappers')."""

    __slots__ = ("entry", "begin", "exit")

    def __init__(self, entry: float):
        self.entry = entry  # enqueue at pipeline ingress
        self.begin = 0.0  # first operator starts processing (=> processing latency)
        self.exit = 0.0  # egress


@dataclass
class OpStats:
    consumed: int = 0
    produced: int = 0
    busy_time: float = 0.0  # seconds of worker time spent in fn
    window_busy: float = 0.0  # worker time in current CT window

    def cost(self, prior: float) -> float:
        """Estimated per-tuple processing cost in seconds."""
        if self.consumed < 8:
            return prior
        return self.busy_time / self.consumed

    def selectivity(self, prior: float) -> float:
        """Estimated outputs per input (``prior`` until estimates warm up)."""
        if self.consumed < 8:
            return prior
        return self.produced / self.consumed


class OperatorNode:
    """Independently schedulable executable operator."""

    def __init__(
        self,
        spec: OpSpec,
        index: int,
        *,
        reorder_scheme: str = "non_blocking",
        worklist_scheme: str = "hybrid",
        reorder_size: int = 1024,
        num_workers: int = 1,
        batch_size: int = 1,
    ):
        self.spec = spec
        self.index = index
        # Micro-batched tuple flow: tuples travel node-to-node in batches,
        # amortizing per-tuple queue/reorder/lock overhead.  Stateless and
        # stateful nodes enqueue whole batches (one serial, one reorder send,
        # one downstream push per batch); partitioned nodes unpack batches to
        # per-tuple worklist items (bucket ownership is per-tuple) and their
        # egress re-enters the batched flow one bundle at a time.
        self.batched = batch_size > 1
        self.downstream: Optional[Callable[[Any, Optional[_Marker]], None]] = None
        self.downstream_batch: Optional[Callable[[list, list], None]] = None
        self.stats = OpStats()
        self.workers = AtomicLong(0)  # currently allotted workers (w_i)
        # Effective parallelism cap M_i: the adaptive controller lowers this
        # below max_dop to match the operator's estimated load share.
        self.dop_cap = 1 << 30
        self._serials = SerialAssigner()
        self._stats_lock = threading.Lock()

        self._queued_tuples = AtomicLong(0)  # batched-mode tuple count
        if spec.kind == STATEFUL:
            self.max_dop = 1
            self._state = spec.init_state()
            self._queue: collections.deque = collections.deque()
            self._reorder = None  # single worker => already ordered
        elif spec.kind in (STATELESS, DEVICE):
            # DEVICE runs its per-value NumPy reference here: on the thread
            # backend a device op is just a stateless flat-map (batched
            # kernel dispatch exists only on the process backend).
            self.max_dop = 1 << 30  # effectively ∞ (capped by cores)
            self._queue = collections.deque()
            # Parking wrapper: non-FIFO worklists (Volcano bucket ownership,
            # hybrid budget handoffs) can pull a serial arbitrarily far ahead
            # of the ring window; spinning on the reject would deadlock once
            # every worker holds a far-future serial.
            self._reorder = ParkingReorderBuffer(
                make_reorder_buffer(reorder_scheme, self._emit, size=reorder_size)
            )
        else:  # PARTITIONED
            self.max_dop = spec.num_partitions
            self._states: dict[int, Any] = {}
            self._worklist = make_worklist(
                worklist_scheme,
                spec.num_partitions,
                spec.partitioner,
                num_workers=num_workers,
            )
            self._reorder = ParkingReorderBuffer(
                make_reorder_buffer(reorder_scheme, self._emit, size=reorder_size)
            )

    # ---- producer side ----------------------------------------------------
    def push(self, value: Any, marker: Optional[_Marker] = None) -> None:
        """Enqueue one tuple (serial assigned here, in push order)."""
        serial = self._serials.next()
        if self.spec.kind == PARTITIONED:
            key = self.spec.key_fn(value)
            self._worklist.add(serial, key, (value, marker))
        else:
            self._queue.append((serial, value, marker))

    def push_batch(self, values: list, markers: list) -> None:
        """Batched-mode inlet: one queue entry (and one serial) per batch.

        ``markers`` is a list of ``(offset-in-batch, marker)`` pairs — probes
        stay attached to the exact tuple they rode in on (offsets are
        remapped through every flat-map, see :meth:`_operate_batch`).
        """
        if self.spec.kind == PARTITIONED:
            # Bucket ownership is per-tuple: unpack, pairing by offset.
            by_off = dict(markers) if markers else None
            for i, v in enumerate(values):
                self.push(v, by_off.get(i) if by_off else None)
            return
        serial = self._serials.next()
        self._queued_tuples.fetch_add(len(values))
        self._queue.append((serial, values, markers))

    # ---- scheduler interface -----------------------------------------------
    def worklist_size(self) -> int:
        """Queued tuples awaiting this operator (scheduler's I_i)."""
        if self.spec.kind == PARTITIONED:
            return len(self._worklist)
        if self.batched:
            return max(self._queued_tuples.load(), 0)
        return len(self._queue)

    def schedulable(self) -> bool:
        """Whether a worker may be assigned here: queued work exists and the
        effective parallelism cap ``min(max_dop, dop_cap)`` is not reached."""
        cap = min(self.max_dop, self.dop_cap)
        return self.workers.load() < cap and self.worklist_size() > 0

    # ---- worker side --------------------------------------------------------
    def work(self, worker_id: int, budget: int) -> int:
        """Process up to ``budget`` tuples; returns the number processed."""
        if self.spec.kind == PARTITIONED:
            return self._worklist.consume(worker_id, self._operate_partitioned, budget)
        done = 0
        while done < budget:
            try:
                serial, value, marker = self._queue.popleft()
            except IndexError:
                break
            if self.batched:  # entry is (serial, values, markers)
                n = max(len(value), 1)
                self._queued_tuples.fetch_sub(len(value))
                self._operate_batch(serial, value, marker)
                done += n
            else:
                self._operate(serial, value, marker)
                done += 1
        return done

    # ---- internals ----------------------------------------------------------
    def _operate(self, serial: int, value: Any, marker: Optional[_Marker]) -> None:
        if marker is not None and self.index == 0 and not marker.begin:
            # not already stamped: a process-backend tail pipeline receives
            # markers whose begin was set in the worker's parallel segment
            marker.begin = time.perf_counter()
        t0 = time.perf_counter()
        if self.spec.kind == STATEFUL:
            self._state, outs = self.spec.fn(self._state, value)
        else:
            outs = self.spec.fn(value)
        dt = time.perf_counter() - t0
        self._account(dt, len(outs))
        if self._reorder is None:
            self._emit((outs, marker))
        else:
            self._reorder.send(serial, (outs, marker))

    def _operate_partitioned(self, serial: int, key: Hashable, item) -> None:
        value, marker = item
        if marker is not None and self.index == 0 and not marker.begin:
            marker.begin = time.perf_counter()
        t0 = time.perf_counter()
        # State is per KEY (the partition/bucket only controls concurrency —
        # tuples in one bucket are serialized, but each key has its own state,
        # exactly the paper's partitioned-stateful semantics).
        state = self._states.get(key)
        if state is None:
            state = self.spec.init_state()
        state, outs = self.spec.fn(state, key, value)
        self._states[key] = state
        dt = time.perf_counter() - t0
        self._account(dt, len(outs))
        if self.batched:  # re-enter the batched flow as a 1-tuple bundle
            self._reorder.send(serial, (outs, [(0, marker)] if marker else []))
        else:
            self._reorder.send(serial, (outs, marker))

    def _operate_batch(self, serial: int, values: list, markers: list) -> None:
        """Process one micro-batch: one fn sweep, one reorder send, one
        downstream push — the per-tuple overhead amortization.

        Marker offsets are remapped through the flat-map: a probe on input i
        re-attaches to the first output of input i; if input i produced no
        output its probe's journey ends here (exit stamped, recorded).
        """
        if self.index == 0:
            for _, m in markers:
                if not m.begin:
                    m.begin = time.perf_counter()
        by_off = dict(markers) if markers else None
        out_markers: list = []
        dropped: list = []
        t0 = time.perf_counter()
        outs: list = []
        stateful = self.spec.kind == STATEFUL
        state, fn = (self._state if stateful else None), self.spec.fn
        for i, v in enumerate(values):
            if stateful:
                state, o = fn(state, v)
            else:
                o = fn(v)
            if by_off is not None:
                m = by_off.get(i)
                if m is not None:
                    if o:
                        out_markers.append((len(outs), m))
                    else:
                        dropped.append(m)
            outs.extend(o)
        if stateful:
            self._state = state
        dt = time.perf_counter() - t0
        self._account(dt, len(outs), n_in=len(values))
        for m in dropped:
            m.exit = time.perf_counter()
            if self.on_marker_drop is not None:
                self.on_marker_drop(m)
        if self._reorder is None:
            self._emit((outs, out_markers))
        else:
            self._reorder.send(serial, (outs, out_markers))

    def overflow_count(self) -> int:
        """Serials parked past the reorder window (0 = no overflow)."""
        return 0 if self._reorder is None else self._reorder.parked_count()

    def _account(self, dt: float, n_out: int, n_in: int = 1) -> None:
        with self._stats_lock:
            s = self.stats
            s.consumed += n_in
            s.produced += n_out
            s.busy_time += dt
            s.window_busy += dt

    def _emit(self, payload) -> None:
        if self.batched:
            # payload is (outs, [(offset, marker)]); one downstream call per batch
            outs, markers = payload
            if outs:
                self.downstream_batch(outs, markers)
                return
            for _, m in markers:
                # batch fully filtered: the probes' journeys end here
                m.exit = time.perf_counter()
                if self.on_marker_drop is not None:
                    self.on_marker_drop(m)
            return
        outs, marker = payload
        down = self.downstream
        for j, out in enumerate(outs):
            down(out, marker if j == 0 else None)
        if not outs and marker is not None:
            # Tuple was filtered out: its journey ends here; record exit so the
            # latency probe is not lost. Wired by the pipeline.
            marker.exit = time.perf_counter()
            if self.on_marker_drop is not None:
                self.on_marker_drop(marker)

    on_marker_drop: Optional[Callable[["_Marker"], None]] = None
