# Port copy of src/repro/core/api.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Engine / Plan / Session: the compile → plan → execute public surface.

The paper's core claim is that an adaptive runtime should *map exposed
parallelism onto the machine* — which makes the execution **plan** (stage
cuts, worker widths, ring geometry, predicted load) a first-class artifact,
not a constructor side-effect.  Following BriskStream's design (PAPERS.md),
this module separates the three phases the legacy one-shots fused:

1. **Configure** — :class:`EngineConfig`, a typed, validated config tree
   (:class:`ThreadOptions` / :class:`ProcessOptions` sub-configs).  Every
   knob that used to ride an unvalidated ``**kw`` grab-bag is a declared
   field; :meth:`EngineConfig.from_kwargs` parses the legacy flat keyword
   surface and rejects unknown or conflicting options with a structured
   :class:`ConfigError` (including a did-you-mean hint for typos).

2. **Plan** — ``engine.plan(graph_or_specs)`` returns a backend-agnostic
   :class:`PhysicalPlan`: per-operator predicted cost/flow/load, the process
   backend's stage cuts with cost-model worker widths and exchange-ring
   geometry, and the unstaged parent-tail remainder (the
   :class:`~.procrun.UnstagedGraphWarning` note).  Plans render as text
   (:meth:`PhysicalPlan.explain`), round-trip through plain dicts
   (:meth:`PhysicalPlan.to_dict` / :meth:`PhysicalPlan.from_dict`) for
   caching and test assertions, and can be re-bound to operator callables
   with :meth:`PhysicalPlan.bind`.

3. **Execute** — two surfaces over the same plan:

   - ``engine.run(plan, source)`` drains a finite source and returns a
     uniform :class:`JobResult` (ordered ``outputs``, the
     :class:`~.runtime.RunReport`, and the plan *actually executed* after
     any elastic replans) regardless of backend.
   - ``engine.open(plan)`` returns a streaming :class:`Session`:
     ``push(tuples)`` feeds the pipeline incrementally (the process backend
     feeds the stage-0 exchange live instead of requiring a finite iterable
     up front), ``results()`` iterates ordered egress as it materializes,
     ``stats()`` samples live occupancy, ``close()`` drains and reports.

The deprecated one-shots (:func:`~.runtime.run_pipeline` /
:func:`~.runtime.run_graph`) are thin shims over this path and return a
:class:`JobResult`-backed :class:`JobHandle` so their historical result
surface (``outputs`` / ``egress_count`` / ``markers``) stays identical
across backends.
"""
from __future__ import annotations

import difflib
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from .costmodel import graph_flows, resolve_workers
from .faults import FaultOptions
from .operators import DEVICE, OpSpec, PARTITIONED, STATEFUL
from .pipeline import CompiledPipeline, GraphPipeline
from .procrun import ProcessRuntime, _chain_nodes
from .runtime import RunReport, StreamRuntime
from .scheduler import HEURISTICS

_REORDER_SCHEMES = ("non_blocking", "lock_based")
_WORKLIST_SCHEMES = ("hybrid", "partitioned", "shared")


# ------------------------------------------------------------------- errors
class ConfigError(ValueError):
    """Structured configuration error raised by the Engine surface.

    Carries the offending ``key`` (when one option is to blame) and an
    optional ``suggestion`` (a did-you-mean hint for typos); the formatted
    message includes both.  Subclasses :class:`ValueError` so legacy callers
    catching ``ValueError`` keep working.
    """

    def __init__(self, message: str, *, key: Optional[str] = None,
                 suggestion: Optional[str] = None):
        self.key = key
        self.suggestion = suggestion
        if suggestion:
            message = f"{message} (did you mean {suggestion!r}?)"
        super().__init__(message)


class PlanVerificationError(ConfigError):
    """A :class:`PhysicalPlan` failed the plan-time ordering-safety catalog
    (:mod:`repro.analysis.plancheck`).  Carries the structured ``violations``
    (:class:`~repro.analysis.plancheck.PlanViolation` rows, each with a
    ``PV4xx`` rule id) so callers can branch on specific rules instead of
    parsing the message."""

    def __init__(self, violations):
        self.violations = list(violations)
        lines = "; ".join(v.render() for v in self.violations)
        super().__init__(
            f"plan fails ordering-safety verification: {lines}"
        )


class SessionStarvation(TimeoutError):
    """``Session.results(timeout=...)`` starved past its deadline: no output
    materialized for ``timeout`` continuous seconds while the session was
    still open.  Carries a live ``snapshot`` dict (per-stage widths, backlog
    slots, heartbeat counters, restart/replan counts — whatever the backend's
    ``stats()`` exposes) captured at expiry, so a hang is diagnosable from
    the exception alone; the snapshot is also rendered into the message."""

    def __init__(self, message: str, snapshot: Optional[dict] = None):
        self.snapshot = dict(snapshot or {})
        super().__init__(message)


def _check(cond: bool, message: str, key: Optional[str] = None) -> None:
    if not cond:
        raise ConfigError(message, key=key)


# ------------------------------------------------------------------ configs
@dataclass
class ThreadOptions:
    """Thread-backend options: the central scheduler's dials (paper §6).

    ``heuristic`` picks the scheduling policy (``qst``/``lp``/``et``/``ct``/
    ``adaptive``); ``time_slice`` is the constant worker slice; ``capacity``
    and ``window`` parameterize the QST and CT heuristics; the adaptive
    controller re-estimates costs every ``adapt_interval`` seconds.
    """

    heuristic: str = "ct"
    time_slice: float = 0.002
    capacity: int = 4096
    window: float = 0.05
    adapt_interval: float = 0.02

    def validate(self) -> None:
        """Raise :class:`ConfigError` on any out-of-range field."""
        _check(self.heuristic in HEURISTICS,
               f"unknown heuristic {self.heuristic!r}; pick from {HEURISTICS}",
               key="heuristic")
        _check(self.time_slice > 0, "time_slice must be > 0", key="time_slice")
        _check(self.capacity >= 1, "capacity must be >= 1", key="capacity")
        _check(self.window > 0, "window must be > 0", key="window")
        _check(self.adapt_interval > 0, "adapt_interval must be > 0",
               key="adapt_interval")


@dataclass
class ProcessOptions:
    """Process-backend options: stage planning, exchange-ring geometry, and
    elastic replanning (see :mod:`.procrun` / :mod:`.shm`).

    ``stages`` caps the planner (``None`` = cut as deep as the graph allows,
    ``1`` = the ingress-only plan); ``io_batch`` is the dispatch-unit size
    (defaults to ``batch_size`` when that is > 1, else 32); ``max_inflight``
    bounds in-flight serials (latency throttle); ``ring_slots`` /
    ``slot_bytes`` / ``reorder_payload`` size the shared-memory rings;
    ``worker_budget`` is the total the ``"auto"`` allocator divides (default
    cores + 1); ``elastic`` forces replanning on/off (``None`` = on exactly
    when ``num_workers="auto"``); the ``replan_*`` trio tunes the occupancy
    monitor; ``parent_idle_cap`` caps the supervisor's idle nap.

    Traffic-reactive elasticity dials (see docs/serving.md): the
    ``traffic_*`` group tunes the :class:`~repro.core.TrafficMonitor` that
    turns serving-tier load signals (``SessionMux.load_signals`` snapshots
    arriving via ``Session.offer_load``) into grow/shrink proposals —
    ``traffic_elastic`` arms it (``None`` = on exactly when the runtime is
    elastic; ``True`` additionally forces ``elastic`` on),
    ``traffic_interval`` is the policy evaluation period,
    ``traffic_grow_util`` / ``traffic_shrink_util`` are the hysteresis
    thresholds on predicted stage utilization (shrink must sit strictly
    below grow), ``traffic_patience`` the consecutive qualifying samples
    required, and ``traffic_cooldown`` the post-resize quiet period.
    ``resize_latency_budget`` is the p99 guard: seconds a replan may stall
    the feeder before the supervisor aborts it pre-quiesce (and a
    traffic-triggered resize that completes over budget is undone);
    ``None`` disables the guard.

    Fault-tolerance dials (see ``docs/fault-tolerance.md``):
    ``checkpoint_interval`` is the epoch length in serials for keyed/stateful
    state snapshots (0 disables — those stages then abort the job on a worker
    crash, the pre-checkpoint behavior); ``stall_timeout`` arms the
    hung-process detector (seconds a worker/router heartbeat may freeze
    before it is SIGKILLed into the crash-recovery path; ``None`` = off;
    must exceed the worst single-unit operator time); ``spill_timeout`` is
    the oversized-bundle relay deadline.

    Columnar / device-offload dials (see ``docs/columnar.md``):
    ``columnar`` arms the zero-copy batch path — dispatchers seal numeric
    micro-batches as ``TAG_COLBLOCK`` column blocks instead of pickled
    units (non-conforming batches fall back to pickle per unit);
    ``device_batch`` is the rows-per-dispatch target of ``device``-kind
    stages (clamped up to ``io_batch``); ``device_workers`` is the pinned
    width of every device stage (device widths never resize — batching
    state lives per worker); ``device_inflight`` bounds asynchronous
    dispatches in flight (2 = double-buffering: the newest dispatch
    overlaps host ingest and the oldest batch's compute);
    ``device_backend`` picks the kernel backend: ``cuda`` (the default:
    the hand-written kernels and torch on the card; raises without one),
    ``cpu`` (torch on the CPU through the kernels' plain versions) or
    ``numpy`` (the pure-NumPy reference).  There is no silent fallback.
    """

    stages: Optional[int] = None
    io_batch: Optional[int] = None
    max_inflight: Optional[int] = None
    ring_slots: int = 2048
    slot_bytes: int = 1024
    reorder_payload: int = 4096
    restart_on_crash: bool = True
    worker_budget: Optional[int] = None
    elastic: Optional[bool] = None
    calibrate_tuples: int = 64
    replan_interval: float = 0.25
    replan_threshold: float = 0.55
    replan_patience: int = 3
    traffic_elastic: Optional[bool] = None
    traffic_interval: float = 0.5
    traffic_grow_util: float = 0.85
    traffic_shrink_util: float = 0.30
    traffic_patience: int = 2
    traffic_cooldown: float = 2.0
    resize_latency_budget: Optional[float] = None
    parent_idle_cap: float = 5e-4
    columnar: bool = False
    device_batch: int = 256
    device_workers: int = 1
    device_inflight: int = 2
    device_backend: str = "cuda"
    checkpoint_interval: int = 1024
    stall_timeout: Optional[float] = None
    spill_timeout: float = 10.0

    def validate(self) -> None:
        """Raise :class:`ConfigError` on any out-of-range field."""
        _check(self.stages is None or self.stages >= 1,
               "stages must be None or >= 1", key="stages")
        _check(self.io_batch is None or self.io_batch >= 1,
               "io_batch must be None or >= 1", key="io_batch")
        _check(self.max_inflight is None or self.max_inflight >= 1,
               "max_inflight must be None or >= 1", key="max_inflight")
        _check(self.ring_slots >= 4, "ring_slots must be >= 4", key="ring_slots")
        _check(self.slot_bytes >= 64, "slot_bytes must be >= 64",
               key="slot_bytes")
        _check(self.reorder_payload >= 16, "reorder_payload must be >= 16",
               key="reorder_payload")
        _check(self.worker_budget is None or self.worker_budget >= 1,
               "worker_budget must be None or >= 1", key="worker_budget")
        _check(self.calibrate_tuples >= 0, "calibrate_tuples must be >= 0",
               key="calibrate_tuples")
        _check(self.replan_interval > 0, "replan_interval must be > 0",
               key="replan_interval")
        _check(0 < self.replan_threshold <= 1,
               "replan_threshold must be in (0, 1]", key="replan_threshold")
        _check(self.replan_patience >= 1, "replan_patience must be >= 1",
               key="replan_patience")
        _check(
            self.traffic_elastic is not True or self.elastic is not False,
            "traffic_elastic=True requires elastic replanning "
            "(elastic must not be False)",
            key="traffic_elastic",
        )
        _check(self.traffic_interval > 0, "traffic_interval must be > 0",
               key="traffic_interval")
        _check(self.traffic_grow_util > 0, "traffic_grow_util must be > 0",
               key="traffic_grow_util")
        _check(
            0 < self.traffic_shrink_util < self.traffic_grow_util,
            "traffic_shrink_util must be in (0, traffic_grow_util) — the "
            "hysteresis band must be non-empty",
            key="traffic_shrink_util",
        )
        _check(self.traffic_patience >= 1, "traffic_patience must be >= 1",
               key="traffic_patience")
        _check(self.traffic_cooldown >= 0, "traffic_cooldown must be >= 0",
               key="traffic_cooldown")
        _check(
            self.resize_latency_budget is None
            or self.resize_latency_budget > 0,
            "resize_latency_budget must be None (guard off) or > 0",
            key="resize_latency_budget",
        )
        _check(self.parent_idle_cap > 0, "parent_idle_cap must be > 0",
               key="parent_idle_cap")
        _check(isinstance(self.columnar, bool),
               "columnar must be a bool", key="columnar")
        _check(
            isinstance(self.device_batch, int) and self.device_batch >= 1,
            "device_batch must be an int >= 1", key="device_batch",
        )
        _check(
            isinstance(self.device_workers, int) and self.device_workers >= 1,
            "device_workers must be an int >= 1", key="device_workers",
        )
        _check(
            isinstance(self.device_inflight, int)
            and self.device_inflight >= 1,
            "device_inflight must be an int >= 1", key="device_inflight",
        )
        _check(
            self.device_backend in ("cuda", "cpu", "numpy"),
            "device_backend must be one of cuda|cpu|numpy",
            key="device_backend",
        )
        _check(
            isinstance(self.checkpoint_interval, int)
            and self.checkpoint_interval >= 0,
            "checkpoint_interval must be an int >= 0 (0 disables epochs)",
            key="checkpoint_interval",
        )
        _check(self.stall_timeout is None or self.stall_timeout > 0,
               "stall_timeout must be None (off) or > 0", key="stall_timeout")
        _check(self.spill_timeout > 0, "spill_timeout must be > 0",
               key="spill_timeout")


_COMMON_KEYS = (
    "backend", "num_workers", "batch_size", "marker_interval",
    "collect_outputs", "reorder_scheme", "worklist_scheme", "reorder_size",
    "cost_priors",
)
_THREAD_KEYS = tuple(f.name for f in fields(ThreadOptions))
_PROCESS_KEYS = tuple(f.name for f in fields(ProcessOptions))
_ALL_KEYS = _COMMON_KEYS + _THREAD_KEYS + _PROCESS_KEYS


@dataclass
class EngineConfig:
    """Validated engine configuration: backend selection plus every knob the
    runtimes accept, as declared fields instead of a ``**kw`` grab-bag.

    Common fields configure both backends (``num_workers`` takes an int or
    ``"auto"`` for cost-model allocation; ``batch_size`` is the micro-batch
    unit; ``cost_priors`` maps op names to per-tuple µs overriding declared
    priors).  Backend-specific dials live in the ``thread`` /
    ``process`` sub-configs — both are always present, so one config can
    A/B the two backends by flipping ``backend`` alone.  Build directly, or
    from the legacy flat keyword surface via :meth:`from_kwargs` (which
    rejects unknown/conflicting keys with :class:`ConfigError`).
    """

    backend: str = "thread"
    num_workers: Union[int, str] = 4
    batch_size: int = 1
    marker_interval: int = 64
    collect_outputs: bool = False
    reorder_scheme: str = "non_blocking"
    worklist_scheme: str = "hybrid"
    reorder_size: int = 1024
    cost_priors: Optional[Dict[str, float]] = None
    thread: ThreadOptions = field(default_factory=ThreadOptions)
    process: ProcessOptions = field(default_factory=ProcessOptions)
    #: fault-injection schedule + per-op on_error policy (process backend;
    #: see core/faults.py and docs/fault-tolerance.md)
    faults: FaultOptions = field(default_factory=FaultOptions)

    # ------------------------------------------------------------- parsing
    @classmethod
    def from_kwargs(cls, **kw) -> "EngineConfig":
        """Build a config from the legacy flat keyword surface.

        Routes each key to the right (sub-)config field.  Unknown keys raise
        :class:`ConfigError` with a did-you-mean hint; process-only keys
        combined with ``backend="thread"`` raise a conflict error (they were
        silently meaningless before this surface existed).  Thread-scheduler
        keys are accepted alongside ``backend="process"`` — the config
        carries both sub-configs precisely so one object can drive either
        backend — but only the selected backend reads its own section.
        """
        backend = kw.get("backend", "thread")
        common: Dict[str, Any] = {}
        thread_kw: Dict[str, Any] = {}
        process_kw: Dict[str, Any] = {}
        subs: Dict[str, Any] = {}
        for key, value in kw.items():
            if key in ("thread", "process", "faults"):  # whole sub-configs
                subs[key] = value
            elif key in _COMMON_KEYS:
                common[key] = value
            elif key in _THREAD_KEYS:
                thread_kw[key] = value
            elif key in _PROCESS_KEYS:
                if backend == "thread":
                    raise ConfigError(
                        f"option {key!r} is process-backend-only but "
                        "backend='thread' is selected; pass "
                        "backend='process' or drop it",
                        key=key,
                    )
                process_kw[key] = value
            else:
                hits = difflib.get_close_matches(key, _ALL_KEYS, n=1)
                raise ConfigError(
                    f"unknown option {key!r}",
                    key=key,
                    suggestion=hits[0] if hits else None,
                )
        for name, flat in (("thread", thread_kw), ("process", process_kw)):
            if name in subs and flat:
                raise ConfigError(
                    f"pass {name} options either flat or as a {name}= "
                    "sub-config, not both",
                    key=sorted(flat)[0],
                )
        thread = subs.get("thread", None)
        process = subs.get("process", None)
        faults = subs.get("faults", None)
        cfg = cls(
            thread=thread if thread is not None else ThreadOptions(**thread_kw),
            process=(
                process if process is not None else ProcessOptions(**process_kw)
            ),
            faults=faults if faults is not None else FaultOptions(),
            **common,
        )
        cfg.validate()
        return cfg

    # ---------------------------------------------------------- validation
    def validate(self) -> "EngineConfig":
        """Validate every field (including sub-configs); returns ``self`` so
        construction sites can chain.  Raises :class:`ConfigError`."""
        if isinstance(self.thread, dict):  # convenience: accept plain dicts
            self.thread = ThreadOptions(**self.thread)
        if isinstance(self.process, dict):
            self.process = ProcessOptions(**self.process)
        if isinstance(self.faults, dict):
            self.faults = FaultOptions.from_dict(self.faults)
        _check(isinstance(self.faults, FaultOptions),
               f"faults must be a FaultOptions, got "
               f"{type(self.faults).__name__}", key="faults")
        try:
            self.faults.validate()
        except ValueError as exc:
            raise ConfigError(str(exc), key="faults") from None
        _check(isinstance(self.thread, ThreadOptions),
               f"thread must be a ThreadOptions, got "
               f"{type(self.thread).__name__}", key="thread")
        _check(isinstance(self.process, ProcessOptions),
               f"process must be a ProcessOptions, got "
               f"{type(self.process).__name__}", key="process")
        _check(self.backend in ("thread", "process"),
               f"unknown backend {self.backend!r} (thread | process)",
               key="backend")
        if self.num_workers != "auto":
            _check(
                isinstance(self.num_workers, int) and self.num_workers >= 1,
                "num_workers must be a positive int or 'auto', got "
                f"{self.num_workers!r}",
                key="num_workers",
            )
        _check(isinstance(self.batch_size, int) and self.batch_size >= 1,
               "batch_size must be an int >= 1", key="batch_size")
        _check(isinstance(self.marker_interval, int) and self.marker_interval >= 0,
               "marker_interval must be an int >= 0", key="marker_interval")
        _check(self.reorder_scheme in _REORDER_SCHEMES,
               f"unknown reorder_scheme {self.reorder_scheme!r}; "
               f"pick from {_REORDER_SCHEMES}", key="reorder_scheme")
        _check(self.worklist_scheme in _WORKLIST_SCHEMES,
               f"unknown worklist_scheme {self.worklist_scheme!r}; "
               f"pick from {_WORKLIST_SCHEMES}", key="worklist_scheme")
        _check(isinstance(self.reorder_size, int) and self.reorder_size >= 2,
               "reorder_size must be an int >= 2", key="reorder_size")
        if self.cost_priors is not None:
            _check(
                isinstance(self.cost_priors, dict)
                and all(
                    isinstance(k, str) and isinstance(v, (int, float))
                    for k, v in self.cost_priors.items()
                ),
                "cost_priors must map op names to per-tuple µs numbers",
                key="cost_priors",
            )
        self.thread.validate()
        self.process.validate()
        return self

    # --------------------------------------------------------- round-trip
    def to_dict(self) -> dict:
        """Plain-dict form (JSON-able); inverse of :meth:`from_dict`."""
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        """Rebuild a config from :meth:`to_dict` output (validated)."""
        d = dict(d)
        thread = ThreadOptions(**d.pop("thread", {}))
        process = ProcessOptions(**d.pop("process", {}))
        faults = FaultOptions.from_dict(d.pop("faults", None) or {})
        return cls(
            thread=thread, process=process, faults=faults, **d
        ).validate()


# ------------------------------------------------------------------- plans
@dataclass
class PlannedOp:
    """One operator's predicted profile inside a :class:`PhysicalPlan`:
    relative input ``flow`` (tuples per source tuple), per-tuple ``cost_us``,
    declared ``selectivity``, the ``load_share`` fraction of total predicted
    work, and the intrinsic parallelism cap ``max_dop`` (``None`` =
    unbounded — stateless operators).  ``schema_width`` is the declared
    columnar field count of ``device``-kind operators (``None``
    otherwise)."""

    name: str
    kind: str
    cost_us: float
    selectivity: float
    flow: float
    load_share: float
    max_dop: Optional[int] = None
    schema_width: Optional[int] = None


@dataclass
class PlannedStage:
    """One process-backend stage cut inside a :class:`PhysicalPlan`: the
    operator run it executes, its allocated worker-group width (``workers``,
    from the cost model under ``num_workers="auto"``), the elastic headroom
    (``max_workers``), the predicted per-tuple ``cost_us`` / relative
    ``flow`` / ``load_share`` driving the allocation, and whether the stage
    participates in epoch checkpointing (``checkpointed`` — keyed, stateful,
    and device stages with a non-zero ``checkpoint_interval`` and crash
    restarts on)."""

    index: int
    kind: str
    ops: List[str]
    workers: int
    max_workers: int
    cost_us: float
    flow: float
    load_share: float
    checkpointed: bool = False


class PhysicalPlan:
    """Backend-agnostic execution plan: the inspectable artifact between
    ``engine.plan(...)`` and ``engine.run(...)`` / ``engine.open(...)``.

    Carries the per-operator predicted profile (``ops``), the routing-node
    names (``routing``), and — for the process backend — the stage cuts with
    cost-model worker widths (``stages``), the exchange-ring geometry
    (``ring``), and the unstaged parent-tail node names (``unstaged``).
    ``explain()`` renders a stable text form (golden-testable);
    ``to_dict()`` / ``from_dict()`` round-trip the plan through plain dicts
    so it can be cached or asserted on.  A plan deserialized from a dict is
    *unbound* (operator callables cannot be serialized); re-attach the graph
    with :meth:`bind` before executing it.
    """

    def __init__(
        self,
        *,
        backend: str,
        config: EngineConfig,
        ops: Sequence[PlannedOp],
        routing: Sequence[str] = (),
        stages: Sequence[PlannedStage] = (),
        unstaged: Sequence[str] = (),
        ring: Optional[Dict[str, int]] = None,
        worker_budget: Optional[int] = None,
        graph: Optional[Tuple[dict, list]] = None,
    ):
        self.backend = backend
        self.config = config
        self.ops = list(ops)
        self.routing = list(routing)
        self.stages = list(stages)
        self.unstaged = list(unstaged)
        self.ring = dict(ring) if ring else None
        self.worker_budget = worker_budget
        self._graph = graph  # (nodes, edges) with live callables; not serialized

    # ------------------------------------------------------------- binding
    @property
    def bound(self) -> bool:
        """Whether the plan still references live operator callables."""
        return self._graph is not None

    @property
    def graph(self) -> Tuple[dict, list]:
        """The bound ``(nodes, edges)`` graph; raises if the plan came from
        :meth:`from_dict` and was never :meth:`bind`-ed."""
        if self._graph is None:
            raise ConfigError(
                "plan is unbound (deserialized from a dict); call "
                "plan.bind(graph_or_specs) to re-attach operator callables"
            )
        return self._graph

    def bind(self, graph, edges=None) -> "PhysicalPlan":
        """Re-attach operator callables to a deserialized plan.  Accepts the
        same graph forms as :meth:`Engine.plan`; node names and kinds must
        match the plan's recorded operator rows.  Returns ``self``."""
        nodes, edge_list, _specs = _normalize_graph(graph, edges)
        got = [
            (spec.name, spec.kind) for _n, spec in _topo_ops(nodes, edge_list)
        ]
        want = [(op.name, op.kind) for op in self.ops]
        if got != want:
            raise ConfigError(
                f"graph ops {got} do not match the plan's {want}"
            )
        self._graph = (nodes, edge_list)
        return self

    # ---------------------------------------------------------- rendering
    def explain(self) -> str:
        """Deterministic text rendering of the plan.  Stable across hosts
        when the config pins every machine-derived input — in particular
        pass an explicit ``worker_budget`` (and an int ``num_workers``)
        for golden tests: the ``"auto"`` defaults read the host's core
        count, which would leak into the budget line and the widths."""
        c = self.config
        lines = [f"PhysicalPlan backend={self.backend}"]
        if self.backend == "process":
            lines.append(
                f"  workers: num_workers={c.num_workers} "
                f"budget={self.worker_budget}"
            )
        else:
            lines.append(
                f"  workers: num_workers={c.num_workers} "
                f"heuristic={c.thread.heuristic}"
            )
        lines.append(
            f"  batching: batch_size={c.batch_size} "
            f"marker_interval={c.marker_interval}"
        )
        lines.append(
            f"  ordering: reorder={c.reorder_scheme}/{c.reorder_size} "
            f"worklist={c.worklist_scheme}"
        )
        lines.append("  ops:")
        lines.append(
            "    name                 kind          cost_us    flow   sel"
            "    load%"
        )
        for op in self.ops:
            lines.append(
                f"    {op.name:<20} {op.kind:<12} {op.cost_us:>8.1f} "
                f"{op.flow:>7.2f} {op.selectivity:>5.2f} "
                f"{op.load_share * 100:>7.1f}%"
            )
        if self.routing:
            lines.append(f"  routing nodes: {', '.join(self.routing)}")
        if self.backend == "process":
            lines.append("  stages:")
            for s in self.stages:
                ops = ", ".join(s.ops) or "<identity>"
                lines.append(
                    f"    s{s.index} {s.kind:<9} x{s.workers} "
                    f"(max {s.max_workers})  cost={s.cost_us:.1f}us "
                    f"flow={s.flow:.2f} load={s.load_share * 100:.1f}%  "
                    f"ops=[{ops}]"
                )
            r = self.ring or {}
            lines.append(
                f"  exchange: io_batch={r.get('io_batch')} "
                f"max_inflight={r.get('max_inflight')} "
                f"ring_slots={r.get('ring_slots')} "
                f"slot_bytes={r.get('slot_bytes')} "
                f"reorder_size={r.get('reorder_size')} "
                f"reorder_payload={r.get('reorder_payload')}"
            )
            p = c.process
            dev_stages = [s for s in self.stages if s.kind == "device"]
            if r.get("columnar") or dev_stages:
                bits = [f"columnar={'on' if r.get('columnar') else 'off'}"]
                if dev_stages:
                    bits.append(
                        f"device_batch={r.get('device_batch')} "
                        f"device_workers={r.get('device_workers')} "
                        f"device_inflight={r.get('device_inflight')} "
                        f"backend={p.device_backend}"
                    )
                lines.append(f"  columnar: {' '.join(bits)}")
            ckpt = [
                f"s{s.index}" for s in self.stages
                if getattr(s, "checkpointed", False)
            ]
            if ckpt:
                lines.append(
                    f"  checkpoint: interval="
                    f"{r.get('checkpoint_interval') or p.checkpoint_interval} "
                    f"stages=[{', '.join(ckpt)}] "
                    f"stall_timeout={p.stall_timeout}"
                )
            else:
                why = (
                    "disabled"
                    if p.checkpoint_interval == 0 or not p.restart_on_crash
                    else "no keyed/stateful/device stage"
                )
                lines.append(f"  checkpoint: off ({why})")
            elastic_on = (
                p.elastic if p.elastic is not None
                else c.num_workers == "auto"
            ) or p.traffic_elastic is True
            traffic_on = (
                p.traffic_elastic if p.traffic_elastic is not None
                else elastic_on
            )
            if traffic_on:
                guard = (
                    "off" if p.resize_latency_budget is None
                    else f"{p.resize_latency_budget:g}s"
                )
                lines.append(
                    f"  elasticity: traffic=on "
                    f"interval={p.traffic_interval:g}s "
                    f"grow>{p.traffic_grow_util:g} "
                    f"shrink<{p.traffic_shrink_util:g} "
                    f"patience={p.traffic_patience} "
                    f"cooldown={p.traffic_cooldown:g}s guard={guard}"
                )
            else:
                why = "static widths" if not elastic_on else "disabled"
                lines.append(f"  elasticity: traffic=off ({why})")
            if self.unstaged:
                # execution warns only when routing nodes land in the tail
                # (a stages=N cap can strand plain ops there silently)
                warns = any(n in self.routing for n in self.unstaged)
                note = " (UnstagedGraphWarning)" if warns else ""
                lines.append(
                    f"  tail: {', '.join(self.unstaged)} run serially in "
                    f"the parent{note}"
                )
            else:
                lines.append("  tail: none (fully staged)")
        from ..analysis.plancheck import CATALOG_VERSION  # lazy: no cycle

        violations = self.verify(raise_on_violation=False)
        if violations:
            rules = ", ".join(sorted({v.rule for v in violations}))
            lines.append(
                f"  ordering-safety: {len(violations)} violation(s) "
                f"[{rules}] (catalog v{CATALOG_VERSION})"
            )
        else:
            lines.append(
                f"  ordering-safety: verified OK (catalog v{CATALOG_VERSION})"
            )
        return "\n".join(lines)

    # ---------------------------------------------------------- round-trip
    def to_dict(self) -> dict:
        """Plain-dict (JSON-able) form of everything but the operator
        callables; inverse of :meth:`from_dict`."""
        return {
            "version": 1,
            "backend": self.backend,
            "config": self.config.to_dict(),
            "ops": [asdict(op) for op in self.ops],
            "routing": list(self.routing),
            "stages": [asdict(s) for s in self.stages],
            "unstaged": list(self.unstaged),
            "ring": dict(self.ring) if self.ring else None,
            "worker_budget": self.worker_budget,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PhysicalPlan":
        """Rebuild an (unbound) plan from :meth:`to_dict` output."""
        if d.get("version") != 1:
            raise ConfigError(f"unknown plan version {d.get('version')!r}")
        return cls(
            backend=d["backend"],
            config=EngineConfig.from_dict(d["config"]),
            ops=[PlannedOp(**op) for op in d["ops"]],
            routing=d.get("routing", ()),
            stages=[PlannedStage(**s) for s in d.get("stages", ())],
            unstaged=d.get("unstaged", ()),
            ring=d.get("ring"),
            worker_budget=d.get("worker_budget"),
        )

    # -------------------------------------------------------- verification
    def verify(self, *, raise_on_violation: bool = True):
        """Check the plan against the ordering-safety rule catalog
        (:mod:`repro.analysis.plancheck`, rules PV401–PV406): stage widths
        vs. operator kinds, reorder-ring geometry vs. publish span, elastic
        headroom.  Every plan :meth:`Engine.plan` builds passes by
        construction; a hand-built or deserialized-and-edited plan may not.

        Returns the violation list (empty = safe).  With
        ``raise_on_violation`` (the default) a non-empty list raises
        :class:`PlanVerificationError` instead, carrying the structured
        violations.
        """
        from ..analysis.plancheck import verify_plan  # lazy: no cycle

        violations = verify_plan(self)
        if violations and raise_on_violation:
            raise PlanVerificationError(violations)
        return violations

    def stage_widths(self) -> List[int]:
        """Planned per-stage worker-group widths (process backend)."""
        return [s.workers for s in self.stages]

    def __repr__(self) -> str:
        return (
            f"<PhysicalPlan backend={self.backend} ops={len(self.ops)} "
            f"stages={len(self.stages)} bound={self.bound}>"
        )


# ------------------------------------------------------- graph normalization
def _normalize_graph(graph, edges=None):
    """Accept the ``Engine.plan`` graph forms and return
    ``(nodes, edges, chain_specs_or_None)``."""
    if edges is not None:
        return dict(graph), [tuple(e) for e in edges], None
    if (
        isinstance(graph, tuple) and len(graph) == 2
        and isinstance(graph[0], dict)
    ):  # (nodes, edges) — a 2-tuple of OpSpecs is a chain, not a graph pair
        nodes, edge_list = graph
        return dict(nodes), [tuple(e) for e in edge_list], None
    if isinstance(graph, dict):
        raise ConfigError(
            "a node dict needs its edge list: pass plan(nodes, edges) or "
            "plan((nodes, edges))"
        )
    specs = list(graph)
    if not specs:
        raise ConfigError("pipeline needs at least one operator")
    for s in specs:
        if not isinstance(s, OpSpec):
            raise ConfigError(
                f"expected OpSpec elements in the chain, got {type(s).__name__}"
            )
    nodes, edge_list = _chain_nodes(specs)
    return nodes, edge_list, specs


def _topo_ops(nodes, edges):
    """(name, spec) for every OpSpec node in topological order."""
    rows, _routing = graph_flows(nodes, edges, None)
    return [(name, spec) for name, spec, _flow, _cost in rows]


# ----------------------------------------------------------------- results
@dataclass
class JobResult:
    """Uniform result of ``engine.run``: ordered ``outputs`` (empty unless
    ``collect_outputs``), the :class:`~.runtime.RunReport`, the
    :class:`PhysicalPlan` actually executed (post elastic replans), latency
    ``markers``, the ``egress_count``, and the elastic/crash instrumentation
    counters (``recoveries`` counts completed crash recoveries — group
    restores and router re-forks; ``dead_letters`` holds the
    :class:`~.faults.DeadLetter` tuples quarantined under the
    ``on_error="dead_letter"`` policy).  ``handle()`` wraps it in the
    legacy-shaped proxy."""

    outputs: list
    report: RunReport
    plan: PhysicalPlan
    markers: list
    egress_count: int
    replans: int = 0
    restarts: int = 0
    recoveries: int = 0
    dead_letters: list = field(default_factory=list)
    target: Any = field(default=None, repr=False)  # executed pipeline/runtime

    def handle(self) -> "JobHandle":
        """The legacy result proxy (see :class:`JobHandle`)."""
        return JobHandle(self)


class JobHandle:
    """:class:`JobResult`-backed proxy with the legacy "pipeline" surface.

    The deprecated one-shots used to return a different object per backend
    (``CompiledPipeline`` / ``GraphPipeline`` vs ``ProcessRuntime``); this
    proxy exposes the documented result attributes — ``outputs``,
    ``egress_count``, ``markers`` — identically for both, plus ``result``
    (the full :class:`JobResult`) and attribute pass-through to the executed
    pipeline/runtime for backend-specific introspection
    (``num_stages``, ``stage_widths()``, ``cost_model``, ...).
    """

    def __init__(self, result: JobResult):
        self._result = result

    @property
    def result(self) -> JobResult:
        """The full :class:`JobResult` behind this proxy."""
        return self._result

    @property
    def outputs(self) -> list:
        """Ordered egress tuples (``collect_outputs=True`` runs only)."""
        return self._result.outputs

    @property
    def egress_count(self) -> int:
        """Total tuples egressed by the run."""
        return self._result.egress_count

    @property
    def markers(self) -> list:
        """Latency probe markers recorded during the run (paper §7)."""
        return self._result.markers

    def __getattr__(self, name: str):
        target = object.__getattribute__(self, "_result").target
        if target is None:
            raise AttributeError(name)
        return getattr(target, name)

    def __repr__(self) -> str:
        return f"<JobHandle {self._result.plan!r} out={self._result.egress_count}>"


# ----------------------------------------------------------------- session
class Session:
    """Streaming execution handle returned by ``engine.open(plan)``.

    Protocol: ``push(tuples)`` feeds the pipeline incrementally (blocking
    backpressure once the in-flight window fills), ``results()`` iterates
    ordered egress as it materializes, ``stats()`` samples live state, and
    ``close()`` seals the input, drains every in-flight tuple, tears the
    backend down, and returns the final :class:`~.runtime.RunReport` (also
    stored as ``session.report``).  Context-manager aware (``with
    engine.open(plan) as s: ...`` closes on exit, aborting on error).
    Sessions force ``collect_outputs`` on so egress is observable; one
    caller thread drives a session (its methods are not re-entrant).
    """

    backend = "?"

    def __init__(self):
        self.report: Optional[RunReport] = None
        self._pushed = 0
        self._cursor = 0  # absolute egress index of the next unread output
        self._trimmed = 0  # outputs already released from the backing list
        self._closed = False
        self._aborted = False  # error-path teardown: backend state is gone
        self._t0 = time.perf_counter()

    # -- surface ------------------------------------------------------------
    #: consumed-prefix length at which results() trims the backing output
    #: list — long-lived serving sessions must not hold every egressed tuple
    _TRIM_THRESHOLD = 4096

    def push(self, tuples: Iterable[Any]) -> int:
        """Feed an iterable of tuples into the live pipeline, in order;
        returns how many were pushed.  Blocks (backpressure) when the
        backend's in-flight window is full.  Raises ``RuntimeError`` once
        the session is closed (or when a worker failed)."""
        if self._closed:
            raise RuntimeError("session is closed")
        n = 0
        for value in tuples:
            self._push_one(value)
            n += 1
            self._pushed += 1  # counted per tuple: a mid-iterable failure
            # must not uncount tuples that already entered the pipeline
        return n

    def try_push(self, value: Any) -> bool:
        """Non-blocking single-tuple push: ``True`` if the tuple entered the
        pipeline, ``False`` if the backend's in-flight window is full right
        now (the caller may retry, service results, or shed load).  This is
        the ingress primitive multiplexers build fairness on — a blocked
        ``push()`` would hold *every* queued session hostage to global
        backpressure, ``try_push`` lets the caller keep draining egress
        while the window is full.  Raises like :meth:`push` once closed."""
        if self._closed:
            raise RuntimeError("session is closed")
        if not self._try_push_one(value):
            return False
        self._pushed += 1
        return True

    def poll(self, max_items: Optional[int] = None) -> list:
        """Non-blocking egress read: return (and consume) whatever ordered
        outputs have already materialized — possibly ``[]`` — without ever
        waiting.  Shares the exactly-once cursor with :meth:`results`; use
        one or the other per drain phase, not both concurrently.  Unlike
        ``results()`` this never services the backend, so a process-backend
        caller interleaving only ``try_push``/``poll`` should expect to see
        progress ride on its pushes."""
        if self._aborted:
            raise RuntimeError(
                "session was aborted (error-path teardown); "
                "results are unavailable"
            )
        consumed = self._cursor - self._trimmed
        if consumed >= self._TRIM_THRESHOLD:
            self._discard_consumed(consumed)
            self._trimmed = self._cursor
            consumed = 0
        batch = self._outputs_since(consumed)
        if max_items is not None:
            batch = batch[:max_items]
        self._cursor += len(batch)
        return batch

    def service(self) -> None:
        """One liveness crank for non-blocking drivers.

        Callers that interleave :meth:`try_push` / :meth:`poll` (instead of
        the blocking ``results()`` loop, which services internally) must
        call this when idle: it flushes partial ingress micro-batches and —
        on the process backend — cranks the single-threaded parent
        supervisor, without which nothing would ever egress."""
        self._idle_service(64)

    def results(self, max_items: Optional[int] = None,
                timeout: Optional[float] = None) -> Iterator[Any]:
        """Iterate ordered egress tuples as they materialize.

        Yields every output exactly once across all ``results()`` calls, in
        egress (= serial) order.  The iterator ends when the session is
        closed and fully drained; before that it waits for more output —
        bounded by ``timeout`` seconds of *continuous* starvation when given
        (the clock resets whenever an output arrives; on expiry it raises
        :class:`SessionStarvation` carrying a live per-stage backlog/
        heartbeat snapshot).  ``max_items`` bounds this call.  Consumed outputs
        are released from memory as the iterator advances, so an indefinite
        session stays bounded by its in-flight window, not its history.
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        yielded = 0
        starved = 0
        while max_items is None or yielded < max_items:
            if self._aborted:
                raise RuntimeError(
                    "session was aborted (error-path teardown); "
                    "results are unavailable"
                )
            consumed = self._cursor - self._trimmed
            if consumed >= self._TRIM_THRESHOLD:
                self._discard_consumed(consumed)
                self._trimmed = self._cursor
                consumed = 0
            batch = self._outputs_since(consumed)
            if batch:
                starved = 0
                if timeout is not None:  # starvation clock resets on arrival
                    deadline = time.perf_counter() + timeout
                for value in batch:
                    self._cursor += 1
                    yielded += 1
                    yield value
                    if max_items is not None and yielded >= max_items:
                        return
                continue
            if self._drained_after_close():
                return
            if deadline is not None and time.perf_counter() > deadline:
                snap = self._starvation_snapshot()
                raise SessionStarvation(
                    f"session.results() starved: no output for {timeout}s "
                    f"(pushed={self._pushed}, egressed so far="
                    f"{self._cursor}); live snapshot: {snap}",
                    snapshot=snap,
                )
            starved += 1
            self._idle_service(starved)

    def stats(self) -> dict:
        """Live counters: tuples pushed/egressed plus backend-specific
        occupancy (scheduler snapshot or stage widths/backlog)."""
        raise NotImplementedError

    def offer_load(self, signals: dict) -> None:
        """Feed a serving-tier load snapshot to the backend.

        ``signals`` is a :meth:`repro.serve.SessionMux.load_signals`-shaped
        dict (``ts``, ``sessions``, ``admitted_total``, ``ingress_queued``,
        ``backpressured``).  The process backend forwards it to the
        traffic-reactive elasticity policy
        (:class:`~repro.core.TrafficMonitor`); other backends ignore it.
        Must be called from the thread that owns the session."""

    def service_once(self) -> bool:
        """One *non-blocking* backend progress crank; ``True`` if it did work.

        Unlike :meth:`service` this never sleeps and never flushes partial
        micro-batches, so a pump loop may call it every iteration: on the
        process backend it advances the single-threaded parent supervisor
        (whose progress would otherwise ration on ``try_push``/``poll``
        side effects under steady paced traffic); on backends whose workers
        make progress on their own threads it is a no-op."""
        return False

    def close(self, drain_timeout: float = 60.0) -> RunReport:
        """Seal the input, drain every in-flight tuple, stop the backend,
        and return the final report (idempotent)."""
        raise NotImplementedError

    # -- plumbing (backend hooks) --------------------------------------------
    # _outputs_since/_discard_consumed index into the backing output list
    # RELATIVE to the already-trimmed prefix (the base class does the
    # absolute-cursor bookkeeping).
    def _push_one(self, value: Any) -> None:
        raise NotImplementedError

    def _try_push_one(self, value: Any) -> bool:
        raise NotImplementedError

    def _outputs_since(self, cursor: int) -> list:
        raise NotImplementedError

    def _discard_consumed(self, n: int) -> None:
        raise NotImplementedError

    def _drained_after_close(self) -> bool:
        raise NotImplementedError

    def _idle_service(self, starved: int) -> None:
        raise NotImplementedError

    def _starvation_snapshot(self) -> dict:
        """Live state attached to :class:`SessionStarvation`; backends with
        richer liveness signals (heartbeats, backlog) extend ``stats()``."""
        try:
            return self.stats()
        except Exception:  # diagnostics must not mask the starvation raise
            return {}

    def _abort(self) -> None:
        raise NotImplementedError

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            if not self._closed:
                self.close()
        else:  # error path: tear down without insisting on a clean drain
            self._abort()


class _ThreadSession(Session):
    """Session over the threaded runtime: worker threads process pushes
    concurrently; reads snapshot the pipeline's ordered output list."""

    backend = "thread"

    def __init__(self, pipeline: GraphPipeline, runtime: StreamRuntime):
        super().__init__()
        self._pipe = pipeline
        self._rt = runtime
        # Input-side backpressure bound: worklists are unbounded deques, so
        # without a gate an over-fast producer grows them without limit —
        # the same indefinite-session leak the output-side trim closes.
        self._inflight_cap = max(
            2 * getattr(pipeline, "batch_size", 1) * 64,
            2048,
        )
        # the gate's worklist sweep costs O(n_ops) locks: amortize it over
        # _GATE_EVERY pushes (backlog bound becomes cap + _GATE_EVERY)
        self._gate_left = 0
        runtime.start()

    _GATE_EVERY = 64

    def _push_one(self, value: Any) -> None:
        pipe = self._pipe
        if self._gate_left <= 0:
            self._gate_left = self._GATE_EVERY
            while sum(n.worklist_size() for n in pipe.nodes) >= self._inflight_cap:
                if self._rt.worker_error is not None:
                    raise RuntimeError(
                        f"worker failed: {self._rt.worker_error!r}"
                    ) from self._rt.worker_error
                time.sleep(1e-4)  # workers drain concurrently; no deadlock
        self._gate_left -= 1
        pipe.push(value)

    def _try_push_one(self, value: Any) -> bool:
        # same amortized gate as _push_one, but a closed gate reports False
        # instead of spinning; the re-check happens on the next attempt
        if self._gate_left <= 0:
            if self._rt.worker_error is not None:
                raise RuntimeError(
                    f"worker failed: {self._rt.worker_error!r}"
                ) from self._rt.worker_error
            pipe = self._pipe
            if sum(n.worklist_size() for n in pipe.nodes) >= self._inflight_cap:
                return False
            self._gate_left = self._GATE_EVERY
        self._gate_left -= 1
        self._pipe.push(value)
        return True

    def _outputs_since(self, cursor: int) -> list:
        return self._pipe.outputs_since(cursor)

    def _discard_consumed(self, n: int) -> None:
        self._pipe.consume_outputs(n)

    def _drained_after_close(self) -> bool:
        return self._closed and self._pipe.drained()

    def _idle_service(self, starved: int) -> None:
        if self._rt.worker_error is not None:
            raise RuntimeError(
                f"worker failed: {self._rt.worker_error!r}"
            ) from self._rt.worker_error
        if starved % 64 == 0:
            # liveness under micro-batching: a partial ingress batch can hold
            # the very tuples a results() reader is waiting for
            self._pipe.flush()
        time.sleep(1e-4)

    def stats(self) -> dict:
        """Live thread-backend counters (see :meth:`Session.stats`)."""
        return {
            "backend": self.backend,
            "closed": self._closed,
            "pushed": self._pushed,
            "egressed": self._pipe.egress_count,
            "workers": self._rt.num_workers,
            "ops": self._rt.scheduler.snapshot(),
        }

    def close(self, drain_timeout: float = 60.0) -> RunReport:
        """Flush, drain, stop the worker threads, report (idempotent)."""
        if self._closed:
            if self.report is None:
                raise RuntimeError("session aborted before close()")
            return self.report
        self._closed = True
        self._pipe.flush()
        deadline = time.perf_counter() + drain_timeout
        while not self._pipe.drained():
            if self._rt.worker_error is not None:
                self._abort()
                raise RuntimeError(
                    f"worker failed: {self._rt.worker_error!r}"
                ) from self._rt.worker_error
            if time.perf_counter() > deadline:
                self._rt.stop()
                raise TimeoutError("session failed to drain")
            time.sleep(1e-4)
        self._rt.stop()
        self.report = self._rt.make_report(
            self._pushed, time.perf_counter() - self._t0
        )
        return self.report

    def _abort(self) -> None:
        self._closed = True
        self._aborted = True
        self._rt.stop()


class _ProcessSession(Session):
    """Session over :class:`~.procrun.ProcessRuntime`: pushes feed the
    stage-0 exchange incrementally (no finite iterable needed) and every
    call cranks the single-threaded parent supervisor."""

    backend = "process"

    def __init__(self, runtime: ProcessRuntime):
        super().__init__()
        self._rt = runtime
        runtime.start_stream()

    def _push_one(self, value: Any) -> None:
        self._rt.stream_push(value)

    def _try_push_one(self, value: Any) -> bool:
        return self._rt.stream_try_push(value)

    def _outputs_since(self, cursor: int) -> list:
        return self._rt.collected_outputs()[cursor:]

    def _discard_consumed(self, n: int) -> None:
        # parent-side list, mutated only from the caller's thread
        del self._rt.collected_outputs()[:n]

    def _drained_after_close(self) -> bool:
        return self._closed and (
            self.report is not None or self._rt.stream_drained()
        )

    def _idle_service(self, starved: int) -> None:
        # the parent is single-threaded: a starved reader must crank the
        # supervisor itself or nothing will ever egress
        if not self._rt._service_once():
            time.sleep(1e-4)

    def offer_load(self, signals: dict) -> None:
        """Forward serving-tier load signals to the supervisor's traffic
        monitor (see :meth:`Session.offer_load`)."""
        self._rt.observe_traffic(signals)

    def service_once(self) -> bool:
        """Bounded non-blocking supervisor sweep (see
        :meth:`Session.service_once`): cranks until a pass reports no
        progress (cap 64), so one call drains whatever the workers have
        ready instead of rationing one crank's worth per call — a fixed
        per-crank overhead (ring scans, unpickling, the serial tail) would
        otherwise cap paced throughput far below flood throughput."""
        rt = self._rt
        did = False
        for _ in range(64):
            if not rt._service_once():
                break
            did = True
        return did

    def stats(self) -> dict:
        """Live process-backend counters (see :meth:`Session.stats`)."""
        rt = self._rt
        return {
            "backend": self.backend,
            "closed": self._closed,
            "pushed": self._pushed,
            "egressed": rt.egress_count,
            "stage_widths": rt.stage_widths(),
            "backlog_slots": [x.backlog_slots() for x in rt._exchanges],
            "heartbeats": [x.heartbeats() for x in rt._exchanges],
            "replans": rt.replans,
            "restarts": rt.restarts,
            "recoveries": rt.recoveries,
            "dead_letters": len(rt.dead_letters),
            "grows": rt.grows,
            "shrinks": rt.shrinks,
            "resize_stalls": list(rt.resize_stalls),
            "resize_aborts": rt.resize_aborts,
            "resize_reverts": rt.resize_reverts,
        }

    def close(self, drain_timeout: float = 60.0) -> RunReport:
        """Seal input, drain through every stage, tear down the worker
        groups, report (idempotent)."""
        if self._closed:
            if self.report is None:
                raise RuntimeError("session aborted before close()")
            return self.report
        self._closed = True
        self.report = self._rt.finish_stream(drain_timeout)
        return self.report

    def _abort(self) -> None:
        self._closed = True
        self._aborted = True
        self._rt.stop()


# ------------------------------------------------------------------- engine
class Engine:
    """Execution engine owning backend selection: compile → plan → execute.

    Construct from an :class:`EngineConfig` (or legacy flat keywords, parsed
    strictly) and use:

    - :meth:`plan` — derive an inspectable :class:`PhysicalPlan` from a
      graph (no processes are forked, nothing runs);
    - :meth:`run` — execute a plan (or plan-on-the-fly from a graph) over a
      finite source, returning a :class:`JobResult`;
    - :meth:`open` — start a streaming :class:`Session` over the plan.

    ::

        engine = Engine(EngineConfig(backend="process", num_workers="auto"))
        plan = engine.plan(specs)
        print(plan.explain())
        result = engine.run(plan, source)
        with engine.open(plan) as s:
            s.push(batch)
            for out in s.results(max_items=10):
                ...
    """

    def __init__(self, config: Optional[EngineConfig] = None, **kw):
        if config is None:
            config = EngineConfig.from_kwargs(**kw)
        elif kw:
            raise ConfigError(
                "pass either an EngineConfig or flat keywords, not both"
            )
        if not isinstance(config, EngineConfig):
            raise ConfigError(
                f"config must be an EngineConfig, got {type(config).__name__}"
            )
        self.config = config.validate()

    # ----------------------------------------------------------------- plan
    def plan(self, graph, edges=None) -> PhysicalPlan:
        """Compile ``graph`` into a :class:`PhysicalPlan` without running it.

        ``graph`` is a chain (sequence of :class:`~.operators.OpSpec`), a
        ``(nodes, edges)`` tuple, or a node dict with ``edges`` passed
        separately.  For the process backend this cuts stages, prices them
        with the cost model (priors or explicit ``cost_priors`` — run-time
        calibration only refines plans made *at* run time), and records the
        exchange-ring geometry; ``plan.unstaged`` names every node left in
        the serial parent tail, and — exactly as execution would — planning
        emits :class:`~.procrun.UnstagedGraphWarning` when routing nodes
        (``Split``/``Merge``) are among them.
        """
        nodes, edge_list, _specs = _normalize_graph(graph, edges)
        cfg = self.config
        op_rows, routing = graph_flows(nodes, edge_list, cfg.cost_priors)
        ops = _planned_ops(op_rows)
        if cfg.backend == "thread":
            plan = PhysicalPlan(
                backend="thread", config=cfg, ops=ops, routing=routing,
                graph=(nodes, edge_list),
            )
        else:
            rt = self._make_process_runtime(nodes, edge_list)
            plan = self._describe_process(rt, ops, routing, (nodes, edge_list))
        # Engine-built plans hold by construction; verifying here keeps the
        # catalog honest (a planner bug surfaces at plan time, not run time).
        plan.verify()
        return plan

    # ------------------------------------------------------------------ run
    def run(self, plan_or_graph, source: Iterable, *, edges=None,
            drain_timeout: float = 60.0) -> JobResult:
        """Execute over a finite ``source`` and drain; returns
        :class:`JobResult`.

        Accepts a bound :class:`PhysicalPlan` (its stage widths are pinned —
        elastic replanning, when enabled, may still adjust them live) or any
        :meth:`plan` graph form (planned on the fly; ``num_workers="auto"``
        without priors then also runs the calibration pass).  The result's
        ``plan`` field describes what actually executed, including
        post-replan widths.
        """
        cfg = self.config
        plan, nodes, edge_list, chain_specs, pinned = self._resolve(
            plan_or_graph, edges
        )

        if cfg.backend == "thread":
            pipe, rt = self._build_thread(nodes, edge_list, chain_specs)
            report = rt.run(source, drain_timeout=drain_timeout)
            if plan is None:
                op_rows, routing = graph_flows(nodes, edge_list, cfg.cost_priors)
                plan = PhysicalPlan(
                    backend="thread", config=cfg, ops=_planned_ops(op_rows),
                    routing=routing, graph=(nodes, edge_list),
                )
            return JobResult(
                outputs=pipe.outputs, report=report, plan=plan,
                markers=list(pipe.markers), egress_count=pipe.egress_count,
                target=pipe,
            )

        rt = self._make_process_runtime(nodes, edge_list, stage_widths=pinned)
        report = rt.run(source, drain_timeout=drain_timeout)
        op_rows, routing = graph_flows(nodes, edge_list, cfg.cost_priors)
        executed = self._describe_process(
            rt, _planned_ops(op_rows), routing, (nodes, edge_list)
        )
        return JobResult(
            outputs=rt.outputs, report=report, plan=executed,
            markers=list(rt.markers), egress_count=rt.egress_count,
            replans=rt.replans, restarts=rt.restarts,
            recoveries=rt.recoveries, dead_letters=list(rt.dead_letters),
            target=rt,
        )

    # ----------------------------------------------------------------- open
    def open(self, plan_or_graph, edges=None) -> Session:
        """Open a streaming :class:`Session` over a plan or graph.

        The session forces ``collect_outputs`` on (its ``results()``
        iterator is the egress).  Process-backend sessions size
        ``workers="auto"`` from priors only — there is no source to
        calibrate on — and rely on elastic replanning to adapt live.
        """
        cfg = self.config
        _plan, nodes, edge_list, chain_specs, pinned = self._resolve(
            plan_or_graph, edges
        )
        if cfg.backend == "thread":
            pipe, rt = self._build_thread(
                nodes, edge_list, chain_specs, collect=True
            )
            return _ThreadSession(pipe, rt)
        rt = self._make_process_runtime(
            nodes, edge_list, stage_widths=pinned, collect=True
        )
        return _ProcessSession(rt)

    # ------------------------------------------------------------ internals
    def _resolve(self, plan_or_graph, edges):
        """Shared plan-vs-graph resolution for :meth:`run` / :meth:`open`:
        returns ``(plan_or_None, nodes, edges, chain_specs, pinned_widths)``,
        rejecting plans made for the other backend."""
        if isinstance(plan_or_graph, PhysicalPlan):
            plan = plan_or_graph
            if plan.backend != self.config.backend:
                raise ConfigError(
                    f"plan was made for backend={plan.backend!r} but this "
                    f"engine runs backend={self.config.backend!r}"
                )
            plan.verify()  # a hand-edited plan must not reach execution
            nodes, edge_list = plan.graph
            return plan, nodes, edge_list, None, (
                plan.stage_widths() if plan.stages else None
            )
        nodes, edge_list, chain_specs = _normalize_graph(plan_or_graph, edges)
        return None, nodes, edge_list, chain_specs, None

    def _build_thread(self, nodes, edges, chain_specs=None,
                      collect: Optional[bool] = None):
        cfg = self.config
        num_workers = resolve_workers(cfg.num_workers)
        collect_outputs = cfg.collect_outputs if collect is None else collect
        # chains keep their CompiledPipeline face (legacy `.specs` surface)
        if chain_specs is None and all(
            isinstance(s, OpSpec) for s in nodes.values()
        ):
            order = [name for name, _spec in _topo_ops(nodes, edges)]
            if list(edges) == list(zip(order, order[1:])):
                chain_specs = [nodes[n] for n in order]
        pipe_kw = dict(
            reorder_scheme=cfg.reorder_scheme,
            worklist_scheme=cfg.worklist_scheme,
            num_workers=num_workers,
            collect_outputs=collect_outputs,
            marker_interval=cfg.marker_interval,
            batch_size=cfg.batch_size,
            reorder_size=cfg.reorder_size,
        )
        if chain_specs is not None:
            pipe = CompiledPipeline(chain_specs, **pipe_kw)
        else:
            pipe = GraphPipeline(nodes, edges, **pipe_kw)
        t = cfg.thread
        rt = StreamRuntime(
            pipe,
            num_workers=num_workers,
            heuristic=t.heuristic,
            cost_priors=cfg.cost_priors,
            time_slice=t.time_slice,
            capacity=t.capacity,
            window=t.window,
            adapt_interval=t.adapt_interval,
        )
        return pipe, rt

    def _make_process_runtime(self, nodes, edges, stage_widths=None,
                              collect: Optional[bool] = None) -> ProcessRuntime:
        cfg = self.config
        p = cfg.process
        return ProcessRuntime(
            nodes,
            edges,
            num_workers=cfg.num_workers,
            marker_interval=cfg.marker_interval,
            collect_outputs=cfg.collect_outputs if collect is None else collect,
            io_batch=p.io_batch,
            batch_size=cfg.batch_size,
            stages=p.stages,
            ring_slots=p.ring_slots,
            slot_bytes=p.slot_bytes,
            reorder_size=cfg.reorder_size,
            reorder_payload=p.reorder_payload,
            max_inflight=p.max_inflight,
            restart_on_crash=p.restart_on_crash,
            reorder_scheme=cfg.reorder_scheme,
            worklist_scheme=cfg.worklist_scheme,
            worker_budget=p.worker_budget,
            cost_priors=cfg.cost_priors,
            elastic=p.elastic,
            calibrate_tuples=p.calibrate_tuples,
            replan_interval=p.replan_interval,
            replan_threshold=p.replan_threshold,
            replan_patience=p.replan_patience,
            traffic_elastic=p.traffic_elastic,
            traffic_interval=p.traffic_interval,
            traffic_grow_util=p.traffic_grow_util,
            traffic_shrink_util=p.traffic_shrink_util,
            traffic_patience=p.traffic_patience,
            traffic_cooldown=p.traffic_cooldown,
            resize_latency_budget=p.resize_latency_budget,
            parent_idle_cap=p.parent_idle_cap,
            columnar=p.columnar,
            device_batch=p.device_batch,
            device_workers=p.device_workers,
            device_inflight=p.device_inflight,
            device_backend=p.device_backend,
            checkpoint_interval=p.checkpoint_interval,
            stall_timeout=p.stall_timeout,
            spill_timeout=p.spill_timeout,
            fault_plan=cfg.faults.plan,
            on_error=cfg.faults.on_error,
            stage_widths=stage_widths,
        )

    def _describe_process(self, rt: ProcessRuntime, ops, routing,
                          graph) -> PhysicalPlan:
        profiles = rt.cost_model.profiles
        total = sum(p.load for p in profiles) or 1.0
        stages = [
            PlannedStage(
                index=plan.index,
                kind=plan.kind,
                ops=[op.name for op in plan.ops],
                workers=plan.workers,
                max_workers=max(plan.max_workers, plan.workers),
                cost_us=round(prof.cost_us, 3),
                flow=round(prof.flow, 4),
                load_share=round(prof.load / total, 4),
                checkpointed=rt._ckpt_enabled(plan.index),
            )
            for plan, prof in zip(rt.stage_plans, profiles)
        ]
        ring = {
            "io_batch": rt.io_batch,
            "max_inflight": rt.max_inflight,
            "ring_slots": rt.ring_slots,
            "slot_bytes": rt.slot_bytes,
            "reorder_size": rt.reorder_size,
            "reorder_payload": rt.reorder_payload,
            # effective epoch length: barriers stamp at dispatch-unit
            # boundaries, so the interval never undercuts io_batch (PV407)
            "checkpoint_interval": (
                max(rt.checkpoint_interval, rt.io_batch)
                if any(s.checkpointed for s in stages) else 0
            ),
            "columnar": int(rt.columnar),
            "device_batch": rt.device_batch,
            "device_workers": rt.device_workers,
            "device_inflight": rt.device_inflight,
        }
        return PhysicalPlan(
            backend="process", config=self.config, ops=ops, routing=routing,
            stages=stages, unstaged=rt.tail_node_names, ring=ring,
            worker_budget=rt.worker_budget, graph=graph,
        )


def _planned_ops(op_rows) -> List[PlannedOp]:
    total = sum(flow * cost for _n, _s, flow, cost in op_rows) or 1.0
    ops = []
    for _name, spec, flow, cost in op_rows:
        if spec.kind == STATEFUL:
            max_dop: Optional[int] = 1
        elif spec.kind == PARTITIONED:
            max_dop = spec.num_partitions
        else:
            max_dop = None
        schema_width = (
            spec.schema.width
            if spec.kind == DEVICE and spec.schema is not None else None
        )
        ops.append(
            PlannedOp(
                name=spec.name,
                kind=spec.kind,
                cost_us=round(cost, 3),
                selectivity=round(float(spec.selectivity), 4),
                flow=round(flow, 4),
                load_share=round(flow * cost / total, 4),
                max_dop=max_dop,
                schema_width=schema_width,
            )
        )
    return ops
