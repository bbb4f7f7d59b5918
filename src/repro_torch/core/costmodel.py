# Port copy of src/repro/core/costmodel.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Cost-model-driven per-stage worker allocation (ROADMAP: "per-stage
worker-count allocation from cost priors").

The staged process backend (:mod:`.procrun`) cuts a pipeline into stages and
— before this module — handed every data-parallel stage the same flat
``num_workers``.  That starves a skewed pipeline's hot stage: the paper's
central claim is that handling *load imbalance*, not merely exposing data
parallelism, is what makes ordered streaming scale.  Following BriskStream's
relative-rate cost model (arXiv 1904.03604) and TStream's punctuation-bounded
live restructuring (arXiv 1904.03800), this module supplies:

- :func:`proportional_allocation` — divide a core budget across stages in
  proportion to their predicted load so stage throughputs equalize (the
  classic largest-remainder method; stateful stages stay pinned at one
  worker, keyed stages cap at their partition count).
- :class:`CostModel` — per-stage service cost + relative flow (tuples per
  source tuple), seeded from declared :class:`~.operators.OpSpec` priors or
  explicit ``cost_priors``, optionally refined by :meth:`CostModel.calibrate`
  (a short profiled dry run of the actual operator functions on buffered
  source tuples — legal because operator fns are required to be
  deterministic and side-effect-free) and by live observations
  (:meth:`CostModel.observe`).
- :class:`OccupancyMonitor` — samples the per-stage progress/backlog
  counters already flowing through :class:`~.shm.ExchangeRing` (drained
  serials = stage input tuples, ingress-ring queue depths = occupancy),
  re-estimates stage costs from observed service rates, and proposes a new
  width vector when occupancy drifts past a threshold for several
  consecutive samples — the trigger for :class:`~.procrun.ProcessRuntime`'s
  elastic replanning.
- :class:`TrafficMonitor` — the serving-tier counterpart: an offered-load
  rate EWMA fed by :meth:`repro.serve.SessionMux.load_signals` snapshots,
  converted to per-stage utilization against the live cost model, with
  hysteresis (separate grow/shrink thresholds), per-stage patience streaks,
  and post-resize cooldowns — so worker widths react to *traffic* (session
  fan-out, bursty/diurnal ramps), not just skew.

The thread backend's adaptive controller (:meth:`.scheduler.Scheduler.adapt`)
shares the cost surface (:func:`op_cost_us` folds ``cost_priors`` into
declared priors on both paths) but keeps ceil-of-share caps: a thread-side
``dop_cap`` is a cap, not a reservation, so a hot operator must stay able to
absorb idle workers — hard-partitioning applies only where widths reserve
forked processes.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .operators import OpSpec, STATEFUL

#: default worker budget for ``workers="auto"``: one process per core plus
#: one to hide exchange/feeder latency (stages overlap, so mild
#: oversubscription keeps the hot stage fed while feeders run).
def default_budget() -> int:
    return max((os.cpu_count() or 2) + 1, 2)


def resolve_workers(num_workers, budget: Optional[int] = None) -> int:
    """Resolve the ``num_workers`` API value ("auto" | int) to an int.

    The thread backend and :class:`~.pipeline.GraphPipeline` construction
    need a concrete integer; ``"auto"`` means "one worker per core" there
    (the process backend does finer per-stage division via
    :class:`CostModel`)."""
    if num_workers == "auto":
        return budget if budget is not None else max(os.cpu_count() or 2, 2)
    if not isinstance(num_workers, int):
        raise ValueError(
            f"num_workers must be an int or 'auto', got {num_workers!r}"
        )
    return num_workers


def op_cost_us(op: OpSpec, cost_priors: Optional[Dict[str, float]]) -> float:
    """Declared per-tuple cost of ``op`` in µs, with ``cost_priors``
    (``{op name: cost_us}``) taking precedence over the spec's own prior."""
    if cost_priors and op.name in cost_priors:
        return max(float(cost_priors[op.name]), 1e-3)
    return max(float(op.cost_us), 1e-3)


#: per-batch device dispatch overhead prior (µs): jax trace-cache hit +
#: host->device staging setup, amortised over the batch.
DEVICE_DISPATCH_US = 50.0
#: host<->device transfer bandwidth prior, bytes per µs (~8 GB/s).
DEVICE_BYTES_PER_US = 8192.0


def device_cost_us(
    op: OpSpec,
    device_batch: int,
    cost_priors: Optional[Dict[str, float]],
) -> float:
    """Per-tuple cost of a device op: the op's own compute prior plus the
    amortised dispatch overhead and the per-row transfer term (the schema's
    fixed row width is on the wire twice: in and out).  ``cost_priors``
    override the whole estimate, same as :func:`op_cost_us`."""
    if cost_priors and op.name in cost_priors:
        return max(float(cost_priors[op.name]), 1e-3)
    batch = max(int(device_batch), 1)
    cost = max(float(op.cost_us), 1e-3) + DEVICE_DISPATCH_US / batch
    if op.schema is not None:
        cost += 2.0 * op.schema.row_bytes / DEVICE_BYTES_PER_US
    return cost


def proportional_allocation(
    loads: Sequence[float],
    budget: int,
    mins: Sequence[int],
    caps: Sequence[int],
) -> List[int]:
    """Divide ``budget`` workers across stages proportionally to ``loads``.

    Every stage first receives ``mins[i]`` (the allocator never zeroes a
    stage); the remaining budget is split by the largest-remainder method of
    each stage's load share, clipped to ``caps[i]``.  Equalizing
    ``width_i / load_i`` equalizes predicted stage throughput — the pipeline
    moves at the pace of its slowest stage, so the optimum gives each stage
    width proportional to its load.  Leftover budget that no un-capped stage
    can absorb is simply not spent.  ``sum(result) <= max(budget,
    sum(mins))`` always holds.
    """
    n = len(loads)
    if not (n == len(mins) == len(caps)):
        raise ValueError("loads/mins/caps must have equal length")
    widths = [max(int(m), 0) for m in mins]
    caps = [max(int(c), w) for c, w in zip(caps, widths)]
    spare = budget - sum(widths)
    while spare > 0:
        # ideal extra share for each growable stage, by load
        grow = [i for i in range(n) if widths[i] < caps[i]]
        if not grow:
            break
        total = sum(loads[i] for i in grow) or float(len(grow))
        ideal = {
            i: spare * ((loads[i] / total) if total else 1.0 / len(grow))
            for i in grow
        }
        granted = 0
        for i in grow:
            take = min(int(ideal[i]), caps[i] - widths[i])
            widths[i] += take
            granted += take
        if granted == 0:
            # largest remainder: hand single workers to the biggest shares
            order = sorted(grow, key=lambda i: ideal[i] - int(ideal[i]),
                           reverse=True)
            for i in order:
                if spare - granted <= 0:
                    break
                if widths[i] < caps[i]:
                    widths[i] += 1
                    granted += 1
            if granted == 0:
                break
        spare -= granted
    return widths


def graph_flows(
    nodes: Dict[str, object],
    edges: Sequence[Tuple[str, str]],
    cost_priors: Optional[Dict[str, float]] = None,
):
    """Predicted per-operator flow profile of a dataflow graph.

    Propagates relative input flow (tuples per source tuple) through the
    topology — a ``Split`` divides its inbound flow evenly across branches,
    a ``Merge`` sums — chaining each :class:`~.operators.OpSpec`'s declared
    selectivity, with ``cost_priors`` overriding declared per-tuple costs.
    Returns ``(op_rows, routing_names)`` where ``op_rows`` is a list of
    ``(node_name, spec, flow, cost_us)`` tuples in topological order (op
    nodes only) and ``routing_names`` lists the Split/Merge node names.
    Shared by :meth:`.api.Engine.plan` (the plan's per-op load table) and
    kept here so the plan surface and the allocator price operators with
    the same :func:`op_cost_us` rule.
    """
    names = set(nodes)
    indeg = {n: 0 for n in names}
    succ: Dict[str, list] = {n: [] for n in names}
    for u, v in edges:
        if u not in names or v not in names:
            raise ValueError(f"edge ({u!r}, {v!r}) references unknown node")
        succ[u].append(v)
        indeg[v] += 1
    flow = {n: (1.0 if indeg[n] == 0 else 0.0) for n in names}
    ready = sorted(n for n in names if indeg[n] == 0)
    order: list = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for v in succ[n]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if len(order) != len(names):
        raise ValueError("graph has a cycle")
    op_rows = []
    routing = []
    for n in order:
        spec = nodes[n]
        if isinstance(spec, OpSpec):
            out_flow = flow[n] * max(float(spec.selectivity), 0.0)
            op_rows.append((n, spec, flow[n], op_cost_us(spec, cost_priors)))
        else:  # Split/Merge: flow passes through (a split divides evenly)
            routing.append(n)
            out_flow = flow[n]
        outs = succ[n]
        if outs:
            share = out_flow / len(outs) if len(outs) > 1 else out_flow
            for v in outs:
                flow[v] += share
    return op_rows, routing


# --------------------------------------------------------------- cost model
@dataclass
class StageProfile:
    """Predicted shape of one stage: per-tuple service cost and relative
    input flow (stage input tuples per pipeline source tuple)."""

    index: int
    kind: str  # "stateless" | "keyed" | "stateful" | "device"
    cost_us: float
    flow: float = 1.0
    selectivity: float = 1.0  # stage output tuples per stage input tuple
    measured: bool = False  # True once calibration/observation replaced priors

    @property
    def load(self) -> float:
        """Relative work rate: input flow × per-tuple cost (BriskStream's
        relative-rate model — absolute input rates cancel out)."""
        return self.flow * self.cost_us


class CostModel:
    """Per-stage cost/flow accounting + the allocation rule.

    Built from the planner's :class:`~.procrun.StagePlan` list.  Stage cost
    is the sum of each operator's per-tuple cost weighted by its within-stage
    input flow (the running selectivity product); stage flow chains the same
    product across stages.
    """

    def __init__(
        self,
        plans: Sequence,
        cost_priors: Optional[Dict[str, float]] = None,
        device_batch: int = 256,
    ):
        self.plans = list(plans)
        self.cost_priors = dict(cost_priors) if cost_priors else None
        self.device_batch = max(int(device_batch), 1)
        self.profiles: List[StageProfile] = []
        flow = 1.0
        for plan in self.plans:
            cost = 0.0
            sel = 1.0
            for op in plan.ops:
                if plan.kind == "device":
                    cost += sel * device_cost_us(
                        op, self.device_batch, self.cost_priors
                    )
                else:
                    cost += sel * op_cost_us(op, self.cost_priors)
                sel *= max(float(op.selectivity), 0.0)
            if not plan.ops:  # identity pass-through stage
                cost = 1e-3
            self.profiles.append(
                StageProfile(plan.index, plan.kind, max(cost, 1e-3), flow, sel)
            )
            flow = max(flow * sel, 1e-9)

    # ------------------------------------------------------------ refinement
    def calibrate(self, sample: Sequence, min_tuples: int = 8) -> bool:
        """Profile the real operator functions on ``sample`` source tuples.

        Dry-runs each stage's operator run with throwaway state (operator fns
        are deterministic and side-effect-free by contract, so this is
        invisible to the later real run), measuring per-tuple stage cost and
        selectivity.  Returns True if the sample was large enough to trust.
        """
        if len(sample) < min_tuples:
            return False
        from .procrun import _apply_segment, _init_states  # late: avoid cycle

        values = list(sample)
        for prof, plan in zip(self.profiles, self.plans):
            if not values:
                break
            states = _init_states(plan.ops)
            outs: list = []
            t0 = time.perf_counter()
            for v in values:
                outs.extend(_apply_segment(plan.ops, states, v))
            dt = time.perf_counter() - t0
            prof.cost_us = max(dt * 1e6 / len(values), 1e-3)
            prof.selectivity = len(outs) / len(values)
            prof.measured = True
            values = outs
        self._rechain_flows()
        return True

    def observe(self, index: int, cost_us: float, alpha: float = 0.5) -> None:
        """Fold a live per-worker service-cost observation into stage
        ``index`` (EMA; used by :class:`OccupancyMonitor`)."""
        prof = self.profiles[index]
        if prof.measured:
            prof.cost_us = (1 - alpha) * prof.cost_us + alpha * max(cost_us, 1e-3)
        else:
            prof.cost_us = max(cost_us, 1e-3)
            prof.measured = True

    def observe_flows(self, drained: Sequence[int]) -> None:
        """Update relative flows from the stages' drained-serial counters
        (stage i's serials count its *input* tuples, so the ratios are the
        exact observed flow fractions)."""
        if not drained or drained[0] <= 0:
            return
        base = float(drained[0])
        for prof, d in zip(self.profiles, drained):
            if d > 0:
                prof.flow = max(d / base, 1e-9)

    def _rechain_flows(self) -> None:
        flow = 1.0
        for prof in self.profiles:
            prof.flow = flow
            flow = max(flow * prof.selectivity, 1e-9)

    # ------------------------------------------------------------ allocation
    def loads(self) -> List[float]:
        """Per-stage relative loads (``flow × cost``), allocation's input."""
        return [p.load for p in self.profiles]

    def stage_caps(self) -> List[int]:
        """Per-stage width caps: stateful = 1, keyed = partition count,
        device = its planned width (pinned), stateless = effectively
        unbounded."""
        caps = []
        for plan, prof in zip(self.plans, self.profiles):
            if prof.kind == "stateful":
                caps.append(1)  # intrinsic serial constraint
            elif prof.kind == "keyed":
                caps.append(max(plan.ops[0].num_partitions, 1))
            elif prof.kind == "device":
                # device widths are pinned at plan time (device_workers):
                # batching state lives per worker, so elastic resize would
                # strand half-filled batches.
                caps.append(max(plan.max_workers, 1))
            else:
                caps.append(1 << 30)
        return caps

    def allocate(self, budget: int) -> List[int]:
        """Width vector for ``budget`` total workers (each stage >= 1,
        stateful pinned at 1, keyed capped at its partition count, device
        pinned at its planned width)."""
        mins = [
            max(plan.max_workers, 1) if p.kind == "device" else 1
            for plan, p in zip(self.plans, self.profiles)
        ]
        # stateful stages carry load but cannot widen: exclude their load so
        # the remaining budget divides over the stages that can absorb it.
        # Device stages are likewise pinned (mins == caps), so their load is
        # excluded too.
        loads = [
            0.0 if p.kind in ("stateful", "device") else p.load
            for p in self.profiles
        ]
        return proportional_allocation(loads, budget, mins, self.stage_caps())

    def describe(self) -> str:
        """One-line human rendering of the per-stage profiles."""
        return " ".join(
            f"s{p.index}[{p.kind} cost={p.cost_us:.1f}us flow={p.flow:.2f}"
            f"{' meas' if p.measured else ''}]"
            for p in self.profiles
        )


# --------------------------------------------------------- occupancy monitor
@dataclass
class _Snapshot:
    ts: float
    drained: List[int]  # per-stage drained serials (reorder shared_next - 1)
    backlog: List[int]  # per-stage queued ingress slots


def _refresh_measured_costs(
    model: CostModel,
    prev: _Snapshot,
    snap: _Snapshot,
    widths: Sequence[int],
    min_backlog: int,
) -> None:
    """Fold live drain rates into ``model``: a backlogged stage is
    service-limited, so its drain rate ≈ width / cost; an unsaturated
    stage's drain rate only upper-bounds its cost (it is arrival-limited),
    so it may only lower the estimate."""
    dt = snap.ts - prev.ts
    if dt <= 0:
        return
    for i, width in enumerate(widths):
        dd = snap.drained[i] - prev.drained[i]
        if dd <= 0 or width <= 0:
            continue
        measured = width * dt * 1e6 / dd
        if (
            snap.backlog[i] >= min_backlog
            or measured < model.profiles[i].cost_us
        ):
            model.observe(i, measured)
    model.observe_flows(snap.drained)


class OccupancyMonitor:
    """Watches live stage counters and proposes elastic replans.

    Fed by the process-backend supervisor each ``interval`` seconds with the
    per-stage counters the :class:`~.shm.ExchangeRing` already publishes.
    When one stage holds more than ``occupancy_threshold`` of the queued
    work for ``patience`` consecutive samples, the monitor proposes growing
    it by one worker — funded by spare budget if any, else by shrinking the
    idlest resizable stage (shrink listed first so the supervisor frees the
    budget before spending it).  The one-worker step is deliberate: observed
    occupancy says *which* stage is starved with certainty, but service-cost
    estimates for non-saturated stages are only upper bounds, so stepwise
    rebalancing converges without thrashing on estimation noise.  Live
    service rates still refresh the cost model (for reporting and for the
    next static allocation).
    """

    def __init__(
        self,
        model: CostModel,
        budget: int,
        *,
        interval: float = 0.25,
        occupancy_threshold: float = 0.55,
        min_backlog: int = 8,
        patience: int = 3,
    ):
        self.model = model
        self.budget = budget
        self.interval = interval
        self.occupancy_threshold = occupancy_threshold
        self.min_backlog = min_backlog
        self.patience = patience
        self._prev: Optional[_Snapshot] = None
        self._next_at = 0.0
        # patience accumulates PER STAGE: two stages alternating as the
        # backlog leader each still reach ``patience`` qualifying samples
        # (a single shared streak would reset on every leader change and
        # an oscillating hot spot would never replan).  All streaks clear
        # whenever the pipeline shows no addressable drift at all.
        self._streaks: Dict[int, int] = {}
        self.samples = 0  # instrumentation

    def due(self, now: float) -> bool:
        """Whether the next sampling interval has elapsed."""
        return now >= self._next_at

    def sample(
        self,
        now: float,
        drained: Sequence[int],
        backlog: Sequence[int],
        widths: Sequence[int],
        resizable: Sequence[bool],
    ) -> Optional[List[Tuple[int, int]]]:
        """Feed one counter snapshot; returns ``[(stage, new_width), ...]``
        (shrinks first) when a replan should happen, else None."""
        self._next_at = now + self.interval
        snap = _Snapshot(now, list(drained), list(backlog))
        prev, self._prev = self._prev, snap
        self.samples += 1
        if prev is None:
            return None
        dt = now - prev.ts
        if dt <= 0:
            return None
        _refresh_measured_costs(self.model, prev, snap, widths,
                                self.min_backlog)

        total_backlog = sum(snap.backlog)
        if total_backlog < self.min_backlog:
            self._streaks.clear()
            return None
        hot = max(range(len(widths)), key=lambda i: snap.backlog[i])
        caps = self.model.stage_caps()
        if (
            snap.backlog[hot] / total_backlog < self.occupancy_threshold
            or not resizable[hot]
            or widths[hot] >= caps[hot]
        ):
            # no drift, or drift that is unaddressable (hot stage pinned or
            # already at cap): do not thrash the others
            self._streaks.clear()
            return None
        proposal: List[Tuple[int, int]] = []
        if self.budget - sum(widths) <= 0:
            donors = [
                i for i in range(len(widths))
                if i != hot and resizable[i] and widths[i] > 1
            ]
            if not donors:
                self._streaks.clear()
                return None
            donor = min(donors, key=lambda i: snap.backlog[i])
            proposal.append((donor, widths[donor] - 1))
        proposal.append((hot, widths[hot] + 1))
        self._streaks[hot] = self._streaks.get(hot, 0) + 1
        if self._streaks[hot] < self.patience:
            return None
        self._streaks.clear()
        return proposal


# ----------------------------------------------------------- traffic monitor
@dataclass
class TrafficSnapshot:
    """One serving-tier load observation, as exported by
    :meth:`repro.serve.SessionMux.load_signals`.

    ``admitted_total`` is a monotonic count of tuples the mux admitted into
    the runtime, ``ingress_queued`` the tuples still parked in per-session
    DRR ingress queues (admission pressure the runtime is not absorbing),
    ``backpressured`` the number of sessions paused on a full result
    buffer."""

    ts: float
    sessions: int = 0
    admitted_total: int = 0
    ingress_queued: int = 0
    backpressured: int = 0


class TrafficMonitor:
    """Traffic-aware elasticity policy: grow/shrink proposals keyed on
    *offered load*, not just ring occupancy.

    The :class:`OccupancyMonitor` reacts to stage *skew* — where queued work
    sits.  A multiplexed serving tier (``repro.serve.SessionMux``) also
    needs the plan to react to *traffic*: session fan-out and offered-load
    ramps should widen the sid-partitioned stage, sustained diurnal troughs
    should hand the workers back.  Following BriskStream's rule that scaling
    decisions come from a measured execution model re-evaluated at runtime,
    this policy:

    - ingests serving-tier load snapshots (:meth:`ingest`) and keeps an
      EWMA of the offered source-tuple rate — the admitted-counter delta
      *plus* ingress-queue growth, so load the runtime fails to absorb
      still counts as offered;
    - converts the rate into per-stage utilization against the live
      measured cost model (``util = rate * flow * cost_us / (width * 1e6)``)
      and proposes growing the hottest resizable stage (keyed —
      i.e. sid-partitioned — stages preferred) once utilization exceeds
      ``grow_util`` for ``patience`` consecutive samples, or immediately on
      sustained admission pressure even when the cost model disagrees;
    - proposes shrinking the idlest over-provisioned stage only when its
      utilization sits below ``shrink_util`` *and* would remain below
      ``grow_util`` at the narrower width — the hysteresis band that stops
      grow/shrink oscillation;
    - enforces a ``cooldown`` after every proposal, quadrupled when the
      supervisor reports the resize was aborted or blew its latency budget
      (:meth:`resize_result`), so a resize that stalls the pipeline is not
      immediately retried.

    Streaks accumulate per stage and per direction; all state is touched
    only from the supervisor thread.
    """

    def __init__(
        self,
        model: CostModel,
        budget: int,
        *,
        interval: float = 0.5,
        grow_util: float = 0.85,
        shrink_util: float = 0.30,
        patience: int = 2,
        cooldown: float = 2.0,
        alpha: float = 0.3,
        min_backlog: int = 8,
    ):
        if not (0.0 < shrink_util < grow_util):
            raise ValueError(
                "traffic policy hysteresis requires 0 < shrink_util "
                f"< grow_util, got shrink={shrink_util} grow={grow_util}"
            )
        self.model = model
        self.budget = budget
        self.interval = interval
        self.grow_util = grow_util
        self.shrink_util = shrink_util
        self.patience = max(int(patience), 1)
        self.cooldown = cooldown
        self.alpha = alpha
        self.min_backlog = min_backlog
        self._last: Optional[TrafficSnapshot] = None
        self._rate = 0.0  # EWMA offered source tuples/s
        self._have_rate = False
        self._pressure = 0
        self._sessions = 0
        self._prev: Optional[_Snapshot] = None
        self._next_at = 0.0
        self._cooldown_until = 0.0
        self._grow_streaks: Dict[int, int] = {}
        self._shrink_streaks: Dict[int, int] = {}
        self.ingests = 0  # instrumentation
        self.samples = 0
        self.proposals = 0
        self.backoffs = 0

    @property
    def rate(self) -> float:
        """Current EWMA estimate of the offered source-tuple rate (1/s)."""
        return self._rate

    def ingest(self, signals: Dict[str, float]) -> None:
        """Feed one serving-tier load snapshot (a ``load_signals()`` dict).

        The offered rate between consecutive snapshots is the admitted
        delta plus the ingress-queue growth over the elapsed time; it is
        folded into the EWMA.  Queue depth and session count are kept as
        the admission-pressure signal."""
        snap = TrafficSnapshot(
            ts=float(signals.get("ts", 0.0)),
            sessions=int(signals.get("sessions", 0)),
            admitted_total=int(signals.get("admitted_total", 0)),
            ingress_queued=int(signals.get("ingress_queued", 0)),
            backpressured=int(signals.get("backpressured", 0)),
        )
        prev, self._last = self._last, snap
        self._pressure = snap.ingress_queued
        self._sessions = snap.sessions
        self.ingests += 1
        if prev is None:
            return
        dt = snap.ts - prev.ts
        if dt <= 0:
            return
        offered = max(
            (snap.admitted_total - prev.admitted_total)
            + (snap.ingress_queued - prev.ingress_queued),
            0,
        ) / dt
        if not self._have_rate:
            self._rate, self._have_rate = offered, True
        else:
            self._rate += self.alpha * (offered - self._rate)

    def due(self, now: float) -> bool:
        """Whether the next policy evaluation interval has elapsed."""
        return now >= self._next_at

    def saturated(self) -> bool:
        """Sustained admission pressure: the mux-side ingress queues hold
        more than a couple of tuples per open session, i.e. the runtime is
        not absorbing the offered load regardless of what the cost model
        predicts."""
        return self._pressure >= max(16, 2 * max(self._sessions, 1))

    def utilization(self, widths: Sequence[int]) -> List[float]:
        """Predicted per-stage utilization of the offered rate:
        ``rate * flow_i * cost_us_i / (width_i * 1e6)`` — the fraction of
        stage *i*'s service capacity the measured load consumes."""
        return [
            self._rate * p.flow * p.cost_us / (max(w, 1) * 1e6)
            for p, w in zip(self.model.profiles, widths)
        ]

    def resize_result(
        self,
        now: float,
        *,
        stall_s: Optional[float] = None,
        aborted: bool = False,
        over_budget: bool = False,
    ) -> None:
        """Record the outcome of a resize: a completed one (re)starts the
        normal cooldown; an aborted or over-latency-budget one backs off
        4x, so a resize whose quiesce stall blew the p99 budget is not
        immediately retried.  ``stall_s`` is informational."""
        mult = 4.0 if (aborted or over_budget) else 1.0
        if aborted or over_budget:
            self.backoffs += 1
        self._cooldown_until = max(
            self._cooldown_until, now + mult * self.cooldown
        )

    def sample(
        self,
        now: float,
        drained: Sequence[int],
        backlog: Sequence[int],
        widths: Sequence[int],
        resizable: Sequence[bool],
    ) -> Optional[List[Tuple[int, int]]]:
        """Evaluate the policy against one stage-counter snapshot; returns
        ``[(stage, new_width), ...]`` (shrinks first) or None.  Inert until
        the first two :meth:`ingest` calls establish a rate estimate."""
        self._next_at = now + self.interval
        self.samples += 1
        snap = _Snapshot(now, list(drained), list(backlog))
        prev, self._prev = self._prev, snap
        if prev is not None:
            _refresh_measured_costs(self.model, prev, snap, widths,
                                    self.min_backlog)
        if not self._have_rate:
            return None
        if now < self._cooldown_until:
            return None
        utils = self.utilization(widths)
        caps = self.model.stage_caps()
        saturated = self.saturated()

        # grow path: hottest resizable under-cap stage, keyed preferred —
        # in a mux'd plan the sid-partitioned stage is where fan-out lands.
        grow_cands = [
            i for i in range(len(widths))
            if resizable[i] and widths[i] < caps[i]
        ]
        target = None
        if grow_cands:
            keyed = [
                i for i in grow_cands
                if self.model.profiles[i].kind == "keyed"
            ]
            pool = keyed or grow_cands
            target = max(pool, key=lambda i: (utils[i], snap.backlog[i]))
        if target is not None and (utils[target] > self.grow_util or saturated):
            self._shrink_streaks.clear()
            self._grow_streaks[target] = self._grow_streaks.get(target, 0) + 1
            if self._grow_streaks[target] < self.patience:
                return None
            proposal: List[Tuple[int, int]] = []
            if self.budget - sum(widths) <= 0:
                donors = [
                    i for i in range(len(widths))
                    if i != target and resizable[i] and widths[i] > 1
                ]
                if not donors:
                    self._grow_streaks.pop(target, None)
                    return None
                donor = min(donors, key=lambda i: utils[i])
                proposal.append((donor, widths[donor] - 1))
            proposal.append((target, widths[target] + 1))
            self._grow_streaks.clear()
            self._cooldown_until = now + self.cooldown
            self.proposals += 1
            return proposal
        self._grow_streaks.clear()

        # shrink path: sustained trough only — idle utilization below the
        # shrink threshold AND still below grow_util at the narrower width
        # (hysteresis), with no queued pressure anywhere near the stage.
        if saturated:
            self._shrink_streaks.clear()
            return None
        victim = None
        for i in sorted(range(len(widths)), key=lambda i: utils[i]):
            if not resizable[i] or widths[i] <= 1:
                continue
            if snap.backlog[i] >= self.min_backlog:
                continue
            if (
                utils[i] < self.shrink_util
                and utils[i] * widths[i] / (widths[i] - 1) < self.grow_util
            ):
                victim = i
                break
        if victim is None:
            self._shrink_streaks.clear()
            return None
        self._shrink_streaks[victim] = self._shrink_streaks.get(victim, 0) + 1
        if self._shrink_streaks[victim] < self.patience:
            return None
        self._shrink_streaks.clear()
        self._cooldown_until = now + self.cooldown
        self.proposals += 1
        return [(victim, widths[victim] - 1)]
