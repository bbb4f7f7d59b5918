# Port copy of src/repro/analysis/plancheck.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Plan-time ordering-safety rule catalog (rules PV401–PV408, PV410–PV412).

:meth:`repro.core.api.PhysicalPlan.verify` delegates here.  The rules assert
the structural invariants that make a plan's parallel execution externally
indistinguishable from the single-threaded reference (the paper's ordering
contract) — they hold by construction for every plan :meth:`Engine.plan`
builds, but a hand-built or deserialized-and-edited plan can violate them:

- **PV401** — a stateful stage must have width 1 (a single state box cannot
  be shared by two workers; :class:`~repro.core.procrun.StagePlan` pins it).
- **PV402** — a keyed stage's width must not exceed the smallest partition
  count among its operators (extra workers would split a partition's state).
- **PV403** — ring capacity must cover the publish span: ``reorder_size >=
  io_batch`` (a span publish must fit the entry window or it can never be
  admitted) and ``max_inflight <= reorder_size`` (procrun's clamp: serials
  in flight must fit the reorder window or the dispatcher livelocks).
- **PV404** — elastic headroom: ``max_workers >= workers`` per stage (the
  exchange is built with ``max_workers`` ingress rings; a width above it has
  no ring to read from).
- **PV405** — every stage with width > 1 must drain through a reorder ring
  (the plan must carry ring geometry with ``reorder_size >= 1``).
- **PV406** — per-operator caps must match kinds on any backend: a stateful
  operator's ``max_dop`` is exactly 1, a partitioned operator's is >= 1.
- **PV407** — checkpoint geometry: only keyed/stateful/device stages may be
  marked ``checkpointed`` (stateless workers carry no state to snapshot —
  they recover by re-fork + replay alone; device stages ride group restore
  because their batches span ingress units), and when any stage checkpoints
  the plan's epoch interval must cover a full dispatch unit
  (``checkpoint_interval >= io_batch``: barriers ride unit boundaries, a
  shorter interval cannot be honored).
- **PV408** — traffic-elasticity policy geometry: the hysteresis band must
  be non-empty (``traffic_shrink_util < traffic_grow_util`` — a shrink
  threshold at or above the grow threshold makes the policy oscillate a
  width forever), the p99-guard budget, when set, must be positive, and an
  *explicitly* armed policy (``traffic_elastic=True``) must have at least
  one stage it can ever act on (non-stateful with ``max_workers > 1``) —
  a policy with no resizable stage silently never fires.
- **PV410** — device stages are width-pinned: a device stage's planned
  ``workers`` must equal the ring geometry's ``device_workers`` pin and its
  ``max_workers`` (per-worker batching state strands half-filled batches
  under elastic resize, so device stages carry zero elastic headroom).
- **PV411** — device batching geometry: ``device_batch >= io_batch`` (a
  device batch smaller than a dispatch unit splits units across dispatches
  for no win) and ``device_batch × device_inflight <= reorder_size`` (the
  rows a device worker may hold unpublished must fit the reorder window or
  ordered egress can livelock behind them).
- **PV412** — columnar claims need fixed-width schemas: when the plan arms
  the columnar path (or cuts a device stage), every device operator must
  declare a fixed-width schema (``schema_width >= 1``) — the block codec
  cannot type a column vector without one.

The module deliberately imports nothing from :mod:`repro.core` — it reads
the plan duck-typed — so ``core.api`` can import it lazily with no cycle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

CATALOG_VERSION = 4


@dataclass(frozen=True)
class PlanViolation:
    """One ordering-safety violation found in a :class:`PhysicalPlan`."""

    rule: str
    message: str
    stage: Optional[int] = None  # stage index, if stage-scoped
    op: Optional[str] = None  # operator name, if op-scoped

    def render(self) -> str:
        """One-line human-readable form (used by the raised error)."""
        where = ""
        if self.stage is not None:
            where = f" [stage {self.stage}]"
        elif self.op is not None:
            where = f" [op {self.op}]"
        return f"{self.rule}{where}: {self.message}"


def verify_plan(plan) -> List[PlanViolation]:
    """Check ``plan`` (a :class:`~repro.core.api.PhysicalPlan`) against the
    ordering-safety catalog; returns violations (empty = safe)."""
    v: List[PlanViolation] = []
    op_caps = {}
    for op in plan.ops:
        op_caps[op.name] = op.max_dop
        if op.kind == "stateful" and op.max_dop != 1:
            v.append(
                PlanViolation(
                    rule="PV406",
                    op=op.name,
                    message=f"stateful operator has max_dop={op.max_dop!r}; "
                    "a single state box requires exactly 1",
                )
            )
        elif op.kind == "partitioned" and (op.max_dop is None or op.max_dop < 1):
            v.append(
                PlanViolation(
                    rule="PV406",
                    op=op.name,
                    message=f"partitioned operator has max_dop={op.max_dop!r}; "
                    "needs its partition count (>= 1)",
                )
            )

    ring = getattr(plan, "ring", None) or {}
    if plan.backend == "process":
        widest = max((s.workers for s in plan.stages), default=1)
        if widest > 1 and not ring.get("reorder_size"):
            v.append(
                PlanViolation(
                    rule="PV405",
                    message=f"a stage runs {widest} workers but the plan "
                    "carries no reorder-ring geometry to drain through",
                )
            )
        if ring:
            io_batch = ring.get("io_batch") or 1
            reorder = ring.get("reorder_size") or 0
            inflight = ring.get("max_inflight") or 0
            if reorder < io_batch:
                v.append(
                    PlanViolation(
                        rule="PV403",
                        message=f"reorder_size={reorder} < io_batch={io_batch}: "
                        "a full span can never enter the ring window",
                    )
                )
            if inflight > reorder:
                v.append(
                    PlanViolation(
                        rule="PV403",
                        message=f"max_inflight={inflight} > reorder_size="
                        f"{reorder}: in-flight serials overrun the window",
                    )
                )
        ckpt_stages = [
            s for s in getattr(plan, "stages", ())
            if getattr(s, "checkpointed", False)
        ]
        for s in ckpt_stages:
            if s.kind not in ("keyed", "stateful", "device"):
                v.append(
                    PlanViolation(
                        rule="PV407",
                        stage=s.index,
                        message=f"{s.kind} stage marked checkpointed; only "
                        "keyed/stateful/device stages carry recovery state",
                    )
                )
        if ckpt_stages:
            interval = ring.get("checkpoint_interval") or 0
            io_batch = ring.get("io_batch") or 1
            if interval < 1:
                v.append(
                    PlanViolation(
                        rule="PV407",
                        message="stages are marked checkpointed but the plan "
                        "carries no checkpoint_interval in its ring geometry",
                    )
                )
            elif interval < io_batch:
                v.append(
                    PlanViolation(
                        rule="PV407",
                        message=f"checkpoint_interval={interval} < io_batch="
                        f"{io_batch}: epoch barriers ride dispatch-unit "
                        "boundaries, a shorter interval cannot be honored",
                    )
                )
        popts = getattr(getattr(plan, "config", None), "process", None)
        if popts is not None:
            grow = getattr(popts, "traffic_grow_util", None)
            shrink = getattr(popts, "traffic_shrink_util", None)
            if (
                grow is not None and shrink is not None
                and not (0 < shrink < grow)
            ):
                v.append(
                    PlanViolation(
                        rule="PV408",
                        message=f"traffic policy hysteresis is empty: "
                        f"shrink_util={shrink} must sit strictly inside "
                        f"(0, grow_util={grow}) or widths oscillate",
                    )
                )
            guard = getattr(popts, "resize_latency_budget", None)
            if guard is not None and guard <= 0:
                v.append(
                    PlanViolation(
                        rule="PV408",
                        message=f"resize_latency_budget={guard} must be "
                        "positive (None disables the p99 guard)",
                    )
                )
            if getattr(popts, "traffic_elastic", None) is True:
                stages = list(getattr(plan, "stages", ()))
                if stages and not any(
                    s.kind not in ("stateful", "device") and s.max_workers > 1
                    for s in stages
                ):
                    v.append(
                        PlanViolation(
                            rule="PV408",
                            message="traffic_elastic=True but no stage is "
                            "resizable (non-stateful with max_workers > 1): "
                            "the policy can never act",
                        )
                    )

    for s in getattr(plan, "stages", ()):
        if s.kind == "stateful" and s.workers > 1:
            v.append(
                PlanViolation(
                    rule="PV401",
                    stage=s.index,
                    message=f"stateful stage planned at width {s.workers}; "
                    "stateful stages are pinned at 1",
                )
            )
        if s.kind == "keyed":
            caps = [
                op_caps[name]
                for name in s.ops
                if op_caps.get(name) is not None
            ]
            cap = min(caps) if caps else None
            if cap is not None and s.workers > cap:
                v.append(
                    PlanViolation(
                        rule="PV402",
                        stage=s.index,
                        message=f"keyed stage width {s.workers} exceeds its "
                        f"partition count {cap}",
                    )
                )
        if s.workers > s.max_workers:
            v.append(
                PlanViolation(
                    rule="PV404",
                    stage=s.index,
                    message=f"width {s.workers} exceeds elastic headroom "
                    f"max_workers={s.max_workers}; the exchange has no "
                    "ingress ring for the extra workers",
                )
            )
        if s.kind == "device":
            pin = ring.get("device_workers")
            if pin is not None and s.workers != pin:
                v.append(
                    PlanViolation(
                        rule="PV410",
                        stage=s.index,
                        message=f"device stage planned at width {s.workers} "
                        f"but the ring geometry pins device_workers={pin}",
                    )
                )
            if s.max_workers != s.workers:
                v.append(
                    PlanViolation(
                        rule="PV410",
                        stage=s.index,
                        message=f"device stage has elastic headroom "
                        f"(max_workers={s.max_workers} != workers="
                        f"{s.workers}); per-worker batching state cannot "
                        "survive a resize",
                    )
                )

    dev_stages = [
        s for s in getattr(plan, "stages", ()) if s.kind == "device"
    ]
    if dev_stages and ring:
        io_batch = ring.get("io_batch") or 1
        dbatch = ring.get("device_batch") or 0
        dinflight = ring.get("device_inflight") or 1
        reorder = ring.get("reorder_size") or 0
        if dbatch and dbatch < io_batch:
            v.append(
                PlanViolation(
                    rule="PV411",
                    message=f"device_batch={dbatch} < io_batch={io_batch}: "
                    "a device batch must cover at least one dispatch unit",
                )
            )
        if dbatch and reorder and dbatch * dinflight > reorder:
            v.append(
                PlanViolation(
                    rule="PV411",
                    message=f"device_batch={dbatch} x device_inflight="
                    f"{dinflight} exceeds reorder_size={reorder}: unpublished "
                    "device rows overrun the ordered-egress window",
                )
            )
    if dev_stages or ring.get("columnar"):
        for op in plan.ops:
            if op.kind != "device":
                continue
            width = getattr(op, "schema_width", None)
            if not width or width < 1:
                v.append(
                    PlanViolation(
                        rule="PV412",
                        op=op.name,
                        message="device operator declares no fixed-width "
                        "columnar schema (schema_width must be >= 1)",
                    )
                )
    return v
