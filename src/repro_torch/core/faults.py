# Port copy of src/repro/core/faults.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Deterministic fault injection for the process backend (chaos harness).

A :class:`FaultPlan` is a reproducible schedule of injected failures keyed by
``(stage, worker, serial)``.  Two delivery paths:

- **Supervisor-side** faults (``kill``, ``hang``, ``router_kill``) are process
  signals.  The parent samples each stage's drained-serial counter during its
  supervision tick and fires the signal once the counter crosses the spec's
  trigger serial — so a given plan kills at (approximately) the same stream
  position on every run, independent of wall-clock timing.
- **Child-side** faults (``op_error``, ``spill_delay``) ride the worker fork
  arguments: the worker raises :class:`InjectedFault` while processing the
  trigger serial, or sleeps before shipping a spill body.

``op_error`` composes with the per-op ``on_error`` policy
(:class:`FaultOptions`): ``raise`` aborts the job (the classic path),
``skip`` drops the offending tuple, ``dead_letter`` drops it AND quarantines
a :class:`DeadLetter` record surfaced in ``JobResult.dead_letters`` — so the
chaos battery can assert exact accounting of every injected failure.

Everything here is plain data (validated dataclasses): the runtime wiring
lives in :mod:`.procrun`, the config plumbing in :mod:`.api`.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

KILL = "kill"  # SIGKILL a worker once its stage drains past `serial`
HANG = "hang"  # SIGSTOP a worker (hung-not-dead: exercises stall detection)
ROUTER_KILL = "router_kill"  # SIGKILL the stage's exchange router
OP_ERROR = "op_error"  # raise InjectedFault inside the worker at `serial`
SPILL_DELAY = "spill_delay"  # sleep `delay`s before shipping a spill body

_KINDS = (KILL, HANG, ROUTER_KILL, OP_ERROR, SPILL_DELAY)
_CHILD_KINDS = (OP_ERROR, SPILL_DELAY)
ON_ERROR_POLICIES = ("raise", "skip", "dead_letter")


class InjectedFault(RuntimeError):
    """The exception an ``op_error`` fault raises inside a worker."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``serial`` is the trigger position in the
    stage's serial stream; ``worker`` is ignored for ``router_kill``;
    ``delay`` applies to ``spill_delay`` only."""

    kind: str
    stage: int = 0
    worker: int = 0
    serial: int = 1
    delay: float = 0.0

    def validate(self) -> None:
        """Raise ``ValueError`` if any field is out of range for its kind."""
        if self.kind not in _KINDS:
            raise ValueError(
                f"fault kind must be one of {_KINDS}, got {self.kind!r}"
            )
        if self.stage < 0 or self.worker < 0:
            raise ValueError("fault stage/worker must be >= 0")
        if self.serial < 1:
            raise ValueError("fault serial must be >= 1 (serials start at 1)")
        if self.kind == SPILL_DELAY and self.delay < 0:
            raise ValueError("spill_delay needs delay >= 0")


@dataclass
class FaultPlan:
    """A deterministic fault schedule: an explicit spec list, optionally
    derived from a seed (:meth:`generate`)."""

    specs: List[FaultSpec] = field(default_factory=list)
    seed: Optional[int] = None

    def validate(self) -> None:
        """Validate every spec in the schedule (see :meth:`FaultSpec.validate`)."""
        for spec in self.specs:
            spec.validate()

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_faults: int,
        stage_widths: Sequence[int],
        max_serial: int,
        kinds: Sequence[str] = (KILL,),
    ) -> "FaultPlan":
        """Derive a reproducible schedule from a seed: ``n_faults`` specs
        drawn uniformly over the given kinds, stages/workers (from
        ``stage_widths``), and serials in ``[1, max_serial]``."""
        rng = random.Random(seed)
        specs = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            stage = rng.randrange(len(stage_widths))
            if kind == ROUTER_KILL:
                stage = max(stage, 1) if len(stage_widths) > 1 else 1
            spec = FaultSpec(
                kind=kind,
                stage=stage,
                worker=rng.randrange(max(stage_widths[min(stage, len(stage_widths) - 1)], 1))
                if stage < len(stage_widths) else 0,
                serial=rng.randrange(1, max(max_serial, 2)),
                delay=rng.uniform(0.0, 0.05) if kind == SPILL_DELAY else 0.0,
            )
            specs.append(spec)
        plan = cls(specs=specs, seed=seed)
        plan.validate()
        return plan

    # -- delivery-path splits (consumed by procrun) -------------------------
    def supervisor_specs(self) -> List[FaultSpec]:
        """Signal faults the parent fires off drained-serial counters."""
        return [s for s in self.specs if s.kind not in _CHILD_KINDS]

    def child_specs(self, stage: int, worker: int) -> Dict[str, Dict[int, FaultSpec]]:
        """Faults a specific worker injects on itself, keyed
        ``kind -> {trigger serial -> spec}`` (empty dicts elided)."""
        out: Dict[str, Dict[int, FaultSpec]] = {}
        for s in self.specs:
            if s.kind in _CHILD_KINDS and s.stage == stage and s.worker == worker:
                out.setdefault(s.kind, {})[s.serial] = s
        return out


@dataclass
class FaultOptions:
    """Fault-injection config carried by :class:`~.api.EngineConfig`.

    ``on_error`` is the worker-side policy for operator exceptions (injected
    or organic): a single policy string, or a per-op ``{op_name: policy}``
    mapping (ops not named fall back to ``raise``)."""

    plan: Optional[FaultPlan] = None
    on_error: Union[str, Dict[str, str]] = "raise"

    def validate(self) -> None:
        """Validate the plan (if any) and every ``on_error`` policy name."""
        if self.plan is not None:
            self.plan.validate()
        policies = (
            self.on_error.values()
            if isinstance(self.on_error, dict)
            else [self.on_error]
        )
        for p in policies:
            if p not in ON_ERROR_POLICIES:
                raise ValueError(
                    f"on_error policy must be one of {ON_ERROR_POLICIES}, "
                    f"got {p!r}"
                )

    def policy_for(self, op_name: str) -> str:
        """Resolve the effective ``on_error`` policy for one operator."""
        if isinstance(self.on_error, dict):
            return self.on_error.get(op_name, "raise")
        return self.on_error

    def to_dict(self) -> dict:
        """Plain-dict form (JSON-safe) for configs and logs; inverse of
        :meth:`from_dict`."""
        return {
            "plan": None if self.plan is None else {
                "seed": self.plan.seed,
                "specs": [vars(s).copy() for s in self.plan.specs],
            },
            "on_error": self.on_error
            if isinstance(self.on_error, str)
            else dict(self.on_error),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultOptions":
        """Rebuild options from :meth:`to_dict` output."""
        plan = None
        if d.get("plan"):
            plan = FaultPlan(
                specs=[FaultSpec(**s) for s in d["plan"].get("specs", ())],
                seed=d["plan"].get("seed"),
            )
        return cls(plan=plan, on_error=d.get("on_error", "raise"))


@dataclass(frozen=True)
class DeadLetter:
    """One quarantined tuple: the input that made an operator raise under
    the ``dead_letter`` policy, with enough context to replay or audit it."""

    stage: int
    worker: int
    serial: int
    op: str
    value: object
    error: str


def resolve_policies(on_error, ops) -> Tuple[str, ...]:
    """Flatten an ``on_error`` config into one policy per op in a stage's
    run (fork-argument form: workers index it positionally)."""
    if isinstance(on_error, str):
        return tuple(on_error for _ in ops)
    return tuple(on_error.get(op.name, "raise") for op in ops)
