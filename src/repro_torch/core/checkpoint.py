# Port copy of src/repro/core/checkpoint.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Epoch checkpointing for stateful/keyed process stages (TStream-style
transactional state management grafted onto the serial protocol).

Protocol (the runtime wiring lives in :mod:`.procrun`):

1. Every ``checkpoint_interval`` serials a stage's *feeder* flushes its
   partial dispatch units and stamps a ``TAG_BARRIER`` record into every
   active ingress ring — the record's serial field is the epoch's boundary
   serial ``B`` (all serials ``< B`` precede it in every ring, per-ring FIFO)
   and its payload is the epoch number.
2. Each worker, on consuming the barrier, snapshots its worker-local state
   (exactly the elastic-handoff blob) and acks ``("ckpt", wid, epoch, B,
   blob)`` over its control pipe.  Nothing is published to the reorder ring
   for a barrier, so the serial stream is untouched.
3. The supervisor collects acks in this :class:`CheckpointStore`; an epoch
   *completes* when every active worker has acked, at which point it becomes
   the stage's restore point and the feeder is told to truncate its replay
   log below ``B`` (``("ckpt_done", epoch, B)``).
4. On a keyed/stateful worker crash the supervisor halts the feeder, kills
   the rest of the group, resets the ingress rings, re-forks the group
   preloaded with the epoch-``B`` snapshots, and has the feeder re-pump its
   replay log ``[B, …)`` — deterministic segments plus the reorder ring's
   per-serial idempotence make the recovered egress exact.

An elastic resize doubles as a *synthetic* checkpoint (:meth:`force`): the
quiesced handoff state at the resize boundary is already exactly a complete
epoch snapshot at the new width.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

_I8 = struct.Struct("<q")


def encode_barrier(epoch: int) -> bytes:
    """Barrier record payload: the 8-byte epoch number."""
    return _I8.pack(epoch)


def decode_barrier(data: bytes) -> int:
    return _I8.unpack(data)[0]


@dataclass
class Checkpoint:
    """A completed epoch: per-worker state blobs valid at ``boundary``
    (state after applying every serial ``< boundary``)."""

    epoch: int
    boundary: int
    blobs: Dict[int, Optional[bytes]] = field(default_factory=dict)


class CheckpointStore:
    """Supervisor-held snapshot store: pending per-epoch acks plus the
    latest *complete* checkpoint per stage (older epochs are dropped — the
    replay log only ever covers the latest boundary onward)."""

    def __init__(self) -> None:
        # pending acks keyed by BOUNDARY, not epoch: boundaries are globally
        # monotone per stage across feeder restarts (serial positions),
        # while epoch labels restart with a re-forked router's dispatcher.
        # Two barriers at the same boundary snapshot identical state
        # (deterministic replay), so merging their acks is sound.
        self._pending: Dict[int, Dict[int, Dict[int, Optional[bytes]]]] = {}
        self._epoch: Dict[Tuple[int, int], int] = {}  # (stage, B) -> label
        self._latest: Dict[int, Checkpoint] = {}
        self.completed = 0  # completed-epoch count (instrumentation)

    def ack(
        self, stage: int, wid: int, epoch: int, boundary: int,
        blob: Optional[bytes], width: int,
    ) -> Optional[Checkpoint]:
        """Record one worker's epoch ack; returns the finished
        :class:`Checkpoint` when this ack completes the epoch (every worker
        in ``range(width)`` acked), else None.  Replayed barriers re-ack
        idempotently; acks at or below the stage's latest complete boundary
        are ignored."""
        latest = self._latest.get(stage)
        if latest is not None and boundary <= latest.boundary:
            return None
        stage_pending = self._pending.setdefault(stage, {})
        acks = stage_pending.setdefault(boundary, {})
        acks[wid] = blob
        key = (stage, boundary)
        self._epoch[key] = max(self._epoch.get(key, 0), epoch)
        if set(acks) < set(range(width)):
            return None
        ckpt = Checkpoint(self._epoch[key], boundary, dict(acks))
        self._commit(stage, ckpt)
        return ckpt

    def force(self, stage: int, boundary: int, blobs: Dict[int, Optional[bytes]]) -> Checkpoint:
        """Install a synthetic checkpoint (elastic-resize quiesce: the
        handed-off state at the boundary IS a complete snapshot).  Epoch
        numbering continues from the stage's last complete epoch."""
        latest = self._latest.get(stage)
        epoch = (latest.epoch if latest else 0) + 1
        ckpt = Checkpoint(epoch, boundary, dict(blobs))
        self._commit(stage, ckpt)
        return ckpt

    def _commit(self, stage: int, ckpt: Checkpoint) -> None:
        self._latest[stage] = ckpt
        self.completed += 1
        stage_pending = self._pending.get(stage)
        if stage_pending:
            for b in [b for b in stage_pending if b <= ckpt.boundary]:
                del stage_pending[b]
        for key in [
            k for k in self._epoch if k[0] == stage and k[1] <= ckpt.boundary
        ]:
            del self._epoch[key]

    def latest(self, stage: int) -> Optional[Checkpoint]:
        """The stage's current restore point (None before the first
        complete epoch: recovery then replays from serial 1 with fresh
        state — the log is never truncated before a checkpoint exists)."""
        return self._latest.get(stage)

    def clear_pending(self, stage: int) -> None:
        """Drop in-flight (incomplete) epoch acks — a group restore or
        resize invalidates them (the replayed/new group re-acks)."""
        self._pending.pop(stage, None)
        for key in [k for k in self._epoch if k[0] == stage]:
            del self._epoch[key]
