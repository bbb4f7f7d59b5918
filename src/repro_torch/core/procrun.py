# Port copy of src/repro/core/procrun.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Staged process-parallel execution backend (sidesteps the GIL).

The threaded :class:`~.runtime.StreamRuntime` can never exceed ~1 core of
real Python work; this backend runs the pipeline on **forked OS processes**
connected by shared-memory exchange edges (:mod:`.shm`):

  parent ──▶ stage₀ workers ──exchange──▶ stage₁ workers ──…──▶ parent
             (W₀ procs)       (router)     (W₁ procs)          (egress)

Execution model (pipeline × data parallelism over *stages*):

- The operator chain/DAG prefix is cut into **stages** at partitioned/
  stateful boundaries: a stage is either a run of stateless operators
  (round-robin routing, ``num_workers``-way data parallel), a partitioned
  operator plus its trailing stateless run (**keyed** routing by the
  operator's partitioner, so per-key state never crosses workers), or a
  stateful operator plus trailing stateless run (one worker — the operator's
  intrinsic serial constraint, but it still leaves the parent and overlaps
  with every other stage).  Anything uncuttable (``Split``/``Merge`` regions,
  fan-out) remains a **tail** executed in the parent after the final reorder.
  ``stages=1`` reproduces the ingress-only plan; ``stages=None`` (the
  default) cuts as deep as the graph allows.

- Each stage owns an :class:`~.shm.ExchangeRing`: per-worker ingress SPSC
  rings in, one serial-number reorder ring out (the paper's fig. 4
  non-blocking buffer, per stage).  The stage's *feeder* — the parent for
  stage 0, an **exchange router** process for every interior stage — drains
  the previous stage's reorder ring (already in stream order), assigns
  per-tuple serials, seals micro-batches of ``io_batch`` tuples, and routes
  them round-robin or by key.  Workers publish results under those serials:
  contiguous round-robin units as one span slot, keyed units one slot per
  tuple — per-worker batches carry per-tuple serials precisely so the
  downstream drain restores the cross-worker interleave order (this is what
  lets ``batch_size``/``io_batch`` and keyed stages compose).  End-of-stream
  is an in-band ``TAG_EOF`` published by each feeder at ``last_serial + 1``;
  ring contiguity delays it behind every real result, so EOF cascades stage
  by stage until the parent sees it at egress.

- The parent is a thin supervisor: it seals ingress units, drains the final
  reorder ring (running the uncuttable tail graph, if any, in serial order),
  monitors every child process, forwards spill bundles to the router that
  needs them, and aggregates stats.  It executes no operator ``fn`` bodies
  when the graph is fully staged (feeders — parent and routers — do still
  evaluate a keyed stage's ``key_fn``/``partitioner`` to route tuples, so
  those two callables must be cheap, exception-free, and fork-safe).

Crash tolerance: workers consume their ingress ring with peek → process →
publish → advance, so a killed worker strands at most one uncommitted unit
in shared memory; the parent re-forks a replacement onto the same rings and
the unit is transparently re-processed (duplicate publishes are idempotent —
see :mod:`.shm` — which requires segment functions to be **deterministic**).
Stateless stages recover this way per-worker.  Keyed/stateful stages
recover via **epoch checkpointing** (:mod:`.checkpoint`): the stage's
feeder stamps ``TAG_BARRIER`` records every ``checkpoint_interval`` serials
and keeps a replay log of every unit it pumped since the last complete
epoch; workers snapshot their state at each barrier and ack it to a
supervisor-held :class:`~.checkpoint.CheckpointStore`.  On a keyed/stateful
worker crash the supervisor halts the feeder, kills the rest of the group,
resets the ingress rings, re-forks the group preloaded with the epoch
snapshots, and re-pumps the log — per-serial publish idempotence makes the
recovered egress exact.  (``checkpoint_interval=0`` or
``restart_on_crash=False`` restores the old behaviour: such a crash
raises.)  Routers keep a crash-atomic *commit record* in the upstream
reorder header (:meth:`~.shm.ShmReorderRing.commit`) and are likewise
re-forked on death, resuming at the committed (read position, downstream
serial) pair; downstream duplicates are absorbed by per-serial publish
idempotence (stateless stages) or a worker-side ``last_seen`` trim
(keyed/stateful stages — state must not be double-applied).  A hung-not-
dead process (e.g. SIGSTOP) is caught by the supervisor's stall detector:
every worker/router bumps a monotone shm heartbeat, and a counter frozen
longer than ``stall_timeout`` gets SIGKILLed into the ordinary crash path.
Out of scope (documented): simultaneous death of a router and one of its
downstream workers, and a keyed/stateful crash after its feeder exited.

Deterministic fault injection (:mod:`.faults`) drives the chaos battery:
supervisor-side kill/hang/router-kill faults fire off drained-serial
counters; worker-side ``op_error``/``spill_delay`` faults ride fork
arguments.  Operator exceptions pass a per-op ``on_error`` policy —
``raise`` | ``skip`` | ``dead_letter`` — with quarantined tuples shipped to
the parent's ``dead_letters``.

Payloads ride fixed-width ring slots (units and result bundles pickled,
single int/float results raw); result bundles too large for a reorder slot
spill to the worker's pipe with a spill tag left in the ring, preserving
order — the parent relays spill bodies to the router that drains them.
With ``columnar=True`` fixed-width numeric units skip pickle entirely:
feeders seal them as ``TAG_COLBLOCK`` span slots (:mod:`repro.columnar`),
workers decode the column vectors zero-copy, and 1:1 numeric results ride
back out the same way.  Device stages work either way — with columnar off
the device worker converts pickled tuples to columns itself, serially —
so the knob is an honest pickle-vs-columnar A/B even on device chains.

**Device stages** (``OpSpec.kind == "device"``) are a fourth stage kind:
each worker wraps its op in a :class:`~repro_torch.columnar.DeviceExecutor`,
accumulating columnar units to ``device_batch`` rows and dispatching them
asynchronously to a CUDA kernel on a side stream (double-buffered; torch on
the CPU or the NumPy reference when the caller pins ``cpu`` / ``numpy``).
A CUDA context does not survive ``fork``: the parent must not have
initialised CUDA before it forks a ``cuda`` device worker (the preflight
in ``_setup`` raises), and each such worker opens its own context.
Because a device batch spans ingress units, the worker
must commit its ring cursor *before* publishing — so device stages are
not re-fork-recoverable and instead ride the keyed/stateful checkpoint +
replay-log group restore (publishes stay per-serial guarded, and
elementwise kernels make results independent of batch regrouping).  A
device worker also flushes partial batches on barriers, EOF, and upstream
stalls, so an idle pipeline can never wedge on rows parked below the
batch threshold.
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing
import os
import pickle
import signal
import threading
import time
import uuid
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .checkpoint import CheckpointStore, decode_barrier, encode_barrier
from .costmodel import (
    CostModel,
    OccupancyMonitor,
    TrafficMonitor,
    default_budget,
)
from .faults import (
    DeadLetter, FaultPlan, HANG, InjectedFault, KILL, OP_ERROR, ROUTER_KILL,
    SPILL_DELAY, resolve_policies,
)
from .operators import DEVICE, OpSpec, PARTITIONED, STATEFUL, STATELESS, _Marker
from .pipeline import GraphPipeline, Merge, NodeSpec, Split, percentile_latencies
from .runtime import RunReport
from . import shm

_PICKLE = pickle.HIGHEST_PROTOCOL

# Optional coverage hook for forked children: they exit via os._exit (no
# atexit), so the coverage gate (scripts/coverage_gate.py) installs a dump
# callable here pre-fork; workers/routers invoke it right before _exit.
_COV_HOOK: Optional[Callable[[], None]] = None


# Idle-nap tuning for child processes.  On this class of kernel a single
# time.sleep() costs ~50 µs of CPU regardless of the requested duration, so
# liveness comes from napping LESS OFTEN, not napping shorter: floors start
# high enough to avoid micro-nap storms and caps bound the wake rate of a
# starved process (the latency cost is ms-scale on drain edges only).
_IDLE_MIN = 2e-5
_IDLE_MAX = 2e-3
_CONN_POLL_IVL = 0.005  # router-side parent-pipe poll period (spills/control)


def _sig_raise(signum, frame):
    """SIGTERM/SIGINT handler installed while a stream is live: convert the
    signal into SystemExit so the supervisor's ``finally: stop()`` path reaps
    children and unlinks every shm segment.  The handler body must stay
    lock-free (analysis rule FS303): it can interrupt the supervisor at an
    arbitrary bytecode, including inside pipe/lock internals."""
    raise SystemExit(128 + signum)


class UnstagedGraphWarning(UserWarning):
    """``backend="process"`` could not stage part of the graph.

    Routing nodes (``Split``/``Merge``) and everything downstream of them run
    serially in the parent tail, so their throughput is bounded by one core.
    ``unstaged`` names the nodes left in the tail.
    """

    def __init__(self, unstaged: Sequence[str]):
        self.unstaged = tuple(unstaged)
        super().__init__(
            "backend='process' cannot stage routing nodes: "
            f"{', '.join(self.unstaged)} run(s) serially in the parent tail "
            "(throughput bounded by the parent core); restructure the graph "
            "into a linear prefix or use backend='thread' for "
            "Split/Merge-heavy graphs"
        )


def _chain_nodes(specs: Sequence[OpSpec]):
    names = [f"{i:03d}_{s.name}" for i, s in enumerate(specs)]
    return dict(zip(names, specs)), list(zip(names, names[1:]))


# ------------------------------------------------------------------ stage plan
@dataclass
class StagePlan:
    """One process stage: a worker group executing a run of operators."""

    kind: str  # "stateless" | "keyed" | "stateful" | "device"
    ops: List[OpSpec] = field(default_factory=list)
    workers: int = 1
    index: int = 0
    # Ring headroom for elastic replanning: the exchange is built with this
    # many ingress rings so the live group can be re-forked wider than its
    # initial width without re-creating shared memory.  0 = no headroom.
    max_workers: int = 0

    @property
    def recoverable(self) -> bool:
        """Only stateless stages survive a worker crash (no lost state).
        Device stages are stateless in the fn sense but advance their ring
        cursor before publishing (batches span units), so they recover via
        the checkpoint/replay-log path, not per-worker re-fork."""
        return all(op.kind == STATELESS for op in self.ops)

    @property
    def resizable(self) -> bool:
        """Elastic replanning can re-fork this stage at a new width:
        stateless trivially, keyed via quiesced state migration; stateful
        stages are pinned at one worker and device stages at their
        ``device_workers`` width (PV410 verifies the pin)."""
        return (
            self.kind not in ("stateful", "device")
            and max(self.max_workers, 1) > 1
        )

    def describe(self) -> str:
        names = ",".join(op.name for op in self.ops) or "<identity>"
        return f"stage{self.index}[{self.kind} x{self.workers}: {names}]"


def _plan_stages(
    nodes: Dict[str, NodeSpec],
    edges: Sequence[Tuple[str, str]],
    num_workers: int,
    max_stages: Optional[int],
    allocate: Optional[Callable[[List["StagePlan"]], List[int]]] = None,
    device_workers: int = 1,
):
    """Cut the graph's linear ingress prefix into stages.

    Returns ``(stages, tail_nodes, tail_edges)``.  The walk stops at the
    first routing node (Split/Merge) or fan-out — that remainder is the
    parent-side tail.  ``max_stages=1`` reproduces the ingress-only plan
    (maximal stateless run, or leading partitioned op + stateless run).

    ``allocate`` replaces the flat ``num_workers`` width with a cost-model
    allocation: called with the stage list, it returns one width per stage
    (see :meth:`~.costmodel.CostModel.allocate`); stateful stages stay
    pinned at 1 regardless."""
    cap = max_stages if max_stages and max_stages > 0 else (1 << 30)
    succ: dict[str, list] = {n: [] for n in nodes}
    pred: dict[str, list] = {n: [] for n in nodes}
    for u, v in edges:
        succ[u].append(v)
        pred[v].append(u)
    sources = [n for n in nodes if not pred[n]]
    if len(sources) != 1:
        raise ValueError(f"graph needs exactly one ingress (got {sources})")

    stages: list[StagePlan] = []
    cur_ops: list[OpSpec] = []
    cur_kind: Optional[str] = None
    seg_names: set[str] = set()

    def close_stage():
        nonlocal cur_ops, cur_kind
        if cur_ops:
            w = 1 if cur_kind == "stateful" else num_workers
            stages.append(StagePlan(cur_kind, cur_ops, w, len(stages)))
        cur_ops, cur_kind = [], None

    cur: Optional[str] = sources[0]
    while cur is not None:
        spec = nodes.get(cur)
        if not isinstance(spec, OpSpec) or len(succ.get(cur, ())) > 1:
            break
        if spec.kind == STATELESS:
            if cur_kind is None:
                if len(stages) >= cap:
                    break
                cur_kind = "stateless"
        elif spec.kind == DEVICE:
            # A device op owns its stage alone (the worker body is the batch
            # executor, not the segment interpreter) at a width pre-pinned to
            # device_workers — the cost-model allocator never touches it.
            close_stage()
            if len(stages) >= cap:
                break
            dw = max(int(device_workers), 1)
            stages.append(
                StagePlan("device", [spec], dw, len(stages), max_workers=dw)
            )
            seg_names.add(cur)
            cur = succ[cur][0] if succ[cur] else None
            continue
        else:  # partitioned/stateful operators must head their own stage
            close_stage()
            if len(stages) >= cap:
                break
            cur_kind = "keyed" if spec.kind == PARTITIONED else "stateful"
        cur_ops.append(spec)
        seg_names.add(cur)
        cur = succ[cur][0] if succ[cur] else None
    close_stage()

    if not stages:  # routing-headed graph: identity pass-through stage
        stages = [StagePlan("stateless", [], num_workers, 0)]
    if allocate is not None:
        widths = allocate(stages)
        for plan, w in zip(stages, widths):
            if plan.kind not in ("stateful", "device"):
                plan.workers = max(int(w), 1)
    tail_nodes = {k: v for k, v in nodes.items() if k not in seg_names}
    tail_edges = [(u, v) for u, v in edges if u not in seg_names]
    return stages, tail_nodes, tail_edges


# ------------------------------------------------------------- worker process
def _init_states(ops: Sequence[OpSpec]) -> list:
    return [
        [op.init_state()] if op.kind == STATEFUL else {} for op in ops
    ]


def _apply_segment(ops: Sequence[OpSpec], states: list, value: Any) -> list:
    """Flat-map ``value`` through the stage's operator run (worker-side)."""
    vals = [value]
    for oi, op in enumerate(ops):
        nxt: list = []
        if op.kind in (STATELESS, DEVICE):  # device: per-value reference fn
            fn = op.fn
            for v in vals:
                nxt.extend(fn(v))
        elif op.kind == STATEFUL:  # single-worker stage: one state box
            box = states[oi]
            for v in vals:
                box[0], outs = op.fn(box[0], v)
                nxt.extend(outs)
        else:  # partitioned: per-key state, worker-local (keyed routing)
            st_map = states[oi]
            for v in vals:
                k = op.key_fn(v)
                s = st_map.get(k)
                if s is None:
                    s = op.init_state()
                s, outs = op.fn(s, k, v)
                st_map[k] = s
                nxt.extend(outs)
        vals = nxt
        if not vals:
            break
    return vals


def _apply_segment_safe(ops, states, value, policies):
    """Policy-guarded :func:`_apply_segment`: an operator exception checks
    its op's ``on_error`` policy — ``raise`` propagates, ``skip``/
    ``dead_letter`` drop the input tuple's whole remaining expansion at that
    op and return ``(outs_so_far=[], (op_name, error, policy))``.  Ops
    earlier in the run have already seen the tuple (their state mutations
    stand); the quarantine covers the op that raised."""
    vals = [value]
    for oi, op in enumerate(ops):
        try:
            nxt: list = []
            if op.kind in (STATELESS, DEVICE):
                fn = op.fn
                for v in vals:
                    nxt.extend(fn(v))
            elif op.kind == STATEFUL:
                box = states[oi]
                for v in vals:
                    box[0], outs = op.fn(box[0], v)
                    nxt.extend(outs)
            else:
                st_map = states[oi]
                for v in vals:
                    k = op.key_fn(v)
                    s = st_map.get(k)
                    if s is None:
                        s = op.init_state()
                    s, outs = op.fn(s, k, v)
                    st_map[k] = s
                    nxt.extend(outs)
        except BaseException as exc:  # noqa: BLE001 — policy decides
            pol = policies[oi]
            if pol == "raise":
                raise
            return [], (op.name, f"{type(exc).__name__}: {exc}", pol)
        vals = nxt
        if not vals:
            break
    return vals, None


def _publish(reorder, conn, serial, tag, data, span, beat=None,
             spill_delay=None) -> None:
    """Publish one result slot, spilling oversized bodies via the pipe; spins
    (with teardown escape) while the reorder window is full.  ``beat`` keeps
    the worker's heartbeat live through a long FULL spin (backpressure is
    not a stall); ``spill_delay`` is the fault-injection hook."""
    if len(data) > reorder.payload_bytes:
        if spill_delay:
            spec = spill_delay.pop(serial, None)
            if spec is not None:
                time.sleep(spec.delay)
        conn.send(("spill", serial, tag, data))  # body via pipe, before the tag
        tag, data = shm.TAG_SPILL, b""
    spin = _IDLE_MIN
    while True:
        st = reorder.try_publish(serial, tag, data, span)
        if st != shm.ShmReorderRing.FULL:
            return
        if reorder.stopped():
            return
        if beat is not None:
            beat()
        time.sleep(spin)
        spin = min(spin * 2, _IDLE_MAX)


def _worker_main(wid, ingress, reorder, conn, seg_ops, preload=None,
                 stage=0, dedup=False, policies=None, child_faults=None,
                 columnar=False, dev_cfg=None):
    """Stage worker body (entered via fork; exits with os._exit).

    Consumes peek → process → publish → advance so a crash strands at most
    one uncommitted unit (see module docstring).  ``preload`` carries
    migrated per-key state (elastic resize) or a restored epoch snapshot
    (crash recovery).  ``dedup`` (keyed/stateful stages) arms the
    ``last_seen`` serial trim so duplicate units re-dispatched by a
    restarted router are never re-applied to state.  Every publish is
    guarded by :meth:`~.shm.ShmReorderRing.published` — replayed or
    duplicate serials whose result already landed are skipped, never
    republished (a second publisher could race the slot's reuse).

    ``policies`` is one ``on_error`` policy per op (positional);
    ``child_faults`` carries this worker's injected ``op_error``/
    ``spill_delay`` triggers keyed by serial.

    ``columnar`` arms the result-side columnar codec (1:1 numeric results
    publish as ``TAG_COLBLOCK`` instead of pickled ``TAG_BUNDLES``);
    columnar *ingress* needs no flag — any worker decodes ``TAG_COLBLOCK``
    units on arrival.  ``dev_cfg`` is ``(device_batch, device_inflight,
    device_backend)`` for device stages, whose whole worker body is the
    batch-executor path (see the module docstring)."""
    ingress.sync_consumer()  # crash replacement: resume at the shared cursor
    states = preload if preload is not None else _init_states(seg_ops)
    busy = 0.0
    processed = 0
    code = 0
    beat = ingress.beat
    last_seen = 0  # highest serial applied to state (dedup stages only)
    guarded = policies is not None and any(p != "raise" for p in policies)
    op_err = (child_faults or {}).get(OP_ERROR) or None
    spill_delay = (child_faults or {}).get(SPILL_DELAY) or None
    dead: list = []  # (serial, op, value, error) quarantined this unit

    # Columnar plumbing — imported lazily so non-columnar streams never pay
    # the numpy import in every forked child.
    col = None  # repro.columnar.codec module
    colout = None  # result-side codec (columnar-armed non-device stages)
    executor = None  # DeviceExecutor (device stages)
    ColumnBlock = None
    if seg_ops and seg_ops[0].kind == DEVICE:
        from ..columnar import codec as col
        from ..columnar.block import ColumnBlock
        from ..columnar.device import DeviceExecutor

        dbatch, dinflight, dbackend = dev_cfg or (256, 2, "cuda")
        # one torch thread per device worker: a pool the parent started
        # does not survive the fork, and the stage's CPU work is serial
        import torch

        torch.set_num_threads(1)
        try:
            executor = DeviceExecutor(
                seg_ops[0], batch=dbatch, inflight=dinflight, backend=dbackend
            )
        except BaseException as exc:  # noqa: BLE001 — e.g. no CUDA context
            # a worker that cannot reach its device fails the run: a
            # re-forked replacement would fail the same way, forever
            try:
                conn.send(("error", wid,
                           f"device worker setup failed: "
                           f"{type(exc).__name__}: {exc}"))
                conn.close()
            except Exception:
                pass
            os._exit(70)
    elif columnar:
        from ..columnar import codec as col

        colout = col.ColumnarCodec()

    def publish_block(out) -> None:
        # ordered-egress boundary: the executor synchronised `out` already;
        # publish rides the generic span/spill path under the block's head
        if not reorder.published(out.head_serial):
            _publish(reorder, conn, out.head_serial, shm.TAG_COLBLOCK,
                     col.encode_block(out), len(out), beat, spill_delay)

    def apply_one(serial, v):
        if op_err is not None and serial in op_err:
            op_err.pop(serial)
            msg = f"injected operator error at serial {serial}"
            pol = policies[0] if policies else "raise"
            if pol == "raise":
                raise InjectedFault(msg)
            err = (seg_ops[0].name if seg_ops else "<injected>",
                   f"InjectedFault: {msg}", pol)
            outs = []
        elif guarded:
            outs, err = _apply_segment_safe(seg_ops, states, v, policies)
        else:
            outs, err = _apply_segment(seg_ops, states, v), None
        if err is not None and err[2] == "dead_letter":
            dead.append((serial, err[0], v, err[1]))
        return outs

    try:
        idle = _IDLE_MIN
        while True:
            beat()
            # Sample the close flags BEFORE peeking: the producer publishes
            # its last records before setting closed, and stores are ordered,
            # so a peek issued after an observed close cannot miss a queued
            # record.  Peek-then-check races — an empty peek, then put+close
            # by the router, then the closed() read exits the worker with a
            # record abandoned in the ring, wedging the downstream reorder.
            closing = ingress.closed() or reorder.stopped()
            rec = ingress.peek()
            if rec is None:
                if (
                    executor is not None
                    and (executor.pending_rows or executor.inflight)
                    and (closing or idle >= 1e-3)
                ):
                    # liveness: an upstream stall (or EOF) must not park rows
                    # below the batch threshold — the inflight window could be
                    # wedged on exactly those serials.  Elementwise kernels
                    # make the partial-batch flush result-identical.
                    for out in executor.flush():
                        publish_block(out)
                if closing:
                    break
                time.sleep(idle)
                idle = min(idle * 2, _IDLE_MAX)
                continue
            idle = _IDLE_MIN
            serial, tag, data, nslots = rec
            if tag == shm.TAG_BARRIER:
                if executor is not None:
                    # every serial below the boundary must be published
                    # before the epoch can complete — once the replay log
                    # truncates at the boundary, unpublished older rows
                    # would be unrecoverable
                    for out in executor.flush():
                        publish_block(out)
                # epoch checkpoint: snapshot state-after-serials-< boundary
                # and ack over the pipe; nothing reaches the reorder ring.
                # Acking before advance keeps the snapshot ≤1 barrier stale
                # on a crash, and replayed barriers re-ack idempotently.
                epoch = decode_barrier(data)
                conn.send(("ckpt", wid, epoch, serial,
                           pickle.dumps(states, _PICKLE)))
                ingress.advance(nslots)
                continue
            t_begin = time.perf_counter()
            if tag == shm.TAG_KUNIT:
                serials, values, marks = pickle.loads(data)
                if dedup and serials and serials[0] <= last_seen:
                    # duplicate prefix from a restarted feeder: already
                    # applied AND published by this same worker (keyed
                    # routing is deterministic) — trim, don't re-apply
                    cut = 0
                    while cut < len(serials) and serials[cut] <= last_seen:
                        cut += 1
                    serials = serials[cut:]
                    values = values[cut:]
                    marks = [(i - cut, m) for i, m in marks if i >= cut]
                    if not serials:
                        ingress.advance(nslots)
                        continue
                by_off = dict(marks) if marks else None
                results = []
                for i, v in enumerate(values):
                    m = by_off.get(i) if by_off else None
                    if m is not None and not m.begin:
                        m.begin = time.perf_counter()
                    results.append((serials[i], apply_one(serials[i], v), m))
                if dedup:
                    last_seen = serials[-1]
                processed += len(values)
                busy += time.perf_counter() - t_begin
                # Per-SERIAL results so the downstream drain restores the
                # cross-worker interleave — but published as ONE batched
                # TAG_KBUNDLES slot at the unit's first serial (the drainer
                # scatter-stashes the rest), so reorder-ring traffic stays
                # per-unit.  Oversized batches fall back to per-tuple slots
                # (which may individually spill).  Both modes are publish-
                # guarded: the batching decision is deterministic, so a
                # crash-replayed unit re-derives exactly the slot shape its
                # predecessor used and the head check is exact.
                entries = []
                for s, outs, m in results:
                    if m is None:
                        btag, bdata = shm.encode_bundle(outs)
                    else:
                        if not outs:
                            m.exit = time.perf_counter()
                        btag, bdata = shm.TAG_MBUNDLE, pickle.dumps((outs, m), _PICKLE)
                    entries.append((s, btag, bdata))
                blob = pickle.dumps(entries, _PICKLE) if len(entries) > 1 else b""
                if len(entries) > 1 and len(blob) <= reorder.payload_bytes:
                    if not reorder.published(entries[0][0]):
                        _publish(reorder, conn, entries[0][0],
                                 shm.TAG_KBUNDLES, blob, 1, beat, spill_delay)
                else:
                    for s, btag, bdata in entries:
                        if not reorder.published(s):
                            _publish(reorder, conn, s, btag, bdata, 1,
                                     beat, spill_delay)
            else:  # TAG_UNIT/TAG_COLBLOCK: contiguous span [serial, serial+len)
                block = None
                if tag == shm.TAG_COLBLOCK:
                    if col is None:  # upstream device stage, columnar off
                        from ..columnar import codec as col
                    block = col.decode_block(data)
                    values, marks = None, block.marks
                else:
                    values, marks = pickle.loads(data)
                if executor is not None:
                    blk = block
                    if blk is None:
                        blk = ColumnBlock.from_values(
                            values, head_serial=serial, marks=marks,
                            schema=executor.schema,
                        )
                    elif blk.schema != executor.schema:
                        blk = ColumnBlock.from_values(
                            blk.to_values(), head_serial=serial, marks=marks,
                            schema=executor.schema,
                        )
                    if blk is not None:
                        for _, m in blk.marks:
                            if not m.begin:
                                m.begin = t_begin
                        ready = executor.submit(blk)
                        processed += len(blk)
                        busy += time.perf_counter() - t_begin
                        # Commit BEFORE publish: the device batch spans
                        # ingress units, so this worker can never be replayed
                        # by per-worker re-fork — device stages recover via
                        # the checkpoint/replay-log group restore, and the
                        # per-serial publish guards absorb replayed
                        # duplicates however the batches regroup.
                        ingress.advance(nslots)
                        for out in ready:
                            publish_block(out)
                        continue
                    # off-schema unit: per-value reference fallback below
                if values is None:
                    values = block.to_values()
                if dedup and serial <= last_seen:
                    cut = min(last_seen + 1 - serial, len(values))
                    values = values[cut:]
                    marks = [(i - cut, m) for i, m in marks if i >= cut]
                    serial += cut
                    if not values:
                        ingress.advance(nslots)
                        continue
                by_off = dict(marks) if marks else None
                bundles: list = []
                out_marks: list = []
                dropped: list = []
                for i, v in enumerate(values):
                    m = by_off.get(i) if by_off else None
                    if m is not None and not m.begin:
                        m.begin = time.perf_counter()
                    outs = apply_one(serial + i, v)
                    bundles.append(outs)
                    if m is not None:
                        if outs:
                            out_marks.append((i, m))
                        else:
                            m.exit = time.perf_counter()
                            dropped.append(m)
                if dedup:
                    last_seen = serial + len(values) - 1
                processed += len(values)
                busy += time.perf_counter() - t_begin
                if not reorder.published(serial):
                    enc = None
                    if colout is not None and not dropped and all(
                        len(b) == 1 for b in bundles
                    ):
                        # 1:1 numeric results stay columnar end-to-end; the
                        # slot shape (head, span) matches the TAG_BUNDLES
                        # fallback exactly, so the replay head check is
                        # indifferent to which encoding a predecessor chose
                        enc = colout.try_encode_unit(
                            [b[0] for b in bundles], out_marks, serial
                        )
                    if enc is not None:
                        _publish(reorder, conn, serial, shm.TAG_COLBLOCK,
                                 enc[0], len(values), beat, spill_delay)
                    else:
                        bdata = pickle.dumps(
                            (bundles, out_marks, dropped), _PICKLE
                        )
                        _publish(
                            reorder, conn, serial, shm.TAG_BUNDLES, bdata,
                            len(values), beat, spill_delay,
                        )
            if dead:
                conn.send(("dead", wid, dead))
                dead = []
            ingress.advance(nslots)  # commit only after the publish (replay)
    except BaseException as exc:  # noqa: BLE001 — forwarded to the parent
        code = 70
        try:
            conn.send(("error", wid, f"{type(exc).__name__}: {exc}"))
        except Exception:
            pass
    try:
        if code == 0 and ingress.handoff_requested():
            # elastic resize: the group is quiesced; hand worker-local state
            # back so the supervisor can re-shard it across the new width
            conn.send(("state", wid, pickle.dumps(states, _PICKLE)))
        conn.send(("stats", wid, busy, processed,
                   executor.stats() if executor is not None else None))
        conn.close()
    except Exception:
        pass
    if _COV_HOOK is not None:
        _COV_HOOK()
    os._exit(code)  # skip inherited atexit/resource_tracker teardown


# ------------------------------------------------------------------ dispatcher
class _Dispatcher:
    """The feeder half of an exchange edge: assigns per-tuple serials in
    stream order, seals ``io_batch``-sized units, and routes them into a
    stage's ingress rings (keyed for partitioned stages, round-robin
    otherwise).  Used by the parent (stage 0) and by every router."""

    def __init__(self, exchange: shm.ExchangeRing, plan: StagePlan,
                 io_batch: int, max_inflight: int, ckpt_interval: int = 0,
                 columnar: bool = False):
        self.x = exchange
        self.plan = plan
        self.workers = plan.workers  # ACTIVE width (<= exchange.consumers)
        self.io_batch = max(1, io_batch)
        self.max_inflight = max_inflight
        self.paused = False  # elastic replan: gate intake + liveness flushes
        self.keyed = plan.kind == "keyed"
        # Columnar sealing (non-keyed only — keyed units carry explicit
        # per-tuple serials and stay pickled).  Armed by the ``columnar``
        # knob alone: device workers accept both pickled units (converting
        # per tuple, serially) and TAG_COLBLOCK spans (zero-copy ingest),
        # so the flag is an honest A/B switch.  When feeding a device stage
        # the codec is pinned to the op's declared schema so blocks arrive
        # ready-typed.
        self._codec = None
        if columnar and not self.keyed:
            from ..columnar.codec import ColumnarCodec

            schema = (
                plan.ops[0].schema
                if plan.kind == "device" and plan.ops else None
            )
            self._codec = ColumnarCodec(schema)
        # Epoch checkpointing (keyed/stateful stages only): stamp a barrier
        # every ckpt_interval serials and keep a per-ring replay log of
        # every record pumped since the last COMPLETE epoch — the group-
        # restore recovery source (see module docstring).
        self.ckpt_interval = max(int(ckpt_interval or 0), 0)
        self.epoch = 0
        self._last_boundary = 0
        self._next_boundary = (
            1 + self.ckpt_interval if self.ckpt_interval else None
        )
        self._log: list[collections.deque] = [
            collections.deque() for _ in range(exchange.consumers)
        ]
        # accumulators/queues sized at the exchange's max width so an elastic
        # resize only moves the active-width cursor, never reallocates
        if self.keyed:
            head = plan.ops[0]
            self._key_fn, self._part = head.key_fn, head.partitioner
            # per-worker accumulators: (serials, values, marks)
            self._acc = [([], [], []) for _ in range(exchange.consumers)]
        else:
            self._vals: list = []
            self._marks: list = []
            self._head_serial = 1
        self.next_serial = 1
        self._rr = itertools.cycle(range(self.workers))
        # sealed units awaiting ring space: per-worker FIFO (keyed units must
        # stay ordered per ring; cross-ring order is restored by the reorder)
        self._outq: list[collections.deque] = [
            collections.deque() for _ in range(exchange.consumers)
        ]
        self._queued = 0

    def set_workers(self, w: int) -> None:
        """Elastic resize: point routing at the new active width.  Only legal
        on a quiesced dispatcher (accumulators and out-queues empty — the
        supervisor's pause → quiesce protocol guarantees it)."""
        self.workers = w
        self._rr = itertools.cycle(range(w))

    # -- intake gate --------------------------------------------------------
    def inflight(self) -> int:
        return self.next_serial - self.x.reorder.shared_next()

    def ready(self) -> bool:
        """Whether the feeder should accept more upstream tuples."""
        return (
            not self.paused
            and self._queued < 2 * self.workers
            and self.inflight() < self.max_inflight
        )

    # -- epoch barriers / replay log ----------------------------------------
    def stamp_barrier(self) -> None:
        """Seal the partials and append one ``TAG_BARRIER`` record per
        active ring: every serial < the boundary precedes it in its ring
        (per-ring FIFO), so a worker's barrier snapshot is exactly the
        state-at-boundary.  Barriers ride the out-queues and the replay log
        like any unit (a restored group re-acks them idempotently)."""
        self.flush()
        b = self.next_serial
        if b == self._last_boundary:  # no serials since the last barrier
            return
        self.epoch += 1
        self._last_boundary = b
        payload = encode_barrier(self.epoch)
        for w in range(self.workers):
            self._outq[w].append((b, shm.TAG_BARRIER, payload))
            self._queued += 1
        self._next_boundary = b + self.ckpt_interval

    def force_barrier(self) -> None:
        """Stamp an out-of-cadence barrier now (supervisor ``ckpt_now``,
        e.g. right after a router restart emptied the replay log)."""
        if self._next_boundary is not None and not self.paused:
            self.stamp_barrier()

    def truncate_log(self, boundary: int) -> None:
        """Epoch complete at ``boundary``: drop replayable records below it
        (units are entirely < or ≥ a boundary — barriers flush first) and
        the completed epoch's own barrier."""
        for q in self._log:
            while q:
                serial, tag, _data = q[0]
                if tag == shm.TAG_BARRIER:
                    if serial > boundary:
                        break
                elif serial >= boundary:
                    break
                q.popleft()

    def requeue_log(self) -> None:
        """Group restore: move the replay log back to the out-queue heads
        (the rings were reset; everything re-logs as it re-pumps)."""
        for w in range(len(self._outq)):
            log = self._log[w]
            if log:
                self._outq[w].extendleft(reversed(log))
                self._queued += len(log)
                self._log[w] = collections.deque()

    def restore_serial(self, serial: int) -> None:
        """Restarted-feeder resume: continue serial assignment exactly
        where the commit record left off."""
        self.next_serial = serial
        if not self.keyed:
            self._head_serial = serial

    # -- sealing ------------------------------------------------------------
    def add(self, value: Any, marker: Optional[_Marker]) -> None:
        if (
            self._next_boundary is not None
            and self.next_serial >= self._next_boundary
        ):
            self.stamp_barrier()
        serial = self.next_serial
        self.next_serial += 1
        if self.keyed:
            w = self._part(self._key_fn(value)) % self.workers
            serials, vals, marks = self._acc[w]
            if marker is not None:
                marks.append((len(vals), marker))
            serials.append(serial)
            vals.append(value)
            if len(vals) >= self.io_batch:
                self._seal_keyed(w)
        else:
            if marker is not None:
                self._marks.append((len(self._vals), marker))
            self._vals.append(value)
            if len(self._vals) >= self.io_batch:
                self._seal_contiguous()

    def _seal_keyed(self, w: int) -> None:
        serials, vals, marks = self._acc[w]
        if not vals:
            return
        self._acc[w] = ([], [], [])
        data = pickle.dumps((serials, vals, marks), _PICKLE)
        self._outq[w].append((serials[0], shm.TAG_KUNIT, data))
        self._queued += 1

    def _seal_contiguous(self) -> None:
        vals, marks = self._vals, self._marks
        if not vals:
            return
        self._vals, self._marks = [], []
        head = self._head_serial
        self._head_serial = self.next_serial
        if self._codec is not None:
            enc = self._codec.try_encode_unit(vals, marks, head)
            if enc is not None:
                self._outq[next(self._rr)].append(
                    (head, shm.TAG_COLBLOCK, enc[0])
                )
                self._queued += 1
                return
        data = pickle.dumps((vals, marks), _PICKLE)
        self._outq[next(self._rr)].append((head, shm.TAG_UNIT, data))
        self._queued += 1

    def add_block(self, block) -> bool:
        """Columnar pass-through: route a whole decoded block as one unit,
        re-stamped with this stage's serials — no per-tuple add, no pickle.
        Returns False when the block must be re-fed per-value instead
        (keyed routing, or a schema pinned to a different layout)."""
        if self.keyed or self._codec is None:
            return False
        if self._codec.schema is None:
            self._codec.schema = block.schema
        elif block.schema != self._codec.schema:
            return False
        if (
            self._next_boundary is not None
            and self.next_serial >= self._next_boundary
        ):
            self.stamp_barrier()
        self._seal_contiguous()  # partial scalar adds precede this block
        from ..columnar.codec import encode_block

        head = self.next_serial
        self.next_serial += len(block)
        self._head_serial = self.next_serial
        data = encode_block(block.with_serials(head))
        self._outq[next(self._rr)].append((head, shm.TAG_COLBLOCK, data))
        self._queued += 1
        return True

    def flush(self) -> None:
        """Seal every partial accumulator (source end / upstream idle)."""
        if self.keyed:
            for w in range(self.workers):
                self._seal_keyed(w)
        else:
            self._seal_contiguous()

    # -- dispatch -----------------------------------------------------------
    def pump(self) -> bool:
        """Move sealed units into ingress rings; True if anything moved.
        With checkpointing armed, every record that enters a ring is also
        appended to that ring's replay log — the log is exactly what was
        pumped since the last complete epoch, in per-ring order."""
        progress = False
        log = self.ckpt_interval > 0
        for w, q in enumerate(self._outq):
            ring = self.x.rings[w]
            while q:
                serial, tag, data = q[0]
                if not ring.put(serial, tag, data):
                    break  # ring full: backpressure, try again later
                q.popleft()
                if log:
                    self._log[w].append((serial, tag, data))
                self._queued -= 1
                progress = True
        return progress

    def pending(self) -> bool:
        return self._queued > 0 or (
            any(acc[1] for acc in self._acc) if self.keyed else bool(self._vals)
        )

    def publish_eof(self) -> bool:
        """Publish the in-band end-of-stream marker at ``last_serial + 1``.
        Contiguity holds it behind every real result.  False while the
        reorder window cannot accept it yet."""
        st = self.x.reorder.try_publish(self.next_serial, shm.TAG_EOF, b"")
        return st != shm.ShmReorderRing.FULL

    def stall_flush(self) -> bool:
        """The feeders' shared liveness rule: when the pipeline stalls,
        release partial units.  Keyed batches fill unevenly, so a waiting
        partial can hold exactly the serial the downstream drain (and
        therefore the inflight window) is blocked on — keeping it would
        deadlock.  Returns True if anything was dispatched.  No-op while the
        dispatcher is paused for an elastic replan (nothing may enter the
        rings mid-quiesce)."""
        if self.paused:
            return False
        self.flush()
        return self.pump()


# -------------------------------------------------------------- router process
def _pump_router_conn(conn, spills, ctrl=None) -> None:
    """Drain parent→router messages (spill bodies + elastic pause/resume
    control, which lands in ``ctrl``); never blocks."""
    try:
        while conn.poll():
            msg = conn.recv()
            if msg[0] == "spill":
                spills[msg[1]] = (msg[2], msg[3])
            elif ctrl is not None:
                ctrl.append(msg)
    except (EOFError, OSError):
        pass


def _await_spill(spills, serial, pump, timeout: float = 10.0, describe=None):
    """Wait (≤ ``timeout`` s) for a spill body to land in ``spills`` via
    ``pump`` — a callable draining pending pipe messages.  Shared by the
    parent (conns sweep) and the routers (parent-relay pipe).  ``describe``
    supplies stage/backlog context for the raise so a lost spill is
    diagnosable from the exception alone."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if serial in spills:
            return spills.pop(serial)
        pump()
        time.sleep(0.001)
    ctx = f" ({describe()})" if describe is not None else ""
    raise TimeoutError(
        f"spilled bundle for serial {serial} never arrived within "
        f"{timeout:.1f}s{ctx}; raise spill_timeout in ProcessOptions if the "
        "pipe relay is just slow"
    )


def _router_main(ridx, upstream, exchange, conn, plan, io_batch, max_inflight,
                 ckpt_interval=0, spill_timeout=10.0, columnar=False):
    """Exchange-router body: drain the upstream stage's reorder ring (stream
    order), re-stamp serials, seal/route units into the downstream stage, and
    cascade EOF.  Never runs operator ``fn`` bodies — though keyed routing
    does evaluate the downstream head's ``key_fn``/``partitioner`` here.

    The upstream drain is read-ahead/commit split (restartability): reads
    move a router-local cursor, and the shared window — whose slots double
    as the replay source for a router replacement — advances only at
    :meth:`~.shm.ShmReorderRing.commit` points, taken when everything read
    has durably left router memory (accumulators, out-queues, and scatter
    stash all empty; forced via a flush once read-ahead spans half the
    ring).  A freshly forked replacement resumes from the committed
    (read position, downstream serial) pair via ``sync_drainer``.

    Parent-pipe control verbs: ``("pause",)`` → flush, stop feeding, ack
    ``("paused", ridx, next_serial)`` once drained (elastic quiesce);
    ``("resume", new_width[, boundary])`` → re-point routing (and truncate
    the replay log at the resize's synthetic checkpoint);
    ``("ckpt_done", epoch, boundary)`` → truncate the replay log;
    ``("ckpt_now",)`` → stamp an immediate barrier; ``("halt",)`` → ack
    ``("halted", ridx)`` and block (touching nothing) until
    ``("restore",)`` re-queues the replay log — the downstream group-restore
    window."""
    exchange.sync_feeder()  # restart: reload the ingress producer cursors
    resume_serial = upstream.sync_drainer()  # restart: committed pair
    disp = _Dispatcher(exchange, plan, io_batch, max_inflight, ckpt_interval,
                       columnar=columnar)
    if resume_serial > 1:
        disp.restore_serial(resume_serial)
    committed = upstream.read_pos()
    commit_span = max(upstream.size // 2, 1)
    want_commit = False
    spills: dict[int, tuple[int, bytes]] = {}
    ctrl: collections.deque = collections.deque()

    def pump_conn():
        upstream.beat_drainer()
        _pump_router_conn(conn, spills, ctrl)

    def service_ctrl():
        """Apply queued control verbs; blocks inside a halt window."""
        while ctrl:
            msg = ctrl.popleft()
            if msg[0] == "pause":
                disp.flush()  # seal partials: drain to a serial boundary
                disp.paused = True
                state["acked"] = False
            elif msg[0] == "resume":
                disp.set_workers(msg[1])
                if len(msg) > 2:  # resize = synthetic checkpoint
                    disp.truncate_log(msg[2])
                disp.paused = False
            elif msg[0] == "ckpt_done":
                disp.truncate_log(msg[2])
            elif msg[0] == "ckpt_now":
                disp.force_barrier()
            elif msg[0] == "halt":
                # downstream group restore: ack immediately and freeze —
                # the supervisor is about to reset our ingress rings, so
                # nothing may be pumped until ("restore",) re-queues the log
                conn.send(("halted", ridx))
                while True:
                    upstream.beat_drainer()
                    if ctrl:
                        m2 = ctrl.popleft()
                        if m2[0] == "restore":
                            disp.requeue_log()
                            break
                        continue  # drop stale verbs queued behind the halt
                    if conn.poll(0.01):
                        m2 = conn.recv()
                        if m2[0] == "spill":
                            spills[m2[1]] = (m2[2], m2[3])
                        else:
                            ctrl.append(m2)

    state = {"acked": False}
    describe = lambda: (  # noqa: E731
        f"stage {ridx} router, ingress backlog "
        f"{exchange.backlog_slots()} slots"
    )
    busy = 0.0
    code = 0
    try:
        idle = _IDLE_MIN
        eof = False
        conn_at = 0.0
        while not eof:
            if upstream.stopped():
                break
            now = time.monotonic()
            if now >= conn_at or disp.paused:
                # the parent pipe carries only rare traffic (spill bodies,
                # elastic control): poll it on a period, not per iteration —
                # Connection.poll() is a ~20 µs syscall on this kernel
                conn_at = now + _CONN_POLL_IVL
                pump_conn()
            service_ctrl()
            if disp.paused:
                if disp.pump():
                    continue  # keep moving sealed units into the rings
                if not state["acked"] and not disp.pending():
                    conn.send(("paused", ridx, disp.next_serial))
                    state["acked"] = True
                time.sleep(1e-3)
                continue
            drained = 0
            if disp.ready():
                t0 = time.perf_counter()
                for _ in range(64):  # batch the drain: one pump per sweep
                    got = upstream.read_ahead()
                    if got is None:
                        break
                    t, tag, data, _span = got
                    if tag == shm.TAG_EOF:
                        eof = True
                        break
                    if tag == shm.TAG_SPILL:
                        tag, data = _await_spill(
                            spills, t, pump_conn, spill_timeout, describe
                        )
                    _route_result(disp, conn, tag, data)
                    drained += 1
                if drained:
                    busy += time.perf_counter() - t0
            # commit policy: once read-ahead spans half the upstream window
            # (publishers would soon stall on FULL), flush the partials and
            # take the next safe commit point — everything read durably in
            # the downstream rings, no scatter entries awaiting their serial
            if upstream.read_pos() - committed >= commit_span:
                want_commit = True
                disp.flush()
            if (
                want_commit
                and not disp.pending()
                and not upstream.has_stashed()
            ):
                upstream.commit(disp.next_serial)
                committed = upstream.read_pos()
                want_commit = False
            if drained or eof:
                idle = _IDLE_MIN
                disp.pump()
                continue
            moved = disp.pump()
            if not moved and idle >= 1e-4:
                moved = disp.stall_flush()  # liveness: see _Dispatcher
                if (
                    not moved
                    and not disp.pending()
                    and not upstream.has_stashed()
                    and upstream.read_pos() > committed
                ):
                    # quiescent: bank the progress as a commit point
                    upstream.commit(disp.next_serial)
                    committed = upstream.read_pos()
                    want_commit = False
            if moved:
                idle = _IDLE_MIN
            else:
                time.sleep(idle)
                idle = min(idle * 2, _IDLE_MAX)
        if eof:
            disp.flush()
            spin = _IDLE_MIN
            done = False
            # Control stays serviced through the drain: a downstream group
            # restore can halt us here and refill the queue from the replay
            # log, which re-opens the close_ingress → publish_eof sequence.
            while not done and not exchange.reorder.stopped():
                pump_conn()
                service_ctrl()
                if disp.pending():  # drain our queue into the rings
                    if disp.pump():
                        spin = _IDLE_MIN
                    else:
                        time.sleep(spin)
                        spin = min(spin * 2, _IDLE_MAX)
                    continue
                exchange.close_ingress()  # workers drain the rest, then exit
                if disp.publish_eof():  # cascade EOF downstream
                    done = True
                else:
                    time.sleep(spin)
                    spin = min(spin * 2, _IDLE_MAX)
            if done and not upstream.has_stashed():
                upstream.commit(disp.next_serial)  # final window release
    except BaseException as exc:  # noqa: BLE001
        code = 71
        try:
            conn.send(("error", f"router{ridx}", f"{type(exc).__name__}: {exc}"))
        except Exception:
            pass
    try:
        conn.send(("stats", f"router{ridx}", busy, 0))
        conn.close()
    except Exception:
        pass
    if _COV_HOOK is not None:
        _COV_HOOK()
    os._exit(code)


def _route_result(disp, conn, tag, data) -> None:
    """Flatten one drained result slot into the downstream tuple stream."""
    if tag == shm.TAG_BUNDLES:
        bundles, out_marks, dropped = pickle.loads(data)
        if dropped:  # probes whose tuples were filtered: record at the parent
            conn.send(("marks", dropped))
        mk = dict(out_marks) if out_marks else None
        for i, outs in enumerate(bundles):
            m = mk.get(i) if mk else None
            for j, v in enumerate(outs):
                disp.add(v, m if j == 0 else None)
    elif tag == shm.TAG_MBUNDLE:
        outs, m = pickle.loads(data)
        if not outs and m is not None:
            conn.send(("marks", [m]))
        for j, v in enumerate(outs):
            disp.add(v, m if j == 0 else None)
    elif tag == shm.TAG_COLBLOCK:
        from ..columnar.codec import decode_block

        block = decode_block(data)
        if not disp.add_block(block):
            # keyed routing (or schema mismatch): per-value re-dispatch
            mk = dict(block.marks) if block.marks else None
            for i, v in enumerate(block.to_values()):
                disp.add(v, mk.get(i) if mk else None)
    else:
        for v in shm.decode_bundle(tag, data):
            disp.add(v, None)


# -------------------------------------------------------------- process runtime
class ProcessRuntime:
    """Drives a dataflow graph with staged OS-process worker groups connected
    by shared-memory exchange edges.

    Mirrors the :class:`~.runtime.StreamRuntime` reporting surface
    (``run(source) -> RunReport``) and the pipeline result surface
    (``outputs``, ``egress_count``, ``markers``) so ``run_pipeline``/
    ``run_graph`` can return it in the pipeline slot.

    ``num_workers`` is the worker-group size of each data-parallel stage
    (stateful stages always run one worker); ``stages`` caps how many stages
    the planner may cut (``None`` = as many as the graph allows, ``1`` = the
    ingress-only plan).

    ``num_workers="auto"`` replaces the flat width with a cost-model
    allocation (:mod:`.costmodel`): a ``worker_budget`` (default: cores + 1)
    is divided across stages in proportion to their predicted load, from
    declared/explicit ``cost_priors`` or — when no priors are given — a short
    profiled calibration pass over the first ``calibrate_tuples`` source
    tuples.  Auto mode also enables **elastic replanning** (``elastic=True``
    forces it for flat widths too): the supervisor samples per-stage
    occupancy every ``replan_interval`` seconds and, when one stage holds
    more than ``replan_threshold`` of the queued work for
    ``replan_patience`` consecutive samples, quiesces the affected stages at
    a serial-number boundary and re-forks their worker groups at the
    re-estimated widths (keyed state migrates through the quiesced handoff;
    see ``docs/architecture.md``).
    """

    def __init__(
        self,
        nodes: Dict[str, NodeSpec],
        edges: Sequence[Tuple[str, str]],
        *,
        num_workers=4,  # int, or "auto" for cost-model allocation
        marker_interval: int = 64,
        collect_outputs: bool = False,
        io_batch: Optional[int] = None,
        batch_size: int = 1,
        stages: Optional[int] = None,
        ring_slots: int = 2048,
        slot_bytes: int = 1024,
        reorder_size: int = 1024,
        reorder_payload: int = 4096,
        max_inflight: Optional[int] = None,  # dispatch units; default 8/worker
        restart_on_crash: bool = True,
        reorder_scheme: str = "non_blocking",
        worklist_scheme: str = "hybrid",
        worker_budget: Optional[int] = None,
        cost_priors: Optional[Dict[str, float]] = None,
        elastic: Optional[bool] = None,
        calibrate_tuples: int = 64,
        replan_interval: float = 0.25,
        replan_threshold: float = 0.55,
        replan_patience: int = 3,
        traffic_elastic: Optional[bool] = None,  # None = on when elastic
        traffic_interval: float = 0.5,
        traffic_grow_util: float = 0.85,
        traffic_shrink_util: float = 0.30,
        traffic_patience: int = 2,
        traffic_cooldown: float = 2.0,
        resize_latency_budget: Optional[float] = None,  # p99 guard; None off
        stage_widths: Optional[Sequence[int]] = None,  # pin a PhysicalPlan's widths
        columnar: bool = False,  # seal numeric units as TAG_COLBLOCK blocks
        device_batch: int = 256,  # rows per device kernel dispatch
        device_workers: int = 1,  # pinned width of every device stage
        device_inflight: int = 2,  # async dispatches in flight (2 = dbl-buf)
        device_backend: str = "cuda",  # cuda | cpu | numpy
        checkpoint_interval: int = 1024,  # serials per epoch; 0 disables
        stall_timeout: Optional[float] = None,  # hung-process detector; None off
        spill_timeout: float = 10.0,  # spill-body relay deadline (seconds)
        fault_plan: Optional[FaultPlan] = None,  # chaos-harness schedule
        on_error="raise",  # str | {op_name: str} of raise/skip/dead_letter
        **_ignored,  # thread-backend knobs (heuristic, ...) have no meaning here
    ):
        self.auto_workers = num_workers == "auto"
        if self.auto_workers:
            num_workers = 1  # provisional; the allocator sets real widths
        if not isinstance(num_workers, int) or num_workers < 1:
            raise ValueError(
                "num_workers must be a positive int or 'auto', got "
                f"{num_workers!r}"
            )
        if "fork" not in multiprocessing.get_all_start_methods():
            raise RuntimeError(
                "process backend requires the fork start method (POSIX); "
                "use backend='thread' on this platform"
            )
        self._ctx = multiprocessing.get_context("fork")
        self.num_workers = num_workers
        self.marker_interval = marker_interval
        self.collect_outputs = collect_outputs
        self.ring_slots = ring_slots
        self.slot_bytes = slot_bytes
        self.reorder_size = reorder_size
        self.reorder_payload = reorder_payload
        # batch_size (the thread path's knob) doubles as the dispatch-unit
        # size when io_batch is not given, so the two backends share one dial.
        if io_batch is None:
            io_batch = batch_size if batch_size and batch_size > 1 else 32
        self.io_batch = max(1, io_batch)
        self.columnar = bool(columnar)
        if not isinstance(device_batch, int) or device_batch < 1:
            raise ValueError(
                f"device_batch must be a positive int, got {device_batch!r}"
            )
        # a device batch smaller than a dispatch unit would split units
        # across dispatches for no win; clamp to the PV411 floor
        self.device_batch = max(device_batch, self.io_batch)
        if not isinstance(device_workers, int) or device_workers < 1:
            raise ValueError(
                f"device_workers must be a positive int, got {device_workers!r}"
            )
        self.device_workers = device_workers
        if not isinstance(device_inflight, int) or device_inflight < 1:
            raise ValueError(
                f"device_inflight must be a positive int, got "
                f"{device_inflight!r}"
            )
        self.device_inflight = device_inflight
        if device_backend not in ("cuda", "cpu", "numpy"):
            raise ValueError(
                f"device_backend must be cuda|cpu|numpy, got {device_backend!r}"
            )
        self.device_backend = device_backend
        self.restart_on_crash = restart_on_crash
        if not isinstance(checkpoint_interval, int) or checkpoint_interval < 0:
            raise ValueError(
                "checkpoint_interval must be an int >= 0 (0 disables), got "
                f"{checkpoint_interval!r}"
            )
        self.checkpoint_interval = checkpoint_interval
        self.stall_timeout = stall_timeout
        self.spill_timeout = float(spill_timeout)
        self.fault_plan = fault_plan
        if fault_plan is not None:
            fault_plan.validate()
        self.on_error = on_error
        # Parent nap ceiling while the stages grind.  On small boxes the
        # supervisor's wake rate competes with the worker groups for cores;
        # raising the cap trades a little drain latency for worker headroom.
        self.parent_idle_cap = float(_ignored.pop("parent_idle_cap", 5e-4))
        self._tail_opts = dict(
            reorder_scheme=reorder_scheme, worklist_scheme=worklist_scheme
        )

        self.cost_priors = dict(cost_priors) if cost_priors else None
        self.worker_budget = worker_budget
        self.calibrate_tuples = max(int(calibrate_tuples), 0)
        self.elastic = self.auto_workers if elastic is None else bool(elastic)
        self.replan_interval = replan_interval
        self.replan_threshold = replan_threshold
        self.replan_patience = replan_patience
        # traffic-reactive elasticity needs the elastic machinery (stage
        # headroom, quiesce/re-fork); an explicit True arms both.
        if traffic_elastic is None:
            self.traffic_elastic = self.elastic
        else:
            self.traffic_elastic = bool(traffic_elastic)
            if self.traffic_elastic and elastic is False:
                raise ValueError(
                    "traffic_elastic=True requires elastic replanning "
                    "(elastic must not be False)"
                )
            if self.traffic_elastic:
                self.elastic = True
        self.traffic_interval = traffic_interval
        self.traffic_grow_util = traffic_grow_util
        self.traffic_shrink_util = traffic_shrink_util
        self.traffic_patience = traffic_patience
        self.traffic_cooldown = traffic_cooldown
        self.resize_latency_budget = resize_latency_budget

        self.node_specs = dict(nodes)
        self.edges = [tuple(e) for e in edges]
        allocate = None
        if self.auto_workers:
            budget = worker_budget if worker_budget else default_budget()
            self.worker_budget = budget

            def allocate(plans):  # noqa: F811 — prior-based initial widths
                self.cost_model = CostModel(
                    plans, self.cost_priors, device_batch=self.device_batch
                )
                return self.cost_model.allocate(budget)

        self.stage_plans, tail_nodes, tail_edges = _plan_stages(
            self.node_specs, self.edges, num_workers, stages, allocate,
            device_workers=self.device_workers,
        )
        if not self.auto_workers:
            self.cost_model = CostModel(
                self.stage_plans, self.cost_priors,
                device_batch=self.device_batch,
            )
        # Executing a pre-made PhysicalPlan: pin the planner's widths (the
        # plan was built from the same priors, so this is reproducibility,
        # not override) and skip the run-time calibration pass — elastic
        # replanning, when enabled, may still adjust the live widths.
        self.pinned_widths = list(stage_widths) if stage_widths else None
        if self.pinned_widths:
            if len(self.pinned_widths) != len(self.stage_plans):
                raise ValueError(
                    f"stage_widths has {len(self.pinned_widths)} entries for "
                    f"{len(self.stage_plans)} planned stages"
                )
            for plan, w in zip(self.stage_plans, self.pinned_widths):
                if plan.kind not in ("stateful", "device"):
                    plan.workers = max(int(w), 1)
        if self.worker_budget is None:
            # elastic replanning with flat widths: the budget it may
            # redistribute is exactly what the flat plan spent
            self.worker_budget = sum(p.workers for p in self.stage_plans)
        self._set_stage_headroom()
        # In-flight serials are doubly bounded: by the reorder window
        # (correctness — workers must be able to publish) and by this backlog
        # throttle (latency — an unbounded backlog pushes queueing delay into
        # every marker while adding nothing once each worker has spare units).
        widest = max(p.workers for p in self.stage_plans)
        self._explicit_inflight = max_inflight is not None
        units = max_inflight if max_inflight else 8 * max(num_workers, widest)
        self.max_inflight = min(reorder_size, max(units * self.io_batch, 1))

        self.tail_node_names = sorted(tail_nodes)  # plan introspection
        unstaged_routing = [
            name for name, spec in tail_nodes.items()
            if isinstance(spec, (Split, Merge))
        ]
        if unstaged_routing:
            warnings.warn(
                UnstagedGraphWarning(sorted(tail_nodes)), stacklevel=3
            )
        self._tail: Optional[GraphPipeline] = None
        if tail_nodes:
            self._tail = GraphPipeline(
                tail_nodes,
                tail_edges,
                marker_interval=0,  # markers are injected by the parent
                collect_outputs=collect_outputs,
                num_workers=1,
                **self._tail_opts,
            )

        # result surface (used directly when the tail is empty)
        # lock-free: only the single-threaded parent supervisor touches these
        self.outputs: list = []
        self.markers: list[_Marker] = []
        self._egress_count = 0
        self._first_push_ts: Optional[float] = None
        self._last_egress_ts: Optional[float] = None

        # live state
        self._exchanges: List[shm.ExchangeRing] = []
        self._procs: List[Optional[multiprocessing.Process]] = []
        self._pinfo: List[tuple] = []  # ("worker", stage, widx) | ("router", stage)
        self._conns: List[Any] = []
        self._router_conns: dict[int, Any] = {}  # stage idx -> parent-side duplex
        self._disp: Optional[_Dispatcher] = None
        self._spills: dict[int, tuple[int, bytes]] = {}
        self._eof_seen = False
        self._worker_busy = 0.0
        self._worker_processed = 0
        #: one DeviceExecutor.stats() dict per device worker that exited
        #: cleanly, each tagged with its stage (observability)
        self.device_stats: List[dict] = []
        self.restarts = 0  # crash-recovery instrumentation

        # fault-tolerance state (armed per start_stream in _setup)
        self.dead_letters: List[DeadLetter] = []
        self.recoveries = 0  # completed recovery events (group or router)
        self.recovery_time_s = 0.0  # supervisor time inside group restores
        self._ckpt: Optional[CheckpointStore] = None
        self._log_floor: dict[int, int] = {}  # stage -> lowest replayable serial
        self._beats: dict[int, tuple] = {}  # proc idx -> (pid, beat, ts)
        self._halted: set[int] = set()  # stages whose feeder acked a halt
        self._spill_cache: dict[int, dict[int, tuple]] = {}  # stage -> serial -> msg
        self._dead_seen: set[tuple] = set()  # (stage, serial, op) dedup
        self._fault_queue: list = []  # [FaultSpec, fired] pairs
        self._prev_sig: list = []  # (signum, prior handler) to restore

        # elastic replanning state
        self._monitor: Optional[OccupancyMonitor] = None
        self._traffic: Optional[TrafficMonitor] = None
        self._resizes: collections.deque = collections.deque()
        self._active_replan: Optional[dict] = None
        self._handoff: dict[tuple[int, int], bytes] = {}  # (stage, widx) -> blob
        self.replans = 0  # completed elastic replan events (instrumentation)
        # resize-latency accounting (the p99-guard's evidence trail)
        self.resize_stalls: List[float] = []  # begin->finish wall s, completed
        self.resize_aborts = 0  # guard-triggered aborts (stall > budget)
        self.resize_reverts = 0  # over-budget traffic resizes undone
        self.grows = 0  # completed resizes that widened a stage
        self.shrinks = 0  # completed resizes that narrowed a stage

    @classmethod
    def from_chain(cls, specs: Sequence[OpSpec], **kw) -> "ProcessRuntime":
        """Build a runtime for a linear operator chain (names auto-derived)."""
        nodes, edges = _chain_nodes(list(specs))
        return cls(nodes, edges, **kw)

    def _set_stage_headroom(self) -> None:
        """Fix each stage's ring headroom (``StagePlan.max_workers``): the
        widest group an elastic resize may re-fork.  Bounded by the worker
        budget minus one worker for every other stage, and by the stage's
        intrinsic cap (stateful: 1, keyed: its partition count)."""
        caps = self.cost_model.stage_caps()
        spare = max(self.worker_budget - (len(self.stage_plans) - 1), 1)
        for plan, cap in zip(self.stage_plans, caps):
            if not self.elastic or plan.kind in ("stateful", "device"):
                plan.max_workers = plan.workers
            else:
                plan.max_workers = max(min(cap, spare), plan.workers)

    # --------------------------------------------------------------- topology
    @property
    def num_stages(self) -> int:
        """How many stages the planner cut (1 = ingress-only plan)."""
        return len(self.stage_plans)

    def stage_widths(self) -> list[int]:
        """Current per-stage worker-group widths (allocation introspection)."""
        return [p.workers for p in self.stage_plans]

    def worker_groups(self) -> list[list[multiprocessing.Process]]:
        """Live worker processes per stage (crash tests / introspection)."""
        groups: list[list] = [[] for _ in self.stage_plans]
        for p, info in zip(self._procs, self._pinfo):
            if p is not None and info[0] == "worker":
                groups[info[1]].append(p)
        return groups

    # -------------------------------------------------------------- lifecycle
    def _ckpt_enabled(self, stage: int) -> bool:
        """Whether this stage recovers by epoch checkpoint + replay
        (keyed/stateful stages for their state, device stages because their
        batches span ring units; stateless re-forks per worker)."""
        return (
            self.checkpoint_interval > 0
            and self.restart_on_crash
            and self.stage_plans[stage].kind in ("keyed", "stateful", "device")
        )

    def _stage_ckpt_interval(self, stage: int) -> int:
        # barriers stamp at dispatch-unit boundaries, so an interval below
        # io_batch would degenerate to one epoch per unit; clamp (PV407)
        if not self._ckpt_enabled(stage):
            return 0
        return max(self.checkpoint_interval, self.io_batch)

    def _device_preflight(self, plan: StagePlan) -> None:
        """Check a device stage's backend in the parent, before any fork:
        the card must be there for ``cuda``, and this process must not have
        initialised CUDA; then build the stage's kernel once."""
        from ..columnar.device import (
            cuda_fork_hazard, prepare_backend, resolve_backend,
        )

        backend = resolve_backend(
            plan.ops[0].device_backend or self.device_backend
        )
        if backend == "cuda" and cuda_fork_hazard():
            # Fail fast: a CUDA context does not survive fork, so a
            # forked child of a CUDA-initialised parent fails on its
            # first CUDA call.
            raise RuntimeError(
                "cannot fork a cuda device worker: this process has "
                "already initialised CUDA (it ran a CUDA op), and a "
                "CUDA context does not survive fork. Run the engine "
                "from a process that has not touched the card (e.g. a "
                "subprocess), or pin device_backend='cpu'|'numpy' for "
                "this run."
            )
        # compile the stage's kernel here, once, before any fork
        prepare_backend(plan.ops[0], backend)

    def _fork_worker(self, stage: int, widx: int, slot: Optional[int] = None,
                     preload=None):
        x = self._exchanges[stage]
        plan = self.stage_plans[stage]
        if plan.kind == "device" and plan.ops:
            self._device_preflight(plan)
        parent_conn, child_conn = self._ctx.Pipe(duplex=False)
        child_faults = (
            self.fault_plan.child_specs(stage, widx)
            if self.fault_plan is not None else None
        )
        dev_cfg = (
            (self.device_batch, self.device_inflight, self.device_backend)
            if plan.kind == "device" else None
        )
        proc = self._ctx.Process(
            target=_worker_main,
            args=(widx, x.rings[widx], x.reorder, child_conn, plan.ops,
                  preload, stage, plan.kind != "stateless",
                  resolve_policies(self.on_error, plan.ops), child_faults,
                  self.columnar, dev_cfg),
            daemon=True,
        )
        proc.start()
        child_conn.close()
        if slot is None:
            self._procs.append(proc)
            self._pinfo.append(("worker", stage, widx))
            self._conns.append(parent_conn)
        else:  # crash replacement: same rings, fresh pipe
            self._procs[slot] = proc
            self._conns[slot] = parent_conn

    def _fork_router(self, stage: int, slot: Optional[int] = None) -> None:
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=_router_main,
            args=(stage, self._exchanges[stage - 1].reorder,
                  self._exchanges[stage], child_conn,
                  self.stage_plans[stage], self.io_batch, self.max_inflight,
                  self._stage_ckpt_interval(stage), self.spill_timeout,
                  self.columnar),
            daemon=True,
        )
        proc.start()
        child_conn.close()
        if slot is None:
            self._procs.append(proc)
            self._pinfo.append(("router", stage))
            self._conns.append(parent_conn)
        else:  # crash replacement: resumes from the reorder commit record
            self._procs[slot] = proc
            self._conns[slot] = parent_conn
        self._router_conns[stage] = parent_conn

    def _setup(self) -> None:
        for plan in self.stage_plans:  # before any ring or fork exists
            if plan.kind == "device" and plan.ops:
                self._device_preflight(plan)
        # the port's segments carry their own prefix, apart from the JAX
        # package's ``repro_*`` ones (leak checks list /dev/shm by prefix)
        run_id = f"rtorch_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        self._exchanges = [
            shm.ExchangeRing(
                f"{run_id}_s{plan.index}",
                max(plan.max_workers, plan.workers),  # elastic ring headroom
                ring_slots=self.ring_slots,
                slot_bytes=self.slot_bytes,
                reorder_size=self.reorder_size,
                reorder_payload=self.reorder_payload,
            )
            for plan in self.stage_plans
        ]
        for x, plan in zip(self._exchanges, self.stage_plans):
            x.set_active_width(plan.workers)
        # stage-0 workers first (supervision order mirrors the dataflow)
        for stage, plan in enumerate(self.stage_plans):
            for w in range(plan.workers):
                self._fork_worker(stage, w)
        for stage in range(1, len(self.stage_plans)):
            self._fork_router(stage)
        self._disp = _Dispatcher(
            self._exchanges[0], self.stage_plans[0], self.io_batch,
            self.max_inflight, self._stage_ckpt_interval(0),
            columnar=self.columnar,
        )
        self._ckpt = CheckpointStore()
        self._log_floor = {s: 1 for s in range(len(self.stage_plans))}
        self._beats = {}
        self._halted = set()
        self._spill_cache = {}
        self._dead_seen = set()
        self.dead_letters = []
        self._fault_queue = (
            [[spec, False] for spec in self.fault_plan.supervisor_specs()]
            if self.fault_plan is not None else []
        )
        self._eof_seen = False
        self._monitor = None
        self._traffic = None
        if self.elastic and any(p.resizable for p in self.stage_plans):
            self._monitor = OccupancyMonitor(
                self.cost_model,
                self.worker_budget,
                interval=self.replan_interval,
                occupancy_threshold=self.replan_threshold,
                patience=self.replan_patience,
            )
            if self.traffic_elastic:
                # inert until a serving tier feeds it via observe_traffic()
                self._traffic = TrafficMonitor(
                    self.cost_model,
                    self.worker_budget,
                    interval=self.traffic_interval,
                    grow_util=self.traffic_grow_util,
                    shrink_util=self.traffic_shrink_util,
                    patience=self.traffic_patience,
                    cooldown=self.traffic_cooldown,
                )
        self._resizes.clear()
        self._active_replan = None
        self._handoff = {}

    def stop(self) -> None:
        """Tear everything down; idempotent, always unlinks shared memory."""
        for signum, prev in self._prev_sig:  # restore caller's handlers first
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_sig = []
        for x in self._exchanges:
            try:
                x.request_stop()  # unstick FULL-spinning publishers/routers
                x.close_ingress()
            except Exception:
                pass
        for p in self._procs:
            if p is not None:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=1.0)
                if p.is_alive():  # SIGSTOPped children ignore SIGTERM
                    p.kill()
                    p.join(timeout=1.0)
        self._drain_conns(final=True)
        for conn in self._conns:
            try:
                conn.close()
            except Exception:
                pass
        for x in self._exchanges:
            x.close()
            x.unlink()
        self._exchanges = []
        self._procs, self._pinfo, self._conns = [], [], []
        self._router_conns = {}
        self._disp = None
        self._monitor = None
        self._traffic = None
        self._active_replan = None
        self._resizes.clear()
        self._handoff = {}
        self._ckpt = None
        self._beats = {}
        self._halted = set()
        self._spill_cache = {}

    # ---------------------------------------------------------------- plumbing
    def _drain_conns(self, final: bool = False) -> None:
        """Sweep child pipes for spills / stats / marks / errors.

        ``final`` (cleanup context) swallows worker errors: by then every
        input has drained, so a late error cannot have corrupted the output.
        """
        for idx, conn in enumerate(self._conns):
            if conn is None:
                continue
            try:
                while conn.poll():
                    self._on_message(idx, conn.recv(), ignore_errors=final)
            except (EOFError, OSError):
                continue

    def _on_message(self, idx: int, msg, ignore_errors: bool = False) -> None:
        kind = msg[0]
        if kind == "spill":
            # Route the body to whoever drains that stage's reorder ring:
            # the next stage's router, or the parent for the final stage.
            # Router-bound bodies are also cached until the drain commits
            # past them — a restarted router re-reads the spill tag and the
            # body in the dead router's memory is gone.
            stage = self._pinfo[idx][1]
            target = self._router_conns.get(stage + 1)
            if target is None:
                self._spills[msg[1]] = (msg[2], msg[3])
            else:
                self._spill_cache.setdefault(stage + 1, {})[msg[1]] = msg
                try:
                    target.send(msg)
                except (BrokenPipeError, OSError):
                    pass  # router died: the cache replays after its restart
        elif kind == "ckpt":  # worker's epoch-barrier state snapshot
            info = self._pinfo[idx]
            stage = info[1]
            done = self._ckpt.ack(
                stage, msg[1], msg[2], msg[3], msg[4],
                self.stage_plans[stage].workers,
            )
            if done is not None:  # epoch complete: truncate the replay log
                self._log_floor[stage] = max(
                    self._log_floor.get(stage, 1), done.boundary
                )
                if stage == 0:
                    self._disp.truncate_log(done.boundary)
                else:
                    conn = self._router_conns.get(stage)
                    if conn is not None:
                        try:
                            conn.send(("ckpt_done", done.epoch, done.boundary))
                        except (BrokenPipeError, OSError):
                            pass  # dead router keeps a longer log: harmless
        elif kind == "dead":  # quarantined tuples (on_error="dead_letter")
            info = self._pinfo[idx]
            for serial, op, value, error in msg[2]:
                key = (info[1], serial, op)
                if key in self._dead_seen:
                    continue  # duplicate unit re-processed after a restart
                self._dead_seen.add(key)
                self.dead_letters.append(
                    DeadLetter(info[1], msg[1], serial, op, value, error)
                )
        elif kind == "halted":  # router acked a group-restore halt
            self._halted.add(msg[1])
        elif kind == "stats":
            self._worker_busy += msg[2]
            self._worker_processed += msg[3]
            if len(msg) > 4 and msg[4] is not None:  # a device worker's
                info = self._pinfo[idx]
                self.device_stats.append({"stage": info[1], **msg[4]})
        elif kind == "marks":  # probes dropped mid-pipeline (filtered tuples)
            for m in msg[1]:
                self._record_dropped(m)
        elif kind == "state":  # elastic handoff: worker-local state snapshot
            info = self._pinfo[idx]
            if info[0] == "worker":
                self._handoff[(info[1], info[2])] = msg[2]
        elif kind == "paused":  # router acked an elastic pause
            rep = self._active_replan
            if (
                rep is not None
                and rep["phase"] == "pausing"
                and rep["stage"] == msg[1]
            ):
                rep["boundary"] = msg[2]
                rep["phase"] = "quiesce"
        elif kind == "error" and not ignore_errors:
            raise RuntimeError(f"worker {msg[1]} failed: {msg[2]}")

    def _record_dropped(self, m: _Marker) -> None:
        if not m.exit:
            m.exit = time.perf_counter()
        if self._tail is not None:
            self._tail._record_marker(m)
        else:
            self.markers.append(m)

    def _take_spill(self, serial: int) -> tuple[int, bytes]:
        return _await_spill(
            self._spills, serial, self._drain_conns, self.spill_timeout,
            lambda: (
                "final-stage drain, ingress backlog "
                f"{self._exchanges[-1].backlog_slots()} slots"
            ),
        )

    def _evict_spills(self) -> None:
        """Drop cached spill bodies once their stage's drain has committed
        past them (a restarted router can never re-request those serials)."""
        for tstage, cache in self._spill_cache.items():
            nxt = self._exchanges[tstage - 1].reorder.shared_next()
            for s in [s for s in cache if s < nxt]:
                del cache[s]

    # --------------------------------------------------------------- monitor
    def _check_procs(self) -> None:
        for idx, p in enumerate(self._procs):
            if p is None or p.is_alive():
                continue
            # Salvage every message first — a user-fn error beats a crash
            # diagnosis, and spills/stats must not be lost.
            try:
                while self._conns[idx].poll():
                    self._on_message(idx, self._conns[idx].recv())
            except (EOFError, OSError):
                pass
            if p.exitcode == 0:  # normal exit (stage drained)
                self._procs[idx] = None
                continue
            self._on_crash(idx, p)

    def _on_crash(self, idx: int, proc) -> None:
        info = self._pinfo[idx]
        if info[0] == "router":
            if not self.restart_on_crash:
                raise RuntimeError(
                    f"exchange router for stage {info[1]} died "
                    f"(exitcode {proc.exitcode})"
                )
            self._recover_router(idx, info[1])
            return
        _, stage, widx = info
        plan = self.stage_plans[stage]
        if not plan.recoverable:
            # keyed/stateful: recover from the epoch checkpoint unless the
            # operator explicitly opted out (checkpoint_interval=0 /
            # restart_on_crash=False), which keeps the historical raise
            if self._ckpt_enabled(stage):
                self._restore_group(stage)
                return
            raise RuntimeError(
                f"worker process died in {plan.describe()}; worker-local "
                "state is lost and cannot be replayed (only stateless stages "
                "are crash-tolerant)"
            )
        if not self.restart_on_crash:
            raise RuntimeError(
                f"worker {widx} of stage {stage} died (restart_on_crash=False)"
            )
        try:
            self._conns[idx].close()
        except Exception:
            pass
        # Re-fork onto the SAME rings: the dead worker committed its ring
        # head only after publishing, so at most one unit is re-processed
        # and duplicate publishes are idempotent (deterministic segments).
        self._fork_worker(stage, widx, slot=idx)
        self.restarts += 1

    def _recover_router(self, idx: int, stage: int) -> None:
        """Re-fork a dead exchange router onto the same exchanges.  The
        replacement resumes from the upstream reorder's commit record (read
        position + downstream serial); the window between the record and the
        dead router's actual progress is re-dispatched, and downstream
        absorbs the duplicates (worker ``last_seen`` trim on keyed/stateful
        stages, per-serial publish idempotence on stateless ones)."""
        rep = self._active_replan
        if rep is not None and rep["stage"] == stage:
            if rep["phase"] == "collect":
                raise RuntimeError(
                    f"exchange router for stage {stage} died while its "
                    "elastic replan was collecting worker state; the "
                    "quiesce boundary is unrecoverable"
                )
            self._abort_replan()  # pre-quiesce: nothing irreversible yet
        try:
            self._conns[idx].close()
        except Exception:
            pass
        rec = self._exchanges[stage - 1].reorder.commit_record()
        resume = rec[1] if rec is not None else 1
        if self._ckpt_enabled(stage):
            # the dead router's replay log died with it: the new log only
            # covers serials >= resume, so checkpoints older than that can
            # no longer restore this stage — and a fresh barrier is forced
            # below to close the exposure window fast
            self._log_floor[stage] = max(self._log_floor.get(stage, 1), resume)
        self._fork_router(stage, slot=idx)
        conn = self._router_conns[stage]
        for _serial, msg in sorted(self._spill_cache.get(stage, {}).items()):
            try:
                conn.send(msg)  # bodies the dead router held in memory
            except (BrokenPipeError, OSError):
                break
        if self._ckpt_enabled(stage):
            try:
                conn.send(("ckpt_now",))
            except (BrokenPipeError, OSError):
                pass
        self.restarts += 1
        self.recoveries += 1

    def _restore_group(self, stage: int) -> None:
        """Keyed/stateful crash recovery: halt the stage's feeder, kill the
        remaining group members (their state is mid-epoch and must not
        advance), reset the ingress rings, re-fork the group preloaded with
        the latest complete epoch snapshot, and re-pump the feeder's replay
        log from the epoch boundary.  Runs synchronously in the supervisor —
        the stream stalls for the duration (measured in
        ``recovery_time_s``)."""
        t0 = time.perf_counter()
        plan = self.stage_plans[stage]
        x = self._exchanges[stage]
        rep = self._active_replan
        if rep is not None and rep["stage"] == stage:
            if rep["phase"] == "collect":
                raise RuntimeError(
                    f"worker group of stage {stage} lost a member while "
                    "handing off elastic-resize state; the handoff snapshot "
                    "is incomplete and cannot be restored"
                )
            self._abort_replan()  # pre-quiesce: nothing irreversible yet
        ckpt = self._ckpt.latest(stage)
        boundary = ckpt.boundary if ckpt is not None else 1
        floor = self._log_floor.get(stage, 1)
        if boundary < floor:
            raise RuntimeError(
                f"cannot restore stage {stage}: the replay log covers serials"
                f" >= {floor} but the latest checkpoint boundary is "
                f"{boundary} (its feeder restarted before a fresh epoch "
                "completed)"
            )
        # -- halt the feeder: nothing may enter the rings while they reset
        if stage > 0:
            ridx = self._router_slot(stage)
            conn = self._router_conns.get(stage)
            alive = (
                ridx is not None and self._procs[ridx] is not None
                and self._procs[ridx].is_alive()
            )
            if not alive or conn is None:
                raise RuntimeError(
                    f"worker died in {plan.describe()} but its feeder router "
                    "is gone too; simultaneous feeder+worker failures are "
                    "unrecoverable (the replay window died with the router)"
                )
            self._halted.discard(stage)
            conn.send(("halt",))
            deadline = time.perf_counter() + 10.0
            while stage not in self._halted:
                self._drain_conns()
                if not self._procs[ridx].is_alive():
                    raise RuntimeError(
                        f"stage {stage} feeder router died during the group "
                        "restore; simultaneous failures are unrecoverable"
                    )
                if time.perf_counter() > deadline:
                    raise RuntimeError(
                        f"stage {stage} feeder failed to halt for group "
                        "restore within 10s"
                    )
                time.sleep(1e-3)
        # -- kill and reap the rest of the group (later-wins slot map: a
        # resized stage leaves dead pinfo entries behind at the old width)
        slots: dict[int, int] = {}
        for i, info in enumerate(self._pinfo):
            if info[0] != "worker" or info[1] != stage:
                continue
            slots[info[2]] = i
            p = self._procs[i]
            if p is not None:
                if p.is_alive():
                    try:
                        os.kill(p.pid, signal.SIGKILL)
                    except (ProcessLookupError, OSError):
                        pass
                p.join(timeout=5.0)
                self._procs[i] = None
            try:
                if self._conns[i] is not None:
                    self._conns[i].close()
            except Exception:
                pass
        # -- reset the rings and re-fork at the same width with the snapshot
        x.reopen_ingress()  # EOF may already have closed them
        x.reset_ingress()
        self._ckpt.clear_pending(stage)
        blobs = ckpt.blobs if ckpt is not None else {}
        for widx in range(plan.workers):
            blob = blobs.get(widx)
            preload = pickle.loads(blob) if blob is not None else None
            self._fork_worker(stage, widx, slot=slots.get(widx),
                              preload=preload)
        # -- re-pump everything since the boundary
        if stage == 0:
            self._disp.requeue_log()
        else:
            self._router_conns[stage].send(("restore",))
            self._halted.discard(stage)
        self.restarts += plan.workers
        self.recoveries += 1
        self.recovery_time_s += time.perf_counter() - t0

    # ------------------------------------------------------ elastic replanning
    # Protocol (see docs/architecture.md): pause the stage's feeder → let the
    # stage drain to a serial-number boundary (every dispatched serial
    # processed, published, AND consumed downstream) → ask the quiesced group
    # to hand its worker-local state back over the pipes → re-fork the group
    # at the new width with the state re-sharded by the new key routing →
    # resume the feeder.  Order and loss-freedom are inherited from the crash
    # protocol: nothing is in flight across the boundary, and the re-forked
    # workers consume the same rings with peek → publish → advance.
    def observe_traffic(self, signals: Dict) -> None:
        """Feed a serving-tier load snapshot (``SessionMux.load_signals``
        dict) to the traffic-reactive elasticity policy.

        No-op when the policy is off (``traffic_elastic`` resolved False)
        or the runtime has no resizable stage.  Must be called from the
        supervisor-owning thread (the same one that pushes/services)."""
        if self._traffic is not None:
            self._traffic.ingest(signals)

    def _drive_elastic(self, now: float, src_done: bool) -> None:
        if self._active_replan is not None:
            self._step_replan(now, src_done)
            return
        if self._resizes:
            if src_done:  # drain phase: a resize can no longer pay for itself
                self._resizes.clear()
                return
            stage, new_w, origin = self._resizes.popleft()
            self._begin_replan(stage, new_w, now, origin=origin)
            return
        if src_done:
            return
        mon_due = self._monitor is not None and self._monitor.due(now)
        tm_due = self._traffic is not None and self._traffic.due(now)
        if not (mon_due or tm_due):
            return
        drained = [x.progress()[0] for x in self._exchanges]
        backlog = [x.backlog_slots() for x in self._exchanges]
        widths = [p.workers for p in self.stage_plans]
        resizable = [p.resizable for p in self.stage_plans]
        props: List[Tuple[int, int, str]] = []
        if mon_due:
            for stage, w in self._monitor.sample(
                now, drained, backlog, widths, resizable
            ) or ():
                props.append((stage, w, "occupancy"))
        if tm_due and not props:  # skew proposals take the turn; traffic next
            for stage, w in self._traffic.sample(
                now, drained, backlog, widths, resizable
            ) or ():
                props.append((stage, w, "traffic"))
        for stage, w, origin in props:
            plan = self.stage_plans[stage]
            w = min(max(w, 1), plan.max_workers)
            if w != plan.workers:
                self._resizes.append((stage, w, origin))

    def _begin_replan(
        self, stage: int, new_w: int, now: float, origin: str = "occupancy"
    ) -> None:
        rep = {
            "stage": stage, "new_w": new_w, "old_w":
            self.stage_plans[stage].workers, "origin": origin, "t0": now,
            "deadline": now + 10.0, "boundary": None,
        }
        if stage == 0:  # the parent itself is the feeder
            self._disp.paused = True
            self._disp.flush()
            rep["phase"] = "flush"
        else:
            conn = self._router_conns.get(stage)
            if conn is None:
                return
            try:
                conn.send(("pause",))
            except (BrokenPipeError, OSError):
                return  # router already gone (EOF cascade): replan is moot
            rep["phase"] = "pausing"
        self._active_replan = rep

    def _step_replan(self, now: float, src_done: bool) -> None:
        rep = self._active_replan
        stage = rep["stage"]
        plan = self.stage_plans[stage]
        x = self._exchanges[stage]
        phase = rep["phase"]
        budget = self.resize_latency_budget
        if (
            phase in ("flush", "pausing", "quiesce")
            and budget is not None
            and now - rep["t0"] > budget
        ):
            # p99 guard: the quiesce stall already exceeds the latency
            # budget — abort pre-quiesce (nothing irreversible yet) and
            # back the policy off so it is not immediately retried
            self.resize_aborts += 1
            if self._traffic is not None:
                self._traffic.resize_result(
                    now, stall_s=now - rep["t0"], aborted=True
                )
            self._abort_replan()
            return
        if phase in ("flush", "pausing", "quiesce") and (
            src_done or now > rep["deadline"]
        ):
            self._abort_replan()  # nothing irreversible has happened yet
            return
        if phase == "flush":  # stage 0: push the sealed partials into rings
            self._disp.pump()
            if not self._disp.pending():
                rep["boundary"] = self._disp.next_serial
                rep["phase"] = "quiesce"
        elif phase == "pausing":
            # waiting for the router's ("paused", stage, serial) ack, which
            # arrives via _on_message; a router that exited meanwhile (EOF
            # cascade raced the pause) makes the replan moot
            ridx = self._router_slot(stage)
            if ridx is None or self._procs[ridx] is None:
                self._abort_replan()
        elif phase == "quiesce":
            if (
                x.backlog_slots() == 0
                and x.reorder.shared_next() >= rep["boundary"]
            ):
                # serial boundary reached: every dispatched tuple processed,
                # published, and drained downstream — collect the group
                for key in [k for k in self._handoff if k[0] == stage]:
                    del self._handoff[key]
                x.request_handoff()  # before close: exiting workers see it
                x.close_ingress()
                rep["expected"] = [
                    i for i, info in enumerate(self._pinfo)
                    if info[0] == "worker" and info[1] == stage
                    and self._procs[i] is not None
                ]
                rep["phase"] = "collect"
        elif phase == "collect":
            if now > rep["deadline"]:
                raise RuntimeError(
                    f"elastic replan of stage {stage} stuck collecting "
                    "worker state (quiesced workers failed to exit)"
                )
            if all(self._procs[i] is None for i in rep["expected"]):
                self._finish_replan(rep, plan, x)

    def _finish_replan(self, rep: dict, plan: StagePlan, x) -> None:
        stage, new_w = rep["stage"], rep["new_w"]
        preloads = self._build_preloads(plan, new_w)
        x.reopen_ingress()
        for j in range(new_w):
            self._fork_worker(stage, j, preload=preloads[j])
        plan.workers = new_w
        x.set_active_width(new_w)
        ckpt_boundary = None
        if self._ckpt_enabled(stage):
            # the quiesced handoff IS a complete snapshot at the new width:
            # bank it as a synthetic checkpoint so a later crash restores at
            # the resized sharding, and truncate the replay log below it
            boundary = rep["boundary"]
            self._ckpt.clear_pending(stage)
            self._ckpt.force(stage, boundary, {
                j: pickle.dumps(preloads[j], _PICKLE) for j in range(new_w)
            })
            self._log_floor[stage] = max(
                self._log_floor.get(stage, 1), boundary
            )
            ckpt_boundary = boundary
        if stage == 0:
            if ckpt_boundary is not None:
                self._disp.truncate_log(ckpt_boundary)
            self._disp.set_workers(new_w)
            self._disp.paused = False
        else:
            conn = self._router_conns.get(stage)
            if conn is not None:
                if ckpt_boundary is not None:
                    conn.send(("resume", new_w, ckpt_boundary))
                else:
                    conn.send(("resume", new_w))
        self.replans += 1
        if new_w > rep["old_w"]:
            self.grows += 1
        elif new_w < rep["old_w"]:
            self.shrinks += 1
        now = time.perf_counter()
        stall = now - rep["t0"]
        self.resize_stalls.append(stall)
        budget = self.resize_latency_budget
        over = budget is not None and stall > budget
        if self._traffic is not None:
            self._traffic.resize_result(now, stall_s=stall, over_budget=over)
        if over and rep["origin"] == "traffic":
            # p99 guard, undo path: the resize completed but its stall blew
            # the budget — return to the prior width (the revert itself is
            # never re-reverted) and leave the policy in extended cooldown
            self.resize_reverts += 1
            self._resizes.append((stage, rep["old_w"], "revert"))
        self._active_replan = None

    def _abort_replan(self) -> None:
        rep, self._active_replan = self._active_replan, None
        self._resizes.clear()  # stale siblings of an aborted width vector
        stage = rep["stage"]
        if stage == 0:
            self._disp.paused = False
        else:
            conn = self._router_conns.get(stage)
            if conn is not None:
                try:  # resume at the unchanged width
                    conn.send(("resume", self.stage_plans[stage].workers))
                except (BrokenPipeError, OSError):
                    pass

    def _router_slot(self, stage: int) -> Optional[int]:
        for i, info in enumerate(self._pinfo):
            if info[0] == "router" and info[1] == stage:
                return i
        return None

    def _build_preloads(self, plan: StagePlan, new_w: int) -> list:
        """Merge the quiesced group's handed-off state and re-shard it by the
        new width's key routing (worker j owns keys with
        ``partitioner(key) % new_w == j`` — exactly how the dispatcher will
        route them)."""
        merged = _init_states(plan.ops)
        for (stage, _widx), blob in sorted(self._handoff.items()):
            if stage != plan.index:
                continue
            st = pickle.loads(blob)
            for oi, op in enumerate(plan.ops):
                if op.kind == PARTITIONED:
                    merged[oi].update(st[oi])  # key sets are disjoint
        preloads = []
        for j in range(new_w):
            states_j = []
            for oi, op in enumerate(plan.ops):
                if op.kind == PARTITIONED:
                    part = op.partitioner
                    states_j.append({
                        k: v for k, v in merged[oi].items()
                        if part(k) % new_w == j
                    })
                else:  # stateless placeholder (stateful stages never resize)
                    states_j.append({})
            preloads.append(states_j)
        return preloads

    # ------------------------------------------------------- stall supervision
    def _check_stalls(self, now: float) -> None:
        """Hung-process detector: every worker bumps a heartbeat in its
        ingress ring header (also while spinning on a FULL reorder window)
        and every router one in the upstream reorder header.  A live process
        whose counter is frozen longer than ``stall_timeout`` is presumed
        hung (SIGSTOP, deadlocked fn, ...) and SIGKILLed — which converts it
        into an ordinary crash the next :meth:`_check_procs` pass recovers.
        ``stall_timeout`` must exceed the worst single-unit operator time,
        or a slow-but-healthy worker gets shot mid-unit."""
        for idx, p in enumerate(self._procs):
            if p is None or not p.is_alive():
                self._beats.pop(idx, None)
                continue
            info = self._pinfo[idx]
            if info[0] == "worker":
                hb = self._exchanges[info[1]].rings[info[2]].heartbeat()
            else:  # router: drains the upstream stage's reorder ring
                hb = self._exchanges[info[1] - 1].reorder.drainer_heartbeat()
            prev = self._beats.get(idx)
            if prev is None or prev[0] != p.pid or prev[1] != hb:
                self._beats[idx] = (p.pid, hb, now)
                continue
            if now - prev[2] > self.stall_timeout:
                try:
                    os.kill(p.pid, signal.SIGKILL)  # works on stopped procs
                except (ProcessLookupError, OSError):
                    pass
                self._beats.pop(idx, None)

    def _drive_faults(self, now: float) -> None:
        """Fire due supervisor-side injected faults (see :mod:`.faults`):
        each spec triggers once, when its stage's drained-serial counter
        crosses the spec's serial — stream-position-deterministic, not
        wall-clock-deterministic."""
        for item in self._fault_queue:
            spec, fired = item
            if fired:
                continue
            stage = min(spec.stage, len(self.stage_plans) - 1)
            if self._exchanges[stage].reorder.shared_next() <= spec.serial:
                continue
            item[1] = True
            target = None
            if spec.kind == ROUTER_KILL:
                ridx = self._router_slot(max(stage, 1))
                if ridx is not None:
                    target = self._procs[ridx]
            else:
                for i, info in enumerate(self._pinfo):
                    if (
                        info[0] == "worker" and info[1] == stage
                        and info[2] == spec.worker
                        and self._procs[i] is not None
                    ):
                        target = self._procs[i]
            if target is None or not target.is_alive():
                continue  # already gone: the fault is moot
            sig = signal.SIGSTOP if spec.kind == HANG else signal.SIGKILL
            try:
                os.kill(target.pid, sig)
            except (ProcessLookupError, OSError):
                pass

    # ------------------------------------------------------------------ drive
    # The parent-side drive surface is split into a push-driven *stream
    # protocol* — start_stream() → stream_push()* → end_stream() →
    # finish_stream() — with run() as the finite-iterable driver on top.
    # Everything here executes in the caller's thread (the parent is a thin
    # single-threaded supervisor), so the streaming :class:`~.api.Session`
    # can interleave pushes with ordered result reads without extra locking:
    # _service_once() is the one crank that moves dispatch, final-ring
    # drain, the serial tail, supervision, and elastic replanning forward.

    def start_stream(self) -> None:
        """Fork the stage worker groups and arm the push-driven protocol.

        Unlike :meth:`run`, no source calibration pass happens here (there
        is no source yet): ``workers="auto"`` widths come from declared or
        explicit ``cost_priors`` — elastic replanning, when enabled, refines
        them live from observed occupancy."""
        self._setup()
        # Graceful Ctrl-C / SIGTERM: convert to SystemExit so the callers'
        # ``finally: stop()`` reaps children and unlinks every shm segment.
        # Only legal (and only installed) on the main thread; prior handlers
        # are restored in stop().
        # analysis: ignore[FS301]: read-only main-thread identity query; no primitive is created, nothing crosses the fork
        if threading.current_thread() is threading.main_thread():
            for signum in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev_sig.append(
                        (signum, signal.signal(signum, _sig_raise))
                    )
                except (ValueError, OSError):
                    pass
        self._stream_t0 = time.perf_counter()
        self._n_in = 0
        self._src_done = False
        self._eof_published = False
        self._monitor_at = self._stream_t0
        self._stall = 0
        self._idle = 2e-5

    def _stream_add(self, value: Any) -> None:
        """Seal one tuple into the stage-0 dispatcher (marker accounting)."""
        if self._first_push_ts is None:
            self._first_push_ts = time.perf_counter()
        self._n_in += 1
        marker = None
        if self.marker_interval and self._n_in % self.marker_interval == 0:
            marker = _Marker(time.perf_counter())
        self._disp.add(value, marker)

    def stream_push(self, value: Any) -> None:
        """Push one tuple into the live stream (blocking backpressure).

        When the dispatcher's intake gate is closed (in-flight window full or
        out-queues backed up), services the pipeline until space frees — so a
        fast producer is throttled to the pipeline's pace instead of growing
        an unbounded parent-side queue.  Worker/router failures surface here
        (and in :meth:`finish_stream`) as ``RuntimeError``."""
        if self._src_done:
            raise RuntimeError("stream input already closed (end_stream)")
        spin = _IDLE_MIN
        while not self._disp.ready():
            if self._service_once():
                spin = _IDLE_MIN
            else:
                time.sleep(spin)
                spin = min(spin * 2, self.parent_idle_cap)
        self._stream_add(value)

    def stream_try_push(self, value: Any) -> bool:
        """Non-blocking :meth:`stream_push`: when the intake gate is closed,
        run one supervisor crank (so a rejected push still moves the
        pipeline) and report ``False`` instead of spinning.  The streaming
        multiplexer uses this to keep scheduling *other* sessions while the
        in-flight window is full."""
        if self._src_done:
            raise RuntimeError("stream input already closed (end_stream)")
        if not self._disp.ready():
            self._service_once()
            if not self._disp.ready():
                return False
        self._stream_add(value)
        return True

    def end_stream(self) -> None:
        """Close the stream's input side: flush partial dispatch units and
        let the in-band EOF cascade begin once the queues drain."""
        if not self._src_done:
            self._src_done = True
            self._disp.flush()

    def _service_once(self) -> bool:
        """One supervisor crank: dispatch sealed units, publish EOF when the
        input side is done, drain the final reorder ring (running the serial
        tail), and run periodic supervision (child pipes, crash re-fork,
        elastic replanning).  Returns True if anything moved."""
        progress = False
        disp = self._disp
        if disp.pump():
            progress = True
        if self._src_done and not self._eof_published and not disp.pending():
            if disp.publish_eof():
                self._eof_published = True
                progress = True
        if self._drain_final():
            progress = True
        if progress and self._tail is not None:
            self._pump_tail()
        now = time.perf_counter()
        if now >= self._monitor_at:
            self._monitor_at = now + 0.02
            self._drain_conns()
            if self._fault_queue:
                self._drive_faults(now)
            self._check_procs()
            if self.stall_timeout is not None:
                self._check_stalls(now)
            if self._spill_cache:
                self._evict_spills()
            if self._monitor is not None or self._active_replan:
                self._drive_elastic(now, self._src_done)
        if progress:
            self._stall = 0
        else:
            self._stall += 1
            if self._stall >= 50:
                disp.stall_flush()  # liveness: see _Dispatcher
                self._stall = 0
        return progress

    def stream_drained(self) -> bool:
        """True once the in-band EOF reached the parent and the serial tail
        (if any) is quiescent — i.e. every pushed tuple has egressed."""
        if not self._eof_seen:
            return False
        if self._tail is None:
            return True
        self._pump_tail()
        return self._tail.drained()

    def finish_stream(self, drain_timeout: float = 60.0) -> RunReport:
        """Drain the closed stream to quiescence, tear down, and report."""
        self.end_stream()
        deadline = time.perf_counter() + drain_timeout
        try:
            while not self.stream_drained():
                if self._service_once():
                    self._idle = 2e-5
                    continue
                if time.perf_counter() > deadline:
                    raise TimeoutError("process pipeline failed to drain")
                # back off while the stages grind: a busy-polling parent
                # steals the very cores the worker groups need
                time.sleep(self._idle)
                self._idle = min(self._idle * 2, self.parent_idle_cap)
        finally:
            self.stop()
        wall = time.perf_counter() - self._stream_t0
        return self._report(self._n_in, wall)

    def collected_outputs(self) -> list:
        """The live ordered output list (``collect_outputs=True``): the
        tail pipeline's when a serial tail exists, else the parent's own.
        Parent-side state mutated only by the caller's thread, so streaming
        readers may index into it between :meth:`_service_once` cranks."""
        if self._tail is not None:
            return self._tail.outputs
        return self.outputs

    def run(
        self,
        source: Iterable,
        *,
        drain: bool = True,
        drain_timeout: float = 60.0,
    ) -> RunReport:
        """Drive a finite ``source`` to drain and report — the one-shot
        driver over the stream protocol above (plus the ``workers="auto"``
        calibration pass, which needs the source's first tuples)."""
        src = iter(source)
        if (
            self.auto_workers
            and self.cost_priors is None
            and self.calibrate_tuples > 0
            and self.pinned_widths is None
        ):
            # calibration pass: profile the operator fns on a buffered prefix
            # of the real stream (dry run, state discarded), then re-allocate
            # widths from the measured costs before any process is forked
            sample = list(itertools.islice(src, self.calibrate_tuples))
            if self.cost_model.calibrate(sample):
                widths = self.cost_model.allocate(self.worker_budget)
                for plan, w in zip(self.stage_plans, widths):
                    if plan.kind not in ("stateful", "device"):
                        plan.workers = max(int(w), 1)
                self._set_stage_headroom()
                if not self._explicit_inflight:  # user's latency cap wins
                    widest = max(p.workers for p in self.stage_plans)
                    self.max_inflight = min(
                        self.reorder_size, 8 * widest * self.io_batch
                    )
            if sample:
                src = itertools.chain(sample, src)
        self.start_stream()
        deadline = None
        try:
            while True:
                progress = False
                # -- intake: seal source tuples into stage-0 units -----------
                while not self._src_done and self._disp.ready():
                    try:
                        value = next(src)
                    except StopIteration:
                        self.end_stream()
                        deadline = time.perf_counter() + drain_timeout
                        break
                    self._stream_add(value)
                    progress = True
                if self._service_once():
                    progress = True
                # -- termination ---------------------------------------------
                if self._eof_seen and self.stream_drained():
                    break
                if not drain and self._src_done:
                    break
                if progress:
                    self._idle = 2e-5
                else:
                    if deadline is not None and time.perf_counter() > deadline:
                        raise TimeoutError("process pipeline failed to drain")
                    # back off while the stages grind: a busy-polling parent
                    # steals the very cores the worker groups need
                    time.sleep(self._idle)
                    self._idle = min(self._idle * 2, self.parent_idle_cap)
        finally:
            self.stop()
        wall = time.perf_counter() - self._stream_t0
        return self._report(self._n_in, wall)

    def _drain_final(self, limit: int = 256) -> bool:
        progress = False
        for _ in range(limit):
            got = self._exchanges[-1].reorder.poll()
            if got is None:
                break
            t, tag, data, _span = got
            progress = True
            if tag == shm.TAG_EOF:
                self._eof_seen = True
                break
            if tag == shm.TAG_SPILL:
                tag, data = self._take_spill(t)
            if tag == shm.TAG_BUNDLES:
                bundles, out_marks, dropped = pickle.loads(data)
                for m in dropped:
                    self._record_dropped(m)
                mk = dict(out_marks) if out_marks else None
                for i, outs in enumerate(bundles):
                    self._emit(outs, mk.get(i) if mk else None)
            elif tag == shm.TAG_MBUNDLE:
                outs, m = pickle.loads(data)
                if outs:
                    self._emit(outs, m)
                elif m is not None:
                    self._record_dropped(m)
            elif tag == shm.TAG_COLBLOCK:
                from ..columnar.codec import decode_block

                block = decode_block(data)
                mk = dict(block.marks) if block.marks else None
                for i, v in enumerate(block.to_values()):
                    self._emit([v], mk.get(i) if mk else None)
            else:
                self._emit(shm.decode_bundle(tag, data), None)
        return progress

    # ------------------------------------------------------------------- tail
    def _emit(self, outs: list, marker: Optional[_Marker]) -> None:
        if self._tail is not None:
            inlet = self._tail._inlet(self._tail._source_name)
            for j, v in enumerate(outs):
                inlet(v, marker if j == 0 else None)
            if not outs and marker is not None:
                self._record_dropped(marker)
            return
        now = time.perf_counter()
        self._egress_count += len(outs)
        if outs:
            self._last_egress_ts = now
        if self.collect_outputs:
            self.outputs.extend(outs)
        if marker is not None:
            if outs:
                marker.exit = now
                self.markers.append(marker)
            else:
                self._record_dropped(marker)

    def _pump_tail(self) -> None:
        """Run the tail graph to quiescence, single-threaded (serial order)."""
        tail = self._tail
        while True:
            did = 0
            for node in tail.nodes:
                did += node.work(0, 1 << 30)
            if did == 0:
                return

    # ----------------------------------------------------------------- report
    @property
    def egress_count(self) -> int:
        """Tuples egressed so far (tail-aware)."""
        if self._tail is not None:
            return self._tail.egress_count
        return self._egress_count

    def processing_latencies(self, lo: float = 0.2, hi: float = 0.8) -> list:
        """Marker latencies in the [lo, hi] arrival-percentile window (§7)."""
        ms = self.markers if self._tail is None else self._tail.markers
        return percentile_latencies(ms, lo, hi)

    def _report(self, n_in: int, wall: float) -> RunReport:
        if self._tail is not None:
            self.outputs = self._tail.outputs
            self.markers = list(self._tail.markers)
            last_out = self._tail._last_egress_ts
        else:
            last_out = self._last_egress_ts
        lats = sorted(self.processing_latencies())
        mean_lat = sum(lats) / len(lats) if lats else 0.0
        p99 = lats[int(0.99 * (len(lats) - 1))] if lats else 0.0
        n_procs = sum(p.workers for p in self.stage_plans) + max(
            len(self.stage_plans) - 1, 0
        )
        busy = self._worker_busy / (n_procs * wall) if wall > 0 else 0.0
        window = wall
        if self._first_push_ts is not None and last_out is not None:
            window = max(last_out - self._first_push_ts, 1e-9)
        out_n = self.egress_count
        # A 0/1-tuple egress has no meaningful first-push→last-egress window
        # (it would divide by ~0 and report absurd rates): report 0.0.
        egress_thru = out_n / window if (window > 0 and out_n > 1) else 0.0
        return RunReport(
            tuples_in=n_in,
            tuples_out=out_n,
            wall_time=wall,
            throughput=n_in / wall if wall > 0 else 0.0,
            egress_throughput=egress_thru,
            mean_latency=mean_lat,
            p99_latency=p99,
            worker_busy_frac=busy,
        )
