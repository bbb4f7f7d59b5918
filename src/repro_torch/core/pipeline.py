# Port copy of src/repro/core/pipeline.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Dataflow-graph pipeline compilation (paper §2, §6).

The runtime executes a *dataflow DAG* of operators (the paper's computation
model): every ``OpSpec`` node becomes an :class:`~.operators.OperatorNode`
with its own worklist + reorder buffer, and edges wire one node's ordered
egress into the next node's worklist.  Two routing primitives generalize the
topology beyond linear chains while preserving ordered semantics:

- :class:`Split` — fan-out.  Routes each incoming tuple to exactly one of B
  branches (``policy="round_robin"`` or ``policy="keyed"`` with a ``key_fn``)
  and stamps it with a monotone *ticket* plus a :class:`_Frame` that counts the
  tuple's in-flight descendants between the split and its matching merge.
- :class:`Merge` — fan-in.  Collects each ticket's outputs (a frame completes
  when its descendant count hits zero, so filtered-out tuples punch their hole
  in the sequence instead of stalling it) and re-interleaves completed tickets
  in split-ingress order through the existing
  :class:`~.reorder.NonBlockingReorderBuffer`; overflow completions beyond the
  ring window are parked in a pending dict and retried — never spun on — so a
  single worker cannot livelock.

Because every path between a split and its merge preserves FIFO order (each
node's reorder buffer guarantees egress in push order), and the merge restores
ticket order across branches, a ``split -> branches -> merge`` region is
serial-order-equivalent: the DAG's egress equals the single-threaded reference.

Public API:

  ``GraphPipeline(nodes, edges, **opts)``
      ``nodes``: ``{name: OpSpec | Split | Merge}``;
      ``edges``: ``[(src_name, dst_name), ...]``.  The unique node with no
      incoming edge is the ingress; the unique node with no outgoing edge is
      the egress.  Only ``Split`` nodes may have out-degree > 1; only
      ``Merge`` nodes may have in-degree > 1.  Split/merge pairs may nest.
  ``CompiledPipeline(specs, **opts)``
      The linear-chain API, now a thin wrapper that lowers ``specs`` to a
      chain-shaped ``GraphPipeline``.

Latency markers (paper §7) are injected every ``marker_interval`` tuples at
ingress (atomically — concurrent producers each observe a unique count).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .operators import (
    DEVICE,
    OpSpec,
    OperatorNode,
    PARTITIONED,
    STATEFUL,
    STATELESS,
    _Marker,
)
from .reorder import NonBlockingReorderBuffer, ParkingReorderBuffer
from .serial import AtomicLong, SerialAssigner


def percentile_latencies(
    markers: Sequence[_Marker], lo: float = 0.2, hi: float = 0.8
) -> List[float]:
    """Processing latency (begin->exit) of completed markers in the [lo, hi]
    percentile range of arrival — the paper's §7 measurement protocol.
    Shared by every runtime so thread and process backends report over the
    same window convention."""
    ms = sorted((m for m in markers if m.exit and m.begin), key=lambda m: m.entry)
    if not ms:
        return []
    a, b = int(len(ms) * lo), max(int(len(ms) * hi), int(len(ms) * lo) + 1)
    return [m.exit - m.begin for m in ms[a:b]]


# --------------------------------------------------------------------- routing
class Split:
    """Fan-out routing node spec: one inbound edge, B outbound branches.

    ``round_robin`` balances load; ``keyed`` routes tuples with equal
    ``key_fn(value)`` to the same branch (hash-partitioned), which keeps
    partitioned-stateful operators inside branches semantics-preserving.
    """

    def __init__(self, policy: str = "round_robin", key_fn: Optional[Callable] = None):
        if policy not in ("round_robin", "keyed"):
            raise ValueError(f"unknown split policy {policy!r}")
        if policy == "keyed" and key_fn is None:
            raise ValueError("keyed split needs key_fn")
        self.policy = policy
        self.key_fn = key_fn


class Merge:
    """Fan-in routing node spec: B inbound branches, one outbound edge.

    Re-interleaves per-ticket output bundles in split-ingress order via a
    :class:`NonBlockingReorderBuffer` so ordered semantics survive fan-in.
    """

    def __init__(self, reorder_size: int = 1024):
        self.reorder_size = reorder_size


class _Frame:
    """In-flight descendant accounting for one split ticket.

    ``count`` = tuples derived from this ticket that are alive between the
    split and the merge.  An operator producing k outputs from one input adds
    k-1 *before* emitting (creation happens-before consumption, so the count
    can only reach 0 once every descendant has arrived at the merge or been
    filtered out).  Arrived values accumulate in path-FIFO order, which equals
    depth-first serial order along the (single) branch path of the ticket.
    """

    __slots__ = ("ticket", "merge", "values", "markers", "_count", "_lock")

    def __init__(self, ticket: int, merge: "_MergeRouter"):
        self.ticket = ticket
        self.merge = merge
        self.values: list = []  # guarded-by: self._lock
        self.markers: list = []  # guarded-by: self._lock
        self._count = 1  # guarded-by(rw): self._lock
        self._lock = threading.Lock()

    def add(self, delta: int) -> None:
        """Account an operator turning one descendant into 1 + delta."""
        with self._lock:
            self._count += delta
            done = self._count == 0
        if done:
            self.merge.complete(self)

    def arrive(self, value: Any, marker: Optional[_Marker]) -> None:
        with self._lock:
            self.values.append(value)
            if marker is not None:
                self.markers.append(marker)
            self._count -= 1
            done = self._count == 0
        if done:
            self.merge.complete(self)


class _Envelope:
    """A value traveling inside one or more nested split/merge regions."""

    __slots__ = ("frames", "payload")

    def __init__(self, frames: Tuple[_Frame, ...], payload: Any):
        self.frames = frames
        self.payload = payload


class _SplitRouter:
    """Executable form of :class:`Split`: stamps tickets, routes to branches."""

    def __init__(self, spec: Split, branches: List[Callable], merge: "_MergeRouter"):
        self.spec = spec
        self.branches = branches  # push callables of the branch head nodes
        self.merge = merge
        self._tickets = SerialAssigner()
        self._rr = AtomicLong(0)

    def route(self, value: Any, marker: Optional[_Marker]) -> None:
        payload = value.payload if isinstance(value, _Envelope) else value
        outer = value.frames if isinstance(value, _Envelope) else ()
        ticket = self._tickets.next()
        frame = _Frame(ticket, self.merge)
        if self.spec.policy == "round_robin":
            b = self._rr.fetch_add(1) % len(self.branches)
        else:
            b = hash(self.spec.key_fn(payload)) % len(self.branches)
        self.branches[b](_Envelope(outer + (frame,), payload), marker)


class _MergeRouter:
    """Executable form of :class:`Merge`: ordered fan-in.

    Completed tickets go through a NonBlockingReorderBuffer keyed on the split
    ticket, behind the :class:`ParkingReorderBuffer` overflow facade — a
    ticket completing beyond the ring window (while an earlier ticket is still
    in flight) parks instead of spinning, so a lone worker completing tickets
    far ahead cannot livelock the runtime.
    """

    def __init__(self, spec: Merge):
        self.downstream: Optional[Callable[[Any, Optional[_Marker]], None]] = None
        self._reorder = ParkingReorderBuffer(
            NonBlockingReorderBuffer(self._emit_bundle, size=spec.reorder_size)
        )

    def arrive(self, value: Any, marker: Optional[_Marker]) -> None:
        assert isinstance(value, _Envelope), "merge reached by un-split tuple"
        value.frames[-1].arrive(
            _Envelope(value.frames[:-1], value.payload) if len(value.frames) > 1
            else value.payload,
            marker,
        )

    def complete(self, frame: _Frame) -> None:
        self._reorder.send(frame.ticket, (frame.values, frame.markers))

    def pending_count(self) -> int:
        return self._reorder.parked_count()

    def _emit_bundle(self, bundle: tuple) -> None:
        values, markers = bundle
        down = self.downstream
        markers = list(markers)
        for v in values:
            down(v, markers.pop(0) if markers else None)
        for m in markers:  # markers whose tuples were filtered inside the region
            m.exit = time.perf_counter()
            if self.on_marker_drop is not None:
                self.on_marker_drop(m)

    on_marker_drop: Optional[Callable[[_Marker], None]] = None


# --------------------------------------------------------- envelope adaptation
def _wrap_spec(spec: OpSpec) -> OpSpec:
    """Derive a spec whose fn transparently handles :class:`_Envelope` values.

    Inside a split/merge region every value is enveloped; the adapter unwraps
    the payload for the user fn, re-wraps outputs (descendants inherit the
    frame stack), and accounts len(outs)-1 on every enclosing frame *before*
    the outputs are emitted (see :class:`_Frame`).
    """

    def adapt(outs: list, value: Any) -> list:
        if not isinstance(value, _Envelope):
            return outs
        for f in value.frames:
            f.add(len(outs) - 1)
        return [_Envelope(value.frames, o) for o in outs]

    if spec.kind in (STATELESS, DEVICE):
        fn = spec.fn

        def fn_sl(value):
            payload = value.payload if isinstance(value, _Envelope) else value
            return adapt(fn(payload), value)

        new_fn, new_key = fn_sl, None
    elif spec.kind == STATEFUL:
        fn = spec.fn

        def fn_sf(state, value):
            payload = value.payload if isinstance(value, _Envelope) else value
            state, outs = fn(state, payload)
            return state, adapt(outs, value)

        new_fn, new_key = fn_sf, None
    else:  # PARTITIONED
        fn, key_fn = spec.fn, spec.key_fn

        def fn_ps(state, key, value):
            payload = value.payload if isinstance(value, _Envelope) else value
            state, outs = fn(state, key, payload)
            return state, adapt(outs, value)

        def new_key(value):
            return key_fn(value.payload if isinstance(value, _Envelope) else value)

        new_fn = fn_ps

    return OpSpec(
        name=spec.name,
        kind=spec.kind,
        fn=new_fn,
        key_fn=new_key,
        num_partitions=spec.num_partitions,
        partitioner=spec.partitioner,
        init_state=spec.init_state,
        cost_us=spec.cost_us,
        selectivity=spec.selectivity,
        schema=spec.schema,
        device_kernel=spec.device_kernel,
        device_batch=spec.device_batch,
        device_backend=spec.device_backend,
    )


# ---------------------------------------------------------------- GraphPipeline
NodeSpec = Union[OpSpec, Split, Merge]


class GraphPipeline:
    """Compiled dataflow DAG (see module docstring for the API)."""

    def __init__(
        self,
        nodes: Dict[str, NodeSpec],
        edges: Sequence[Tuple[str, str]],
        *,
        reorder_scheme: str = "non_blocking",
        worklist_scheme: str = "hybrid",
        reorder_size: int = 1024,
        num_workers=1,  # int, or "auto" for one worker per core
        marker_interval: int = 64,
        collect_outputs: bool = False,
        batch_size: int = 1,
    ):
        from .costmodel import resolve_workers  # late: pipeline loads first

        num_workers = resolve_workers(num_workers)
        self.node_specs = dict(nodes)
        self.edges = [tuple(e) for e in edges]
        self.marker_interval = marker_interval
        self.collect_outputs = collect_outputs
        self.outputs: list = []  # guarded-by: self._egress_lock
        self.markers: list[_Marker] = []  # guarded-by: self._markers_lock
        self._markers_lock = threading.Lock()
        self._egress_count = 0  # guarded-by: self._egress_lock
        self._egress_lock = threading.Lock()
        self._ingress = AtomicLong(0)
        # lock-free: written once by the producer whose fetch_add claimed n==1
        self._first_push_ts: Optional[float] = None
        self._last_egress_ts: Optional[float] = None  # guarded-by: self._egress_lock
        # Micro-batching applies to plain operator chains; routing nodes keep
        # per-tuple granularity (ticket/frame accounting is per tuple), so a
        # graph with Split/Merge clamps the batch size back to 1.
        has_routing = any(
            isinstance(s, (Split, Merge)) for s in self.node_specs.values()
        )
        self.batch_size = 1 if has_routing else max(1, batch_size)
        self._accum_vals: list = []  # guarded-by: self._accum_lock
        self._accum_marks: list[_Marker] = []  # guarded-by: self._accum_lock
        self._accum_lock = threading.Lock()

        order = self._topo_order()
        succ: dict[str, list[str]] = {n: [] for n in self.node_specs}
        pred: dict[str, list[str]] = {n: [] for n in self.node_specs}
        for u, v in self.edges:
            succ[u].append(v)
            pred[v].append(u)
        self._validate_degrees(succ, pred)

        sources = [n for n in order if not pred[n]]
        sinks = [n for n in order if not succ[n]]
        if len(sources) != 1 or len(sinks) != 1:
            raise ValueError(
                f"graph needs exactly one ingress and one egress node "
                f"(got sources={sources}, sinks={sinks})"
            )
        self._source_name, self._sink_name = sources[0], sinks[0]

        # Build executables. OperatorNodes first (ops only), then routers.
        has_split = any(isinstance(s, Split) for s in self.node_specs.values())
        self.nodes: List[OperatorNode] = []  # op nodes in topo order
        self.node_names: List[str] = []
        self._exec: dict[str, Any] = {}  # name -> OperatorNode|_SplitRouter|_MergeRouter
        for name in order:
            spec = self.node_specs[name]
            if isinstance(spec, OpSpec):
                node = OperatorNode(
                    _wrap_spec(spec) if has_split else spec,
                    len(self.nodes),
                    reorder_scheme=reorder_scheme,
                    worklist_scheme=worklist_scheme,
                    reorder_size=reorder_size,
                    num_workers=num_workers,
                    batch_size=self.batch_size,
                )
                node.on_marker_drop = self._record_marker
                self._exec[name] = node
                self.nodes.append(node)
                self.node_names.append(name)
        self._merges: list[_MergeRouter] = []
        for name in order:
            spec = self.node_specs[name]
            if isinstance(spec, Merge):
                m = _MergeRouter(spec)
                m.on_marker_drop = self._record_marker
                self._exec[name] = m
                self._merges.append(m)
        for name in reversed(order):  # inner splits first: outer branch heads
            spec = self.node_specs[name]  # may be inner splits themselves
            if isinstance(spec, Split):
                merge_name = self._matching_merge(name, succ)
                branches = [self._inlet(v) for v in succ[name]]
                self._exec[name] = _SplitRouter(
                    spec, branches, self._exec[merge_name]
                )

        # Wire downstreams (op/merge outlets -> successor inlets or egress).
        for name in order:
            ex = self._exec[name]
            if isinstance(ex, _SplitRouter):
                continue  # wired at construction via branch inlets
            if name == self._sink_name:
                ex.downstream = self._egress
                if self.batch_size > 1:
                    ex.downstream_batch = self._egress_batch
            else:
                ex.downstream = self._inlet(succ[name][0])
                if self.batch_size > 1:  # chain-only: successor is an op node
                    ex.downstream_batch = self._exec[succ[name][0]].push_batch

        # Scheduler metadata: weighted edges between *op node indices*
        # (routing nodes collapsed; split edges carry fraction 1/B).
        self.sched_edges = self._op_edges(succ)

    # ---- graph plumbing ------------------------------------------------------
    def _topo_order(self) -> list[str]:
        names = set(self.node_specs)
        for u, v in self.edges:
            if u not in names or v not in names:
                raise ValueError(f"edge ({u!r}, {v!r}) references unknown node")
        indeg = {n: 0 for n in names}
        succ: dict[str, list[str]] = {n: [] for n in names}
        for u, v in self.edges:
            succ[u].append(v)
            indeg[v] += 1
        ready = sorted(n for n in names if indeg[n] == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for v in succ[n]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(order) != len(names):
            raise ValueError("graph has a cycle")
        return order

    def _validate_degrees(self, succ, pred) -> None:
        for n, spec in self.node_specs.items():
            if isinstance(spec, Split):
                if len(succ[n]) < 2:
                    raise ValueError(f"split {n!r} needs >= 2 branches")
                if len(pred[n]) > 1:
                    raise ValueError(f"split {n!r} must have a single inbound edge")
            elif isinstance(spec, Merge):
                if len(pred[n]) < 2:
                    raise ValueError(f"merge {n!r} needs >= 2 inbound edges")
                if len(succ[n]) > 1:
                    raise ValueError(f"merge {n!r} must have a single outbound edge")
            else:
                if len(succ[n]) > 1:
                    raise ValueError(
                        f"op {n!r} has out-degree {len(succ[n])}; insert a Split"
                    )
                if len(pred[n]) > 1:
                    raise ValueError(
                        f"op {n!r} has in-degree {len(pred[n])}; insert a Merge"
                    )

    def _matching_merge(self, split_name: str, succ) -> str:
        """The merge closing ``split_name``'s region: follow each branch at
        depth-0 relative to the split until a Merge at relative depth 0."""
        targets = set()
        for start in succ[split_name]:
            depth, n = 0, start
            while True:
                spec = self.node_specs[n]
                if isinstance(spec, Split):
                    depth += 1
                elif isinstance(spec, Merge):
                    if depth == 0:
                        targets.add(n)
                        break
                    depth -= 1
                if not succ[n]:
                    raise ValueError(
                        f"branch of split {split_name!r} never reaches a merge"
                    )
                # After an inner split, any branch leads to its inner merge
                # (which pops depth back), so following branch 0 suffices.
                n = succ[n][0]
        if len(targets) != 1:
            raise ValueError(
                f"branches of split {split_name!r} converge on {sorted(targets)}; "
                "all branches must reach the same merge"
            )
        return targets.pop()

    def _inlet(self, name: str) -> Callable[[Any, Optional[_Marker]], None]:
        """The (value, marker) entry point of node ``name``."""
        ex = self._exec[name]
        if isinstance(ex, OperatorNode):
            return ex.push
        if isinstance(ex, _SplitRouter):
            return ex.route
        return ex.arrive

    def _op_edges(self, succ) -> list[tuple[int, int, float]]:
        """Edges between op-node indices with flow weights, collapsing
        routing nodes (a split divides flow evenly among its B branches)."""
        idx = {name: i for i, name in enumerate(self.node_names)}
        out: list[tuple[int, int, float]] = []

        def reach(name: str, w: float) -> list[tuple[int, float]]:
            spec = self.node_specs[name]
            if isinstance(spec, OpSpec):
                return [(idx[name], w)]
            if isinstance(spec, Split):
                got = []
                for v in succ[name]:
                    got.extend(reach(v, w / len(succ[name])))
                return got
            # Merge: pass through
            return reach(succ[name][0], w) if succ[name] else []

        for name in self.node_names:
            for v in succ[name]:
                for j, w in reach(v, 1.0):
                    out.append((idx[name], j, w))
        # edges out of the graph ingress if it is a routing node
        if self._source_name not in idx:
            for j, w in reach(self._source_name, 1.0):
                out.append((-1, j, w))
        return out

    # ---- ingress ------------------------------------------------------------
    def push(self, value: Any) -> None:
        """Push one tuple at the graph ingress (thread-safe; markers are
        injected here every ``marker_interval`` pushes)."""
        marker = None
        n = self._ingress.fetch_add(1) + 1
        if n == 1:
            # fetch_add makes push #1 unique, so exactly one producer ever
            # stores the window-start timestamp (no check-then-set race).
            self._first_push_ts = time.perf_counter()
        if self.marker_interval and n % self.marker_interval == 0:
            marker = _Marker(time.perf_counter())
        if self.batch_size > 1:
            # push_batch happens INSIDE the lock: sealing and serial
            # assignment must be atomic, or two concurrent producers could
            # enqueue sealed batches in the opposite order they accumulated.
            with self._accum_lock:
                self._accum_vals.append(value)
                if marker is not None:
                    # (offset-in-batch, marker): probes stay attached to the
                    # exact tuple they rode in on (see _operate_batch)
                    self._accum_marks.append((len(self._accum_vals) - 1, marker))
                if len(self._accum_vals) >= self.batch_size:
                    vals, marks = self._accum_vals, self._accum_marks
                    self._accum_vals, self._accum_marks = [], []
                    self._exec[self._source_name].push_batch(vals, marks)
            return
        self._inlet(self._source_name)(value, marker)

    def flush(self) -> None:
        """Release a partial ingress micro-batch (call when the source ends).

        No-op at ``batch_size=1``; the runtime calls this before draining."""
        if self.batch_size <= 1:
            return
        with self._accum_lock:
            vals, marks = self._accum_vals, self._accum_marks
            self._accum_vals, self._accum_marks = [], []
            if vals or marks:
                self._exec[self._source_name].push_batch(vals, marks)

    # ---- egress ---------------------------------------------------------------
    def _egress(self, value: Any, marker: Optional[_Marker]) -> None:
        with self._egress_lock:
            self._egress_count += 1
            self._last_egress_ts = time.perf_counter()
            if self.collect_outputs:
                self.outputs.append(value)
        if marker is not None:
            marker.exit = time.perf_counter()
            self._record_marker(marker)

    def _egress_batch(self, values: list, markers: list) -> None:
        now = time.perf_counter()
        with self._egress_lock:
            self._egress_count += len(values)
            self._last_egress_ts = now
            if self.collect_outputs:
                self.outputs.extend(values)
        for _, m in markers:
            m.exit = now
            self._record_marker(m)

    def _record_marker(self, marker: _Marker) -> None:
        with self._markers_lock:
            self.markers.append(marker)

    # ---- metrics ---------------------------------------------------------------
    @property
    def egress_count(self) -> int:
        """Tuples egressed so far."""
        return self._egress_count

    @property
    def ingress_count(self) -> int:
        """Tuples pushed at ingress so far (atomic; any thread may read)."""
        return self._ingress.load()

    def outputs_since(self, start: int) -> list:
        """Snapshot of collected outputs from index ``start`` on, taken under
        the egress lock — the incremental read behind the streaming
        :class:`~.api.Session`'s ordered ``results()`` iterator (requires
        ``collect_outputs=True``)."""
        with self._egress_lock:
            return self.outputs[start:]

    def consume_outputs(self, n: int) -> None:
        """Release the first ``n`` collected outputs (under the egress lock).
        The streaming Session trims its consumed prefix through this so a
        long-lived session's memory stays bounded by its in-flight window,
        not its full egress history."""
        with self._egress_lock:
            del self.outputs[:n]

    def processing_latencies(self, lo: float = 0.2, hi: float = 0.8) -> list[float]:
        """Marker latencies in the [lo, hi] arrival-percentile window (§7)."""
        with self._markers_lock:
            ms = list(self.markers)
        return percentile_latencies(ms, lo, hi)

    def processing_window(self) -> Optional[float]:
        """Seconds from first ingress push to last egress, if both happened —
        the active window ``egress_throughput`` is measured over.  A run that
        egressed 0 or 1 tuples has no meaningful window (first push and last
        egress coincide) and reports None."""
        if self._first_push_ts is None or self._last_egress_ts is None:
            return None
        if self._egress_count <= 1:
            return None
        return max(self._last_egress_ts - self._first_push_ts, 1e-9)

    def drained(self) -> bool:
        """Quiescence: no queued work, no worker mid-tuple, no merge holding
        an overflow bundle (a worker pushes downstream before it is released,
        so workers==0 makes pushes visible), no partial ingress micro-batch
        awaiting :meth:`flush`."""
        if self._accum_vals or self._accum_marks:
            return False
        return all(
            n.worklist_size() == 0 and n.workers.load() == 0
            and n.overflow_count() == 0
            for n in self.nodes
        ) and all(m.pending_count() == 0 for m in self._merges)


class CompiledPipeline(GraphPipeline):
    """Linear operator chain — a thin wrapper lowering to a chain GraphPipeline."""

    def __init__(
        self,
        specs: Sequence[OpSpec],
        *,
        reorder_scheme: str = "non_blocking",
        worklist_scheme: str = "hybrid",
        reorder_size: int = 1024,
        num_workers: int = 1,
        marker_interval: int = 64,
        collect_outputs: bool = False,
        batch_size: int = 1,
    ):
        specs = list(specs)
        if not specs:
            raise ValueError("pipeline needs at least one operator")
        names = [f"{i:03d}_{s.name}" for i, s in enumerate(specs)]
        super().__init__(
            nodes=dict(zip(names, specs)),
            edges=list(zip(names, names[1:])),
            reorder_scheme=reorder_scheme,
            worklist_scheme=worklist_scheme,
            reorder_size=reorder_size,
            num_workers=num_workers,
            marker_interval=marker_interval,
            collect_outputs=collect_outputs,
            batch_size=batch_size,
        )
        self.specs = specs


def compile_pipeline(specs: Sequence[OpSpec], **kw) -> CompiledPipeline:
    """Compile a linear operator chain (``CompiledPipeline(specs, **kw)``)."""
    return CompiledPipeline(specs, **kw)


def compile_graph(nodes: Dict[str, NodeSpec], edges, **kw) -> GraphPipeline:
    """Compile a dataflow DAG (``GraphPipeline(nodes, edges, **kw)``)."""
    return GraphPipeline(nodes, edges, **kw)
