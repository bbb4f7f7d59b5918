# Port copy of src/repro/serve/mux.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Session multiplexer: many ordered sessions on one planned runtime.

A real service runs thousands of concurrent ordered streams; forking one
:class:`~repro_torch.core.api.Engine` runtime per client would burn a worker
fleet per session.  :class:`SessionMux` admits many :class:`MuxSession`\\ s
onto **one** planned runtime by

1. **tagging** every tuple ``(sid, value)`` at ingress and rewriting the
   operator graph so each operator works per-session:

   - *stateless* ops map the payload and re-tag their outputs;
   - *stateful* ops become **partitioned ops keyed by session id** — each
     session gets its own isolated state *and* previously-serial operators
     now scale across sessions (the multiplexer's parallelism dividend);
   - *partitioned* ops are re-keyed by ``(sid, key)`` so key spaces of
     different sessions never collide;

2. **demuxing** the runtime's totally-ordered egress back into per-session
   result queues — the global egress order is ingress order, so each
   session's subsequence is exactly its own outputs in its own order;

3. scheduling ingress with **deficit round-robin fairness** (per-session
   weights) over bounded per-session ingress queues, with **admission
   control**: ``max_sessions`` at ``open()``, queue-depth shedding with a
   structured :class:`AdmissionError`, and per-session backpressure — a
   slow consumer stops being *admitted* into the runtime instead of
   stalling the shared egress;

4. **graceful churn**: ``MuxSession.close()`` drains exactly that
   session's in-flight tuples (a pickle-safe flush token rides the ordered
   stream behind them) while other sessions keep streaming — composing
   with the process backend's crash recovery, which replays tagged tuples
   and tokens idempotently.

One daemon pump thread owns the inner :class:`~repro_torch.core.api.Session`
(whose methods are not re-entrant) and drives it exclusively through the
non-blocking ``try_push``/``poll``/``service`` surface; client threads
only touch their own session's deques, so no locks are shared with the
runtime.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, Optional

from repro_torch.core.api import Engine, SessionStarvation, _normalize_graph
from repro_torch.core.operators import OpSpec, PARTITIONED, STATEFUL, STATELESS

__all__ = [
    "AdmissionError",
    "MuxConfig",
    "MuxSession",
    "SessionMux",
    "tag_graph",
]


class AdmissionError(RuntimeError):
    """Structured admission rejection from the serving tier.

    ``reason`` is machine-readable: ``"max_sessions"`` (open() beyond the
    session cap), ``"ingress_full"`` (queue-depth shedding on a saturated
    session), or ``"mux_closed"``.  ``snapshot`` carries the per-session
    backlog stats at rejection time so shedding is diagnosable."""

    def __init__(self, message: str, *, reason: str, sid: Optional[int] = None,
                 limit: Optional[int] = None, snapshot: Optional[dict] = None):
        self.reason = reason
        self.sid = sid
        self.limit = limit
        self.snapshot = dict(snapshot or {})
        super().__init__(message)


@dataclass(frozen=True)
class MuxConfig:
    """Serving-tier knobs (the runtime's own knobs live in EngineConfig).

    ``max_sessions`` bounds concurrently open sessions; ``ingress_depth``
    bounds each session's parent-side ingress queue (``push`` blocks, then
    sheds with :class:`AdmissionError` after ``push_timeout``);
    ``result_budget`` is the undelivered-output count past which a slow
    consumer's *ingress* stops being scheduled (its results stay available
    — shared egress never blocks on one reader); ``quantum`` is the
    deficit-round-robin base quantum (tuples per scheduling round for
    weight 1.0); ``state_partitions`` is the partition count given to
    stateful operators converted to session-keyed partitioned form;
    ``load_signal_interval`` is how often (seconds) the pump exports a
    :meth:`SessionMux.load_signals` snapshot to the inner runtime via
    ``Session.offer_load`` — the feed for traffic-reactive elastic
    replanning (docs/serving.md)."""

    max_sessions: int = 64
    ingress_depth: int = 1024
    result_budget: int = 4096
    quantum: int = 16
    state_partitions: int = 8
    push_timeout: float = 30.0
    load_signal_interval: float = 0.25

    def validate(self) -> "MuxConfig":
        """Range-check every knob; returns self for chaining."""
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if self.ingress_depth < 1:
            raise ValueError("ingress_depth must be >= 1")
        if self.result_budget < 1:
            raise ValueError("result_budget must be >= 1")
        if self.quantum < 1:
            raise ValueError("quantum must be >= 1")
        if self.state_partitions < 1:
            raise ValueError("state_partitions must be >= 1")
        if self.load_signal_interval <= 0:
            raise ValueError("load_signal_interval must be > 0")
        return self


class _FlushToken:
    """Pickle-safe drain marker for one session.

    Pushed behind a closing session's last tuple; every rewritten operator
    passes it through unchanged, and the totally-ordered egress guarantees
    that when it surfaces, all of that session's earlier outputs already
    did.  Crash replay may deliver it twice — demux treats a duplicate
    token as idempotent."""

    __slots__ = ("sid",)

    def __init__(self, sid: int):
        self.sid = sid

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_FlushToken(sid={self.sid})"


# ---------------------------------------------------------------- tagging
# Wrappers are module-level classes (not closures) so tagged graphs survive
# fork-style pickling on the process backend.
class _TagStateless:
    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, tagged):
        if isinstance(tagged, _FlushToken):
            return [tagged]
        sid, value = tagged
        return [(sid, out) for out in self.fn(value)]


class _TagStateful:
    """Stateful op converted to partitioned-by-sid: state is per session."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, state, key, tagged):
        if isinstance(tagged, _FlushToken):
            return state, [tagged]
        sid, value = tagged
        state, outs = self.fn(state, value)
        return state, [(sid, out) for out in outs]


class _TagPartitioned:
    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, state, key, tagged):
        if isinstance(tagged, _FlushToken):
            return state, [tagged]
        sid, value = tagged
        state, outs = self.fn(state, key[1], value)
        return state, [(sid, out) for out in outs]


class _TagKey:
    """Key extractor for re-keyed partitioned ops: ``(sid, orig_key)``."""

    __slots__ = ("key_fn",)

    def __init__(self, key_fn):
        self.key_fn = key_fn

    def __call__(self, tagged):
        if isinstance(tagged, _FlushToken):
            return (tagged.sid, None)
        sid, value = tagged
        return (sid, self.key_fn(value))


class _SidKey:
    __slots__ = ()

    def __call__(self, tagged):
        if isinstance(tagged, _FlushToken):
            return tagged.sid
        return tagged[0]


class _HashMod:
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n

    def __call__(self, key) -> int:
        return hash(key) % self.n


def tag_graph(graph, edges=None, *, state_partitions: int = 8):
    """Rewrite an operator graph to flow ``(sid, value)`` tagged tuples.

    Returns ``(nodes, edges)`` ready for ``engine.plan``/``engine.open``.
    Stateful operators come back *partitioned by session id* (isolated
    per-session state, parallel across sessions); partitioned operators are
    re-keyed by ``(sid, key)``.  Operator semantics are per-session: an
    aggregation that used to fold one global stream now folds each
    session's stream independently — exactly what multiplexed serving
    means."""
    nodes, edge_list, _chain = _normalize_graph(graph, edges)
    tagged: Dict[str, OpSpec] = {}
    for name, spec in nodes.items():
        if spec.kind == STATELESS:
            tagged[name] = OpSpec(
                name=spec.name, kind=STATELESS, fn=_TagStateless(spec.fn),
                cost_us=spec.cost_us, selectivity=spec.selectivity,
            )
        elif spec.kind == STATEFUL:
            tagged[name] = OpSpec(
                name=spec.name, kind=PARTITIONED, fn=_TagStateful(spec.fn),
                key_fn=_SidKey(), num_partitions=state_partitions,
                partitioner=_HashMod(state_partitions),
                init_state=spec.init_state,
                cost_us=spec.cost_us, selectivity=spec.selectivity,
            )
        else:  # PARTITIONED
            tagged[name] = OpSpec(
                name=spec.name, kind=PARTITIONED,
                fn=_TagPartitioned(spec.fn),
                key_fn=_TagKey(spec.key_fn),
                num_partitions=spec.num_partitions,
                partitioner=_HashMod(spec.num_partitions),
                init_state=spec.init_state,
                cost_us=spec.cost_us, selectivity=spec.selectivity,
            )
    return tagged, list(edge_list)


# ------------------------------------------------------------------ session
class MuxSession:
    """One client's ordered stream over the shared runtime.

    ``push(values)`` feeds this session (blocking on its own bounded
    ingress queue, shedding with :class:`AdmissionError` past
    ``push_timeout``); ``try_push(value)`` is the non-blocking form;
    ``results()`` iterates exactly this session's outputs in push order;
    ``close()`` seals the session and waits until its in-flight tuples
    drained — other sessions stream on.  Deques cross the pump-thread
    boundary (atomic append/popleft); no locks are shared with the
    runtime."""

    def __init__(self, mux: "SessionMux", sid: int, weight: float):
        self._mux = mux
        self.sid = sid
        self.weight = weight
        self._ingress: collections.deque = collections.deque()
        self._results: collections.deque = collections.deque()
        self.pushed = 0       # accepted into the ingress queue
        self.admitted = 0     # handed to the runtime (pump thread)
        self.egressed = 0     # delivered into the result queue (pump thread)
        self.consumed = 0     # taken by the client
        self._closing = False   # no more pushes; token queued behind ingress
        self._drained = threading.Event()  # flush token egressed
        self._deficit = 0.0

    # ---- client surface ---------------------------------------------------
    def try_push(self, value: Any) -> bool:
        """Non-blocking push into this session's ingress queue."""
        mux = self._mux
        if self._closing or mux._closed:
            raise RuntimeError(f"session {self.sid} is closed")
        mux._raise_pump_error()
        if len(self._ingress) >= mux.config.ingress_depth:
            return False
        self._ingress.append(value)
        self.pushed += 1
        return True

    def push(self, values: Iterable[Any],
             timeout: Optional[float] = None) -> int:
        """Push an iterable in order; blocks per tuple while this session's
        ingress queue is full, shedding with :class:`AdmissionError` after
        ``timeout`` (default ``MuxConfig.push_timeout``) seconds without
        space.  Returns how many tuples were accepted."""
        limit = self._mux.config.push_timeout if timeout is None else timeout
        n = 0
        for value in values:
            deadline = time.perf_counter() + limit
            while not self.try_push(value):
                if time.perf_counter() > deadline:
                    raise AdmissionError(
                        f"session {self.sid}: ingress queue full for "
                        f"{limit}s ({len(self._ingress)} queued) — shedding",
                        reason="ingress_full", sid=self.sid,
                        limit=self._mux.config.ingress_depth,
                        snapshot=self._mux.stats(),
                    )
                time.sleep(1e-4)
            n += 1
        return n

    def poll(self, max_items: Optional[int] = None) -> list:
        """Non-blocking read of this session's ready outputs (in order)."""
        self._mux._raise_pump_error()
        out = []
        limit = len(self._results) if max_items is None else max_items
        for _ in range(limit):
            try:
                out.append(self._results.popleft())
            except IndexError:
                break
        self.consumed += len(out)
        return out

    def results(self, max_items: Optional[int] = None,
                timeout: Optional[float] = None) -> Iterator[Any]:
        """Iterate this session's ordered outputs as they materialize.

        Ends when the session is closed and fully drained.  ``timeout``
        bounds *continuous* starvation (clock resets on every arrival);
        expiry raises :class:`~repro_torch.core.api.SessionStarvation` whose
        snapshot carries per-session backlog stats for the whole mux."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        yielded = 0
        while max_items is None or yielded < max_items:
            batch = self.poll(
                None if max_items is None else max_items - yielded
            )
            if batch:
                if timeout is not None:
                    deadline = time.perf_counter() + timeout
                for value in batch:
                    yielded += 1
                    yield value
                continue
            if self._drained.is_set() and not self._results:
                return
            if deadline is not None and time.perf_counter() > deadline:
                snap = self._mux.stats()
                raise SessionStarvation(
                    f"mux session {self.sid} starved: no output for "
                    f"{timeout}s (pushed={self.pushed}, "
                    f"egressed={self.egressed}); snapshot: {snap}",
                    snapshot=snap,
                )
            time.sleep(1e-4)

    def backlog(self) -> dict:
        """This session's live backlog counters (pump-visible state)."""
        return {
            "pushed": self.pushed,
            "admitted": self.admitted,
            "egressed": self.egressed,
            "consumed": self.consumed,
            "ingress_queued": len(self._ingress),
            "undelivered": len(self._results),
            "weight": self.weight,
            "closing": self._closing,
            "drained": self._drained.is_set(),
        }

    def close(self, drain_timeout: float = 60.0) -> dict:
        """Seal this session and wait for its in-flight tuples to drain
        (flush token round-trips the ordered stream); other sessions are
        untouched.  Returns the final backlog counters."""
        if not self._closing:
            self._closing = True  # pump queues the token once ingress drains
        deadline = time.perf_counter() + drain_timeout
        while not self._drained.wait(timeout=0.05):
            self._mux._raise_pump_error()
            if self._mux._closed:
                break
            if time.perf_counter() > deadline:
                raise TimeoutError(
                    f"session {self.sid} failed to drain in {drain_timeout}s:"
                    f" {self.backlog()}"
                )
        return self.backlog()

    # ---- context manager ---------------------------------------------------
    def __enter__(self) -> "MuxSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._drained.is_set():
            try:
                self.close()
            except Exception:
                if exc_type is None:
                    raise


# -------------------------------------------------------------------- mux
class SessionMux:
    """Admit many ordered sessions onto one planned runtime.

    ::

        engine = Engine(EngineConfig(backend="process", num_workers=4))
        mux = SessionMux(engine, graph, config=MuxConfig(max_sessions=128))
        with mux:
            a, b = mux.open(), mux.open(weight=2.0)
            a.push(stream_a); b.push(stream_b)
            for out in a.results(): ...
            a.close(); b.close()

    The constructor rewrites the graph with :func:`tag_graph`, opens one
    inner :class:`~repro_torch.core.api.Session` over it, and starts the pump
    thread that owns that session."""

    def __init__(self, engine: Engine, graph, edges=None, *,
                 config: Optional[MuxConfig] = None):
        self.config = (config or MuxConfig()).validate()
        self.engine = engine
        nodes, edge_list = tag_graph(
            graph, edges, state_partitions=self.config.state_partitions
        )
        self.plan = engine.plan((nodes, edge_list))
        self._inner = engine.open(self.plan)
        self._sessions: Dict[int, MuxSession] = {}
        self._retired: Dict[int, dict] = {}
        self._sid_iter = itertools.count()
        self._closed = False
        self._pump_error: Optional[BaseException] = None
        self._opened = 0
        self._undeliverable = 0
        self._admitted_total = 0  # monotonic; pump thread only
        self._pending_tokens: collections.deque = collections.deque()
        self.report = None
        self._pump = threading.Thread(
            target=self._pump_loop, name="mux-pump", daemon=True
        )
        self._pump.start()

    # ---- client surface ---------------------------------------------------
    def open(self, weight: float = 1.0) -> MuxSession:
        """Admit a new session (raises :class:`AdmissionError` at the
        ``max_sessions`` cap).  ``weight`` scales the session's fair-share
        quantum (2.0 = twice the ingress bandwidth under contention)."""
        self._raise_pump_error()
        if self._closed:
            raise AdmissionError("mux is closed", reason="mux_closed")
        if weight <= 0:
            raise ValueError("weight must be > 0")
        if len(self._sessions) >= self.config.max_sessions:
            raise AdmissionError(
                f"admission rejected: {len(self._sessions)} open sessions "
                f"(max_sessions={self.config.max_sessions})",
                reason="max_sessions", limit=self.config.max_sessions,
                snapshot=self.stats(),
            )
        sid = next(self._sid_iter)
        session = MuxSession(self, sid, weight)
        # publish fully-constructed: dict assignment is atomic and the pump
        # only iterates snapshots (list(...)) of this dict
        self._sessions[sid] = session
        self._opened += 1
        return session

    def stats(self) -> dict:
        """Per-session backlog stats plus inner-runtime counters."""
        inner: dict = {}
        if self._closed and self.report is not None:
            inner = {"closed": True}
        sessions = {
            sid: s.backlog() for sid, s in list(self._sessions.items())
        }
        return {
            "sessions": sessions,
            "retired": dict(self._retired),
            "open_sessions": len(sessions),
            "opened_total": self._opened,
            "undeliverable": self._undeliverable,
            "max_sessions": self.config.max_sessions,
            "traffic": self.load_signals(),
            "inner": inner,
        }

    def load_signals(self) -> dict:
        """Aggregate serving-tier load snapshot for elastic replanning.

        Keys: ``ts`` (perf_counter), ``sessions`` (open count),
        ``admitted_total`` (monotonic tuples admitted into the runtime),
        ``ingress_queued`` (tuples parked in DRR ingress queues — admission
        pressure the runtime is not absorbing), ``backpressured`` (sessions
        paused on a full result buffer), ``undeliverable``.  The pump feeds
        this to ``Session.offer_load`` every ``load_signal_interval``
        seconds; the process backend's :class:`~repro_torch.core.TrafficMonitor`
        turns it into grow/shrink proposals."""
        cfg = self.config
        sessions = list(self._sessions.values())
        return {
            "ts": time.perf_counter(),
            "sessions": len(sessions),
            "admitted_total": self._admitted_total,
            "ingress_queued": sum(len(s._ingress) for s in sessions),
            "backpressured": sum(
                1 for s in sessions if len(s._results) >= cfg.result_budget
            ),
            "undeliverable": self._undeliverable,
        }

    def close(self, drain_timeout: float = 60.0):
        """Close every session, drain, stop the pump, close the inner
        session; returns the runtime's final report (idempotent)."""
        if self._closed:
            return self.report
        for s in list(self._sessions.values()):
            s._closing = True
        deadline = time.perf_counter() + drain_timeout
        while any(
            not s._drained.is_set() for s in list(self._sessions.values())
        ):
            self._raise_pump_error()
            if time.perf_counter() > deadline:
                self._closed = True  # stop the pump before raising
                raise TimeoutError(
                    f"mux failed to drain in {drain_timeout}s: {self.stats()}"
                )
            time.sleep(1e-3)
        self._closed = True
        self._pump.join(timeout=drain_timeout)
        self._raise_pump_error()
        self.report = self._inner.close(drain_timeout=drain_timeout)
        return self.report

    def __enter__(self) -> "SessionMux":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self._closed = True
            self._inner._abort()

    # ---- pump thread ------------------------------------------------------
    def _raise_pump_error(self) -> None:
        if self._pump_error is not None:
            raise RuntimeError(
                f"mux pump failed: {self._pump_error!r}"
            ) from self._pump_error

    def _pump_loop(self) -> None:
        try:
            idle_spin = 0
            # duck-typed: the inner session exports load signals to the
            # supervisor when it can (process backend); fakes/thread
            # sessions without the hook are simply not fed
            offer = getattr(self._inner, "offer_load", None)
            crank = getattr(self._inner, "service_once", None)
            signal_at = 0.0
            while not self._closed:
                if offer is not None:
                    now = time.perf_counter()
                    if now >= signal_at:
                        signal_at = now + self.config.load_signal_interval
                        offer(self.load_signals())
                moved = self._pump_ingress()
                moved |= self._pump_egress()
                if crank is not None:
                    # crank the backend every turn: the process backend's
                    # single-threaded supervisor must not ration its
                    # progress on try_push/poll side effects while the
                    # pump is busy moving tuples (paced traffic would
                    # otherwise run far below flood capacity)
                    moved |= crank()
                if moved:
                    idle_spin = 0
                else:
                    idle_spin += 1
                    self._inner.service()
                    if idle_spin > 4:
                        time.sleep(1e-4)
            # final egress sweep so close() sees every delivered output
            self._pump_egress()
        except BaseException as e:  # surfaced to every client call
            self._pump_error = e

    def _pump_ingress(self) -> bool:
        """One deficit-round-robin scheduling round over live sessions."""
        cfg = self.config
        moved = False
        for session in list(self._sessions.values()):
            if session._drained.is_set():
                continue
            # per-session backpressure: a slow consumer stops being
            # admitted into the runtime, not delivered from it
            if len(session._results) >= cfg.result_budget:
                continue
            # cap banked credit at two rounds (and never below one tuple,
            # or a tiny weight could starve its own session forever)
            session._deficit = min(
                session._deficit + cfg.quantum * session.weight,
                max(1.0, 2 * cfg.quantum * session.weight),
            )
            while session._deficit >= 1.0:
                try:
                    value = session._ingress.popleft()
                except IndexError:
                    if session._closing:
                        # ingress empty + closing: send the drain token
                        # exactly once, behind everything already admitted
                        if session.admitted == session.pushed:
                            self._pending_tokens.append(session.sid)
                            session.admitted += 1  # token slot: queue once
                        break
                    # idle turn: keep the banked credit (the accrual cap
                    # above already bounds it at two rounds) — a briefly
                    # paused high-weight session must not forfeit its
                    # earned share, exactly like a backpressured one
                    break
                if not self._inner.try_push((session.sid, value)):
                    session._ingress.appendleft(value)  # runtime is full
                    return moved
                session.admitted += 1
                self._admitted_total += 1
                session._deficit -= 1.0
                moved = True
        while self._pending_tokens:
            sid = self._pending_tokens[0]
            if not self._inner.try_push(_FlushToken(sid)):
                break
            self._pending_tokens.popleft()
            moved = True
        return moved

    def _pump_egress(self) -> bool:
        outs = self._inner.poll()
        if not outs:
            return False
        for item in outs:
            if isinstance(item, _FlushToken):
                session = self._sessions.get(item.sid)
                if session is not None and not session._drained.is_set():
                    session._drained.set()
                    self._retire(session)
                continue  # duplicate after crash replay: idempotent
            sid, value = item
            session = self._sessions.get(sid)
            if session is None:
                # late output of a retired session (crash replay overlap):
                # ordered egress makes this impossible in a clean run, and
                # replay duplicates are not deliverable — count, don't leak
                self._undeliverable += 1
                continue
            session._results.append(value)
            session.egressed += 1
        return True

    def _retire(self, session: MuxSession) -> None:
        self._retired[session.sid] = {
            "pushed": session.pushed,
            "egressed": session.egressed,
        }
        self._sessions.pop(session.sid, None)
