"""Port parity: the serving tier (``repro_torch.serve``: ``SessionMux`` and
the open-loop load generator) against the JAX package's.

The fifteen test functions of ``tests/test_serve_mux.py``, every
parametrized case included (the 18-case backend x batch x sessions matrix
on ``thread`` and ``process``), run on the port's mux over the port's
Engine; then ``arrival_times`` is held to the reference's, computed in a
spawned child (``torch_jaxref``), for every shape and several seeds.

The reference's own description: covers the SessionMux contract
(docs/serving.md): per-session ordering under interleaving (property, both
backends x batch sizes x session counts), deterministic deficit-round-robin
fairness, slow-consumer isolation, admission control and shedding, graceful
churn, and the starvation snapshot's per-session backlog stats.
"""
import collections
import random
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.core.api import Engine, EngineConfig, SessionStarvation
from repro_torch.core.operators import OpSpec
from repro_torch.serve import (
    AdmissionError,
    ArrivalConfig,
    MuxConfig,
    SessionMux,
    arrival_times,
    percentile,
    run_open_loop,
)

# runs the reference package only (no jax computation), one child per call:
# the process-backend cases below fork workers from this process
JAX = Reference(keep=False)
_reference_child = JAX.fixture()


# --------------------------------------------------------- op zoo (picklable)
# Module-level functions (process-backend dispatch units pickle them), all
# int -> list[int] so every random chain composition stays well-typed.
def _double(v):
    return [v * 2]


def _drop_mod3(v):
    return [] if v % 3 == 0 else [v]


def _fan2(v):
    return [v, v + 1]


def _spin_double(v):
    end = time.perf_counter() + 1e-3
    while time.perf_counter() < end:
        pass
    return [v * 2]


def _runsum(state, v):
    s = (state or 0) + v
    return s, [s]


def _keyed_sum(state, key, v):
    s = (state or 0) + v
    return s, [s]


def _mod4(v):
    return v % 4


_ZOO = {
    "double": lambda: OpSpec("double", "stateless", _double),
    "drop": lambda: OpSpec("drop", "stateless", _drop_mod3, selectivity=0.67),
    "fan": lambda: OpSpec("fan", "stateless", _fan2, selectivity=2.0),
    "runsum": lambda: OpSpec("runsum", "stateful", _runsum),
    "ksum": lambda: OpSpec("ksum", "partitioned", _keyed_sum,
                           key_fn=_mod4, num_partitions=4),
}


def _oracle(chain, values):
    """Reference single-threaded evaluation of an OpSpec chain."""
    stream = list(values)
    for spec in chain:
        out = []
        if spec.kind == "stateless":
            for v in stream:
                out.extend(spec.fn(v))
        elif spec.kind == "stateful":
            state = spec.init_state()
            for v in stream:
                state, o = spec.fn(state, v)
                out.extend(o)
        else:
            states = {}
            for v in stream:
                k = spec.key_fn(v)
                state, o = spec.fn(states.get(k), k, v)
                states[k] = state
                out.extend(o)
        stream = out
    return stream


def _mux(backend, batch, chain, *, workers=2, **mux_kw):
    eng = Engine(EngineConfig(
        backend=backend, num_workers=workers, batch_size=batch,
    ))
    return SessionMux(
        eng, [_ZOO[name]() for name in chain], config=MuxConfig(**mux_kw)
    )


# ----------------------------------------------------------------- property
# Acceptance: N interleaved sessions through one Engine yield
# exactly their own outputs in their own order, on both backends across
# batch sizes and session counts.  Chains and inputs are seeded-random
# (string seeds are deterministic across interpreter runs, unlike hash()).
_MATRIX = [
    (backend, batch, n)
    for backend in ("thread", "process")
    for batch in (1, 7, 32)
    for n in (2, 8, 32)
]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("backend,batch,n_sessions", _MATRIX)
def test_interleaved_sessions_exact_per_session_ordering(
    backend, batch, n_sessions
):
    rng = random.Random(f"{backend}-{batch}-{n_sessions}")
    chain_names = [rng.choice(list(_ZOO)) for _ in range(rng.randint(1, 3))]
    per_n = 6 if backend == "process" else 20
    inputs = {
        i: [rng.randrange(1000) for _ in range(rng.randint(2, per_n))]
        for i in range(n_sessions)
    }
    with _mux(backend, batch, chain_names, max_sessions=n_sessions) as mux:
        handles = {i: mux.open() for i in range(n_sessions)}
        # interleave: push a small random chunk per session, round-robin,
        # until every session has fed its full input
        cursors = {i: 0 for i in range(n_sessions)}
        while any(cursors[i] < len(inputs[i]) for i in inputs):
            for i in inputs:
                lo = cursors[i]
                if lo >= len(inputs[i]):
                    continue
                hi = min(lo + rng.randint(1, 4), len(inputs[i]))
                handles[i].push(inputs[i][lo:hi])
                cursors[i] = hi
        chain = [_ZOO[nm]() for nm in chain_names]
        for i, h in handles.items():
            want = _oracle(chain, inputs[i])
            got = list(h.results(max_items=len(want), timeout=60))
            assert got == want, (
                f"session {i} (chain={chain_names}): {got[:8]} != {want[:8]}"
            )
            h.close()
            # drain token egressed behind everything: no stray extras
            assert h.poll() == [], f"session {i} produced extra outputs"


# ----------------------------------------------------------------- fairness
class _FakeInner:
    """Stand-in runtime for deterministic scheduler tests: rejects every
    push until released, then accepts unboundedly, recording sids."""

    def __init__(self):
        self.accepted = []
        self.released = False

    def try_push(self, tagged):
        if not self.released:
            return False
        self.accepted.append(tagged)
        return True

    def poll(self, max_items=None):
        return []

    def service(self):
        time.sleep(1e-4)

    def close(self, drain_timeout=60.0):
        return None

    def _abort(self):
        pass


class _FakeEngine:
    def __init__(self, inner):
        self._inner = inner

    def plan(self, graph, edges=None):
        return None

    def open(self, plan, edges=None):
        return self._inner


@pytest.mark.timeout(60)
def test_deficit_round_robin_respects_weights():
    """Fill two sessions' ingress queues while the runtime is gated shut,
    then release the gate: admissions must follow deficit round-robin —
    a weight-3 session gets ~3x the tuples of a weight-1 session in any
    steady window of the admission trace."""
    inner = _FakeInner()
    mux = SessionMux(
        _FakeEngine(inner), [_ZOO["double"]()],
        config=MuxConfig(max_sessions=2, quantum=4, ingress_depth=512),
    )
    try:
        a = mux.open(weight=1.0)
        b = mux.open(weight=3.0)
        a.push(range(300))
        b.push(range(1000, 1300))
        inner.released = True
        deadline = time.perf_counter() + 30
        while len(inner.accepted) < 400:
            assert time.perf_counter() < deadline, len(inner.accepted)
            time.sleep(1e-3)
        # skip the release transient, stop before either queue runs dry
        # (b exhausts its 300 tuples around entry ~400 of the merged trace)
        window = [sid for sid, _v in inner.accepted[20:320]]
        counts = collections.Counter(window)
        assert counts[a.sid] + counts[b.sid] == 300
        ratio = counts[b.sid] / counts[a.sid]
        assert 2.4 <= ratio <= 3.6, (ratio, counts)
        # no starvation stretch longer than one heavy-session DRR round
        a_at = [j for j, sid in enumerate(window) if sid == a.sid]
        assert max(q - p for p, q in zip(a_at, a_at[1:])) <= 13
    finally:
        mux._closed = True  # fake runtime: skip the drain protocol
        mux._pump.join(timeout=5)


@pytest.mark.timeout(60)
def test_deficit_round_robin_banks_credit_across_pause_resume():
    """Regression (empty-ingress DRR turn): a briefly idle session must
    keep its banked deficit — capped at two rounds' worth — so a paused
    high-weight session resumes at its earned share.  The pre-fix pump
    zeroed ``_deficit`` whenever a session's ingress came up empty, so a
    weight-3 session that paused for even one scheduling round restarted
    from zero credit and was admitted at the same trickle as a fresh
    session (12 tuples in the resume round instead of the banked 24)."""
    inner = _FakeInner()
    inner.released = True  # runtime accepts from the start
    mux = SessionMux(
        _FakeEngine(inner), [_ZOO["double"]()],
        config=MuxConfig(max_sessions=2, quantum=4, ingress_depth=512),
    )
    try:
        a = mux.open(weight=1.0)
        b = mux.open(weight=3.0)
        # stop the pump thread: the test drives DRR rounds by hand so the
        # round structure (accrual -> admit -> idle) is deterministic.
        # (_closed also gates the client push surface, so ingress is fed
        # through the queues directly below.)
        mux._closed = True
        mux._pump.join(timeout=5)
        a._deficit = b._deficit = 0.0  # clear accrual from pump idle turns
        a._ingress.extend(range(100))
        a.pushed += 100
        # rounds 1-3: b idle (paused client), a streaming.  b accrues
        # quantum*weight = 12 credit per round, capped at two rounds (24);
        # the cap must hold — an idle session can't bank unboundedly.
        for _ in range(3):
            mux._pump_ingress()
        assert b._deficit == 24.0, b._deficit  # banked, capped (pre-fix: 0.0)
        assert a.admitted == 12  # 3 rounds x quantum 4, unaffected
        # resume: b pushes a burst; the next single round must spend the
        # banked credit plus this round's accrual, already capped at 24
        b._ingress.extend(range(1000, 1060))
        b.pushed += 60
        before = len(inner.accepted)
        mux._pump_ingress()
        admitted = collections.Counter(
            sid for sid, _v in inner.accepted[before:]
        )
        assert admitted[b.sid] == 24, admitted  # pre-fix: 12
        assert admitted[a.sid] == 4  # a's steady share keeps flowing
    finally:
        mux._closed = True
        if mux._pump.is_alive():
            mux._pump.join(timeout=5)


@pytest.mark.timeout(60)
def test_late_output_of_retired_session_counted_undeliverable():
    """A retired session's late outputs (crash-replay overlap, or tuples
    surfacing while an elastic resize drains the sid-partitioned stage)
    must be counted ``undeliverable`` — never delivered to another
    session, never a KeyError in the pump."""
    from repro_torch.serve.mux import _FlushToken

    class _EchoInner(_FakeInner):
        """Accepts pushes and lets the test script the egress stream."""

        def __init__(self):
            super().__init__()
            self.released = True
            self.out = []

        def poll(self, max_items=None):
            out, self.out = self.out, []
            return out

    inner = _EchoInner()
    mux = SessionMux(
        _FakeEngine(inner), [_ZOO["double"]()],
        config=MuxConfig(max_sessions=2),
    )
    try:
        a = mux.open()
        b = mux.open()
        mux._closed = True  # stop the pump; drive the demux loop by hand
        mux._pump.join(timeout=5)
        # retire a through the real drain protocol: closing + empty
        # ingress queues its flush token, the token's egress retires it
        a._closing = True
        mux._pump_ingress()
        assert any(isinstance(x, _FlushToken) for x in inner.accepted)
        inner.out = [_FlushToken(a.sid)]
        mux._pump_egress()
        assert a._drained.is_set()
        assert a.sid in mux._retired
        # late outputs of the retired sid arrive interleaved with b's
        inner.out = [(a.sid, 111), (b.sid, 7), (a.sid, 222)]
        mux._pump_egress()
        assert mux._undeliverable == 2
        assert list(b._results) == [7]  # b's stream untouched
        assert a.poll() == []  # nothing leaked into the retired session
        stats = mux.stats()
        assert stats["undeliverable"] == 2
        assert stats["traffic"]["undeliverable"] == 2
        # a duplicate flush token after retirement is idempotent
        inner.out = [_FlushToken(a.sid)]
        mux._pump_egress()
        assert mux._undeliverable == 2
    finally:
        mux._closed = True
        if mux._pump.is_alive():
            mux._pump.join(timeout=5)


@pytest.mark.timeout(120)
def test_slow_consumer_does_not_stall_other_sessions():
    """A consumer that never reads must not delay another session's
    results: its backlog hits result_budget, its ingress stops being
    admitted, and the shared egress keeps flowing."""
    with _mux(
        "thread", 4, ["double"], max_sessions=2,
        result_budget=32, ingress_depth=64, quantum=4, push_timeout=0.2,
    ) as mux:
        slow = mux.open()
        fast = mux.open()
        # feed the slow consumer until shedding proves its lane is full
        with pytest.raises(AdmissionError) as exc_info:
            slow.push(range(10_000), timeout=0.2)
        assert exc_info.value.reason == "ingress_full"
        assert exc_info.value.sid == slow.sid
        assert slow.pushed < 10_000
        # the fast session (which *does* consume) must still stream
        # promptly end to end, staying under its own result budget
        t0 = time.perf_counter()
        got = []
        for lo in range(0, 200, 16):
            n = fast.push(range(lo, min(lo + 16, 200)))
            got.extend(fast.results(max_items=n, timeout=20))
        elapsed = time.perf_counter() - t0
        assert got == [2 * v for v in range(200)]
        assert elapsed < 10, f"fast session stalled {elapsed:.1f}s"
        # slow lane: undelivered backlog bounded near result_budget (plus
        # tuples already in flight when admission stopped), never the flood
        snap = mux.stats()["sessions"][slow.sid]
        assert snap["undelivered"] <= 32 + 512
        drained = list(slow.results(max_items=slow.pushed, timeout=30))
        assert drained == [2 * v for v in range(slow.pushed)]
        slow.close()
        fast.close()


@pytest.mark.timeout(60)
def test_starvation_snapshot_carries_per_session_backlog():
    with _mux("thread", 1, ["double"], max_sessions=2) as mux:
        quiet = mux.open()
        busy = mux.open()
        busy.push([1, 2, 3])
        with pytest.raises(SessionStarvation) as exc_info:
            list(quiet.results(timeout=0.3))
        snap = exc_info.value.snapshot
        assert set(snap["sessions"]) == {quiet.sid, busy.sid}
        for stats in snap["sessions"].values():
            for key in ("pushed", "admitted", "egressed", "undelivered",
                        "ingress_queued", "weight"):
                assert key in stats
        assert snap["open_sessions"] == 2
        assert list(busy.results(max_items=3, timeout=20)) == [2, 4, 6]
        quiet.close()
        busy.close()


# ---------------------------------------------------------------- admission
@pytest.mark.timeout(60)
def test_admission_control_max_sessions_and_churn_frees_slots():
    with _mux("thread", 1, ["double"], max_sessions=2) as mux:
        a = mux.open()
        b = mux.open()
        with pytest.raises(AdmissionError) as exc_info:
            mux.open()
        assert exc_info.value.reason == "max_sessions"
        assert exc_info.value.limit == 2
        assert "sessions" in exc_info.value.snapshot
        a.push([1, 2])
        assert list(a.results(max_items=2, timeout=20)) == [2, 4]
        a.close()  # graceful churn: retiring a session frees its slot
        c = mux.open()
        c.push([5])
        assert list(c.results(max_items=1, timeout=20)) == [10]
        b.close()
        c.close()
    stats = mux.stats()
    assert stats["retired"][a.sid] == {"pushed": 2, "egressed": 2}
    assert stats["undeliverable"] == 0


@pytest.mark.timeout(60)
def test_mux_closed_rejects_new_sessions_and_pushes():
    mux = _mux("thread", 1, ["double"], max_sessions=4)
    s = mux.open()
    s.push([1])
    assert list(s.results(max_items=1, timeout=20)) == [2]
    mux.close()
    with pytest.raises(AdmissionError) as exc_info:
        mux.open()
    assert exc_info.value.reason == "mux_closed"
    with pytest.raises(RuntimeError):
        s.try_push(9)
    assert mux.close() is mux.report  # idempotent


def test_mux_config_validation():
    for bad in (
        {"max_sessions": 0},
        {"ingress_depth": 0},
        {"result_budget": 0},
        {"quantum": 0},
        {"state_partitions": 0},
    ):
        with pytest.raises(ValueError):
            MuxConfig(**bad).validate()
    with _mux("thread", 1, ["double"]) as mux:
        with pytest.raises(ValueError):
            mux.open(weight=0.0)


# ------------------------------------------------------------ load generator
def test_arrival_shapes_hit_requested_mean_rate():
    n = 4000
    for shape in ("poisson", "lognormal", "pareto", "bursty", "diurnal"):
        cfg = ArrivalConfig(shape=shape, rate=500.0, seed=13, period_s=0.5)
        times = arrival_times(cfg, n)
        assert len(times) == n
        assert all(b >= a for a, b in zip(times, times[1:]))
        achieved = n / times[-1]
        assert 0.6 * cfg.rate < achieved < 1.7 * cfg.rate, (shape, achieved)
    with pytest.raises(ValueError):
        arrival_times(ArrivalConfig(shape="nope"), 1)
    with pytest.raises(ValueError):
        arrival_times(ArrivalConfig(shape="pareto", alpha=0.9), 1)
    with pytest.raises(ValueError):
        arrival_times(ArrivalConfig(shape="bursty", burst_duty=1.5), 1)


def test_modulated_arrivals_unbiased_when_trough_gap_rivals_period():
    """Regression (Lewis-Shedler thinning): at low nominal rates the old
    generator stepped by the local rate at each gap's *start*, so one
    trough-drawn gap (mean ~ 1/low_rate, comparable to the whole period)
    leapt entire bursts and the realized mean rate landed at a fraction of
    nominal (~0.23x for these parameters).  Thinned sampling must realize
    the nominal mean within sampling noise for both modulated shapes."""
    for cfg in (
        ArrivalConfig(shape="bursty", rate=18.0, burst_factor=4.0,
                      burst_duty=0.35, period_s=1.0, seed=11),
        ArrivalConfig(shape="diurnal", rate=10.0, period_s=2.0, seed=11),
    ):
        times = arrival_times(cfg, 400)
        realized = 400 / times[-1]
        assert 0.75 <= realized / cfg.rate <= 1.33, (cfg.shape, realized)
        assert all(b >= a for a, b in zip(times, times[1:]))
    # the bursty square wave's analytic mean must stay pinned to cfg.rate
    # even when the trough floor binds (duty * factor > 1)
    from repro_torch.serve.loadgen import _bursty_factors
    for duty, factor in ((0.2, 8.0), (0.35, 4.0), (0.5, 3.0), (0.225, 4.0)):
        cfg = ArrivalConfig(shape="bursty", burst_duty=duty,
                            burst_factor=factor)
        high, low = _bursty_factors(cfg)
        mean = duty * high + (1.0 - duty) * low
        assert mean == pytest.approx(1.0), (duty, factor, mean)
        assert high > 1.0 > low > 0.0


class _PacedHandle:
    """Fake session: ignores pushes, emits ``n`` completions at a fixed
    ``pace`` once ``start`` is set — a deterministic server for exercising
    run_open_loop's measurement windows without a real runtime."""

    def __init__(self, sid, n, pace, start, done):
        self.sid = sid
        self._n, self._pace = n, pace
        self._start, self._done = start, done

    def try_push(self, value):
        return True

    def close(self, drain_timeout=None):
        pass

    def results(self, timeout=None):
        self._start.wait(timeout)
        for k in range(self._n):
            time.sleep(self._pace)
            yield k
        self._done.set()


class _PacedMux:
    """Serves sessions *sequentially* (session 1 only starts once session 0
    has drained) — the maximally uneven progress that inflates a naive
    warmup-window rate."""

    def __init__(self, n, pace):
        first = threading.Event()
        first.set()
        self._events = [first]
        self._n, self._pace = n, pace
        self._opened = 0

    def open(self, weight=1.0):
        nxt = threading.Event()
        h = _PacedHandle(self._opened, self._n, self._pace,
                         self._events[-1], nxt)
        self._events.append(nxt)
        self._opened += 1
        return h


def test_warmup_rate_counts_only_steady_window_completions():
    """Regression (serving probe warm-up): ``achieved_rate`` must divide
    the completions *inside* the steady-state window by that window.  The
    pre-fix probe had no warmup handling at all (cold-start ramp deflated
    capacity), and the first cut divided every post-warmup completion by a
    window that opens only when the slowest session exits warmup — with
    uneven per-session progress that inflates the rate ~2x (here: two
    sessions served back to back at exactly 200/s each)."""
    n, pace = 60, 0.005
    rep = run_open_loop(
        _PacedMux(n, pace), sessions=2, requests=n, warmup=30,
        arrivals=ArrivalConfig(shape="poisson", rate=1e6, seed=3),
    )
    # true service rate is 200/s whenever anything is being served; the
    # naive all-completions/late-window quotient reads ~400/s
    assert 140.0 < rep.achieved_rate < 280.0, rep.achieved_rate
    # warmup requests are excluded from the percentile population
    assert rep.per_session[0]["n"] == n - 30
    with pytest.raises(ValueError):
        run_open_loop(_PacedMux(n, pace), sessions=1, requests=10,
                      warmup=10, arrivals=ArrivalConfig(rate=1e6))


def test_percentile_nearest_rank():
    vals = [float(i) for i in range(1, 101)]
    assert percentile(vals, 50) == 50.0
    assert percentile(vals, 99) == 99.0
    assert percentile(vals, 99.9) == 100.0
    assert percentile([], 50) != percentile([], 50)  # NaN


@pytest.mark.timeout(120)
def test_open_loop_latency_charges_queueing_to_the_request():
    """Coordinated-omission check with a ~1ms/tuple operator: a burst
    offered far beyond capacity must report latencies dominated by queueing
    (charged from the *scheduled* arrival), far above the lightly-loaded
    run's service-time latencies."""
    def build():
        eng = Engine(EngineConfig(backend="thread", num_workers=2,
                                  batch_size=1))
        return SessionMux(eng, [OpSpec("spin", "stateless", _spin_double)],
                          config=MuxConfig(max_sessions=4))

    with build() as mux:
        light = run_open_loop(
            mux, sessions=4, requests=20,
            arrivals=ArrivalConfig(rate=25.0, seed=5),
        )
    with build() as mux:
        slam = run_open_loop(
            mux, sessions=4, requests=20,
            arrivals=ArrivalConfig(rate=1e6, seed=5),
        )
    assert light.completed == slam.completed == 80
    # 80 requests x ~1ms arrive "instantly": the tail must carry the queue
    assert slam.p99 > 0.02, slam.p99
    assert slam.p99 > 2 * light.p50, (slam.p99, light.p50)
    assert len(light.per_session) == 4
    for summary in light.per_session.values():
        assert summary["n"] == 20


@pytest.mark.timeout(120)
def test_open_loop_slow_consumer_injection_confined():
    """Slow-consumer injection via the load generator: the victim's own
    completions slow down, everyone else's p99 stays sane."""
    with _mux(
        "thread", 4, ["double"], max_sessions=4, result_budget=8
    ) as mux:
        rep = run_open_loop(
            mux, sessions=4, requests=30,
            arrivals=ArrivalConfig(rate=400.0, seed=9),
            slow_consumers={0: 0.02},
        )
    assert rep.completed == 120
    victim = rep.per_session[0]["p99"]
    others = max(rep.per_session[i]["p99"] for i in (1, 2, 3))
    assert victim > others, (victim, others)


# ------------------------------------------------- parity with the reference
_ARRIVAL_CASES = [
    (dict(shape=shape, rate=rate, seed=seed, period_s=0.5), 500)
    for shape in ("poisson", "lognormal", "pareto", "bursty", "diurnal")
    for rate, seed in ((500.0, 13), (18.0, 11), (1e6, 3))
] + [
    (dict(shape="bursty", rate=18.0, burst_factor=4.0, burst_duty=0.35, period_s=1.0,
          seed=11), 400),
    (dict(shape="diurnal", rate=10.0, period_s=2.0, seed=11), 400),
    (dict(shape="lognormal", rate=200.0, sigma=2.0, seed=5), 300),
    (dict(shape="pareto", rate=200.0, alpha=1.2, seed=5), 300),
]


def test_arrival_times_equal_reference():
    """Both generators are seeded ``random.Random``: the schedules are equal
    to the last bit for every shape, rate and seed."""
    theirs = JAX("arrival_times_many", _ARRIVAL_CASES)
    for (cfg, n), want in zip(_ARRIVAL_CASES, theirs):
        assert arrival_times(ArrivalConfig(**cfg), n) == want, cfg
