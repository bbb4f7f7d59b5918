# Port copy of src/repro/serve/loadgen.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Open-loop load generation with coordinated-omission-free latency.

Closed-loop drivers (push, wait, push) hide overload: a stalled server
slows the *driver*, so measured latencies stay flat while real clients
would be queueing.  This generator is **open-loop**: every request has a
*scheduled* arrival time drawn from an arrival process, the driver never
waits for completions, and each latency is measured from the scheduled
arrival — not the actual push instant — so time spent queueing behind a
saturated runtime is charged to the request (Tene's coordinated-omission
correction).  That is the fig.10-style metric that matters at serving
scale: p50/p99/p999 under sustained load, not drain throughput.

Arrival shapes: ``poisson`` (memoryless), ``lognormal`` / ``pareto``
(heavy-tailed inter-arrivals), ``bursty`` (square-wave modulated rate),
``diurnal`` (sinusoidally modulated rate).  All are seeded and normalized
to the same mean rate so shapes are comparable at equal offered load.
"""
from __future__ import annotations

import heapq
import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "ArrivalConfig",
    "LatencyReport",
    "arrival_times",
    "percentile",
    "run_open_loop",
]

_SHAPES = ("poisson", "lognormal", "pareto", "bursty", "diurnal")


@dataclass(frozen=True)
class ArrivalConfig:
    """One arrival process: ``shape`` at mean ``rate`` requests/second.

    ``sigma`` spreads the lognormal; ``alpha`` is the Pareto tail index
    (must be > 1 for a finite mean); ``burst_factor``/``burst_duty``/
    ``period_s`` shape the modulated processes (bursty spends ``duty`` of
    each period at ``factor``× the base rate; diurnal swings ±80% over a
    period — a compressed day)."""

    shape: str = "poisson"
    rate: float = 1000.0
    seed: int = 0
    sigma: float = 1.0
    alpha: float = 1.5
    burst_factor: float = 8.0
    burst_duty: float = 0.2
    period_s: float = 1.0

    def validate(self) -> "ArrivalConfig":
        """Range-check shape and parameters; returns self for chaining."""
        if self.shape not in _SHAPES:
            raise ValueError(f"shape must be one of {_SHAPES}, got {self.shape!r}")
        if self.rate <= 0:
            raise ValueError("rate must be > 0")
        if self.shape == "pareto" and self.alpha <= 1.0:
            raise ValueError("pareto alpha must be > 1 (finite mean)")
        if self.shape == "bursty" and not (0.0 < self.burst_duty < 1.0):
            raise ValueError("burst_duty must be in (0, 1)")
        return self


def arrival_times(cfg: ArrivalConfig, n: int) -> List[float]:
    """``n`` scheduled arrival offsets (seconds from start, nondecreasing)."""
    cfg.validate()
    rng = random.Random(cfg.seed)
    mean_gap = 1.0 / cfg.rate
    times: List[float] = []
    t = 0.0
    if cfg.shape == "poisson":
        for _ in range(n):
            t += rng.expovariate(cfg.rate)
            times.append(t)
    elif cfg.shape == "lognormal":
        # mean of LogNormal(mu, sigma) is exp(mu + sigma^2/2): pin it to the
        # requested mean gap so heavy tails don't change offered load
        mu = math.log(mean_gap) - cfg.sigma ** 2 / 2.0
        for _ in range(n):
            t += rng.lognormvariate(mu, cfg.sigma)
            times.append(t)
    elif cfg.shape == "pareto":
        # paretovariate(alpha) >= 1 with mean alpha/(alpha-1); scale to mean_gap
        scale = mean_gap * (cfg.alpha - 1.0) / cfg.alpha
        for _ in range(n):
            t += scale * rng.paretovariate(cfg.alpha)
            times.append(t)
    else:  # modulated (non-homogeneous) Poisson: bursty / diurnal
        # Lewis-Shedler thinning: homogeneous candidates at the peak rate,
        # each kept with probability rate(t)/peak.  Stepping by the local
        # rate at the gap's *start* (the obvious shortcut) is badly biased
        # once the trough's mean gap rivals the period: a single
        # trough-drawn gap leaps whole bursts, so bursts are systematically
        # under-sampled and the realized mean rate lands far below nominal.
        peak = _peak_rate(cfg)
        while len(times) < n:
            t += rng.expovariate(peak)
            if rng.random() * peak <= _instant_rate(cfg, t):
                times.append(t)
    return times


def _bursty_factors(cfg: ArrivalConfig) -> tuple:
    """``(high, low)`` rate multipliers of the bursty square wave, scaled so
    the wave's analytic mean is exactly ``cfg.rate`` even when the trough
    floor (5% of base) binds because ``duty * factor > 1``."""
    duty, factor = cfg.burst_duty, cfg.burst_factor
    low = max(1.0 - duty * factor, 0.05) / (1.0 - duty)
    norm = duty * factor + (1.0 - duty) * low
    return factor / norm, low / norm


def _instant_rate(cfg: ArrivalConfig, t: float) -> float:
    """Instantaneous rate of the modulated processes at offset ``t``."""
    if cfg.shape == "bursty":
        # square wave at the mean rate: duty of each period at ~factor x
        # the base rate, the remainder at the (floored) low rate
        high, low = _bursty_factors(cfg)
        phase = (t % cfg.period_s) / cfg.period_s
        return cfg.rate * (high if phase < cfg.burst_duty else low)
    # diurnal: +-80% sinusoidal swing over one period
    swing = 1.0 + 0.8 * math.sin(2.0 * math.pi * t / cfg.period_s)
    return max(cfg.rate * swing, cfg.rate * 0.05)


def _peak_rate(cfg: ArrivalConfig) -> float:
    """Upper bound on :func:`_instant_rate` (the thinning envelope)."""
    if cfg.shape == "bursty":
        high, low = _bursty_factors(cfg)
        return cfg.rate * max(high, low)
    return cfg.rate * 1.8  # diurnal peak of the +-80% swing


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (``q`` in [0, 100])."""
    if not sorted_vals:
        return float("nan")
    rank = max(int(math.ceil(q / 100.0 * len(sorted_vals))) - 1, 0)
    return sorted_vals[min(rank, len(sorted_vals) - 1)]


@dataclass
class LatencyReport:
    """Open-loop run outcome: CO-free latency percentiles in seconds."""

    requests: int
    completed: int
    duration_s: float
    offered_rate: float
    achieved_rate: float
    p50: float
    p99: float
    p999: float
    mean: float
    max: float
    per_session: Dict[int, dict] = field(default_factory=dict)

    def row(self) -> dict:
        """Flat dict for benchmark JSON (milliseconds for readability)."""
        return {
            "requests": self.requests,
            "completed": self.completed,
            "duration_s": round(self.duration_s, 4),
            "offered_rate": round(self.offered_rate, 1),
            "achieved_rate": round(self.achieved_rate, 1),
            "p50_ms": round(self.p50 * 1e3, 3),
            "p99_ms": round(self.p99 * 1e3, 3),
            "p999_ms": round(self.p999 * 1e3, 3),
            "mean_ms": round(self.mean * 1e3, 3),
            "max_ms": round(self.max * 1e3, 3),
        }


def _summarize(lat: List[float]) -> dict:
    lat = sorted(lat)
    return {
        "n": len(lat),
        "p50": percentile(lat, 50.0),
        "p99": percentile(lat, 99.0),
        "p999": percentile(lat, 99.9),
        "mean": (sum(lat) / len(lat)) if lat else float("nan"),
        "max": lat[-1] if lat else float("nan"),
    }


def run_open_loop(
    mux,
    *,
    sessions: int,
    requests: int,
    arrivals: ArrivalConfig,
    payload: Callable[[int, int], Any] = lambda sid, i: i,
    slow_consumers: Optional[Dict[int, float]] = None,
    drain_timeout: float = 120.0,
    warmup: int = 0,
) -> LatencyReport:
    """Drive ``sessions`` concurrent sessions open-loop through ``mux``.

    Each session gets ``requests`` scheduled arrivals from its own seeded
    copy of ``arrivals``; the single driver thread pushes strictly by the
    global schedule (``try_push`` retries never advance the clock, so
    backpressure queueing is *charged to the request*).  One consumer
    thread per session records completion times; latency of the k-th
    output of a session is measured against the k-th scheduled arrival, so
    the pipeline must be selectivity-1 end to end (one output per input —
    assert-checked).  ``slow_consumers`` maps a session *index* to a
    per-item sleep, injecting consumer-side stalls (the mux must confine
    the damage to that session).  Returns a :class:`LatencyReport` with a
    ``per_session`` breakdown (latency summaries per session index).

    ``warmup`` discards each session's first ``warmup`` requests from the
    measurement window: they are pushed on schedule (the server still sees
    them) but excluded from the latency percentiles, and ``achieved_rate``
    counts only the completions inside the steady-state window (opening
    when the *last* session finishes its warmup prefix, closing at the
    last completion overall).  Use it when probing steady-state capacity —
    a cold start (fork, first plan, jit) otherwise deflates the probe's
    achieved rate, while dividing all post-warmup completions by a
    late-opening window would inflate it.
    """
    if sessions < 1 or requests < 1:
        raise ValueError("sessions and requests must be >= 1")
    if not (0 <= warmup < requests):
        raise ValueError("warmup must be in [0, requests)")
    slow = dict(slow_consumers or {})
    handles = [mux.open() for _ in range(sessions)]
    # per-session schedules, decorrelated by seed; one global merged heap
    schedules = [
        arrival_times(
            ArrivalConfig(**{**arrivals.__dict__, "seed": arrivals.seed + 1000 * idx}),
            requests,
        )
        for idx in range(sessions)
    ]
    heap = [
        (schedules[idx][k], idx, k)
        for idx in range(sessions)
        for k in (0,)
    ]
    heapq.heapify(heap)
    next_k = [0] * sessions

    t0 = time.perf_counter()
    sched_abs = [[t0 + t for t in sch] for sch in schedules]
    completions: List[List[float]] = [[] for _ in range(sessions)]
    errors: List[BaseException] = []

    def consume(idx: int) -> None:
        try:
            delay = slow.get(idx, 0.0)
            for _out in handles[idx].results(timeout=drain_timeout):
                completions[idx].append(time.perf_counter())
                if delay:
                    time.sleep(delay)
        except BaseException as e:  # surfaced after join
            errors.append(e)

    threads = [
        threading.Thread(target=consume, args=(idx,), daemon=True)
        for idx in range(sessions)
    ]
    for th in threads:
        th.start()

    # open-loop driver: release strictly by schedule, retry-don't-reschedule
    while heap:
        t_sched, idx, k = heap[0]
        now = time.perf_counter()
        wait = (t0 + t_sched) - now
        if wait > 0:
            time.sleep(min(wait, 0.005))
            continue
        heapq.heappop(heap)
        value = payload(handles[idx].sid, k)
        while not handles[idx].try_push(value):
            time.sleep(1e-4)  # schedule does NOT advance: queueing is charged
        next_k[idx] = k + 1
        if next_k[idx] < requests:
            heapq.heappush(heap, (schedules[idx][next_k[idx]], idx, next_k[idx]))

    for h in handles:
        h.close(drain_timeout=drain_timeout)
    for th in threads:
        th.join(timeout=drain_timeout)
    if errors:
        raise errors[0]
    duration = time.perf_counter() - t0

    latencies: List[float] = []
    per_session: Dict[int, dict] = {}
    for idx in range(sessions):
        done = completions[idx]
        if len(done) != requests:
            raise RuntimeError(
                f"session index {idx}: {len(done)} outputs for {requests} "
                "requests — run_open_loop needs a selectivity-1 pipeline"
            )
        lats = [done[k] - sched_abs[idx][k] for k in range(warmup, requests)]
        per_session[idx] = _summarize(lats)
        latencies.extend(lats)

    latencies.sort()
    total = sessions * requests
    if warmup:
        # steady-state window: opens once *every* session is past its
        # warmup prefix, closes at the last completion — and only the
        # completions inside it count, so uneven per-session progress
        # cannot inflate the rate (completions before the window opened
        # must not be divided by the window they didn't land in)
        win_start = max(completions[idx][warmup - 1] for idx in range(sessions))
        win_end = max(completions[idx][-1] for idx in range(sessions))
        window = win_end - win_start
        measured = sum(
            1 for done in completions for t in done if t > win_start
        )
    else:
        window = duration
        measured = total
    return LatencyReport(
        requests=total,
        completed=sum(len(c) for c in completions),
        duration_s=duration,
        offered_rate=arrivals.rate * sessions,
        achieved_rate=(measured / window) if window > 0 else float("nan"),
        p50=percentile(latencies, 50.0),
        p99=percentile(latencies, 99.0),
        p999=percentile(latencies, 99.9),
        mean=sum(latencies) / len(latencies),
        max=latencies[-1],
        per_session=per_session,
    )
