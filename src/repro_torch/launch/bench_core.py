"""The port's twin of ``benchmarks/bench_core.py``: the core-runtime perf
tracker (thread vs process backends, batching, staging, cost-model worker
allocation, recovery, the columnar wire, device offload and serving).

  PYTHONPATH=src python -m repro_torch.launch.bench_core [--smoke] [--seconds S]
                                                         [--device cuda|cpu]
                                                         [--out PATH] [--workers N]

It keeps the reference's rows, workloads, constants (``SPIN``,
``HOT_SPIN``, ``SKEW_*``, ``COL_WIDTH``, ``COL_BATCH``, the serving
sessions and utilisation), interleaving and JSON row keys, and runs them on
``repro_torch``'s own copy of the runtime.  It differs in five ways:

- It imports only ``repro_torch``; :func:`engine_run` is its own copy of
  the helper in ``benchmarks/common.py``, which imports ``repro.core``.
- The ``device_offload`` row runs its device stage on ``device_backend=
  "cuda"``: K1 through ``columnar/device.py::DeviceExecutor`` (where the
  reference picks ``jax``/``affine_pallas`` or NumPy).  With ``--device
  cpu`` it runs K1's plain version on the CPU.  Nothing falls back: without
  a card and without ``--device cpu`` the run raises at once, as
  ``repro_torch.default_device`` does.  The row adds three keys to the
  reference's: ``device_dispatches`` and ``device_launches`` (the K1
  launches, from the device workers' ``device_stats``, summed over every
  run of the row, probe included) and ``egress_in_order`` (each run's egress
  held to the chain computed in Python).  On ``cuda`` K1 must run once per
  dispatch, or the row raises.
- The ``columnar_device`` A/B keeps ``device_backend="numpy"``, as the
  reference does: that pair measures the wire, not the kernel.
- It writes ``build/BENCH_core_torch.json`` by default; the root's
  ``BENCH_core.json`` stays the reference's.
- The parent process asks NVML (``repro_torch.have_cuda``), never
  ``torch.cuda.is_available()``, before it forks workers: a parent that
  initialised CUDA cannot fork device workers that use the card.

``--smoke`` shrinks the window to ~1 s per config.

The rows, as the reference describes them.  Runs fixed wall-clock-sized (default ~10 s per config) fig. 8-style
CPU-bound synthetic queries (pure-Python compute stages, GIL-bound) through:

  - cpu_chain (3 stateless stages):
      backend=thread, batch_size=1   (the paper-faithful baseline)
      backend=thread, batch_size=32  (micro-batched tuple path)
      backend=process                (OS-process workers + shared-memory rings)
  - keyed_hotspot (SL → partitioned hot spot → SL — the interior-stateful
    shape the ingress-only plan cannot parallelize):
      backend=process, stages=1      (the ingress-only plan: hot op in the
                                      serial parent tail)
      backend=process, stages=auto   (staged plan: the keyed stage gets its
                                      own process worker group)
  - recovery (the keyed_hotspot shape under a seeded 1-kill schedule):
      backend=process, checkpointed   (the keyed stage's worker 0 is
                                      SIGKILLed mid-run and restored from
                                      the last epoch checkpoint; the row
                                      tracks goodput under the fault and the
                                      supervisor-measured recovery latency)
  - skewed_stages (SL(hot) → PS(cold) — a pipeline whose load is
    concentrated in one stage):
      workers=1        (flat: the even split of the default worker budget
                        across the two data-parallel stages — the hot stage
                        is starved exactly as a flat ``num_workers`` starves
                        any skewed pipeline)
      workers="auto"   (cost-model allocation: the calibrated budget
                        division gives the hot stage the spare workers)
    The pair is measured INTERLEAVED (flat/auto alternating over several
    rounds, throughput aggregated per config) so the ``auto_vs_flat_process``
    ratio cancels host-speed drift on small/noisy boxes.

  - columnar_device (SL widen -> two device affine stages, NumPy reference
    kernel): the SAME chain with ``columnar=False`` (pickled units; the
    device workers convert tuples to columns serially) vs ``columnar=True``
    (TAG_COLBLOCK spans end-to-end: parallel block encode upstream,
    zero-copy device ingest, block pass-through between device stages).
    Measured INTERLEAVED like skewed_stages so the
    ``columnar_vs_pickle_process`` ratio cancels host-speed drift (still
    budget ~±20% run-to-run on shared vCPUs — see docs/columnar.md).
  - device_offload (widen -> one device stage on K1, or on its plain
    version with ``--device cpu``, columnar ingest): the offload smoke row —
    proves the dispatch path end-to-end and tracks its throughput.

  - serving / elastic_serving (open-loop multiplexed sessions): the serving
    row tracks coordinated-omission-free tail latency at 50% of probed
    capacity; the elastic_serving row replays a bursty trace against static
    vs traffic-reactive widths (SessionMux load signals driving the
    TrafficMonitor's grow/shrink of the sid-partitioned stage) and records
    the reactive side's resize counters next to both sides' percentiles.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

from repro_torch import default_device
from repro_torch.streams.parametric import (
    cpu_bound_chain,
    keyed_hotspot_chain,
    skewed_stage_chain,
)

SPIN = 100  # ~24 µs of GIL-bound work per tuple across the 3-stage chain
STAGES = 3
HOT_SPIN = 1200  # keyed hot spot: ~96 µs/tuple in the partitioned op alone
SKEW_HOT = 10000  # skewed_stages hot stage: heavy per-tuple compute so the
SKEW_COLD = 30  # allocation effect dominates exchange/plumbing overhead

COL_WIDTH = 12  # i8 columns per row on the columnar rows (96-byte payload)
COL_BATCH = 256  # micro-batch = device batch on the columnar A/B: units big
#                  enough that codec cost, not per-unit exchange plumbing,
#                  is what the pair contrasts (at batch 32 both sides mostly
#                  measure the router and the ratio collapses to ~1)


def _col_widen(v):
    # intentionally cheap widening: the columnar rows measure the *wire*
    # (pickled units vs TAG_COLBLOCK spans), so per-tuple compute stays
    # negligible next to codec + exchange costs
    return [(v,) * COL_WIDTH]


COL_DEVICE_PARAMS = ((3, -1), (1, 5))  # (a, b) of each device stage, in order


def _columnar_device_chain(backend: str, kernel: str, ndev: int = 2):
    from repro_torch.columnar import Schema, device_op
    from repro_torch.core.operators import OpSpec

    schema = Schema.of(*(["i8"] * COL_WIDTH))
    ops = [OpSpec("widen", "stateless", _col_widen, cost_us=1.0)]
    for i, (a, b) in zip(range(ndev), COL_DEVICE_PARAMS):
        ops.append(device_op(
            f"dev{i}", kernel, schema, params={"a": a, "b": b},
            backend=backend, cost_us=2.0,
        ))
    return ops


OFFLOAD_KERNEL = "affine_pallas"  # K1 on ``cuda``, its plain version on ``cpu``


def engine_run(graph, source, **knobs):
    """Run a chain (list of OpSpec) or ``(nodes, edges)`` graph on the
    Engine API with flat legacy knobs (strictly parsed — a typo'd knob
    raises ``ConfigError`` instead of silently measuring the wrong config);
    returns ``(handle, RunReport)`` like the deprecated one-shots did."""
    from repro_torch.core import Engine, EngineConfig

    engine = Engine(EngineConfig.from_kwargs(**knobs))
    result = engine.run(graph, source)
    return result.handle(), result.report


# each builds the workload's chain; the device rows read their backend from
# the config
WORKLOADS = {
    "cpu_chain": lambda cfg: cpu_bound_chain(stages=STAGES, spin=SPIN),
    "keyed_hotspot": lambda cfg: keyed_hotspot_chain(spin_edge=30, spin_hot=HOT_SPIN),
    "skewed_stages": lambda cfg: skewed_stage_chain(
        spin_hot=SKEW_HOT, spin_cold=SKEW_COLD
    ),
    "columnar_device": lambda cfg: _columnar_device_chain("numpy", "affine"),
    "device_offload": lambda cfg: _columnar_device_chain(
        cfg["device_backend"], OFFLOAD_KERNEL, ndev=1
    ),
}

CONFIGS = (
    {"workload": "cpu_chain", "backend": "thread", "batch_size": 1},
    {"workload": "cpu_chain", "backend": "thread", "batch_size": 32},
    {"workload": "cpu_chain", "backend": "process", "batch_size": 1},
    # The hotspot pair measures stage *topology*, not fan-out: pin the
    # per-stage worker-group size to 2 so the A/B stays apples-to-apples
    # regardless of --workers (and of a small host's core count).
    {"workload": "keyed_hotspot", "backend": "process", "batch_size": 32,
     "stages": 1, "workers": 2},
    {"workload": "keyed_hotspot", "backend": "process", "batch_size": 32,
     "stages": None, "workers": 2},  # None = auto: cut as deep as possible
)

# The allocation A/B: both sides get the SAME worker budget (the auto
# default, cores+1).  Flat spends it as an even per-stage split over the
# chain's two data-parallel stages (budget // 2 each — the remainder is
# unusable, which IS flat's deficiency on an odd budget); auto divides it by
# predicted load, concentrating the spare on the hot stage.  parent_idle_cap
# trades ~ms of drain latency for supervisor CPU the hot worker group needs
# on a 2-core box — applied to BOTH sides.
AB_ROUNDS = 4


def _ab_configs():
    from repro_torch.core import costmodel

    budget = costmodel.default_budget()
    return (
        {"workload": "skewed_stages", "backend": "process", "batch_size": 32,
         "workers": max(1, budget // 2), "parent_idle_cap": 2e-3,
         "worker_budget": budget},
        {"workload": "skewed_stages", "backend": "process", "batch_size": 32,
         "workers": "auto", "parent_idle_cap": 2e-3,
         "worker_budget": budget},
    )


def _run_once(cfg: dict, n: int, workers: int):
    """One measured run on the Engine surface (compile → plan-on-the-fly →
    execute); returns ``(handle, report)`` like the legacy one-shot did."""
    kw = dict(
        num_workers=cfg.get("workers", workers),
        backend=cfg["backend"],
        batch_size=cfg["batch_size"],
    )
    if "stages" in cfg:
        kw["stages"] = cfg["stages"]
    if "parent_idle_cap" in cfg:
        kw["parent_idle_cap"] = cfg["parent_idle_cap"]
    if cfg.get("workers") == "auto" and "worker_budget" in cfg:
        kw["worker_budget"] = cfg["worker_budget"]
    for key in ("columnar", "device_batch", "device_backend",
                "device_inflight", "max_inflight", "reorder_size",
                "collect_outputs"):
        if key in cfg:
            kw[key] = cfg[key]
    handle, report = engine_run(WORKLOADS[cfg["workload"]](cfg), range(n), **kw)
    if "on_run" in cfg:
        cfg["on_run"](handle, n)
    return handle, report


def _run_config(cfg: dict, seconds: float, workers: int):
    workers = cfg.get("workers", workers)
    # probe: size the real run to ~`seconds` of wall clock
    probe_n = 2000
    _, probe = _run_once(cfg, probe_n, workers)
    n = max(int(probe.throughput * seconds), probe_n)
    pipe, report = _run_once(cfg, n, workers)
    if not (0.7 * seconds <= report.wall_time <= 1.3 * seconds):
        # the short probe misjudged the sustained rate (startup effects);
        # rescale once so every config measures a comparable window
        scale = min(max(seconds / max(report.wall_time, 1e-9), 0.25), 4.0)
        n = max(int(n * scale), probe_n)
        pipe, report = _run_once(cfg, n, workers)
    return {
        "workload": cfg["workload"],
        "backend": cfg["backend"],
        "batch_size": cfg["batch_size"],
        # process stages the planner actually cut (1 = ingress-only plan;
        # null for the thread backend, which has no process stages)
        "stages": getattr(pipe, "num_stages", None),
        "workers": workers,
        "tuples": n,
        "wall_s": round(report.wall_time, 3),
        "throughput_per_s": round(report.throughput, 1),
        "egress_throughput_per_s": round(report.egress_throughput, 1),
        "p99_latency_ms": round(report.p99_latency * 1e3, 3),
        "mean_latency_ms": round(report.mean_latency * 1e3, 3),
        "busy_frac": round(report.worker_busy_frac, 3),
    }


RECOVERY_SPIN = 300  # keyed hot op: enough work that recovery cost is visible
RECOVERY_CKPT = 512  # epoch length (serials) for the recovery row


def _run_recovery(seconds: float, workers: int):
    """Goodput + recovery latency under a seeded 1-kill schedule.

    A clean pass sizes the run and provides the no-fault baseline; the
    measured pass SIGKILLs the keyed stage's worker 0 at the stream midpoint.
    The supervisor restores the group from the last epoch checkpoint and
    replays, so every tuple still egresses exactly once — ``goodput`` is the
    end-to-end throughput *including* the recovery stall, and
    ``recovery_latency_ms`` is the supervisor-measured halt-to-replay time.
    """
    from repro_torch.core import FaultOptions, FaultPlan, FaultSpec

    def chain():
        return keyed_hotspot_chain(spin_edge=30, spin_hot=RECOVERY_SPIN)

    kw = dict(backend="process", num_workers=2, batch_size=32,
              checkpoint_interval=RECOVERY_CKPT)
    probe_n = 2000
    _, probe = engine_run(chain(), range(probe_n), **kw)
    n = max(int(probe.throughput * seconds), probe_n)
    _, clean = engine_run(chain(), range(n), **kw)
    plan = FaultPlan(
        specs=[FaultSpec(kind="kill", stage=1, worker=0,
                         serial=max(n // 2, 1))],
        seed=7,
    )
    handle, report = engine_run(
        chain(), range(n), faults=FaultOptions(plan=plan), **kw
    )
    result = handle.result
    assert result.egress_count == n, (
        f"recovery lost tuples: {result.egress_count}/{n}"
    )
    return {
        "workload": "recovery",
        "backend": "process",
        "batch_size": 32,
        "stages": getattr(handle, "num_stages", None),
        "workers": 2,
        "checkpoint_interval": RECOVERY_CKPT,
        "tuples": n,
        "wall_s": round(report.wall_time, 3),
        "throughput_per_s": round(report.throughput, 1),
        "egress_throughput_per_s": round(report.egress_throughput, 1),
        "p99_latency_ms": round(report.p99_latency * 1e3, 3),
        "mean_latency_ms": round(report.mean_latency * 1e3, 3),
        "busy_frac": round(report.worker_busy_frac, 3),
        "clean_throughput_per_s": round(clean.throughput, 1),
        "restarts": result.restarts,
        "recoveries": result.recoveries,
        "recovery_latency_ms": round(handle.recovery_time_s * 1e3, 3),
    }


SERVING_SESSIONS = 8  # concurrent ordered sessions multiplexed per runtime
SERVING_UTIL = 0.5  # offered load as a fraction of probed capacity


def _run_serving(seconds: float, workers: int):
    """Open-loop serving row: ``SERVING_SESSIONS`` concurrent sessions
    multiplexed onto one planned runtime (``repro_torch.serve.SessionMux``), fed
    Poisson arrivals at ~``SERVING_UTIL`` of probed capacity.  Latency is
    coordinated-omission-free (measured from each request's *scheduled*
    arrival), so p99/p999 reflect queueing under sustained load — the
    fig.10-style serving metric — not closed-loop drain time."""
    from repro_torch.core.api import Engine, EngineConfig
    from repro_torch.serve import ArrivalConfig, MuxConfig, SessionMux, run_open_loop

    def make_mux():
        eng = Engine(EngineConfig(
            backend="thread", num_workers=workers, batch_size=8,
        ))
        return SessionMux(
            eng, cpu_bound_chain(stages=STAGES, spin=SPIN),
            config=MuxConfig(max_sessions=SERVING_SESSIONS),
        )

    # probe: saturating offered load -> achieved rate ~= mux capacity.
    # The warmup prefix keeps the cold-start ramp (thread spin-up, first
    # plan, estimator warm-up) out of the capacity window: without it the
    # probe under-reads capacity and the measured run is offered less load
    # than SERVING_UTIL claims.  The probe must be big enough that the
    # steady window is 100s of ms — at ~25k/s a 250-request probe leaves a
    # ~30 ms window where completion-timestamp clumping (the pump drains
    # outputs in bursts) inflates the rate 2-20x.
    with make_mux() as mux:
        probe = run_open_loop(
            mux, sessions=SERVING_SESSIONS, requests=2000, warmup=400,
            arrivals=ArrivalConfig(shape="poisson", rate=1e6, seed=3),
        )
    capacity = max(probe.achieved_rate, 1.0)
    offered = capacity * SERVING_UTIL
    per_session = max(int(offered * seconds / SERVING_SESSIONS), 50)
    with make_mux() as mux:
        rep = run_open_loop(
            mux, sessions=SERVING_SESSIONS, requests=per_session,
            arrivals=ArrivalConfig(
                shape="poisson", rate=offered / SERVING_SESSIONS, seed=11,
            ),
        )
    return {
        "workload": "serving",
        "backend": "thread",
        "batch_size": 8,
        "stages": None,
        "workers": workers,
        "sessions": SERVING_SESSIONS,
        "arrivals": "poisson",
        "open_loop": True,
        "capacity_per_s": round(capacity, 1),
        "offered_rate_per_s": round(rep.offered_rate, 1),
        "achieved_rate_per_s": round(rep.achieved_rate, 1),
        "tuples": rep.requests,
        "wall_s": round(rep.duration_s, 3),
        "throughput_per_s": round(rep.achieved_rate, 1),
        "p50_latency_ms": round(rep.p50 * 1e3, 3),
        "p99_latency_ms": round(rep.p99 * 1e3, 3),
        "p999_latency_ms": round(rep.p999 * 1e3, 3),
        "mean_latency_ms": round(rep.mean * 1e3, 3),
    }


ELASTIC_SESSIONS = 6  # concurrent sessions on the elastic serving row
ELASTIC_PARTITIONS = 4  # sid partitions (= keyed-stage elastic ceiling)
ELASTIC_SPIN = 20000  # stateful accumulator: ~1 ms/tuple, so the keyed
#                       *worker* is the bottleneck (well under the parent
#                       supervisor's shuttle capacity) and stage width
#                       genuinely sets end-to-end capacity — the property
#                       the grow/shrink A/B is about
ELASTIC_BUDGET = 3  # worker budget: 1 spare over the 2 stages' floor
ELASTIC_UTIL = 0.4  # mean offered load as a fraction of probed capacity
#                     (low enough that the mean stays sustainable even if
#                     the host runs ~1.5x slower than the probe sampled —
#                     shared-vCPU speed regimes shift on ~10 s timescales)
ELASTIC_BURST = 4.0  # burst peak = BURST x mean = 1.6 x capacity: deep
#                      enough that width 1 falls behind even if the probe
#                      *under*-sampled capacity by ~1.5x, while width 2
#                      still has drain headroom at the nominal calibration
ELASTIC_DUTY = 0.225  # fraction of each period spent at the burst rate
#                       (duty x factor = 0.9 < 1, so the square wave's
#                       analytic mean is exactly the nominal rate)
ELASTIC_PERIOD = 4.0  # seconds per burst/trough cycle: a ~1 s burst
#                       dwarfs both the policy's detection lag (~0.3 s:
#                       signal interval + patience) and the ~50-150 ms
#                       quiesce stall a grow costs, so the extra width
#                       has most of the burst left to repay the stall —
#                       shallow bursts end before the grow lands and
#                       measure nothing but the stall


def _elastic_chain():
    """SL(edge) -> stateful(accsum): the mux converts the stateful op into
    a sid-partitioned keyed stage (``ELASTIC_PARTITIONS`` partitions) —
    exactly the stage the traffic policy grows and shrinks."""
    from repro_torch.core.operators import OpSpec
    from repro_torch.streams.parametric import cpu_bound_stateless

    def acc(state, v):
        x = float(v)
        for _ in range(ELASTIC_SPIN):
            x = (x * 1.0000001 + 1.31) % 97.0
        return (state or 0) + 1, [x]

    return [
        cpu_bound_stateless("edge", spin=30),
        OpSpec("accsum", "stateful", acc, init_state=lambda: 0,
               cost_us=ELASTIC_SPIN * 0.08),
    ]


def _elastic_mux(reactive: bool):
    from repro_torch.core.api import Engine, EngineConfig, ProcessOptions
    from repro_torch.serve import MuxConfig, SessionMux

    # replan_interval parks the occupancy (skew) monitor so the row
    # isolates the *traffic* loop; the reactive side gets aggressive dials
    # (short interval, patience 1, brief cooldown) because the bursty
    # trace compresses a diurnal cycle into ~1 s periods.
    # max_inflight bounds the quiesce stall a resize must drain (8 units
    # x io_batch 8 x ~1 ms/tuple ~= 64 ms), keeping honest resizes well
    # inside the 0.5 s p99-guard budget
    popts = dict(worker_budget=ELASTIC_BUDGET, replan_interval=600.0,
                 max_inflight=8)
    if reactive:
        popts.update(
            traffic_elastic=True, traffic_interval=0.15,
            traffic_grow_util=0.65, traffic_shrink_util=0.30,
            traffic_patience=1, traffic_cooldown=0.6,
            resize_latency_budget=0.5,
        )
    else:
        popts.update(elastic=False)  # static widths: the control arm
    eng = Engine(EngineConfig(
        backend="process", num_workers=1, batch_size=2,
        process=ProcessOptions(**popts),
    ))
    return SessionMux(
        eng, _elastic_chain(),
        config=MuxConfig(
            max_sessions=ELASTIC_SESSIONS,
            state_partitions=ELASTIC_PARTITIONS,
            load_signal_interval=0.05,
        ),
    )


def _run_elastic_serving(seconds: float, workers: int):
    """Traffic-reactive elasticity A/B: the same bursty open-loop trace
    (square-wave offered load: ``ELASTIC_DUTY`` of each second at
    ``ELASTIC_BURST``x the mean, a deep trough in between) is replayed
    against *static* widths and against the closed loop — SessionMux load
    signals feeding the TrafficMonitor, which grows the sid-partitioned
    stateful stage into the burst and shrinks it back in the trough
    (hysteresis + cooldown + the resize-latency p99 guard).  The row
    carries the reactive side's grow/shrink/abort/revert counters and both
    sides' percentiles."""
    from repro_torch.serve import ArrivalConfig, run_open_loop

    window = max(seconds, 2.25 * ELASTIC_PERIOD)  # >= 2 full cycles
    # Median of three flood probes: the shared-vCPU host shifts speed
    # regimes on ~10 s timescales (observed 1.5-2x capacity swings between
    # back-to-back probes), and a single sample mis-calibrates the whole
    # trace.  The bursty trace itself tolerates a further ~1.5x drift in
    # either direction (see ELASTIC_UTIL / ELASTIC_BURST).
    samples = []
    for _ in range(3):
        with _elastic_mux(reactive=False) as mux:
            probe = run_open_loop(
                mux, sessions=ELASTIC_SESSIONS, requests=90, warmup=24,
                arrivals=ArrivalConfig(shape="poisson", rate=1e6, seed=5),
            )
        samples.append(probe.achieved_rate)
    capacity = max(sorted(samples)[1], 1.0)
    offered = capacity * ELASTIC_UTIL
    per_session = max(int(offered * window / ELASTIC_SESSIONS), 40)
    arrivals = ArrivalConfig(
        shape="bursty", rate=offered / ELASTIC_SESSIONS,
        burst_factor=ELASTIC_BURST, burst_duty=ELASTIC_DUTY,
        period_s=ELASTIC_PERIOD, seed=17,
    )
    reports, counters = {}, {}
    for mode, reactive in (("static", False), ("reactive", True)):
        with _elastic_mux(reactive=reactive) as mux:
            reports[mode] = run_open_loop(
                mux, sessions=ELASTIC_SESSIONS, requests=per_session,
                arrivals=arrivals,
            )
            counters[mode] = mux._inner.stats()
    static, reactive_rep = reports["static"], reports["reactive"]
    rs = counters["reactive"]
    stalls = rs.get("resize_stalls") or []
    return {
        "workload": "elastic_serving",
        "backend": "process",
        "batch_size": 2,
        "stages": len(rs.get("stage_widths") or []) or None,
        "workers": 1,
        "worker_budget": ELASTIC_BUDGET,
        "sessions": ELASTIC_SESSIONS,
        "arrivals": "bursty",
        "open_loop": True,
        "capacity_per_s": round(capacity, 1),
        "offered_rate_per_s": round(reactive_rep.offered_rate, 1),
        "achieved_rate_per_s": round(reactive_rep.achieved_rate, 1),
        "tuples": reactive_rep.requests,
        "wall_s": round(reactive_rep.duration_s, 3),
        "throughput_per_s": round(reactive_rep.achieved_rate, 1),
        "p50_latency_ms": round(reactive_rep.p50 * 1e3, 3),
        "p99_latency_ms": round(reactive_rep.p99 * 1e3, 3),
        "p999_latency_ms": round(reactive_rep.p999 * 1e3, 3),
        "mean_latency_ms": round(reactive_rep.mean * 1e3, 3),
        "static_p50_latency_ms": round(static.p50 * 1e3, 3),
        "static_p99_latency_ms": round(static.p99 * 1e3, 3),
        "final_stage_widths": rs.get("stage_widths"),
        "grows": rs.get("grows", 0),
        "shrinks": rs.get("shrinks", 0),
        "resize_aborts": rs.get("resize_aborts", 0),
        "resize_reverts": rs.get("resize_reverts", 0),
        "max_resize_stall_ms": (
            round(max(stalls) * 1e3, 3) if stalls else 0.0
        ),
    }


def _run_ab_configs(seconds: float, workers: int):
    """Measure the skewed-stages pair interleaved: flat/auto alternate over
    ``AB_ROUNDS`` rounds and each config's throughput is aggregated across
    its rounds.  Back-to-back alternation means both sides sample the same
    host-speed regime, so the ratio is robust to machine drift that dwarfs
    the effect on shared/bursted vCPUs."""
    flat_cfg, auto_cfg = _ab_configs()
    probe_n = 1500
    _, probe = _run_once(flat_cfg, probe_n, workers)
    per_round = max(
        int(probe.throughput * seconds / AB_ROUNDS), probe_n
    )
    agg = {id(flat_cfg): [0, 0.0, None], id(auto_cfg): [0, 0.0, None]}
    for _ in range(AB_ROUNDS):
        for cfg in (flat_cfg, auto_cfg):
            pipe, report = _run_once(cfg, per_round, workers)
            slot = agg[id(cfg)]
            slot[0] += report.tuples_in
            slot[1] += report.wall_time
            slot[2] = (pipe, report)
    rows = []
    for cfg in (flat_cfg, auto_cfg):
        tuples, wall, (pipe, report) = agg[id(cfg)]
        rows.append({
            "workload": cfg["workload"],
            "backend": cfg["backend"],
            "batch_size": cfg["batch_size"],
            "stages": getattr(pipe, "num_stages", None),
            "workers": cfg["workers"],
            "stage_widths": getattr(pipe, "stage_widths", lambda: None)(),
            "interleaved_rounds": AB_ROUNDS,
            "tuples": tuples,
            "wall_s": round(wall, 3),
            "throughput_per_s": round(tuples / wall, 1),
            "egress_throughput_per_s": round(report.egress_throughput, 1),
            "p99_latency_ms": round(report.p99_latency * 1e3, 3),
            "mean_latency_ms": round(report.mean_latency * 1e3, 3),
            "busy_frac": round(report.worker_busy_frac, 3),
        })
    return rows


def _columnar_ab_configs():
    base = dict(
        workload="columnar_device", backend="process", batch_size=COL_BATCH,
        workers=2, device_batch=COL_BATCH, device_backend="numpy",
        max_inflight=32, reorder_size=1024,
    )
    return (dict(base, columnar=False), dict(base, columnar=True))


def _run_columnar_ab(seconds: float, workers: int):
    """The tentpole wire A/B: pickled units vs TAG_COLBLOCK spans through
    the same widen -> device -> device chain, interleaved over
    ``AB_ROUNDS`` so both sides sample the same host-speed regime.  Even
    interleaved, budget ~±20% ratio drift run-to-run on shared vCPUs."""
    pickle_cfg, col_cfg = _columnar_ab_configs()
    probe_n = 4000
    _, probe = _run_once(pickle_cfg, probe_n, workers)
    per_round = max(int(probe.throughput * seconds / AB_ROUNDS), probe_n)
    agg = {id(pickle_cfg): [0, 0.0, None], id(col_cfg): [0, 0.0, None]}
    for _ in range(AB_ROUNDS):
        for cfg in (pickle_cfg, col_cfg):
            pipe, report = _run_once(cfg, per_round, workers)
            slot = agg[id(cfg)]
            slot[0] += report.tuples_in
            slot[1] += report.wall_time
            slot[2] = (pipe, report)
    rows = []
    for cfg in (pickle_cfg, col_cfg):
        tuples, wall, (pipe, report) = agg[id(cfg)]
        rows.append({
            "workload": cfg["workload"],
            "backend": cfg["backend"],
            "batch_size": cfg["batch_size"],
            "stages": getattr(pipe, "num_stages", None),
            "workers": cfg["workers"],
            "columnar": cfg["columnar"],
            "device_batch": cfg["device_batch"],
            "device_backend": cfg["device_backend"],
            "interleaved_rounds": AB_ROUNDS,
            "tuples": tuples,
            "wall_s": round(wall, 3),
            "throughput_per_s": round(tuples / wall, 1),
            "egress_throughput_per_s": round(report.egress_throughput, 1),
            "p99_latency_ms": round(report.p99_latency * 1e3, 3),
            "mean_latency_ms": round(report.mean_latency * 1e3, 3),
            "busy_frac": round(report.worker_busy_frac, 3),
        })
    return rows


def _offload_expected(n: int) -> list:
    """The device_offload chain computed in Python: widen, then ``a*x + b``
    of its one device stage on every column (the values stay far inside
    int64)."""
    a, b = COL_DEVICE_PARAMS[0]
    return [(v * a + b,) * COL_WIDTH for v in range(n)]


def _run_device_offload(seconds: float, workers: int, device: str = "cuda"):
    """Offload smoke row: one device stage on K1 (``device="cuda"``) or its
    plain version (``"cpu"``) with columnar ingest — an absolute-throughput
    tracker for the dispatch path, not an A/B.  Every run of the row (probe
    included) collects its egress and holds it to the chain computed in
    Python, and counts the device stage's dispatches and K1 launches."""
    default_device(device)  # no card: raise now (asks NVML, not CUDA)
    counts = {"dispatches": 0, "launches": 0, "runs": 0}

    def on_run(handle, n):
        if handle.outputs != _offload_expected(n):
            raise RuntimeError(f"device_offload: egress of {n} tuples is not in order "
                               "or differs from the chain computed in Python")
        for stats in handle.device_stats:
            counts["dispatches"] += stats["dispatches"]
            counts["launches"] += stats["launches"]
        counts["runs"] += 1

    cfg = {
        "workload": "device_offload", "backend": "process",
        "batch_size": 64, "workers": 2, "columnar": True,
        "device_batch": 128, "device_backend": device, "max_inflight": 32,
        "collect_outputs": True, "on_run": on_run,
    }
    row = _run_config(cfg, seconds, workers)
    if device == "cuda" and counts["launches"] != counts["dispatches"]:
        raise RuntimeError(f"device_offload: K1 launched {counts['launches']} times for "
                           f"{counts['dispatches']} dispatches")
    row["columnar"] = True
    row["device_backend"] = device
    row["device_kernel"] = OFFLOAD_KERNEL
    row["device_dispatches"] = counts["dispatches"]
    row["device_launches"] = counts["launches"]
    row["egress_in_order"] = counts["runs"] > 0
    return row


def run(seconds: float = 10.0, workers: int = 4,
        out: str = os.path.join("build", "BENCH_core_torch.json"), print_fn=print,
        device: str = "cuda"):
    default_device(device)  # no card: raise before any row (asks NVML, not CUDA)
    rows = []
    for cfg in CONFIGS:
        row = _run_config(cfg, seconds, workers)
        rows.append(row)
        stages = "-" if row["stages"] is None else row["stages"]
        print_fn(
            f"{row['workload']:>14} {row['backend']:>7} "
            f"batch={row['batch_size']:<3} stages={stages:<2} "
            f"thru={row['throughput_per_s']:>10,.0f}/s "
            f"p99={row['p99_latency_ms']:.3f}ms busy={row['busy_frac']:.2f} "
            f"({row['tuples']} tuples / {row['wall_s']}s)"
        )
    row = _run_recovery(seconds, workers)
    rows.append(row)
    print_fn(
        f"{row['workload']:>14} {row['backend']:>7} "
        f"batch={row['batch_size']:<3} "
        f"goodput={row['throughput_per_s']:>10,.0f}/s "
        f"clean={row['clean_throughput_per_s']:>10,.0f}/s "
        f"recovery={row['recovery_latency_ms']:.1f}ms "
        f"restarts={row['restarts']}"
    )
    for row in _run_ab_configs(seconds, workers):
        rows.append(row)
        print_fn(
            f"{row['workload']:>14} {row['backend']:>7} "
            f"batch={row['batch_size']:<3} workers={row['workers']} "
            f"widths={row['stage_widths']} "
            f"thru={row['throughput_per_s']:>10,.0f}/s "
            f"({row['tuples']} tuples / {row['wall_s']}s interleaved)"
        )
    for row in _run_columnar_ab(seconds, workers):
        rows.append(row)
        wire = "colblock" if row["columnar"] else "pickle"
        print_fn(
            f"{row['workload']:>14} {row['backend']:>7} "
            f"batch={row['batch_size']:<3} wire={wire:<8} "
            f"thru={row['throughput_per_s']:>10,.0f}/s "
            f"busy={row['busy_frac']:.2f} "
            f"({row['tuples']} tuples / {row['wall_s']}s interleaved)"
        )
    row = _run_device_offload(seconds, workers, device)
    rows.append(row)
    print_fn(
        f"{row['workload']:>14} {row['backend']:>7} "
        f"batch={row['batch_size']:<3} "
        f"kernel={row['device_kernel']}({row['device_backend']}) "
        f"thru={row['throughput_per_s']:>10,.0f}/s "
        f"p99={row['p99_latency_ms']:.3f}ms "
        f"({row['tuples']} tuples / {row['wall_s']}s) "
        f"dispatches={row['device_dispatches']} K1 launches={row['device_launches']} "
        f"egress in order={row['egress_in_order']}"
    )
    row = _run_serving(seconds, workers)
    rows.append(row)
    print_fn(
        f"{row['workload']:>14} {row['backend']:>7} "
        f"sessions={row['sessions']} open-loop poisson "
        f"offered={row['offered_rate_per_s']:>8,.0f}/s "
        f"p50={row['p50_latency_ms']:.2f}ms p99={row['p99_latency_ms']:.2f}ms "
        f"p999={row['p999_latency_ms']:.2f}ms"
    )
    row = _run_elastic_serving(seconds, workers)
    rows.append(row)
    print_fn(
        f"{row['workload']:>14} {row['backend']:>7} "
        f"sessions={row['sessions']} open-loop bursty "
        f"grows={row['grows']} shrinks={row['shrinks']} "
        f"aborts={row['resize_aborts']} "
        f"p99={row['p99_latency_ms']:.2f}ms "
        f"static-p99={row['static_p99_latency_ms']:.2f}ms"
    )

    def thru(workload, backend, batch, staged=None):
        for r in rows:
            if (
                r["workload"] == workload
                and r["backend"] == backend
                and r["batch_size"] == batch
                and (
                    staged is None
                    or (r["stages"] != 1 if staged else r["stages"] == 1)
                )
            ):
                return r["throughput_per_s"]
        return 0.0

    def thru_workers(workload, auto):
        for r in rows:
            if r["workload"] == workload and (
                (r.get("workers") == "auto") == auto
            ):
                return r["throughput_per_s"]
        return 0.0

    ratios = {
        "process_vs_thread": round(
            thru("cpu_chain", "process", 1) /
            max(thru("cpu_chain", "thread", 1), 1e-9), 3,
        ),
        "thread_batch32_vs_batch1": round(
            thru("cpu_chain", "thread", 32) /
            max(thru("cpu_chain", "thread", 1), 1e-9), 3,
        ),
        # Staged plan vs the ingress-only plan
        # on the same workload.  The auto plan cuts SL|PS|SL into 2 stages
        # (the trailing stateless run folds into the keyed stage).
        "staged_vs_ingress_process": round(
            thru("keyed_hotspot", "process", 32, staged=True) /
            max(thru("keyed_hotspot", "process", 32, staged=False), 1e-9), 3,
        ),
        # Cost-model worker allocation vs the flat
        # even split of the same budget (interleaved measurement).
        "auto_vs_flat_process": round(
            thru_workers("skewed_stages", auto=True) /
            max(thru_workers("skewed_stages", auto=False), 1e-9), 3,
        ),
        # Robustness: goodput under a mid-run keyed-worker
        # kill (checkpoint restore + replay included) vs the clean run.
        "recovery_goodput_vs_clean": round(
            thru("recovery", "process", 32) /
            max(next(
                (r["clean_throughput_per_s"] for r in rows
                 if r["workload"] == "recovery"), 0.0,
            ), 1e-9), 3,
        ),
        # TAG_COLBLOCK spans vs pickled units on
        # the same widen -> device -> device chain (interleaved; the
        # columnar side encodes blocks in the parallel upstream workers and
        # device stages ingest/relay them zero-copy).
        "columnar_vs_pickle_process": round(
            next((r["throughput_per_s"] for r in rows
                  if r["workload"] == "columnar_device" and r["columnar"]),
                 0.0) /
            max(next(
                (r["throughput_per_s"] for r in rows
                 if r["workload"] == "columnar_device"
                 and not r["columnar"]), 0.0,
            ), 1e-9), 3,
        ),
        # Tail latency of the traffic-reactive
        # loop vs static widths on the same bursty trace (< 1 = reactive
        # resizes pay for themselves; the acceptance bar is <= 1.25).
        "elastic_serving_p99_vs_static": round(
            next((r["p99_latency_ms"] for r in rows
                  if r["workload"] == "elastic_serving"), 0.0) /
            max(next(
                (r["static_p99_latency_ms"] for r in rows
                 if r["workload"] == "elastic_serving"), 0.0,
            ), 1e-9), 3,
        ),
    }
    doc = {
        "meta": {
            "workloads": {
                "cpu_chain": f"fig8-style CPU-bound chain ({STAGES} stages, "
                             f"spin={SPIN})",
                "keyed_hotspot": f"SL(spin=30) -> PS(spin={HOT_SPIN}, keyed) "
                                 f"-> SL(spin=30) interior hot spot",
                "recovery": f"keyed_hotspot(spin_hot={RECOVERY_SPIN}) under "
                            "a seeded mid-run SIGKILL of the keyed stage's "
                            f"worker 0 (checkpoint_interval={RECOVERY_CKPT}; "
                            "goodput includes the restore+replay stall)",
                "skewed_stages": f"SL(spin={SKEW_HOT}, hot) -> "
                                 f"PS(spin={SKEW_COLD}, keyed cold): flat "
                                 "width 1 = even split of the default "
                                 "cores+1 budget over the 2 data-parallel "
                                 "stages; auto = cost-model division "
                                 f"(interleaved x{AB_ROUNDS})",
                "columnar_device": (
                    f"SL widen (scalar -> {COL_WIDTH}x i8 tuple) -> 2 device "
                    "affine stages (NumPy reference kernel), batch "
                    f"{COL_BATCH}: pickled units vs TAG_COLBLOCK spans on "
                    f"the same chain, interleaved x{AB_ROUNDS}; the ratio "
                    "still carries ~±20% host drift on shared vCPUs "
                    "(docs/columnar.md)"
                ),
                "device_offload": (
                    "widen -> 1 device stage with columnar ingest on "
                    f"{OFFLOAD_KERNEL} (K1 on cuda, its plain version on "
                    "cpu; recorded in device_backend) — offload smoke row, "
                    "not an A/B"
                ),
                "serving": f"{SERVING_SESSIONS} concurrent ordered sessions "
                           "multiplexed onto one runtime (SessionMux), "
                           "open-loop Poisson arrivals at "
                           f"{SERVING_UTIL:.0%} of probed capacity; "
                           "latency is coordinated-omission-free "
                           "(measured from scheduled arrival; probe "
                           "discards a 400-request warmup prefix)",
                "elastic_serving": f"{ELASTIC_SESSIONS} sessions, bursty "
                                   f"open-loop trace ({ELASTIC_DUTY:.0%} of "
                                   f"each period at {ELASTIC_BURST:g}x the "
                                   f"{ELASTIC_UTIL:.0%}-of-capacity mean) "
                                   "on the process backend: static widths "
                                   "vs the traffic-reactive loop (mux load "
                                   "signals -> TrafficMonitor grow/shrink "
                                   "of the sid-partitioned stage, p99 "
                                   "resize guard); reactive side reported",
            },
            "seconds_per_config": seconds,
            "device": device,
            "cpu_count": os.cpu_count(),
            "python": platform.python_version(),
            "unix_time": int(time.time()),
        },
        "results": rows,
        "ratios": ratios,
    }
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    print_fn(
        f"ratios: process/thread={ratios['process_vs_thread']}x  "
        f"batch32/batch1={ratios['thread_batch32_vs_batch1']}x  "
        f"staged/ingress={ratios['staged_vs_ingress_process']}x  "
        f"auto/flat={ratios['auto_vs_flat_process']}x  "
        f"columnar/pickle={ratios['columnar_vs_pickle_process']}x  "
        f"recovery/clean={ratios['recovery_goodput_vs_clean']}x  "
        f"elastic-p99/static={ratios['elastic_serving_p99_vs_static']}x  "
        f"-> {out}"
    )
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="~1 s per config (CI plumbing check)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="wall-clock window per config (default 10, smoke 1)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the device_offload row runs K1 (cpu: its plain version)")
    ap.add_argument("--out", default=os.path.join("build", "BENCH_core_torch.json"))
    args = ap.parse_args(argv)
    seconds = args.seconds if args.seconds is not None else (1.0 if args.smoke else 10.0)
    run(seconds=seconds, workers=args.workers, out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
