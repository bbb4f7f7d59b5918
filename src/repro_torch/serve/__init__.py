"""Serving tier of the port.

- :mod:`.mux` — :class:`SessionMux` / :class:`MuxSession`: many concurrent
  ordered sessions admitted onto one planned Engine runtime (sid-tagged
  ingress, demuxed ordered egress, DRR fairness, admission control,
  graceful churn; see docs/serving.md);
- :mod:`.loadgen` — open-loop load generator (Poisson / heavy-tailed /
  bursty / diurnal arrivals) with coordinated-omission-free p50/p99/p999
  latency accounting;
- :mod:`.engine` — the continuous-batching :class:`OrderedServingEngine`
  (model-serving embodiment of the ordered-egress problem).

Importing the package does not touch CUDA.
"""
from .engine import Completion, OrderedServingEngine, Request
from .loadgen import (
    ArrivalConfig,
    LatencyReport,
    arrival_times,
    percentile,
    run_open_loop,
)
from .mux import AdmissionError, MuxConfig, MuxSession, SessionMux, tag_graph

__all__ = [
    "AdmissionError",
    "ArrivalConfig",
    "Completion",
    "LatencyReport",
    "MuxConfig",
    "MuxSession",
    "OrderedServingEngine",
    "Request",
    "SessionMux",
    "arrival_times",
    "percentile",
    "run_open_loop",
    "tag_graph",
]
