# Port copy of src/repro/streams/parametric.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Parametric operators (paper §7): stateless / partitioned-stateful operators
with tunable per-tuple processing cost (matrix work), selectivity, and state
size — used by the thread-runtime micro-benchmarks and tests.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import OpSpec


def _work(n: int, seed_mat: np.ndarray) -> float:
    # ~n^3 flops of real compute per tuple
    return float((seed_mat @ seed_mat).sum())


def stateless_parametric(
    name: str = "param_sl",
    matrix_n: int = 8,
    selectivity: float = 1.0,
    cost_us: float | None = None,
) -> OpSpec:
    m = np.random.RandomState(0).randn(matrix_n, matrix_n).astype(np.float32)
    acc = [0.0]

    def fn(v):
        _work(matrix_n, m)
        base = int(selectivity)
        acc[0] += selectivity - base
        if acc[0] >= 1.0:
            acc[0] -= 1.0
            base += 1
        return [v] * base

    return OpSpec(
        name, "stateless", fn,
        cost_us=cost_us or (matrix_n ** 3) * 2e-3,
        selectivity=selectivity,
    )


def cpu_bound_stateless(
    name: str = "cpu_sl",
    spin: int = 100,
    selectivity: float = 1.0,
) -> OpSpec:
    """Pure-Python (GIL-bound) compute operator — the fig. 8 CPU-bound
    synthetic profile.  Unlike the numpy variants, none of the per-tuple work
    releases the GIL, so the threaded runtime is pinned to ~1 core and the
    process backend's scaling is measured against an honest baseline.
    ``spin`` iterations ≈ ``spin * 0.08`` µs of interpreter work per tuple.
    """
    period = None
    if selectivity < 1.0:
        period = max(int(round(1.0 / (1.0 - selectivity))), 2)

    def fn(v):
        x = float(v) if not isinstance(v, float) else v
        for _ in range(spin):
            x = (x * 1.0000001 + 1.31) % 97.0
        if period is not None and int(v) % period == 0:
            return []  # deterministic filter: same drop set on every backend
        return [x]

    return OpSpec(
        name, "stateless", fn, cost_us=spin * 0.08, selectivity=selectivity
    )


def cpu_bound_chain(
    stages: int = 3, spin: int = 100, selectivity: float = 1.0
) -> list[OpSpec]:
    """Fig. 8-style CPU-bound synthetic query: a chain of pure-Python compute
    stages (used by ``benchmarks/bench_core.py`` and the fig. 8 backend
    comparison)."""
    return [
        cpu_bound_stateless(f"cpu{i}", spin=spin,
                            selectivity=selectivity if i == 0 else 1.0)
        for i in range(stages)
    ]


def cpu_bound_partitioned(
    name: str = "cpu_ps",
    spin: int = 100,
    num_partitions: int = 64,
    key_mod: int = 64,
) -> OpSpec:
    """Pure-Python (GIL-bound) partitioned-stateful compute operator: per-key
    counter state plus ``spin`` iterations of interpreter work per tuple.
    Deterministic, so it is legal on every backend (incl. crash replay)."""

    def fn(state, key, v):
        x = float(v)
        for _ in range(spin):
            x = (x * 1.0000001 + 1.31) % 97.0
        return (state or 0) + 1, [x]

    return OpSpec(
        name, "partitioned", fn,
        key_fn=lambda v: int(v) % key_mod,
        num_partitions=num_partitions,
        init_state=lambda: 0,
        cost_us=spin * 0.08,
        selectivity=1.0,
    )


def keyed_hotspot_chain(
    spin_edge: int = 30, spin_hot: int = 400, num_partitions: int = 64
) -> list[OpSpec]:
    """SL → PS(hot) → SL: a cheap stateless rim around an interior keyed
    compute hot spot.  The configuration the ingress-only process plan cannot
    parallelize (the hot operator lands in the serial parent tail) but the
    staged plan can (the keyed stage gets its own worker group) — the
    tentpole benchmark workload of ``benchmarks/bench_core.py``."""
    return [
        cpu_bound_stateless("pre", spin=spin_edge),
        cpu_bound_partitioned("hot", spin=spin_hot,
                              num_partitions=num_partitions),
        cpu_bound_stateless("post", spin=spin_edge),
    ]


def skewed_stage_chain(
    spin_hot: int = 10000, spin_cold: int = 30, num_partitions: int = 64
) -> list[OpSpec]:
    """SL(hot) → PS(cold): a deliberately *skewed* staged pipeline — the
    leading stateless stage carries ``spin_hot/spin_cold``× the work of the
    keyed stage behind it.  A flat per-stage worker count starves the hot
    stage (the even split of a small core budget leaves it one worker),
    which is exactly the load-imbalance failure mode the paper's scaling
    argument targets; cost-model allocation (``workers="auto"``)
    concentrates the budget on it instead.  The ``auto_vs_flat_process``
    benchmark workload (``benchmarks/bench_core.py``)."""
    return [
        cpu_bound_stateless("hot", spin=spin_hot),
        cpu_bound_partitioned("cold", spin=spin_cold,
                              num_partitions=num_partitions),
    ]


def partitioned_parametric(
    name: str = "param_ps",
    matrix_n: int = 8,
    state_n: int = 16,
    num_partitions: int = 64,
    cost_us: float | None = None,
) -> OpSpec:
    m = np.random.RandomState(1).randn(matrix_n, matrix_n).astype(np.float32)

    def fn(state, key, v):
        if state is None:
            state = np.zeros((state_n,), np.float32)
        _work(matrix_n, m)
        state = state + 1.0
        return state, [(key, float(state[0]))]

    return OpSpec(
        name, "partitioned", fn,
        key_fn=lambda v: hash(v),
        num_partitions=num_partitions,
        init_state=lambda: None,
        cost_us=cost_us or (matrix_n ** 3) * 2e-3,
        selectivity=1.0,
    )
