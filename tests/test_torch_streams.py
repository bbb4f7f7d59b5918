"""Port parity: the paper's stream workloads (``repro_torch.streams``) and
the discrete-event simulator (``repro_torch.core.simulate``) against the
JAX package's.

Each TPCx-BB query (and DAG form) is rebuilt on each side from
``(name, n, seed)`` (its specs hold lambdas, which do not pickle); only the
egress crosses, as ``repr``, so floats match to the last bit.  The
reference's runtime runs in a spawned child (``torch_jaxref``), never in
this process.  The simulator is a seeded ``random.Random`` on both sides,
so its result dicts are equal exactly.  Then the reference's own simulator
and parametric-runtime tests, run on the port.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import torch_jaxref as ref
from torch_jaxref import Reference
import repro_torch.core as tcore
from repro_torch.core.simulate import SimConfig, SimOp, simulate
from repro_torch.streams import tpcxbb
from repro_torch.streams.parametric import partitioned_parametric, stateless_parametric

# runs the reference package only (no jax computation), one child per call:
# the port's process runs below fork workers from this process
JAX = Reference(keep=False)
_reference_child = JAX.fixture()

N = 6000  # the reference test's size; Q2's state grows with the square of it
SEED = 0
BACKENDS = ["thread", "process"]
CASES = ([(q, N, SEED, False, b) for q in tpcxbb.QUERIES for b in BACKENDS]
         + [(q, N, SEED, True, b) for q in tpcxbb.DAG_QUERIES for b in BACKENDS])


@functools.lru_cache(maxsize=None)
def _reference_egress() -> dict:
    """The reference runtime's egress of every case, from one child."""
    return dict(zip(CASES, JAX("tpcxbb_egress_many", CASES)))


def _sequential_reference(specs, source):
    """Single-threaded oracle: each tuple through the whole chain in turn."""
    states = [{} if s.kind == "partitioned" else
              (s.init_state() if s.kind == "stateful" else None) for s in specs]
    out = []

    def recurse(i, value):
        if i == len(specs):
            out.append(value)
            return
        s = specs[i]
        if s.kind == "stateless":
            outs = s.fn(value)
        elif s.kind == "stateful":
            states[i], outs = s.fn(states[i], value)
        else:
            key = s.key_fn(value)
            st_ = states[i].get(key)
            st_, outs = s.fn(s.init_state() if st_ is None else st_, key, value)
            states[i][key] = st_
        for o in outs:
            recurse(i + 1, o)

    for v in source:
        recurse(0, v)
    return out


# ------------------------------------------------------- (a) TPCx-BB egress
@pytest.mark.timeout(180)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("qname", list(tpcxbb.QUERIES))
def test_tpcxbb_query_egress_equals_reference(qname, backend):
    """Each query's egress on the port's runtime equals the reference
    runtime's on the same backend, tuple for tuple and in order."""
    case = (qname, N, SEED, False, backend)
    ours = ref.tpcxbb_run(tcore, tpcxbb, *case)
    assert repr(ours) == _reference_egress()[case]
    assert ours, f"{qname}: the query produced no output"


@pytest.mark.timeout(180)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("qname", list(tpcxbb.DAG_QUERIES))
def test_tpcxbb_dag_egress_equals_reference_and_the_linear_form(qname, backend):
    """Each DAG form (keyed Split, parallel branches, Merge) gives the
    reference's egress, which is the linear form's (sequential oracle)."""
    case = (qname, N, SEED, True, backend)
    ours = ref.tpcxbb_run(tcore, tpcxbb, *case)
    assert repr(ours) == _reference_egress()[case]
    specs, src = tpcxbb.QUERIES[qname](n=N, seed=SEED)
    assert ours == _sequential_reference(specs, list(src))


# ------------------------------------------------------------ (b) simulator
@functools.lru_cache(maxsize=None)
def _reference_sim_ops() -> dict:
    return JAX("tpcxbb_sim_ops", list(tpcxbb.QUERIES))


@pytest.mark.parametrize("qname", list(tpcxbb.QUERIES))
def test_sim_ops_equal_reference(qname):
    assert [dataclasses.asdict(op) for op in tpcxbb.sim_ops(qname)] == \
        _reference_sim_ops()[qname]


def _ops(*ops):
    return [dataclasses.asdict(op) for op in ops]


# (ops as dicts or a query name, n_tuples, SimConfig fields, key sampler)
SIM_CASES = {
    "stateless_1": (_ops(SimOp("op", "stateless", cost_us=100.0)), 2000,
                    dict(num_workers=1, heuristic="lp"), (None,)),
    "stateless_8": (_ops(SimOp("op", "stateless", cost_us=100.0)), 2000,
                    dict(num_workers=8, heuristic="lp"), (None,)),
    "stateful_8": (_ops(SimOp("sf", "stateful", cost_us=50.0)), 1000,
                   dict(num_workers=8), (None,)),
    "lock_based": (_ops(SimOp("light", "stateless", cost_us=10.0)), 5000,
                   dict(num_workers=16, reorder_scheme="lock_based", heuristic="lp"), (None,)),
    "hybrid_skew": (_ops(SimOp("ps", "partitioned", cost_us=100.0, num_partitions=100)), 3000,
                    dict(num_workers=8, worklist_scheme="hybrid", heuristic="lp"),
                    ("gaussian", 0.2, 100)),
    "partitioned_skew": (_ops(SimOp("ps", "partitioned", cost_us=100.0, num_partitions=8)),
                         3000, dict(num_workers=8, worklist_scheme="partitioned",
                                    heuristic="lp"), ("gaussian", 0.2, 8)),
    "chain_seed3": (_ops(SimOp("a", "stateless", cost_us=5.0, selectivity=2.0),
                         SimOp("b", "partitioned", cost_us=5.0, num_partitions=16),
                         SimOp("c", "stateless", cost_us=5.0, selectivity=0.5)), 1000,
                    dict(num_workers=4, seed=3, jitter=0.5), (None,)),
    **{f"{q}_{h}": (q, 2000, dict(num_workers=8, heuristic=h), ("uniform", 1 << 30))
       for q in ("q1", "q2", "q15") for h in ("ct", "qst", "lp")},
}


@functools.lru_cache(maxsize=None)
def _reference_sims() -> dict:
    return dict(zip(SIM_CASES, JAX("simulate_many", list(SIM_CASES.values()))))


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulate_equals_reference_exactly(case):
    ops, n, cfg, sampler = SIM_CASES[case]
    ops = tpcxbb.sim_ops(ops) if isinstance(ops, str) else [SimOp(**op) for op in ops]
    ours = simulate(ops, n, SimConfig(**cfg), key_sampler=ref.key_sampler(*sampler))
    assert ours == _reference_sims()[case]


# ------------------- (c) the reference's simulator and stream tests, on the port
def test_sim_perfect_scaling_stateless():
    ops = [SimOp("op", "stateless", cost_us=100.0)]
    r1 = simulate(ops, 2000, SimConfig(num_workers=1, heuristic="lp"))
    r8 = simulate(
        [SimOp("op", "stateless", cost_us=100.0)], 2000,
        SimConfig(num_workers=8, heuristic="lp"),
    )
    assert r1["makespan_us"] / r8["makespan_us"] > 7.0


def test_sim_stateful_caps_at_one_worker():
    ops = [SimOp("sf", "stateful", cost_us=50.0)]
    r1 = simulate(ops, 1000, SimConfig(num_workers=1))
    r8 = simulate([SimOp("sf", "stateful", cost_us=50.0)], 1000, SimConfig(num_workers=8))
    assert r1["makespan_us"] / r8["makespan_us"] < 1.2  # no speedup possible


def test_sim_nonblocking_beats_lockbased_under_contention():
    def go(scheme):
        return simulate(
            [SimOp("light", "stateless", cost_us=10.0)],
            20_000,
            SimConfig(num_workers=16, reorder_scheme=scheme, heuristic="lp"),
        )

    nb, lb = go("non_blocking"), go("lock_based")
    assert nb["makespan_us"] < lb["makespan_us"]
    assert lb["blocked_us"] > 10 * nb["blocked_us"]


def test_sim_hybrid_beats_partitioned_under_skew():
    def go(scheme, parts):
        return simulate(
            [SimOp("ps", "partitioned", cost_us=100.0, num_partitions=parts)],
            10_000,
            SimConfig(num_workers=8, worklist_scheme=scheme, heuristic="lp"),
            key_sampler=ref.key_sampler("gaussian", 0.2, parts),
        )

    hy = go("hybrid", 100)
    pq = go("partitioned", 8)
    assert hy["makespan_us"] * 1.5 < pq["makespan_us"]


def test_sim_conservation():
    """Tuples in == tuples out x selectivity along the chain."""
    ops = [
        SimOp("a", "stateless", cost_us=5.0, selectivity=2.0),
        SimOp("b", "partitioned", cost_us=5.0, num_partitions=16, selectivity=1.0),
        SimOp("c", "stateless", cost_us=5.0, selectivity=0.5),
    ]
    r = simulate(ops, 1000, SimConfig(num_workers=4))
    assert r["egress"] == 1000 * 2 * 1 * 0.5


@pytest.mark.timeout(120)
@pytest.mark.parametrize("qname", list(tpcxbb.QUERIES))
def test_tpcxbb_queries_run_ordered(qname):
    """The reference test on the port's Engine (it calls the deprecated
    ``run_pipeline``): three workers, ``ct``, against the sequential oracle."""
    specs, source = tpcxbb.QUERIES[qname](n=N)
    eng = tcore.Engine(tcore.EngineConfig(num_workers=3, collect_outputs=True,
                                          thread={"heuristic": "ct"}))
    res = eng.run(specs, list(source))
    specs2, source2 = tpcxbb.QUERIES[qname](n=N)
    assert res.outputs == _sequential_reference(specs2, list(source2)), \
        f"{qname}: concurrent != sequential"
    assert res.egress_count > 0, f"{qname}: query produced no output"


@pytest.mark.parametrize("qname", list(tpcxbb.QUERIES))
def test_tpcxbb_sim_profiles(qname):
    ops = tpcxbb.sim_ops(qname)
    assert len(ops) >= 3
    r = simulate(ops, 2000, SimConfig(num_workers=4, heuristic="ct"),
                 key_sampler=lambda rng: rng.randrange(1 << 30))
    assert r["throughput_per_s"] > 0
    assert r["egress"] >= 0


def test_ct_beats_qst_on_long_pipeline():
    """The paper's headline scheduling claim, in simulation."""
    def go(h):
        return simulate(
            tpcxbb.sim_ops("q2"), 10_000, SimConfig(num_workers=8, heuristic=h),
            key_sampler=lambda rng: rng.randrange(1 << 30),
        )

    ct, qst = go("ct"), go("qst")
    assert ct["throughput_per_s"] >= qst["throughput_per_s"] * 0.95


def test_parametric_pipeline_ordered_under_threads():
    """``test_parametric_thread_runtime.py`` on the port: ordering holds
    with real compute in the loop."""
    specs = [
        stateless_parametric(matrix_n=8, selectivity=1.0),
        partitioned_parametric(matrix_n=8, num_partitions=32),
    ]
    source = [i % 64 for i in range(2000)]  # 64 recurring keys
    eng = tcore.Engine(tcore.EngineConfig(num_workers=4, collect_outputs=True,
                                          thread={"heuristic": "ct"}))
    res = eng.run(specs, source)
    assert res.report.tuples_out == 2000
    # per-KEY state: each key's counter must be the arrival-ordered 1,2,3,...
    seen = {}
    for key, count in res.outputs:
        assert count == seen.get(key, 0.0) + 1.0, "per-key order violated"
        seen[key] = count
