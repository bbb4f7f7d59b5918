"""Quickstart: compile -> plan -> execute on the Engine API, and check the
ordering guarantee end-to-end.

  PYTHONPATH=src python examples/torch_quickstart.py

The port's twin of ``examples/quickstart.py``: the same program on ``repro_torch``,
which runs on the host alone (no device stage).
"""
from repro_torch.core import Engine, EngineConfig, OpSpec


def main():
    # A 3-operator pipeline: stateless map -> partitioned running sum -> filter
    specs = [
        OpSpec("square", "stateless", lambda v: [v * v], cost_us=2),
        OpSpec(
            "running_sum_by_mod7",
            "partitioned",
            lambda s, k, v: (s + v, [(k, s + v)]),
            key_fn=lambda v: v % 7,
            num_partitions=16,
            init_state=lambda: 0,
            cost_us=3,
        ),
        OpSpec(
            "even_only", "stateless",
            lambda kv: [kv] if kv[1] % 2 == 0 else [], selectivity=0.5, cost_us=1,
        ),
    ]
    source = list(range(1, 5001))

    # compile → plan: the execution plan is a first-class, inspectable artifact
    engine = Engine(EngineConfig(
        backend="thread", num_workers=4, collect_outputs=True,
        thread={"heuristic": "ct"},
    ))
    plan = engine.plan(specs)
    print(plan.explain())
    print()

    # plan → execute: run to drain, uniform JobResult on every backend
    result = engine.run(plan, source)
    print(result.report)
    print("first outputs:", result.outputs[:5])

    # ordering check vs sequential oracle
    state = {}
    expected = []
    for v in source:
        vv = v * v
        k = vv % 7
        state[k] = state.get(k, 0) + vv
        if state[k] % 2 == 0:
            expected.append((k, state[k]))
    assert result.outputs == expected, "ordered-execution guarantee violated!"
    print(f"ordered execution verified over {len(expected)} outputs")


if __name__ == "__main__":
    main()
