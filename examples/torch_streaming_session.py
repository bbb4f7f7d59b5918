"""Streaming Session: push traffic in, pull ordered results out — no finite
source required (the ROADMAP's serving-grade surface).

Opens the same keyed pipeline as a live session on BOTH backends: the thread
runtime processes pushes concurrently; the process backend feeds the stage-0
shared-memory exchange incrementally while forked worker groups execute the
stages.  Ordered egress is identical either way.

  PYTHONPATH=src python examples/torch_streaming_session.py

The port's twin of ``examples/streaming_session.py``: the same program on ``repro_torch``,
which runs on the host alone (no device stage).
"""
from repro_torch.core import Engine, EngineConfig, OpSpec


def build_specs():
    return [
        OpSpec("square", "stateless", _square, cost_us=2),
        OpSpec(
            "running_sum", "partitioned", _running_sum,
            key_fn=_mod7, num_partitions=14, init_state=_zero, cost_us=4,
        ),
    ]


def _square(v):
    return [v * v]


def _running_sum(s, k, v):
    s += v
    return s, [(k, s)]


def _mod7(v):
    return v % 7


def _zero():
    return 0


def reference(n):
    state = {}
    out = []
    for v in range(n):
        vv = v * v
        k = vv % 7
        state[k] = state.get(k, 0) + vv
        out.append((k, state[k]))
    return out


def main():
    n = 2000
    expected = reference(n)
    for backend in ("thread", "process"):
        engine = Engine(EngineConfig(backend=backend, num_workers=2))
        plan = engine.plan(build_specs())
        with engine.open(plan) as session:
            # interleave pushes with ordered reads, like a serving loop
            session.push(range(0, n // 2))
            head = list(session.results(max_items=100))
            session.push(range(n // 2, n))
            print(f"{backend}: mid-stream stats {session.stats()}")
            report = session.close()
            tail = list(session.results())
        got = head + tail
        assert got == expected, f"{backend}: ordering violated"
        print(f"{backend}: {report} — ordered egress verified ({len(got)} tuples)")


if __name__ == "__main__":
    main()
