"""Run the TPCx-BB streaming queries (paper §7) on the Engine API — print
the physical plan, then execute on the chosen backend.

  PYTHONPATH=src python examples/torch_tpcxbb_stream.py [q1|q2|q3|q4|q15] [n_tuples] [thread|process]

The port's twin of ``examples/tpcxbb_stream.py``: the same program on ``repro_torch``,
which runs on the host alone (no device stage).
"""
import sys

from repro_torch.core import Engine, EngineConfig
from repro_torch.streams.tpcxbb import QUERIES


def main():
    qname = sys.argv[1] if len(sys.argv) > 1 else "q2"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    backend = sys.argv[3] if len(sys.argv) > 3 else "thread"
    specs, source = QUERIES[qname](n=n)
    engine = Engine(EngineConfig(
        backend=backend,
        num_workers="auto" if backend == "process" else 4,
        collect_outputs=True,
    ))
    plan = engine.plan(specs)
    print(plan.explain())
    result = engine.run(plan, source)
    print(f"{qname}: {result.report}")
    print(f"egress tuples: {result.egress_count}; sample: {result.outputs[:2]}")


if __name__ == "__main__":
    main()
