"""The paper's fig. 1 example: high-mobility fraud detection over call-data
records, as an ordered streaming pipeline on the Engine API.

  filter(area) -> project(location record) -> compute speed (by phone)
  -> filter(speed > T) -> windowed count

  PYTHONPATH=src python examples/torch_fraud_detection.py

The port's twin of ``examples/fraud_detection.py``: the same program on ``repro_torch``,
which runs on the host alone (no device stage).
"""
from repro_torch.core import Engine, EngineConfig, OpSpec
from repro_torch.streams.sources import cdr_stream

SPEED_T = 25.0  # cells/second — teleporting phones exceed this
WINDOW_S = 10.0


def main():
    def area_filter(cdr):
        return [cdr] if cdr.area_code == 408 else []

    def project(cdr):
        return [(cdr.caller, cdr.cell, cdr.ts)]

    def speed(state, key, rec):
        phone, cell, ts = rec
        out = []
        if state is not None:
            prev_cell, prev_ts = state
            dt = max(ts - prev_ts, 1e-6)
            v = abs(cell - prev_cell) / dt
            out = [(phone, v, ts)]
        return (cell, ts), out

    def fast_only(rec):
        return [rec] if rec[1] > SPEED_T else []

    def windowed_count(state, rec):
        window, count = state if state else (0, 0)
        w = int(rec[2] // WINDOW_S)
        if w != window:
            emitted = [(window, count)] if count else []
            return (w, 1), emitted
        return (window, count + 1), []

    specs = [
        OpSpec("area_filter", "stateless", area_filter, cost_us=2, selectivity=0.7),
        OpSpec("project", "stateless", project, cost_us=2),
        OpSpec(
            "speed", "partitioned", speed,
            key_fn=lambda r: r[0], num_partitions=128,
            init_state=lambda: None, cost_us=4, selectivity=0.9,
        ),
        OpSpec("fast_only", "stateless", fast_only, cost_us=2, selectivity=0.05),
        OpSpec("windowed_count", "stateful", windowed_count,
               init_state=lambda: None, cost_us=3, selectivity=0.1),
    ]
    engine = Engine(EngineConfig(
        backend="thread", num_workers=4, collect_outputs=True,
        thread={"heuristic": "ct"},
    ))
    plan = engine.plan(specs)
    print(plan.explain())
    result = engine.run(plan, cdr_stream(30_000, seed=7))
    print(result.report)
    alerts = result.outputs
    print(f"{len(alerts)} windows with high-mobility alerts; first 5: {alerts[:5]}")
    assert alerts, "expected some fraud windows with the seeded fraudsters"
    # windows must egress in order (ordered processing)
    windows = [w for (w, _) in alerts]
    assert windows == sorted(windows)
    print("ordered windowed alerts verified")


if __name__ == "__main__":
    main()
