"""Run one cell as ``run.py`` does, with the program's own tracer on.

    python3 portbench/spans_run.py --workload olmo-1b.stream-code --seed 7 --seconds 45 \
        --trace 1

The program's tracer (``repro_torch.trace``) records from the window's open
to its close; the profiled stretch is read by ``spans.reduce`` (the
program's ranges are no device work, gaps are named by harness and program
span, launches and device seconds are put down to the program span that
launched them); and a ``--trace 1`` run's result line adds the metrics of
``METRICS`` (one reader each under ``metrics/``, reading ``ctx["spans"]``,
the tracer's records, and the stretch's ``program`` table), after two lines
on standard error: the stretch's launches and device ms by innermost
program span, and how much of the stretch the program's spans account for.
The tracer's cost when on is this run's against ``run.py``'s on the same
seed.

``METRICS`` are the per-layer entries of the program's spans, in
``BENCHMARK.json``'s form; ``run.py`` reports none of them.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SERVE = ["olmo-1b.stream-code", "qwen2-moe-a2.7b.stream-code"]
ENGINE = "serving engine: scheduler and reorder ring"
METRICS = [
    {"name": "queue_wait_p90_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": ENGINE, "moves": "egress_p90_ms", "workloads": SERVE},
    {"name": "ring_held_p90", "unit": "requests", "better": "lower",
     "source": "program_counter", "layer": ENGINE, "moves": "egress_p90_ms", "workloads": SERVE},
    {"name": "ring_parked_pct", "unit": "%", "better": "lower", "source": "program_counter",
     "layer": ENGINE, "moves": "egress_p90_ms", "workloads": SERVE},
    {"name": "engine_self_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": ENGINE, "moves": "serve_tokens_per_s", "workloads": SERVE},
    {"name": "decode_launches", "unit": "launches", "better": "lower", "source": "device_trace",
     "layer": "model step: decode", "moves": "serve_tokens_per_s", "workloads": SERVE},
    {"name": "prefill_launches", "unit": "launches", "better": "lower", "source": "device_trace",
     "layer": "model step: prefill", "moves": "serve_tokens_per_s", "workloads": SERVE},
    {"name": "forward_ms", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "trainer: forward and loss", "moves": "train_tokens_per_s",
     "workloads": ["olmo-1b.train"]},
    {"name": "backward_ms", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "trainer: backward with recompute", "moves": "train_tokens_per_s",
     "workloads": ["olmo-1b.train"]},
    {"name": "adamw_ms", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "trainer: optimizer", "moves": "train_tokens_per_s",
     "workloads": ["olmo-1b.train"]},
]
TRAIN = ("train.forward", "train.backward", "train.adamw")


def account_line(summary: dict) -> str:
    """The idle seconds named by a harness span alone or ``untracked``, and
    the device seconds a training step's three parts launched, each against
    the stretch's whole."""
    idle = summary["window_s"] - summary["busy_s"]
    loose = sum(s for name, s in summary["idle_gaps"].items()
                if "." not in name.split("/")[-1])  # program spans have a dot
    table = summary.get("program", {})
    parts = sum(table[n]["device_s"] for n in TRAIN if n in table)
    return (f"stretch accounted: idle {idle!r} s, of it {loose!r} s under a harness span alone "
            f"or untracked; busy {summary['busy_s']!r} s, of it {parts!r} s launched in "
            f"{'+'.join(TRAIN)}")


def install(patch=setattr) -> None:
    """Add ``METRICS`` to every run's spec, turn the tracer on over the
    window and hand its records to the readers (``patch(module, name,
    value)`` puts each piece in place)."""
    from repro_torch import trace

    from portbench import bench, serving, spans, training
    from portbench import trace as harness_trace

    load = bench.load

    def load_with(*args, **kwargs):
        run = load(*args, **kwargs)
        run.spec = dict(run.spec, per_layer=run.spec["per_layer"] + METRICS)
        return run

    patch(bench, "load", load_with)
    patch(harness_trace, "reduce", spans.reduce)
    for mod in (serving, training):
        def window(*args, _window=mod.window, **kwargs):
            trace.enable()
            try:
                return _window(*args, **kwargs)
            finally:
                trace.disable()

        def read(run, ctx, _read=mod.read_per_layer):
            if ctx["trace"] is not None:
                print(spans.line(ctx["trace"]), file=sys.stderr)
                print(account_line(ctx["trace"]), file=sys.stderr)
            return _read(run, dict(ctx, spans=trace.take()))

        patch(mod, "window", window)
        patch(mod, "read_per_layer", read)


def main(argv=None) -> int:
    from portbench import run  # the process's start, the caches' places

    install()
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
