"""Readings that the limits of ``cells/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload olmo-1b.stream-code \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 20

For each seed, in one process: the cell's set-up and a window as a run
makes them, then the numbers a run compares.  On the control seeds also the
control (the reference in float8 put in the program's place) and, for a
serving cell, a witness (the reference with its linear layers' inputs in
bfloat16, the configuration's precision) or, for a training cell, a planted
fault (half of each batch left out, the mean over the rest).  One JSON line a seed goes to standard output and to
``--out``.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve_seed(run, control: bool) -> dict:
    """The run's numbers; on a control seed also the control's and the
    witness's, each judged by the cell's limits as a run judges its own."""
    from portbench import bench, serving

    params, engine, spans = serving.setup(run)
    w = serving.window(run, engine, spans)
    del engine
    _free()
    out = serving.order_checks(w["egress"], w["asked"])
    picked = serving.sample(w["egress"], run.seed, run.mix["sample"])
    out["egressed"] = len(w["egress"])
    out["served_tokens"] = sum(len(e["tokens"]) for e in picked)
    limits = run.params["limits"]
    modes = (("", False), ("control.", "fp8"), ("bf16_witness.", "bf16"))
    for name, ctl in modes if control else modes[:1]:
        gaps = serving.served_gaps(run, params, w["asked"], picked, ctl)
        numbers = serving.gap_numbers(gaps)
        checks = bench.judge({k: v for k, v in numbers.items() if k in limits}, limits)
        out.update({name + k: v for k, v in numbers.items()})
        out[name + "correct"] = bench.passed(checks)
        out[name + "requests"] = _requests(gaps)
    return out


def _requests(gaps: list) -> list:
    """Each picked request: tokens, tokens off by more than 0.5 and 1.0,
    its median and its widest gap."""
    return [[g.numel(), int((g > 0.5).sum()), int((g > 1.0).sum()),
             round(float(g.median()), 4), round(float(g.max()), 4)] for g in gaps]


def train_seed(run, control: bool) -> dict:
    from portbench import training

    step, params, state, prog, spans = training.setup(run)
    del step, params, state
    _free()
    ref = training.reference_readings(run)
    out = dict(training.compare(prog, ref), loss=prog["loss"], ref_loss=ref["loss"],
               grad_norm=prog["grad_norm"], ref_grad_norm=ref["grad_norm"],
               change=prog["change"], ref_change=ref["change"])
    if control:
        for name, kw in (("control", {"control": True}),
                         ("half_batch", {"keep_rows": run.mix["batch"] // 2})):
            other = training.reference_readings(run, **kw)
            out.update({f"{name}.{k}": v for k, v in training.compare(other, ref).items()})
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import bench

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        run = bench.load(args.workload, seed, args.seconds, False)
        run.device, run.t_start = "cuda", time.perf_counter()
        fn = serve_seed if run.mix["kind"] == "serve" else train_seed
        t0 = time.perf_counter()
        line = dict(workload=args.workload, seed=seed, **fn(run, seed in controls),
                    seconds_taken=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        _free()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
