"""A training cell: the program's train step (loss, remat, K4 in the forward
and the recompute, AdamW in place) on the mix's synthetic batches.

Set-up makes the weights from the seed, builds the step and its optimizer
state, and drives that same object through batches 0, 1 and 2.  It keeps
their losses, each leaf's clipped first gradient (read back from the first
moment after one step: mu / (1 - b1)) and each leaf's change after three
steps (the float32 master that step 4 starts from, against the weights
made anew from the seed).  The window then runs batches 3, 4, ... through
the same step, each step synchronised, until ``seconds`` have passed.

Afterwards the program's state is freed and the reference runs the first
three steps in float32 from the same weights and batches.  Compared, each
against its limit: the worst step's loss, and the worst leaf's first
gradient norm and change norm, each gap over the larger of the reference's
norm of that leaf and of the median leaf.  Leaves whose reference gradient
is under a thousandth of the median leaf's are left out of the change.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from . import families, weights
from .bench import (Run, end_to_end, judge, passed, program_config, read_per_layer,
                    setup_line, window_line)
from .host import GcWatch
from .trace import Spans, Stretch, breakdown, kernel_line
from .traffic import train_batch

DEAD = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _at(tree: dict, name: str):
    for part in name.split("."):
        tree = tree[part]
    return tree


def _batch(run: Run, serial: int) -> dict:
    return train_batch(run.mix, run.model["vocab_size"], run.seed, serial)


def grad_norms(names, state: dict, b1: float) -> dict:
    """{leaf: clipped first gradient norm}, from the first moment after one step."""
    return {name: float(torch.linalg.vector_norm(_at(state["mu"], name).float())) / (1 - b1)
            for name in names}


def drawn(run: Run):
    """(dotted name, tensor) of the run's weights, made from its seed."""
    model = run.model
    return weights.leaves(model, families.of(run.config).layout(model), run.seed, run.device)


def change_norms(run: Run, state: dict) -> dict:
    """Each leaf's float32 master against the weights made anew from the seed."""
    return {name: float(torch.linalg.vector_norm(_at(state["master"], name) - w0.float()))
            for name, w0 in drawn(run)}


def gap(prog: dict, ref: dict, leaves=None) -> float:
    """The worst leaf's |program - reference| over max(reference, median)."""
    names = list(ref) if leaves is None else leaves
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def compare(prog: dict, ref: dict) -> dict:
    med = float(np.median(list(ref["grad_norm"].values())))
    live = [k for k, g in ref["grad_norm"].items() if g >= DEAD * med]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
        "grad_norm_gap": gap(prog["grad_norm"], ref["grad_norm"]),
        "change_gap": gap(prog["change"], ref["change"], live),
    }


def setup(run: Run, steps: int = 3):
    """The step, its state and the readings of its first ``steps`` steps."""
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    model, fam = run.model, families.for_training(run.config)
    cfg = dataclasses.replace(program_config(model), remat=run.mix["remat"])
    ocfg = OptConfig(**run.mix["optimizer"])
    marks = [("start", time.perf_counter())]
    params = weights.make(model, fam.layout(model), run.seed, run.device)
    state = init_opt_state(ocfg, params)
    marks.append(("weights and state", time.perf_counter()))
    spans = Spans(run.trace)
    step = spans.wrap("step", make_train_step(cfg, ocfg))
    prog = {"loss": []}
    for i in range(steps):
        before = fam.launches()
        params, state, m = step(params, state, _batch(run, i))
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norm"] = grad_norms(fam.layout(model), state, ocfg.b1)
            # the program's counters
            prog["calls"] = {k: n - before[k] for k, n in fam.launches().items()}
    marks.append((f"{steps} steps", time.perf_counter()))
    prog["change"] = change_norms(run, state)
    marks.append(("readings", time.perf_counter()))
    setup_line(run, marks)
    spans.records.clear()
    return step, params, state, prog, spans


def reference_readings(run: Run, steps: int = 3, **kw) -> dict:
    flat = dict(drawn(run))
    batches = [{k: torch.from_numpy(v).to(run.device) for k, v in _batch(run, i).items()}
               for i in range(steps)]
    fam = families.for_training(run.config)
    return fam.train_steps(run.model, run.mix["optimizer"], flat, batches, **kw)


def window(run: Run, step, params, state, spans: Spans) -> dict:
    stretch = Stretch(spans) if run.trace else None
    serial, done, traced = 3, [], 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while time.perf_counter() < deadline:
        if stretch is not None and traced == 0 and time.perf_counter() >= t0 + run.seconds * run.mix[
                "stretch_at"]:
            stretch.start()
            traced = run.mix["stretch_steps"]
        params, state, m = step(params, state, _batch(run, serial))
        loss = float(m["loss"])
        if run.device == "cuda":
            torch.cuda.synchronize()
        name, a, b, in_stretch = spans.records[-1]
        done.append({"t0": a, "t1": b, "loss": loss, "traced": in_stretch})
        serial += 1
        if stretch is not None and stretch.active:
            traced -= 1
            if traced == 0:
                stretch.stop()
                traced = -1  # done
    if stretch is not None and stretch.active:
        stretch.stop()
    t_end = time.perf_counter()
    if stretch is not None:
        stretch.finish()
    return {"window_s": t_end - t0, "steps": done,
            "trace": stretch.summary if stretch is not None else None}


def run_cell(run: Run, memory_peak=lambda: 0) -> tuple:
    step, params, state, prog, spans = setup(run)
    setup_s = time.perf_counter() - run.t_start
    with GcWatch() as gcw:
        w = window(run, step, params, state, spans)
    peak = memory_peak()
    print(gcw.line(), file=sys.stderr)
    print(window_line([dict(s, kind="step") for s in w["steps"]]), file=sys.stderr)
    del step, params, state
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    values = compare(prog, reference_readings(run))
    checks = judge(values, run.params["limits"])
    bad = sum(1 for s in w["steps"] if not np.isfinite(s["loss"]))
    result = {"correct": bool(w["steps"]) and bad == 0 and passed(checks),
              "attempted": len(w["steps"]), "failed": bad, "metrics": {},
              "device": {"memory_peak_bytes": peak}}
    mix, model, fam = run.mix, run.model, families.for_training(run.config)
    B, S = mix["batch"], mix["seq_len"]
    per_step = {"flops": fam.train_flops(model, B, S),
                **fam.train_bounds(model, B, S, prog["calls"]), "tokens": B * S}
    steps = [dict(s, kind="step", **per_step) for s in w["steps"]]
    if run.trace:
        ctx = {"steps": steps, "egress": [], "window_s": w["window_s"], "trace": w["trace"],
               "kernels": {key: needle for needle, key in fam.KERNELS}}
        result["metrics"] = read_per_layer(run, ctx)
        result["device"].update(busy_s=w["trace"]["busy_s"], window_s=w["trace"]["window_s"])
        result["breakdown"] = breakdown(w["trace"])
        print(kernel_line(w["trace"], [needle for needle, _ in fam.KERNELS]), file=sys.stderr)
    else:
        tokens = sum(s["tokens"] for s in steps)
        result["metrics"] = end_to_end(run, {"setup_s": setup_s,
                                             "train_tokens_per_s": tokens / w["window_s"]})
    return result, checks
