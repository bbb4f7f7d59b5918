"""What every cell shares: the spec of a run read from ``BENCHMARK.json`` and
the data files it names, the program's configuration, the readers of the
per-layer metrics, the comparison against limits, and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import host

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # top-level names, compared whole


@dataclass
class Run:
    """One run of one cell: the entries of ``BENCHMARK.json`` and the files
    they name, and the arguments of the command."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    spec: dict
    cell: dict  # the workload's entry
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    params: dict  # cells/<workload>.json
    device: object = "cuda"
    t_start: float = 0.0  # the process's start on the perf_counter clock

    @property
    def model(self) -> dict:
        return self.config["model"]


def load(workload: str, seed: int, seconds: float, trace: bool, root: Path = ROOT) -> Run:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    return Run(workload, seed, seconds, trace, spec, cell, config, data("traffic", cell["traffic"]),
               data("cells", workload))


def data(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``: a traffic mix, a cell's parameters."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def program_config(model: dict):
    """The program's ``ModelConfig`` for the configuration file's model:
    the registry's entry for ``arch`` with every field the file states."""
    from repro_torch.configs.registry import get_config

    fields = {k: v for k, v in model.items() if k != "arch"}
    return dataclasses.replace(get_config(model["arch"]), **fields)


def pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def metrics_for(run: Run, section: str) -> list:
    """The entries of ``section`` that this cell reports."""
    return [m for m in run.spec[section]
            if "workloads" not in m or run.workload in m["workloads"]]


def read_per_layer(run: Run, ctx: dict) -> dict:
    """Each per-layer metric of this cell from its reader,
    ``metrics/<name>.py``'s ``read(ctx)``; one that reads nothing is left out."""
    out = {}
    for m in metrics_for(run, "per_layer"):
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(run: Run, values: dict) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in metrics_for(run, "end_to_end")}


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}; a value passes at or under its limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def emit(result: dict, checks: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    with the checks under the key that comes last."""
    result = dict(result, checks=checks)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def card_line() -> None:
    """The peaks the rooflines use, beside the card's name and power limit."""
    import subprocess

    from .counts import PEAKS

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "nvidia-smi not readable"
    print(f"peaks {PEAKS['bf16_flops_per_s']:.4g} bf16 FLOP/s, {PEAKS['hbm_bytes_per_s']:.4g} B/s "
          f"({PEAKS['source']}); card: {card}", file=sys.stderr)


def setup_line(run: Run, marks: list) -> None:
    """Seconds of each part of set-up, to standard error."""
    parts = [f"before {marks[0][1] - run.t_start:.3f}"] + [
        f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in enumerate(marks[1:])]
    print("setup s: " + ", ".join(parts), file=sys.stderr)
    print(host.line(run.cell["chips"]), file=sys.stderr)


def window_line(steps: list) -> str:
    """Steps of each kind in the window and their mean host ms: with a
    serving cell bound by the host's enqueue, the host's speed in the run."""
    parts = []
    for kind in sorted({s["kind"] for s in steps}):
        t = [s["t1"] - s["t0"] for s in steps if s["kind"] == kind]
        parts.append(f"{kind} {len(t)} x {1e3 * sum(t) / len(t):.3f} ms")
    return "window: " + ", ".join(parts)
