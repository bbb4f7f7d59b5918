"""Roofline of the production cells against an H100's limits (port of
``repro.launch.roofline``).

The reference adds (nP - 1) x the period body to XLA's aggregate, because
XLA's cost analysis counts a scan body once.  The port runs its periods as
a Python loop, so the dry-run's count (``dryrun.lower_cell``) already holds
all nP of them and nothing is added: ``corrected_record`` keeps the
reference's fields, with ``body_*`` the cost of one period as the step
runs it (:func:`body_costs`), so that a record shows aggregate = nP x body
+ the rest (embedding, head, loss, optimizer).

The terms are arithmetic on the dry-run's counts against the H100 SXM5
80GB data-sheet limits of ``dryrun.py``, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.roofline --arch olmo-1b
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from ..models.common import ModelConfig
from .dryrun import PEAK_FLOPS, PRODUCTION, lower_cell, model_flops, roofline_terms


def _costs(counter) -> dict:
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "coll": float(sum(counter.coll.values()))}


def body_costs(cfg: ModelConfig, shape, mesh_shape, known: dict | None = None) -> dict:
    """One period's per-device costs as the step runs it: the dry-run of
    the cell's step with two periods less the one with one period, on the
    same mesh (``mesh_shape``: (dims, names)) and placements.  (A period
    run alone gets other placements from DTensor than inside the step, so
    its standalone cost would not add up to the step's.)  ``known`` maps a
    number of periods to a dry-run record of it already made."""
    period = len(cfg.pattern)
    costs = []
    for n in (1, 2):
        rec = (known or {}).get(n)
        if rec is None:
            one = dataclasses.replace(cfg, num_layers=period * n)
            rec, _, _ = lower_cell(cfg.name, shape.name, False, cfg=one, shape=shape,
                                   mesh_shape=mesh_shape)
        costs.append({"flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
                      "coll": rec["collective_bytes_per_device"]["total"]})
    return {k: costs[1][k] - costs[0][k] for k in costs[0]}


_DRYRUN_CACHE: dict = {}


def _load_dryrun(path: str) -> dict:
    if path not in _DRYRUN_CACHE:
        recs = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    r = json.loads(line)
                    recs[(r["arch"], r["shape"], r["mesh"])] = r
        _DRYRUN_CACHE[path] = recs
    return _DRYRUN_CACHE[path]


def corrected_record(arch: str, shape_name: str, multi_pod: bool,
                     dryrun_results: str = "experiments/dryrun/results.jsonl", *,
                     cfg: ModelConfig | None = None, shape=None, mesh_shape=None) -> dict:
    """The dry-run record of the cell (from ``dryrun_results`` when it
    holds it and no ``cfg`` is given, else a fresh run) with the period
    body's costs and the roofline terms.  ``cfg``, ``shape`` and
    ``mesh_shape`` as in ``dryrun.lower_cell``."""
    base = cfg
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    dims, names = mesh_shape or PRODUCTION[multi_pod]
    mesh_name = "x".join(map(str, dims))
    record = None if base is not None else _load_dryrun(dryrun_results).get(
        (arch, shape.name, mesh_name))
    if record is None:
        record, _mem, _cost = lower_cell(arch, shape.name, multi_pod, cfg=cfg, shape=shape,
                                         mesh_shape=(dims, names))
    chips = record["chips"]
    body = body_costs(cfg, shape, (dims, names), known={cfg.num_periods: record})

    flops = record["flops_per_device"]
    bytes_ = record["bytes_per_device"]
    coll = record["collective_bytes_per_device"]["total"]
    terms = roofline_terms(flops, bytes_, coll)
    bottleneck = max(terms, key=terms.get).replace("_s", "")
    step_s = max(terms.values())
    mf = model_flops(cfg, shape)
    achieved = mf / chips / step_s if step_s > 0 else 0.0
    return dict(
        record,
        corrected=True,
        body_flops=body["flops"],
        body_bytes=body["bytes"],
        body_coll=body["coll"],
        num_periods=cfg.num_periods,
        flops_per_device=flops,
        bytes_per_device=bytes_,
        collective_total_bytes=coll,
        **terms,
        bottleneck=bottleneck,
        model_flops_global=mf,
        useful_flops_ratio=mf / (flops * chips) if flops else 0.0,
        roofline_fraction=achieved / PEAK_FLOPS,
        step_time_s=step_s,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/roofline")
    ap.add_argument("--dryrun-results", default="experiments/dryrun/results.jsonl",
                    help="reuse full-program records from a dry-run results file")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "roofline.jsonl")
    done = set()
    if args.skip_existing and os.path.exists(path):
        with open(path) as f:
            done = {(r["arch"], r["shape"], r["mesh"]) for r in map(json.loads, f)}

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else applicable_shapes(cfg)
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if (arch, shape_name, mesh_name) in done:
                    continue
                try:
                    rec = corrected_record(arch, shape_name, mp, dryrun_results=args.dryrun_results)
                    print(
                        f"{arch:26s} {shape_name:12s} {mesh_name:8s} "
                        f"C={rec['compute_s']:.4f}s M={rec['memory_s']:.4f}s "
                        f"X={rec['collective_s']:.4f}s -> {rec['bottleneck']:10s} "
                        f"useful={rec['useful_flops_ratio']:.2f} "
                        f"roofline={rec['roofline_fraction']:.3f}",
                        flush=True,
                    )
                    with open(path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                except Exception:
                    import traceback

                    traceback.print_exc()
                    n_fail += 1
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
