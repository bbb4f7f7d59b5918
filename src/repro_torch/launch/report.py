# Port copy of src/repro/launch/report.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Generate EXPERIMENTS.md tables from experiments/*.jsonl."""
from __future__ import annotations

import json
import os


def _load(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(l) for l in f]


def dryrun_table(path="experiments/dryrun/results.jsonl") -> str:
    rows = _load(path)
    out = [
        "| arch | shape | mesh | bytes/dev (args) | temp/dev | HLO flops/dev | collective B/dev | compile |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        ma = r["memory_analysis"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {ma['argument_bytes']/1e9:.2f} GB | {ma['temp_bytes']/1e9:.1f} GB "
            f"| {r['flops_per_device']:.2e} | {r['collective_bytes_per_device']['total']:.2e} "
            f"| {r['compile_s']:.0f}s |"
        )
    return "\n".join(out)


def roofline_table(path="experiments/roofline/roofline.jsonl") -> str:
    rows = _load(path)
    out = [
        "| arch | shape | compute s | memory s | collective s | bottleneck | 6ND/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {r['bottleneck']} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |"
        )
    return "\n".join(out)


def perf_tables(dirpath="experiments/perf") -> str:
    out = []
    if not os.path.isdir(dirpath):
        return ""
    for fn in sorted(os.listdir(dirpath)):
        if not fn.endswith(".jsonl"):
            continue
        rows = _load(os.path.join(dirpath, fn))
        out.append(f"\n### {fn[:-6]}\n")
        out.append("| variant | compute s | memory s | collective s | bottleneck | step s | vs baseline |")
        out.append("|---|---|---|---|---|---|---|")
        base = None
        for r in rows:
            if base is None:
                base = r["step_time_s"]
            out.append(
                f"| {r['variant']} | {r['compute_s']:.4f} | {r['memory_s']:.4f} "
                f"| {r['collective_s']:.4f} | {r['bottleneck']} | {r['step_time_s']:.4f} "
                f"| {base/r['step_time_s']:.2f}x |"
            )
    return "\n".join(out)


if __name__ == "__main__":
    import sys

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "dryrun"):
        print("## Dry-run\n")
        print(dryrun_table())
    if which in ("all", "roofline"):
        print("\n## Roofline\n")
        print(roofline_table())
    if which in ("all", "perf"):
        print("\n## Perf\n")
        print(perf_tables())
