# Port copy of src/repro/analysis/__main__.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""CLI for the static-analysis passes: ``python -m repro_torch.analysis``.

Modes:

- default: run the passes, print findings as text, exit 0.
- ``--check``: additionally diff against the committed baseline and exit 2
  when findings outside the baseline exist (the CI gate; stale baseline
  entries are reported as warnings so the file gets pruned).
- ``--json``: machine-readable report (findings + summary) on stdout.
- ``--write-baseline``: grandfather the current findings into the baseline.
- ``--rules``: print the rule catalog and exit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .common import (
    RULES,
    analyze_paths,
    diff_baseline,
    load_baseline,
    write_baseline,
)

DEFAULT_BASELINE = "ANALYSIS_BASELINE.json"


def main(argv=None) -> int:
    """Entry point; returns the process exit code."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="guarded-by / lock-order / fork-safety static analysis",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files or directories to analyze (default: src/repro_torch/core)",
    )
    ap.add_argument("--json", action="store_true", help="JSON report on stdout")
    ap.add_argument(
        "--check",
        action="store_true",
        help="exit 2 on findings outside the baseline (CI gate)",
    )
    ap.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help=f"baseline file for --check (default: {DEFAULT_BASELINE})",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="grandfather the current findings into the baseline file",
    )
    ap.add_argument("--rules", action="store_true", help="print the rule catalog")
    args = ap.parse_args(argv)

    if args.rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    root = os.getcwd()
    findings = analyze_paths(args.paths or None, root=root)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.check else set()
    new, stale = diff_baseline(findings, baseline)

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.to_dict() for f in findings],
                    "new": [f.key() for f in new],
                    "stale_baseline": sorted(stale),
                    "summary": {
                        "total": len(findings),
                        "new": len(new),
                        "baselined": len(findings) - len(new),
                    },
                },
                indent=2,
            )
        )
    else:
        for f in findings:
            marker = "" if f.key() in baseline else "NEW " if args.check else ""
            print(f"{marker}{f.render()}")
        for k in sorted(stale):
            print(f"warning: stale baseline entry {k} (fixed? prune it)")
        n = len(new if args.check else findings)
        print(
            f"analysis: {len(findings)} finding(s)"
            + (f", {len(new)} new vs baseline" if args.check else "")
        )
    if args.check and new:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
