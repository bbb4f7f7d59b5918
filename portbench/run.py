"""Run one cell of ``BENCHMARK.json`` once.

    python3 portbench/run.py --workload olmo-1b.stream-code --seed 7 --seconds 45 --trace 0

Prints the compared numbers beside their limits as the last lines of
standard error and the result as the last line of standard output.  Exits
2 without a result when no CUDA card is seen or fewer cards than the cell
asks for, and 3 when JAX or the JAX package was loaded.  Every cache the
program builds lies in ``build/`` of this checkout.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        start = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# caches at fixed places inside the checkout (the kernels' nvcc builds go
# to build/kernels, where the program puts them)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import bench

    run = bench.load(args.workload, args.seed, args.seconds, bool(args.trace))
    chips = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine shows {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run.device, run.t_start = "cuda", T_START
    torch.cuda.set_device(0)
    if run.mix["kind"] == "serve":
        from portbench import serving as cell
    else:
        from portbench import training as cell
    result, checks = cell.run_cell(run, memory_peak=torch.cuda.max_memory_allocated)
    found = bench.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    result["device"] = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                            **result["device"])
    bench.card_line()
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
