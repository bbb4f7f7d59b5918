"""Run a cell in sets of runs as a check does, and read what the host did.

    python3 portbench/sets.py --workload olmo-1b.stream-code --seeds 11,12,13,14,15,16 \
        --sets 2 --seconds 45 --out chiprun_out/sets.jsonl \
        [--variant parent=build/parent] [--variant change=.] [--trace 1]

Each set runs every seed once, each run a process of its own
(``portbench/run.py`` of the variant's tree, from that tree's root), the
variants of one seed one after another, their order turned by one from
seed to seed.  A first run of each tree at ``--warm`` seconds builds its
kernels and is left out.  Around each run a fixed loop of Python is timed
(the host's speed just then), and while it goes its threads are read
(each one's CPU seconds, from ``/proc/<pid>/task``) and its affinity once.
A variant's ``CPUS=<list>`` is the affinity its runs start with; its other
``KEY=VALUE`` pairs go to their environment.  One JSON line a run goes to
``--out``, with the result line and the run's ``host:``, ``gc in
window:``, ``window:`` and ``check`` lines of standard error; at the end
each variant's sets: the median of each metric, its spread (first to
third quartile over the median, ``statistics.quantiles``) and its spread
with the run farthest from the median left out where that narrows it, as
the check reads the spread of a set.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.host import parse_cpulist  # noqa: E402

NOTES = ("setup s:", "host:", "gc in window:", "window:", "stretch kernels", "check ")


def threads(pid: int) -> list:
    """[name, CPU seconds] of each of the process's threads."""
    out = []
    tick = os.sysconf("SC_CLK_TCK")
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tids:
        try:
            text = Path(f"/proc/{pid}/task/{tid}/stat").read_text()
        except OSError:
            continue
        name = text[text.index("(") + 1:text.rindex(")")]
        rest = text.rsplit(")", 1)[1].split()
        out.append([name, (int(rest[11]) + int(rest[12])) / tick])
    return out


def probe() -> float:
    """Seconds of a fixed loop of Python: the host's speed just now."""
    t = time.perf_counter()
    x = 0
    for i in range(2_000_000):
        x += i
    return time.perf_counter() - t


def one_run(tree: Path, env: dict, workload: str, seed: int, seconds: float, trace: int,
            timeout: float) -> dict:
    cmd = [sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    env = dict(env)
    cpus = env.pop("CPUS", None)
    start = (lambda: os.sched_setaffinity(0, parse_cpulist(cpus))) if cpus else None
    before = probe()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=tree, env=dict(os.environ, **env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, preexec_fn=start)
    out: dict = {}
    readers = [threading.Thread(target=lambda n=n, f=f: out.__setitem__(n, f.read()))
               for n, f in (("stdout", proc.stdout), ("stderr", proc.stderr))]
    for r in readers:
        r.start()
    affinity, last = None, []
    while proc.poll() is None:
        if time.perf_counter() - t0 > timeout:
            proc.kill()
            break
        last = threads(proc.pid) or last
        if affinity is None and time.perf_counter() - t0 > 5.0:
            try:
                affinity = sorted(os.sched_getaffinity(proc.pid))
            except OSError:
                pass
        time.sleep(0.5)
    proc.wait()
    for r in readers:
        r.join()
    lines = out.get("stdout", "").strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except ValueError:
        result = None
    return {
        "rc": proc.returncode, "wall_s": time.perf_counter() - t0, "result": result,
        "notes": [ln for ln in out.get("stderr", "").splitlines() if ln.startswith(NOTES)],
        "probe_s": [before, probe()], "affinity": affinity,
        "threads": sorted(last, key=lambda t: -t[1])[:8],
        "stderr_tail": "" if result else out.get("stderr", "")[-4000:],
    }


def spread(values: list) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed(values: list) -> float:
    """The spread with the run farthest from the median left out, where that narrows it."""
    if len(values) < 4:
        return spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return min(spread(values), spread(values[:far] + values[far + 1:]))


def summary(rows: list) -> list:
    out = []
    keys = sorted({(r["variant"], r["set"]) for r in rows if r["set"] > 0})
    for variant in sorted({v for v, _ in keys}):
        sets = {}
        for v, s in keys:
            if v != variant:
                continue
            runs = [r for r in rows if r["variant"] == v and r["set"] == s and r["result"]]
            metrics = {}
            for name in runs[0]["result"]["metrics"] if runs else []:
                vals = [r["result"]["metrics"][name]["value"] for r in runs]
                metrics[name] = {"median": statistics.median(vals), "spread": spread(vals),
                                 "trimmed": trimmed(vals), "values": vals} if len(vals) > 1 else {}
            sets[s] = {"runs": len(runs), "correct": sum(r["result"]["correct"] for r in runs),
                       "metrics": metrics}
        mean = {}
        for name in {n for s in sets.values() for n in s["metrics"]}:
            t = [s["metrics"][name]["trimmed"] for s in sets.values() if s["metrics"].get(name)]
            mean[name] = sum(t) / len(t) if t else None
        out.append({"variant": variant, "sets": sets, "mean_trimmed": mean})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR[:KEY=VALUE[;KEY=VALUE]]; default change=. (this tree)")
    ap.add_argument("--warm", type=float, default=3.0, help="seconds of each tree's first run; 0: none")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    variants = []
    for v in args.variant or ["change=."]:
        name, _, rest = v.partition("=")
        tree, _, envs = rest.partition(":")
        env = dict(e.split("=", 1) for e in envs.split(";") if e)
        variants.append((name, (ROOT / tree).resolve(), env))
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    rows = []

    def record(row):
        rows.append(row)
        text = json.dumps(row)
        print(text[:2000], flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    if args.warm > 0:
        for tree in sorted({t for _, t, _ in variants}):
            name, _, env = next(v for v in variants if v[1] == tree)
            record(dict(variant=name, set=0, seed=seeds[0], **one_run(
                tree, env, args.workload, seeds[0], args.warm, 0, 1200)))
    for s in range(1, args.sets + 1):
        for i, seed in enumerate(seeds):
            turn = variants[i % len(variants):] + variants[:i % len(variants)]
            for name, tree, env in turn:
                record(dict(variant=name, set=s, seed=seed, **one_run(
                    tree, env, args.workload, seed, args.seconds, args.trace, 360)))
    table = summary(rows)
    for t in table:
        print(json.dumps({"summary": t}), flush=True)
        if sink:
            sink.write(json.dumps({"summary": t}) + "\n")
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
