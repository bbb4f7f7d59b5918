"""The host side of a run, for standard error: which CPUs it may use, which
lie next to its cards, the load on the machine, and the collector's pauses
in the window.  A serving cell is bound by the host's enqueue of the
prefill, so these are what a later reading of a noisy run needs.
"""
from __future__ import annotations

import gc
import os
import re
import subprocess
import time
from pathlib import Path

PCI = Path("/sys/bus/pci/devices")
BUS_ID = re.compile(r"(?:[0-9a-f]{4,8}:)?[0-9a-f]{2}:[0-9a-f]{2}\.[0-7]")


def parse_cpulist(text: str) -> set:
    """'0-3,8,10-11' -> {0, 1, 2, 3, 8, 10, 11}; raises ValueError on anything else."""
    cpus: set = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        a, b = int(lo), int(hi or lo)
        if b < a:
            raise ValueError(f"bad CPU range {part!r}")
        cpus.update(range(a, b + 1))
    return cpus


def cpulist(cpus) -> str:
    """{0, 1, 2, 3, 8} -> '0-3,8'."""
    out, run = [], []
    for c in sorted(cpus) + [None]:
        if run and c is not None and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
        run = [c]
    return ",".join(out)


def card_bus_ids(chips: int) -> list:
    """PCI bus ids of the first ``chips`` cards CUDA numbers (in
    ``CUDA_VISIBLE_DEVICES`` order where it lists indices), as sysfs names
    them; [] where ``nvidia-smi`` cannot be read or gives no bus id."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=index,pci.bus_id", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    bus = {}
    for line in out.strip().splitlines():
        idx, _, bid = (s.strip().lower() for s in line.partition(","))
        if idx.isdigit() and BUS_ID.fullmatch(bid):
            parts = bid.split(":")
            dom = parts[0][-4:] if len(parts) == 3 else "0000"  # 00000000:19:00.0
            bus[int(idx)] = f"{dom}:{parts[-2]}:{parts[-1]}"
    order = sorted(bus)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        picks = [v.strip() for v in visible.split(",") if v.strip()]
        if not all(p.isdigit() for p in picks):
            return []  # UUIDs or MIG names: not mapped here
        order = [int(p) for p in picks if int(p) in bus]
    return [bus[i] for i in order[:chips]]


def card_local(bus_ids: list, root: Path | None = None):
    """The union of the cards' ``local_cpulist``; None where one cannot be read."""
    root = PCI if root is None else root
    cpus: set = set()
    for b in bus_ids:
        try:
            cpus |= parse_cpulist((root / b / "local_cpulist").read_text())
        except (OSError, ValueError):
            return None
    return cpus if bus_ids else None


def load() -> tuple:
    try:
        return os.getloadavg()
    except OSError:
        return (float("nan"),) * 3


def line(chips: int = 1, bus_ids=None) -> str:
    """The CPUs this process may use and the affinity it runs with (the
    harness sets none), the cards' local CPUs and the load average."""
    allowed = os.sched_getaffinity(0)
    local = card_local(card_bus_ids(chips) if bus_ids is None else bus_ids)
    la = " ".join(f"{x:.2f}" for x in load())
    return (f"host: allowed CPUs {cpulist(allowed)} ({len(allowed)}), affinity as started, "
            f"card-local {cpulist(local) if local else 'unknown'}, load average {la}")


class GcWatch:
    """The collector's pauses while it is entered: collections by
    generation and their seconds."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = 0.0
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def line(self) -> str:
        return (f"gc in window: {sum(self.count)} collections (by generation {self.count}), "
                f"{self.seconds * 1e3:.3f} ms")
