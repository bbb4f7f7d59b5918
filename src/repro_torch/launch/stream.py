"""Ordered stream with a device stage (the port's counterpart of the
reference's device rows, ``benchmarks/bench_core.py``).

  PYTHONPATH=src python -m repro_torch.launch.stream                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --tuples 20000 --device-batch 512

Runs the repo's device chain on the staged process runtime with
``columnar=True``: ``widen`` (a scalar to a row of 12 ``i8`` columns,
96 bytes) -> ``dev0`` (``x*3 - 1``) -> ``dev1`` (``x*1 + 5``), both device
ops on ``affine_pallas`` (K1 on the card).  The source is ``i8`` values from
a seeded generator, most beyond the int32 range and a third of them
overflowing ``x*3``.  Egress must be in serial order and bit-identical to
the same chain computed by NumPy over the whole source.  Prints throughput,
p99 latency, each device worker's counters and the device stage's time
split (on the card, from the side stream's events: the copy in, up to the
launch; K1, whose writes go straight into the pinned output buffer over
PCIe; and the executor's host work and waiting), then a JSON line.

The parent never touches CUDA: device workers are forked, and each opens
its own CUDA context (see ``repro_torch.columnar.device``).
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time

import numpy as np

from repro_torch import default_device
from repro_torch.columnar import Schema, device_op
from repro_torch.columnar.block import ColumnBlock
from repro_torch.columnar.codec import encode_block
from repro_torch.columnar.device import _np_affine
from repro_torch.core import Engine, EngineConfig, OpSpec, ProcessOptions
from repro_torch.core.operators import _Marker
from repro_torch.kernels.affine.ops import affine_staged

COL_WIDTH = 12  # i8 columns per row (96-byte rows), as the reference chain
# tuples per dispatch unit: one unit's block (3.5 KB) fits a reorder slot, so
# a ring of device_batch x (inflight + 1) slots stays near 175 MB of /dev/shm
IO_BATCH = 32
DEVICE_PARAMS = ((3, -1), (1, 5))  # (a, b) of dev0 and dev1
SCHEMA = Schema.of(*(["i8"] * COL_WIDTH))
SHM = "/dev/shm"
# what a device stage's kernel time is, by backend
KERNEL_MEANS = {"cuda": "the side stream's interval around each K1 launch, its writes of the "
                        "pinned output over PCIe inside",
                "cpu": "the plain version's host time"}


def _widen(v):
    return [(v,) * COL_WIDTH]


def chain(backend: str) -> list:
    ops = [OpSpec("widen", "stateless", _widen, cost_us=1.0)]
    for i, (a, b) in enumerate(DEVICE_PARAMS):
        ops.append(device_op(f"dev{i}", "affine_pallas", SCHEMA, params={"a": a, "b": b},
                             backend=backend, cost_us=2.0))
    return ops


def make_source(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-(2**62), 2**62, size=n, dtype=np.int64)


def expected(source: np.ndarray) -> np.ndarray:
    """The chain computed by NumPy over the whole source: widen, then the
    reference's ``_np_affine`` twice."""
    cols = [source] * COL_WIDTH
    for a, b in DEVICE_PARAMS:
        cols = list(_np_affine((("a", a), ("b", b)))(*cols))
    return np.stack(cols, axis=1)


def unit_payload(io_batch: int) -> int:
    """Reorder-slot payload bytes that hold one unit's result block (with a
    latency marker) in the ring, so that no unit spills to the pipe."""
    rows = [(2**62,) * COL_WIDTH] * io_batch
    blk = ColumnBlock.from_values(rows, marks=[(0, _Marker(time.perf_counter()))],
                                  schema=SCHEMA)
    return -(-(len(encode_block(blk)) + 256) // 64) * 64


def stage_line(s: dict) -> str:
    """One device stage's counters and time split (``DeviceExecutor.stats()``),
    in total and per dispatch."""
    per = max(s["dispatches"], 1)
    parts = [(k, what) for k, what in (
        ("copy_in", "from before the copy to the card to the launch"),
        ("kernel", KERNEL_MEANS[s["backend"]]),
        ("host", "the executor's"),
        ("enqueue", "of host: enqueueing the copy and the launch"),
        ("wait", "on the oldest batch")) if f"{k}_ms" in s]
    return (f"device stage {s['stage']} ({s['backend']}): {s['dispatches']} dispatches, "
            f"{s['rows']} rows ({s['rows'] / per:.0f}/dispatch), {s['launches']} K1 launches; " +
            ", ".join(f"{k} {s[f'{k}_ms']:.3f} ms ({s[f'{k}_ms'] / per:.4f}/dispatch; {what})"
                      for k, what in parts))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tuples", type=int, default=1 << 20)
    ap.add_argument("--device-batch", type=int, default=16384)
    ap.add_argument("--inflight", type=int, default=2)
    ap.add_argument("--workers", type=int, default=2, help="width of the widen stage")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    default_device(args.device)  # no card: raise now (asks NVML, not CUDA)
    reorder_size = args.device_batch * (args.inflight + 1)
    payload = unit_payload(IO_BATCH)
    cfg = EngineConfig(
        backend="process", num_workers=args.workers, batch_size=IO_BATCH,
        collect_outputs=True, reorder_size=reorder_size,
        process=ProcessOptions(
            columnar=True, io_batch=IO_BATCH, reorder_payload=payload,
            max_inflight=reorder_size // IO_BATCH,
            device_batch=args.device_batch, device_workers=1,
            device_inflight=args.inflight, device_backend=args.device,
            # an epoch barrier flushes every device batch in flight: one per
            # reorder window keeps the batches whole
            checkpoint_interval=reorder_size,
        ),
    )
    free = shutil.disk_usage(SHM).free
    print(f"[stream] {args.tuples} tuples, rows of {COL_WIDTH} i8 ({SCHEMA.row_bytes} B); "
          f"device_batch {args.device_batch} ({args.device_batch * SCHEMA.row_bytes / 2**20:.2f} MiB), "
          f"inflight {args.inflight}, io_batch {IO_BATCH}, widen workers {args.workers}; "
          f"reorder_size {reorder_size} x payload {payload} B per stage; "
          f"{SHM} free {free / 2**30:.2f} GiB", flush=True)

    source = make_source(args.tuples, args.seed)
    want = expected(source)
    affine_staged.LAUNCHES = 0  # forked workers count from here
    eng = Engine(cfg)
    plan = eng.plan(chain(args.device))
    t0 = time.perf_counter()
    res = eng.run(plan, source.tolist())
    wall = time.perf_counter() - t0
    rep = res.report
    got = np.array(res.outputs, dtype=np.int64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.argmax((got != want).any(axis=1))) if got.shape == want.shape else -1
        raise SystemExit(f"[stream] egress differs from NumPy (shape {got.shape} vs "
                         f"{want.shape}, first bad row {bad})")
    stats = sorted(res.target.device_stats, key=lambda s: s["stage"])
    dispatches = sum(s["dispatches"] for s in stats)
    launches = sum(s["launches"] for s in stats)
    print(f"[stream] egress: {len(got)} rows in serial order, bit-identical to NumPy", flush=True)
    print(f"[stream] {rep}", flush=True)
    split = {}
    for s in stats:
        parts = {k: s[f"{k}_ms"] for k in ("copy_in", "kernel", "host") if f"{k}_ms" in s}
        total = sum(parts.values()) or 1.0
        split[f"stage{s['stage']}"] = {k: v / total for k, v in parts.items()}
        print(f"[stream] {stage_line(s)}; shares " +
              ", ".join(f"{k} {v:.3f}" for k, v in split[f'stage{s["stage"]}'].items()),
              flush=True)
    if args.device == "cuda" and launches != dispatches:
        raise SystemExit(f"[stream] K1 launched {launches} times for {dispatches} dispatches")
    result = {
        "tuples": args.tuples, "device": args.device,
        "device_batch": args.device_batch, "inflight": args.inflight,
        "io_batch": IO_BATCH, "workers": args.workers,
        "wall_s": wall, "throughput_per_s": rep.throughput,
        "egress_throughput_per_s": rep.egress_throughput,
        "p99_latency_ms": rep.p99_latency * 1e3, "mean_latency_ms": rep.mean_latency * 1e3,
        "dispatches": dispatches, "launches": launches, "device_stats": stats,
        "split": split, "shm_free_bytes": free,
    }
    print(json.dumps({"stream": result}), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
