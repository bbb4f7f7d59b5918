"""Where the serving time goes: a model at full width on the card, profiled.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch olmo-1b]
      [--schedule interleave]

Serves the eight requests of ``chip_smoke.py`` (prompt lengths
17..512, 16-64 new tokens, random bf16 weights from seed 0) through
``OrderedServingEngine(max_slots=4, max_len=1024)`` after a one-request
warm-up, and reports:

- host time per prefill and per decode step, from the engine's own
  ``engine.prefill`` and ``engine.decode`` spans (each step ends in a
  device->host read of its tokens, so a step's host time covers its device
  work; taken under the profiler, it includes the profiler's cost and that
  of the tracer's spans, each a ``record_function`` there);
- device time by kernel group from ``torch.profiler`` (K3, K4, K5, matrix
  products, everything else) and the device's busy share of the wall time;
- the same split for one prefill (the 333-token prompt, after three others)
  and one decode step with the four slots full, each profiled alone, with
  the launches the wrappers counted in it;
- beside the decode steps, how many of them replayed the engine's CUDA
  graph (``decode_replays``: on the card an engine captures its decode step
  at its first decode, so the served run's first step is a capture; the
  lone step is taken after one decode, so it is a replay).

A config that does not fit on one card is served with the cut of
:data:`SERVED_CUTS`, as ``chip_smoke.py`` serves it.  The last line is a
JSON summary.  Needs a card; runs nothing on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import default_device, trace
from repro_torch.configs import get_config
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.dispatch.ops import dispatch
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.common import init_params
from repro_torch.serve.engine import OrderedServingEngine

PROMPT_LENS = (17, 128, 200, 333, 512, 64, 45, 300)
_K3 = re.compile(r"(?<![\w])dispatch_one_kernel(?![\w])")  # csrc/dispatch.cu
_K5 = re.compile(r"(?<![\w])ssd_(state|pass|out)_kernel(?![\w])")  # csrc/ssd.cu
COUNTERS = {"K3 dispatch": dispatch, "K4 flash_fwd": flash_attention, "K5 ssd": ssd}
# jamba at its published widths but d_ff, one period of 8 layers: 33.1 GiB in
# bf16 where the published d_ff of 24,576 takes 84.1 GiB a period (the card
# holds 80 GB); no kernel's shape depends on d_ff
SERVED_CUTS = {"jamba-1.5-large-398b": dict(num_layers=8, d_ff=8192, moe_d_ff=8192)}


def _group(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "flash_fwd" in name:
        return "K4 flash_fwd"
    if _K3.search(name):
        return "K3 dispatch"
    if _K5.search(name):
        return "K5 ssd"
    if any(s in name for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
        return "matrix products"
    return "other"


def _device_split(prof) -> tuple[dict, dict, dict]:
    """({group: device s}, {group: kernels run}, {kernel name: device s});
    the tracer's spans, shown on the device's timeline too, are no work."""
    groups: dict[str, float] = {}
    runs: dict[str, int] = {}
    kernels: dict[str, float] = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0
                and not ev.name.startswith(trace.PREFIX)):
            g = _group(ev.name)
            groups[g] = groups.get(g, 0.0) + ev.device_time / 1e6  # us -> s
            runs[g] = runs.get(g, 0) + 1
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time / 1e6
    return groups, runs, kernels


def _profile_step(step) -> dict:
    """One engine step alone under the profiler: its wall time, device time
    by group with each group's share of the step's device time, and the
    launches the wrappers counted."""
    for fn in COUNTERS.values():
        fn.LAUNCHES = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, runs, _ = _device_split(prof)
    busy = sum(groups.values())
    return {
        "wall_s": wall, "device_s": busy,
        "device_s_by_group": groups, "kernels_run_by_group": runs,
        "share_of_device_time": {g: s / busy for g, s in groups.items()} if busy else None,
        "launches_counted": {name: fn.LAUNCHES for name, fn in COUNTERS.items()},
    }


def _print_step(label: str, r: dict) -> None:
    print(f"one {label}: wall {r['wall_s'] * 1e3:.3f} ms, device {r['device_s'] * 1e3:.3f} ms; "
          f"launches counted {r['launches_counted']}")
    for g, s in sorted(r["device_s_by_group"].items(), key=lambda kv: -kv[1]):
        share = r["share_of_device_time"][g]
        print(f"  {g}: {s * 1e3:.4f} ms in {r['kernels_run_by_group'][g]} kernels "
              f"({share:.4f} of the step's device time)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--schedule", default="interleave", choices=["interleave", "prefill_first"])
    args = ap.parse_args(argv)

    device = default_device("cuda")
    cfg = dataclasses.replace(get_config(args.arch), **SERVED_CUTS.get(args.arch, {}))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    rng = np.random.RandomState(0)
    new_tokens = rng.randint(16, 65, size=len(PROMPT_LENS))
    requests = [
        (rng.randint(0, cfg.vocab_size, size=S).astype(np.int32), int(n))
        for S, n in zip(PROMPT_LENS, new_tokens)
    ]

    def engine():
        return OrderedServingEngine(cfg, params, max_slots=4, max_len=1024,
                                    schedule=args.schedule, device=device)

    warm = engine()
    warm.submit(*requests[0])
    warm.run_to_completion()

    eng = engine()
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    torch.cuda.synchronize()
    trace.enable()  # the engine's own spans time each prefill and decode step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        comps = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace.disable()
    spans = trace.take()
    prefill_s, decode_s = ([(r.t1 - r.t0) / 1e9 for r in spans if r.name == name]
                           for name in ("engine.prefill", "engine.decode"))
    groups, _, kernels = _device_split(prof)

    # one prefill and one decode step, each alone
    solo = engine()
    for prompt, n in requests[:4]:
        solo.submit(prompt, max_new_tokens=n)
    for _ in range(3):
        solo._do_prefill()
    one_prefill = _profile_step(solo._do_prefill)
    solo._do_decode()  # the capture
    replays = solo.decode_replays
    one_decode = _profile_step(solo._do_decode)
    one_decode["decode_replays"] = solo.decode_replays - replays

    busy = sum(groups.values())
    ntok = sum(len(c.tokens) for c in comps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"{cfg.name} ({cfg.num_layers} layers) {args.schedule}: {len(comps)} requests, "
          f"{ntok} tokens, wall {wall:.4f}s under the profiler ({ntok / wall:.1f} tok/s)")
    print(f"host time: {len(prefill_s)} prefills {sum(prefill_s):.4f}s "
          f"(mean {np.mean(prefill_s) * 1e3:.3f} ms), {len(decode_s)} decode steps "
          f"{sum(decode_s):.4f}s (mean {np.mean(decode_s) * 1e3:.3f} ms), "
          f"{eng.decode_replays} of them graph replays")
    for g, s in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"device time {g}: {s:.4f}s ({s / wall:.4f} of wall)")
    for name, s in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  kernel {s:.4f}s [{_group(name)}] {name[:110]}")
    print(f"device busy share: {busy / wall:.4f}" if busy else
          "device busy share: not measured (the profiler recorded no device time)")
    _print_step(f"prefill ({len(requests[3][0])} tokens)", one_prefill)
    _print_step(f"decode step (4 slots; graph replays {one_decode['decode_replays']})",
                one_decode)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": cfg.name, "layers": cfg.num_layers,
        "schedule": args.schedule,
        "tokens": ntok, "wall_s": wall, "tok_per_s": ntok / wall,
        "prefills": len(prefill_s), "prefill_host_s": sum(prefill_s),
        "decode_steps": len(decode_s), "decode_host_s": sum(decode_s),
        "decode_replays": eng.decode_replays,
        "device_s_by_group": groups, "device_busy_share": busy / wall if busy else None,
        "one_prefill": one_prefill, "one_decode_step": one_decode,
    }))


if __name__ == "__main__":
    main()
