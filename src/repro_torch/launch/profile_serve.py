"""Where the serving time goes: olmo-1b at full width on the card, profiled.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--schedule interleave]

Serves the eight requests of ``chip_smoke.py`` (prompt lengths
17..512, 16-64 new tokens, random bf16 weights from seed 0) through
``OrderedServingEngine(max_slots=4, max_len=1024)`` after a one-request
warm-up, and reports:

- host time per prefill and per decode step (each step ends in a device->host
  read of its tokens, so a step's host time covers its device work);
- device time by kernel group from ``torch.profiler`` (K4, matrix products,
  everything else) and the device's busy share of the wall time.

The last line is a JSON summary.  Needs a card; runs nothing on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import default_device
from repro_torch.configs import get_config
from repro_torch.models.common import init_params
from repro_torch.serve.engine import OrderedServingEngine

PROMPT_LENS = (17, 128, 200, 333, 512, 64, 45, 300)


def _group(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "flash_fwd" in name:
        return "K4 flash_fwd"
    if any(s in name for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
        return "matrix products"
    return "other"


def _timed(fn, log):
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log.append(time.perf_counter() - t0)
        return out
    return wrapper


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", default="interleave", choices=["interleave", "prefill_first"])
    args = ap.parse_args(argv)

    device = default_device("cuda")
    cfg = get_config("olmo-1b")
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
    prefill_s, decode_s = [], []
    eng._do_prefill = _timed(eng._do_prefill, prefill_s)
    eng._do_decode = _timed(eng._do_decode, decode_s)
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        comps = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    groups: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0:
            g = _group(ev.name)
            groups[g] = groups.get(g, 0.0) + ev.device_time / 1e6  # us -> s
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time / 1e6
    busy = sum(groups.values())
    ntok = sum(len(c.tokens) for c in comps)
    print(torch.cuda.get_device_name(0))
    print(f"{cfg.name} {args.schedule}: {len(comps)} requests, {ntok} tokens, wall {wall:.4f}s "
          f"under the profiler ({ntok / wall:.1f} tok/s)")
    print(f"host time: {len(prefill_s)} prefills {sum(prefill_s):.4f}s "
          f"(mean {np.mean(prefill_s) * 1e3:.3f} ms), {len(decode_s)} decode steps "
          f"{sum(decode_s):.4f}s (mean {np.mean(decode_s) * 1e3:.3f} ms)")
    for g, s in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"device time {g}: {s:.4f}s ({s / wall:.4f} of wall)")
    for name, s in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  kernel {s:.4f}s [{_group(name)}] {name[:110]}")
    print(f"device busy share: {busy / wall:.4f}" if busy else
          "device busy share: not measured (the profiler recorded no device time)")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "schedule": args.schedule,
        "tokens": ntok, "wall_s": wall, "tok_per_s": ntok / wall,
        "prefills": len(prefill_s), "prefill_host_s": sum(prefill_s),
        "decode_steps": len(decode_s), "decode_host_s": sum(decode_s),
        "device_s_by_group": groups, "device_busy_share": busy / wall if busy else None,
    }))


if __name__ == "__main__":
    main()
