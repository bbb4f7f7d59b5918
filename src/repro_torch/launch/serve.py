"""Ordered serving entry point (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import default_device
from repro_torch.configs import smoke_config
from repro_torch.models.common import init_params
from repro_torch.serve.engine import OrderedServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--schedule", default="interleave",
                    choices=["interleave", "prefill_first"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = smoke_config(args.arch)
    params = init_params(cfg, args.seed, device)
    eng = OrderedServingEngine(
        cfg, params, max_slots=args.slots, max_len=args.max_len,
        schedule=args.schedule, device=device,
    )
    rng = np.random.RandomState(args.seed)
    serials = []
    for _ in range(args.requests):
        prompt = rng.randint(0, cfg.vocab_size, size=rng.randint(4, 20))
        serials.append(eng.submit(prompt, max_new_tokens=int(rng.randint(4, 16))))
    t0 = time.perf_counter()
    comps = eng.run_to_completion()
    wall = time.perf_counter() - t0
    if [c.serial for c in comps] != sorted(serials):
        raise RuntimeError("egress out of serial order")
    total_tokens = sum(len(c.tokens) for c in comps)
    print(
        f"arch={cfg.name} schedule={args.schedule} device={device}: "
        f"{len(comps)} requests, {total_tokens} tokens in {wall:.2f}s "
        f"({total_tokens/wall:.1f} tok/s); ordered egress verified; "
        f"stats={eng.stats}"
    )
    return comps


if __name__ == "__main__":
    main()
