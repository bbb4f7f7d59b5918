"""Ordered LM serving on the port: batched requests, continuous batching,
out-of-order completion, in-order egress via the paper's non-blocking
reorder buffer.

Compares the two scheduling policies — 'interleave' (pipelined flow, the
paper's winning strategy) vs 'prefill_first' (micro-batch style) — on a
smoke olmo-1b with random weights from a seed.

  PYTHONPATH=src python examples/torch_serve_ordered.py                # on the card
  PYTHONPATH=src python examples/torch_serve_ordered.py --device cpu

The port's twin of ``examples/serve_ordered.py``.  It runs on the card
unless asked for the CPU; without a card and without ``--device cpu`` it
raises.
"""
import argparse
import time

import numpy as np

from repro_torch import default_device
from repro_torch.configs import smoke_config
from repro_torch.models.common import init_params
from repro_torch.serve.engine import OrderedServingEngine


def run_policy(policy: str, params, cfg, device, n_requests=10):
    eng = OrderedServingEngine(
        cfg, params, max_slots=4, max_len=64, schedule=policy, device=device
    )
    rng = np.random.RandomState(0)
    serials = []
    for _ in range(n_requests):
        prompt = rng.randint(0, cfg.vocab_size, size=rng.randint(4, 16))
        serials.append(eng.submit(prompt, max_new_tokens=int(rng.randint(3, 12))))
    t0 = time.perf_counter()
    comps = eng.run_to_completion()
    wall = time.perf_counter() - t0
    assert [c.serial for c in comps] == sorted(serials), "ordering violated"
    toks = sum(len(c.tokens) for c in comps)
    return {
        "policy": policy,
        "wall_s": wall,
        "tokens": toks,
        "decode_steps": eng.stats["decode_steps"],
        "tok_per_decode_step": toks / max(eng.stats["decode_steps"], 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = default_device(args.device)  # no card: raise now
    cfg = smoke_config("olmo-1b")
    params = init_params(cfg, 0, device)
    for policy in ("interleave", "prefill_first"):
        r = run_policy(policy, params, cfg, device)
        print(
            f"{r['policy']:14s} wall={r['wall_s']:.2f}s tokens={r['tokens']} "
            f"decode_steps={r['decode_steps']} "
            f"tokens/decode-step={r['tok_per_decode_step']:.2f}"
        )
    print("ordered egress verified for both policies")


if __name__ == "__main__":
    main()
