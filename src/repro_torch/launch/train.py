"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --batch 8 --seq 1024

Trains ``--arch`` (``--smoke``: its reduced config) from ``init_params`` at
``--seed`` on the ordered synthetic token pipeline (``train/data.py``), with
the JAX package's optimizer settings (warm-up ``max(steps // 10, 2)``, decay
over ``steps``, the config's moment dtype and master switch), checkpoints
every ``--ckpt-every`` steps in the format both frameworks read, and
exactly-once resume (``--resume``: the latest checkpoint's parameters,
optimizer state and data cursor).  Runs on the card unless ``--device cpu``;
on the card it also prints each logged step's time, tokens/s and peak
memory.  ``main`` returns the losses of the steps it ran.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import default_device
from ..configs import get_config, smoke_config
from ..models.common import count_params, init_params
from ..train.checkpoint import CheckpointManager
from ..train.data import DataConfig, OrderedTokenPipeline
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_step import make_train_step


def opt_config(cfg, steps: int, lr: float = 3e-4) -> OptConfig:
    """The optimizer settings of a ``steps``-step run of ``cfg``."""
    return OptConfig(
        peak_lr=lr,
        warmup_steps=max(steps // 10, 2),
        decay_steps=steps,
        moment_dtype=cfg.optim_moment_dtype,
        master_fp32=cfg.optim_master_fp32,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    on_card = device.type == "cuda"

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ocfg = opt_config(cfg, args.steps, args.lr)
    print(f"arch={cfg.name} params={count_params(cfg)/1e6:.1f}M device={device}")

    params = init_params(cfg, args.seed, device)
    opt_state = init_opt_state(ocfg, params)
    data = OrderedTokenPipeline(
        DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    )
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start_step, state, extra = ckpt.restore(device=device)
        params, opt_state = state["params"], state["opt"]
        data.seek(extra["data_serial"])  # exactly-once resume
        print(f"resumed from step {start_step} (data serial {data.cursor()})")

    step_fn = make_train_step(cfg, ocfg)
    encoder_states = None
    if cfg.num_encoder_tokens:
        encoder_states = torch.zeros(
            (args.batch, cfg.num_encoder_tokens, cfg.d_model), dtype=cfg.dtype, device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = next(data)
        if encoder_states is not None:
            batch["encoder_states"] = encoder_states
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s = time.perf_counter() - ts
        if step % args.log_every == 0 or step == args.steps - 1:
            line = (
                f"step {step:5d} loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.3f} "
                f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)"
            )
            if on_card:
                line += (f" step_ms={step_s * 1e3:.1f} "
                         f"tokens/s={args.batch * args.seq / step_s:.0f} "
                         f"peak_mem_gb={torch.cuda.max_memory_allocated(device) / 1e9:.2f}")
            print(line)
        if ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(
                step + 1,
                {"params": params, "opt": opt_state},
                extra={"data_serial": data.cursor()},
            )
    if ckpt and args.ckpt_every:
        ckpt.save(
            args.steps,
            {"params": params, "opt": opt_state},
            extra={"data_serial": data.cursor()},
        )
    if len(losses) >= 16 and losses[-1] >= losses[0]:
        print("WARNING: loss did not decrease over the run")
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
