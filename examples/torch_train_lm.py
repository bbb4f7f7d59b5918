"""End-to-end LM training with the PyTorch port (twin of
``examples/train_lm.py``): trains an olmo-family model on the ordered data
pipeline with checkpointing, on the card unless ``--device cpu``.

The default is the smoke olmo config for 30 steps; ``--full`` trains the
~100M-parameter olmo variant for 300 steps (same code path, sized for a
card).

  PYTHONPATH=src python examples/torch_train_lm.py [--full] [--device cpu]
"""
import argparse
import dataclasses
import tempfile

from repro_torch import default_device
from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    device = default_device(args.device)
    if args.full:
        # ~100M params: d=768, 12L, like a small GPT; a few hundred steps
        import repro_torch.configs.olmo_1b as olmo
        from repro_torch.models.common import count_params, init_params
        from repro_torch.train import (DataConfig, OptConfig, OrderedTokenPipeline,
                                       init_opt_state, make_train_step)

        cfg = dataclasses.replace(
            olmo.CONFIG,
            name="olmo-100m",
            num_layers=12,
            d_model=768,
            num_heads=12,
            num_kv_heads=12,
            d_ff=3072,
            vocab_size=32000,
        )
        ocfg = OptConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=300)
        print(f"training {cfg.name}: {count_params(cfg)/1e6:.0f}M params on {device}")
        params = init_params(cfg, 0, device)
        opt = init_opt_state(ocfg, params)
        data = OrderedTokenPipeline(DataConfig(cfg.vocab_size, 512, 8))
        step_fn = make_train_step(cfg, ocfg)
        for step in range(300):
            params, opt, m = step_fn(params, opt, next(data))
            if step % 10 == 0:
                print(f"step {step} loss={float(m['loss']):.4f}")
    else:
        with tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_") as ckpt:
            losses = train_main(
                ["--arch", "olmo-1b", "--smoke", "--steps", "30", "--batch", "4",
                 "--seq", "128", "--ckpt-dir", ckpt, "--ckpt-every", "10",
                 "--device", str(device)]
            )
        print(f"trained {len(losses)} steps, checkpoints every 10")


if __name__ == "__main__":
    main()
