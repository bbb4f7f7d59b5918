"""Perf hill-climbing driver (port of ``repro.launch.hillclimb``).

Measures named config VARIANTS of the three chosen cells on the dry-run's
counts (``roofline.corrected_record`` with the variant's config passed in,
where the reference swaps it into the config registry) and logs
hypothesis -> change -> before/after on the dominant roofline term.
The reference's ``bf16_scores`` and ``seq_parallel+bf16`` variants are left
out: ``attn_bf16_scores`` changes nothing in the port, whose causal
attention is K4's (or ``attention_ref``'s) f32 softmax with no bf16 score
buffer, so they would measure the baseline and ``seq_parallel`` again.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell musicgen_prefill
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..configs import get_config
from . import roofline as rl


def _v(name, **kw):
    return (name, lambda cfg: dataclasses.replace(cfg, **kw))


# (arch, shape, [(variant_name, config_transform), ...]) per cell
CELLS = {
    "musicgen_prefill": {
        "arch": "musicgen-large",
        "shape": "prefill_32k",
        "variants": [
            ("baseline", lambda cfg: cfg),
            _v("seq_parallel", seq_parallel=True),
        ],
    },
    "jamba_decode": {
        "arch": "jamba-1.5-large-398b",
        "shape": "decode_32k",
        "variants": [
            ("baseline", lambda cfg: cfg),
            _v("ep_experts", moe_ep=True),
            _v("ep+tp_resident", moe_ep=True, fsdp_params=False),
        ],
    },
    "llama_decode": {
        "arch": "llama-3.2-vision-90b",
        "shape": "decode_32k",
        "variants": [
            ("baseline", lambda cfg: cfg),
            _v("tp_resident", fsdp_params=False),
            _v("tp_resident+int8kv", fsdp_params=False, kv_quant=True),
            _v("int8kv_only", kv_quant=True),
        ],
    },
}


def measure(arch, shape_name, cfg, multi_pod=False, **kw):
    """``corrected_record`` of the cell with ``cfg`` (a variant) in place of
    the registry's config; ``kw`` (``shape``, ``mesh_shape``) as there."""
    return rl.corrected_record(arch, shape_name, multi_pod, cfg=cfg, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)

    spec = CELLS[args.cell]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.cell}.jsonl")
    for name, tf in spec["variants"]:
        if args.variant and name != args.variant:
            continue
        cfg = tf(get_config(spec["arch"]))
        rec = measure(spec["arch"], spec["shape"], cfg)
        rec["variant"] = name
        rec["cell"] = args.cell
        print(
            f"{args.cell:18s} {name:22s} C={rec['compute_s']:.4f} "
            f"M={rec['memory_s']:.4f} X={rec['collective_s']:.4f} "
            f"-> {rec['bottleneck']} step={rec['step_time_s']:.4f}s",
            flush=True,
        )
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
