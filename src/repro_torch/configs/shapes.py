# Port copy of src/repro/configs/shapes.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Assigned input shapes (arch-family: LM transformers).

``decode_*`` / ``long_*`` lower ``serve_step`` (one token against a KV cache of
seq_len); ``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers the
prefill step. ``long_500k`` requires a sub-quadratic path: only SSM/hybrid
archs run it (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs whose pattern contains no full-attention-free path must skip long_500k
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(cfg) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        names.append("long_500k")
    return names
