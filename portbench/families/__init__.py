"""A configuration's model code, found by its file's ``family`` key.

``configs/<config>.json`` may name a family (``"family": "<name>"``); the
harness then takes every piece of model code from the module
``families/<name>.py``, and from ``families/transformer.py`` where the file
names none.  The harness (``serving.py``, ``training.py``, ``calibrate.py``,
``tiny.py``) reaches model code only through ``of(config)``, so a new
family is a module here beside its configuration, cell and traffic files.

A family's module gives:

- ``layout(model)``: {dotted name: (shape, init, dtype name)} of every leaf,
  drawn by ``weights.leaves`` (init "normal", "scaled" or "ones");
- ``served_logits(model, params, seqs, wanted, control=False)``: the plain
  float32 logits at the positions ``wanted`` of each sequence (the float8
  control with ``control="fp8"``, a bfloat16 witness with ``"bf16"``);
- ``prefill_flops(model, seq)`` and ``decode_flops(model, positions)``;
- ``prefill_bounds(model, seq)`` and ``decode_bounds(model, slots)``: the
  step's kernel bounds, {"<k>_bound_s": seconds};
- ``KERNELS``: (name needle, bound key) of each kernel its steps run, which
  the roofline readers and the traced run's kernel line take;
- ``tiny(model)``: the model's sizes cut for the CPU tests;

and, where the family trains:

- ``train_steps(model, opt, flat, batches, *, control=False, rows=2,
  keep_rows=0)``: the reference's AdamW steps (``reference.adamw_steps``);
- ``train_flops(model, batch, seq)``;
- ``launches()``: the program's launch counters it reads, {key: count};
- ``train_bounds(model, batch, seq, calls)``: a step's kernel bounds from
  the counters' advance over the first step.
"""
from __future__ import annotations

import importlib
import re

DEFAULT = "transformer"
NEEDS = ("layout", "served_logits", "prefill_flops", "decode_flops", "prefill_bounds",
         "decode_bounds", "KERNELS", "tiny")
TRAINS = ("train_steps", "train_flops", "launches", "train_bounds")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]{0,63}")


def name_of(config: dict) -> str:
    return config.get("family", DEFAULT)


def load(name: str):
    """The module ``families/<name>.py``, with what every family gives."""
    if not NAME.fullmatch(name):
        raise ValueError(f"family {name!r} is not a module name of families/")
    mod = importlib.import_module(f"{__name__}.{name}")
    missing = [k for k in NEEDS if not hasattr(mod, k)]
    if missing:
        raise TypeError(f"family {name!r} lacks {missing}")
    return mod


def of(config: dict):
    """The family of a configuration file's contents."""
    return load(name_of(config))


def for_training(config: dict):
    """``of(config)``, which has to train."""
    fam = of(config)
    missing = [k for k in TRAINS if not hasattr(fam, k)]
    if missing:
        raise TypeError(f"family {name_of(config)!r} does not train: it lacks {missing}")
    return fam
