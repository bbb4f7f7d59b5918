"""Weights made from the seed, in the layout the served and trained program
takes (nested dicts, every per-layer leaf stacked over the layers), and read
as they are by the reference.  A family's ``layout(model)`` names the
leaves (``families/``); this module draws them.

The benchmark makes them: the program's own initialiser is not called, so
the reference takes nothing the program made.  Each leaf is drawn on the
device from one ``torch.Generator`` in the type it is served in (bfloat16;
the router in float32), in slices of at most 2**30 numbers, and scaled by
1/sqrt(fan_in) (output projections by a further 1/sqrt(2 x layers)); norm
scales are ones.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30  # numbers drawn in one call


def _draw(shape: tuple, dtype: torch.dtype, gen: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        piece = flat[i:i + CHUNK]
        piece.normal_(generator=gen)
    return out


def leaves(model: dict, layout: dict, seed: int, device):
    """Yield (dotted name, tensor) for every leaf of ``layout`` ({dotted
    name: (shape, init, dtype name)}, init "normal", "scaled" or "ones") in
    its order, drawn from ``seed``: the same seed on the same device gives
    the same numbers."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    for name, (shape, init, dtype) in layout.items():
        dt = getattr(torch, dtype)
        if init == "ones":
            yield name, torch.ones(shape, dtype=dt, device=device)
            continue
        scale = 1.0 / math.sqrt(shape[-2])
        if init == "scaled":
            scale /= math.sqrt(2.0 * model["num_layers"])
        yield name, _draw(shape, dt, gen, device).mul_(scale)


def nest(flat: dict) -> dict:
    out: dict = {}
    for name, t in flat.items():
        node = out
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t
    return out


def make(model: dict, layout: dict, seed: int, device) -> dict:
    """The nested parameter tree the program takes."""
    return nest(dict(leaves(model, layout, seed, device)))
