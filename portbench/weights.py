"""Weights made from the seed, in the layout the served and trained program
takes (nested dicts, every per-layer leaf stacked over the layers), and read
as they are by the reference.

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


def padded_vocab(model: dict) -> int:
    return (model["vocab_size"] + 255) // 256 * 256


def head_dim(model: dict) -> int:
    return model["d_model"] // model["num_heads"]


def _norm(model: dict, name: str, lead: tuple) -> dict:
    if model["norm_type"] == "nonparametric_ln":
        return {}
    if model["norm_type"] != "rmsnorm":
        raise ValueError(f"norm {model['norm_type']!r} is not in the reference")
    return {f"{name}_scale": (lead + (model["d_model"],), "ones", "bfloat16")}


def layout(model: dict) -> dict:
    """{dotted name: (shape, init, dtype name)} of every leaf, sorted by name."""
    D, H, Dh, n = model["d_model"], model["num_heads"], head_dim(model), model["num_layers"]
    Hkv, V = model["num_kv_heads"], padded_vocab(model)
    bf = "bfloat16"
    leaves = {"embed": ((V, D), "normal", bf), "lm_head": ((D, V), "normal", bf)}
    leaves.update(_norm(model, "final_norm", ()))
    attn = {"wq": ((n, D, H * Dh), "normal", bf), "wk": ((n, D, Hkv * Dh), "normal", bf),
            "wv": ((n, D, Hkv * Dh), "normal", bf), "wo": ((n, H * Dh, D), "scaled", bf)}
    attn.update(_norm(model, "norm", (n,)))
    leaves.update({f"layers.0.attn.{k}": v for k, v in attn.items()})
    if model.get("num_experts"):
        E, F = model["num_experts"], model["moe_d_ff"]
        Fs = model["num_shared_experts"] * F
        ffn = {"w_router": ((n, D, E), "normal", "float32"),
               "we_up": ((n, E, D, F), "normal", bf), "we_gate": ((n, E, D, F), "normal", bf),
               "we_down": ((n, E, F, D), "scaled", bf)}
        if Fs:
            ffn.update({"ws_up": ((n, D, Fs), "normal", bf), "ws_gate": ((n, D, Fs), "normal", bf),
                        "ws_down": ((n, Fs, D), "scaled", bf)})
        kind = "moe"
    else:
        F = model["d_ff"]
        ffn = {"w_up": ((n, D, F), "normal", bf), "w_gate": ((n, D, F), "normal", bf),
               "w_down": ((n, F, D), "scaled", bf)}
        kind = "mlp"
    ffn.update(_norm(model, "ffn_norm", (n,)))
    leaves.update({f"layers.0.{kind}.{k}": v for k, v in ffn.items()})
    return dict(sorted(leaves.items()))


def _draw(shape: tuple, dtype: torch.dtype, gen: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        piece = flat[i:i + CHUNK]
        piece.normal_(generator=gen)
    return out


def leaves(model: dict, seed: int, device):
    """Yield (dotted name, tensor) for every leaf in ``layout`` order, drawn
    from ``seed``: the same seed on the same device gives the same numbers."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    for name, (shape, init, dtype) in layout(model).items():
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


def make(model: dict, seed: int, device) -> dict:
    """The nested parameter tree the program takes."""
    return nest(dict(leaves(model, seed, device)))
