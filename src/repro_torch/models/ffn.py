"""Dense feed-forward layers (port of ``repro.models.ffn``).

Only ``"mlp"`` and ``"none"`` are ported; the Mixture-of-Experts layer (and
its hybrid-queue dispatch, kernel K3) comes with the MoE slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, apply_norm


def _act(cfg: ModelConfig, up: torch.Tensor, gate) -> torch.Tensor:
    if cfg.ffn_act == "swiglu":
        return F.silu(gate) * up
    return F.gelu(up, approximate="tanh")  # jax.nn.gelu's default


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, x, p, "ffn_norm")
    up = h @ p["w_up"]
    gate = h @ p["w_gate"] if "w_gate" in p else None
    return x + (_act(cfg, up, gate) @ p["w_down"]).to(x.dtype)


def apply_ffn(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Uniform interface over the ported kinds.  (The JAX version also
    returns a load-balancing loss, which is zero for these kinds.)"""
    if kind == "mlp":
        return mlp(cfg, p, x)
    if kind == "none":
        return x
    raise NotImplementedError(f"ffn kind {kind!r} not yet ported to repro_torch")
