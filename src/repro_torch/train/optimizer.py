"""AdamW with a cosine schedule (port of ``repro.train.optimizer``).

The state is the JAX package's tree, ``{"mu", "nu", "step", "master"?}``,
with ``mu``/``nu`` (and the optional f32 ``master``) mirroring the parameter
tree and ``step`` an int32 0-d tensor, so a checkpoint holds the same leaves
in both frameworks.  Moments are stored in ``OptConfig.moment_dtype``; the
f32 master copy is optional (``master_fp32``), as in the reference, where
the largest configs keep bf16 moments and no master.

Where the reference returns new arrays (and its launcher donates the old
ones), :func:`apply_adamw` updates parameters, moments, master and step in
place under ``torch.no_grad()``: every leaf stays the same tensor object.
Each update is computed in f32 with the reference's operations in the
reference's order.  The sharding helpers (``abstract_opt_state``,
``opt_state_pspecs``) wait for the port's sharding slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32
    master_fp32: bool = True


def schedule(ocfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor), in f32: linear warm-up, then a
    cosine decay to ``min_lr_frac`` of the peak at ``decay_steps``."""
    step = step.to(torch.float32)
    warm = step / max(ocfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - ocfg.warmup_steps) / max(ocfg.decay_steps - ocfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = ocfg.min_lr_frac + (1 - ocfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return ocfg.peak_lr * torch.where(step < ocfg.warmup_steps, warm, cos)


def init_opt_state(ocfg: OptConfig, params: Any) -> dict:
    """Zero moments in ``moment_dtype``, step 0 (int32, 0-d) and, with
    ``master_fp32``, an f32 copy of the parameters, each on its parameter's
    device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=ocfg.moment_dtype, device=p.device)
    device = tree_leaves(params)[0].device
    state = {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if ocfg.master_fp32:
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, each squared in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)))


@torch.no_grad()
def apply_adamw(ocfg: OptConfig, params: Any, grads: Any, state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step with global-norm clipping.  Updates ``params`` and
    ``state`` in place and returns ``(params, state, {"lr", "grad_norm"})``
    (0-d f32 tensors), as the reference returns its new trees."""
    step = state["step"] + 1
    lr = schedule(ocfg, step)
    gnorm = global_norm(grads)
    # a true division (a number over a tensor is a reciprocal and a product)
    scale = torch.clamp(torch.full_like(gnorm, ocfg.grad_clip) / (gnorm + 1e-9), max=1.0)

    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    masters = state.get("master")
    leaves_m = tree_leaves(masters) if masters is not None else None
    for i, (p, g, mu, nu) in enumerate(zip(tree_leaves(params), tree_leaves(grads),
                                           tree_leaves(state["mu"]), tree_leaves(state["nu"]))):
        g = g.to(torch.float32) * scale
        mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g
        nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        base = leaves_m[i] if leaves_m is not None else p.to(torch.float32)
        new = base - lr * (mhat / (torch.sqrt(vhat) + ocfg.eps) + ocfg.weight_decay * base)
        p.copy_(new)  # rounds to p's dtype
        mu.copy_(mu32)
        nu.copy_(nu32)
        if leaves_m is not None:
            leaves_m[i].copy_(new)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


__all__ = ["OptConfig", "apply_adamw", "global_norm", "init_opt_state", "schedule"]
