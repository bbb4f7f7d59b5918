"""Train and serve step builders (port of ``repro.train.train_step``).

``make_train_step(cfg, ocfg)`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss (``transformer.loss_fn``), its
gradients with respect to every parameter leaf (``torch.autograd.grad``;
a leaf the loss does not reach gets zeros, as ``jax.grad`` gives), then one
AdamW update in place.  ``batch`` holds numpy or tensor ``tokens`` and
``labels`` (B, S) and, for a cross-attention config, ``encoder_states``;
the step moves them to the parameters' device.  Metrics are 0-d f32 tensors
on that device: ``loss``, ``nll``, ``aux``, ``lr``, ``grad_norm``.

The reference's ``*_shardings`` and ``abstract_*`` builders, which feed
``jax.jit``'s AOT lowering on a mesh, wait for the port's sharding slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import transformer
from ..models.common import ModelConfig
from ..tree import tree_leaves, tree_unflatten
from .optimizer import OptConfig, apply_adamw


def _on(device: torch.device, x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def _device_batch(batch: dict, device: torch.device) -> dict:
    """The tensor entries of ``batch`` (numpy or torch) on ``device``;
    anything else (the pipeline's ``serial``) is left out."""
    return {k: _on(device, v) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


# ----------------------------------------------------------------- train
def make_train_step(cfg: ModelConfig, ocfg: OptConfig):
    def train_step(params, opt_state, batch):
        flat = tree_leaves(params)
        batch = _device_batch(batch, flat[0].device)
        # detached aliases of the parameters: autograd differentiates with
        # respect to them, and the update then writes the parameters in place
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, metrics = transformer.loss_fn(cfg, tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        params, opt_state, opt_metrics = apply_adamw(
            ocfg, params, tree_unflatten(params, grads), opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach(), **opt_metrics)

    return train_step


# ----------------------------------------------------------------- prefill
def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(cfg, params, batch["tokens"], batch.get("encoder_states"))

    return prefill_step


# ----------------------------------------------------------------- decode
def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy-sample the next token against the KV cache
    (written in place)."""

    @torch.no_grad()
    def serve_step(params, cache, token, position):
        logits, cache = transformer.decode_step(cfg, params, token, cache, position)
        return logits.argmax(-1).to(torch.int32), cache

    return serve_step


__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]
