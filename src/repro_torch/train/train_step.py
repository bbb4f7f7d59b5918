"""Train and serve step builders (port of ``repro.train.train_step``).

``make_train_step(cfg, ocfg)`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss (``transformer.loss_fn``), its
gradients with respect to every parameter leaf (``torch.autograd.grad``;
a leaf the loss does not reach gets zeros, as ``jax.grad`` gives), then one
AdamW update in place.  ``batch`` holds numpy or tensor ``tokens`` and
``labels`` (B, S) and, for a cross-attention config, ``encoder_states``;
the step moves them to the parameters' device.  Metrics are 0-d f32 tensors
on that device: ``loss``, ``nll``, ``aux``, ``lr``, ``grad_norm``.

Under a mesh the steps take DTensor parameters, state and batches, placed
by the ``*_shardings`` builders (trees of ``NamedSharding``, applied with
``sharding.partitioning.distribute``; the reference hands the same trees to
``jax.jit``), and run inside ``sharding.context.use_mesh``.  Each gradient
is redistributed to its parameter's placements before the update (the
data-parallel reduction).  The ``abstract_*`` builders give ``meta``
tensors of the inputs' shapes and dtypes, for the dry-run.

With the port's tracer on (``repro_torch.trace``) a train step records a
``train.step`` span with the children ``train.forward`` (the loss),
``train.backward`` (the gradients, the checkpoints' recompute included) and
``train.adamw`` (the update).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import trace
from ..models import transformer
from ..models.common import ModelConfig, abstract_params, meta, param_pspecs
from ..sharding.partitioning import (NamedSharding, batch_spec, cache_pspecs, named,
                                     named_sanitized, place)
from ..sharding.context import mesh_scope, shard
from ..sharding.spec import P
from ..tree import tree_leaves, tree_unflatten
from .optimizer import (OptConfig, abstract_opt_state, apply_adamw, opt_state_pspecs,
                        replicated)


def _on(device: torch.device, x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x if isinstance(x, DTensor) else x.to(device)


def _like(grad, param):
    """A DTensor gradient on its parameter's placements."""
    if isinstance(grad, DTensor) and tuple(grad.placements) != tuple(param.placements):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def _device_batch(batch: dict, like: torch.Tensor) -> dict:
    """The tensor entries of ``batch`` (numpy or torch) on the device of
    ``like`` (a parameter); anything else (the pipeline's ``serial``) is
    left out.  Beside DTensor parameters a plain entry is placed on their
    mesh by ``batch_spec``, as ``train_step_shardings`` places a batch."""
    out = {k: _on(like.device, v) for k, v in batch.items()
           if isinstance(v, (np.ndarray, torch.Tensor))}
    if isinstance(like, DTensor):
        mesh = like.device_mesh
        out = {k: v if isinstance(v, DTensor) else
               place(v, NamedSharding(mesh, batch_spec(mesh, v.shape[0], v.dim() - 1)))
               for k, v in out.items()}
    return out


# ----------------------------------------------------------------- train
def make_train_step(cfg: ModelConfig, ocfg: OptConfig):
    def train_step(params, opt_state, batch):
        with trace.span("train.step"):
            flat = tree_leaves(params)
            batch = _device_batch(batch, flat[0])
            # detached aliases of the parameters: autograd differentiates with
            # respect to them, and the update then writes the parameters in place
            leaves = [p.detach().requires_grad_() for p in flat]
            with torch.enable_grad(), mesh_scope():
                with trace.span("train.forward"):
                    loss, metrics = transformer.loss_fn(cfg, tree_unflatten(params, leaves),
                                                        batch)
                with trace.span("train.backward"):  # the recompute included
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                                materialize_grads=True)
                    grads = [_like(g, p) for g, p in zip(grads, flat)]
                with trace.span("train.adamw"):
                    params, opt_state, opt_metrics = apply_adamw(
                        ocfg, params, tree_unflatten(params, grads), opt_state)
            metrics = dict(metrics, loss=loss, **opt_metrics)
            return params, opt_state, {k: replicated(v.detach()) for k, v in metrics.items()}

    return train_step


def train_step_shardings(cfg: ModelConfig, ocfg: OptConfig, mesh, shape):
    """(in_shardings, out_shardings) trees of the train step on ``mesh``."""
    pp = param_pspecs(cfg)
    op = opt_state_pspecs(ocfg, pp)
    B = shape.global_batch
    batch_specs = {"tokens": batch_spec(mesh, B, 1), "labels": batch_spec(mesh, B, 1)}
    if cfg.num_encoder_tokens:
        batch_specs["encoder_states"] = batch_spec(mesh, B, 2)
    metrics_specs = {"loss": P(), "nll": P(), "aux": P(), "lr": P(), "grad_norm": P()}
    ap = abstract_params(cfg)
    ao = abstract_opt_state(ocfg, ap)
    pshard = named_sanitized(mesh, pp, ap)
    oshard = named_sanitized(mesh, op, ao)
    ins = (pshard, oshard, named(mesh, batch_specs))
    outs = (pshard, oshard, named(mesh, metrics_specs))
    return ins, outs


def abstract_train_batch(cfg: ModelConfig, shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": meta((B, S), torch.int32), "labels": meta((B, S), torch.int32)}
    if cfg.num_encoder_tokens:
        batch["encoder_states"] = meta((B, cfg.num_encoder_tokens, cfg.d_model), cfg.dtype)
    return batch


# ----------------------------------------------------------------- prefill
def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(cfg, params, batch["tokens"], batch.get("encoder_states"))

    return prefill_step


def prefill_shardings(cfg: ModelConfig, mesh, shape):
    pp = param_pspecs(cfg)
    B = shape.global_batch
    batch_specs = {"tokens": batch_spec(mesh, B, 1)}
    if cfg.num_encoder_tokens:
        batch_specs["encoder_states"] = batch_spec(mesh, B, 2)
    ins = (named_sanitized(mesh, pp, abstract_params(cfg)), named(mesh, batch_specs))
    outs = (
        NamedSharding(mesh, batch_spec(mesh, B, 1)),  # logits (B, V)
        named_sanitized(mesh, cache_pspecs(cfg, mesh, B, mode="prefill"),
                        transformer.abstract_cache(cfg, B, shape.seq_len)),
    )
    return ins, outs


def abstract_prefill_batch(cfg: ModelConfig, shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": meta((B, S), torch.int32)}
    if cfg.num_encoder_tokens:
        batch["encoder_states"] = meta((B, cfg.num_encoder_tokens, cfg.d_model), cfg.dtype)
    return batch


# ----------------------------------------------------------------- decode
def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy-sample the next token against the KV cache
    (written in place)."""

    @torch.no_grad()
    def serve_step(params, cache, token, position):
        logits, cache = transformer.decode_step(cfg, params, token, cache, position)
        with mesh_scope():  # the vocab whole on each rank before its argmax
            return shard(logits, "dp", None).argmax(-1).to(torch.int32), cache

    return serve_step


def serve_shardings(cfg: ModelConfig, mesh, shape):
    pp = param_pspecs(cfg)
    B = shape.global_batch
    cshard = named_sanitized(mesh, cache_pspecs(cfg, mesh, B, mode="decode"),
                             transformer.abstract_cache(cfg, B, shape.seq_len))
    tok = NamedSharding(mesh, batch_spec(mesh, B, 0))
    ins = (named_sanitized(mesh, pp, abstract_params(cfg)), cshard, tok, tok)
    outs = (tok, cshard)
    return ins, outs


def abstract_serve_inputs(cfg: ModelConfig, shape):
    B, S = shape.global_batch, shape.seq_len
    return (transformer.abstract_cache(cfg, B, S), meta((B,), torch.int32),
            meta((B,), torch.int32))


__all__ = [
    "abstract_prefill_batch", "abstract_serve_inputs", "abstract_train_batch",
    "make_prefill_step", "make_serve_step", "make_train_step", "prefill_shardings",
    "serve_shardings", "train_step_shardings",
]
