"""Model assembly (port of ``repro.models.transformer``).

Entry points (functions of (cfg, params, ...), parameters as nested dicts of
tensors with a leading ``num_periods`` dim on every per-layer leaf):
  forward_train(cfg, params, tokens, encoder_states) -> (logits, aux_loss)
  loss_fn(cfg, params, batch) -> (loss, {"nll", "aux"})
  prefill(cfg, params, tokens, encoder_states, max_len) -> (last_logits, cache)
  decode_step(cfg, params, token, cache, position) -> (logits, cache)
  generate(cfg, params, prompt, num_steps, encoder_states) -> tokens

``encoder_states`` (B, Se, D), in the model's dtype, feed the cross-attention
(``xattn``) layers; configs without such a layer ignore them.  The JAX
package's ``lax.scan`` over periods is a Python loop here that indexes the
stacked parameters.  ``decode_step`` writes the new k/v (int8 values and f32
scales under ``kv_quant``), and a mamba layer's new ssm and conv states,
into the cache in place and returns the same cache object; the encoder k/v
of a cross-attention layer are only read.

Under a mesh (``sharding.context.use_mesh``) the same functions take DTensor
parameters, batches and caches (placed by ``train.train_step``'s
``*_shardings``): the model code's ``shard()`` calls redistribute its
activations where the JAX package constrains them, plain tensors made
inside (masks, positions, zeros) count as replicated, and
``seq_parallel`` shards the residual stream's sequence dim over 'model'
between blocks.  Without a mesh every ``shard()`` returns its input.

Training recomputes activations as ``cfg.remat`` says, with
``torch.utils.checkpoint`` in place of ``jax.checkpoint``: ``"full"``
checkpoints each period of ``forward_train``'s loop (and, in a period of
more than one sublayer, each sublayer inside it, so the backward holds one
sublayer's working set at a time); ``"dots"`` saves the outputs of the
products with no batch dimension (``aten.mm``/``aten.addmm``: the
reference's ``checkpoint_dots_with_no_batch_dims``) and recomputes the rest;
``"none"`` saves everything.  Remat changes no number.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import ffn as ffn_mod
from . import ssm
from .common import ModelConfig, apply_norm, meta
from .. import default_device
from ..sharding.context import get_mesh, local_apply, logical_spec, mesh_scope, shard
from ..sharding.spec import P

# {"<slot>": leaves}, every leaf with a leading num_periods dim: an attn slot
# holds "k", "v" (nP,B,Hkv,S,Dh), in int8 under kv_quant with f32 "k_scale",
# "v_scale" (nP,B,Hkv,S); an xattn slot "ek", "ev" (nP,B,Hkv,Se,Dh); a mamba
# slot "ssm" (nP,B,H,P,N) f32 and "conv" (nP,B,K-1,Cd)
Cache = dict


def _period(tree: dict, i: int) -> dict:
    """Period ``i``'s slice of a stacked parameter or cache tree (views)."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """Every period's slice of a stacked parameter tree, each leaf cut once
    with ``unbind`` (whose backward stacks the periods' gradients in one
    allocation, where ``_period``'s per-period ``select`` would allocate a
    whole stacked gradient for each period)."""
    flat = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``'s activation checkpointing."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    return lambda *args: checkpoint(_scoped(fn), *args, use_reentrant=False, **kw)


def _scoped(fn):
    """``fn`` inside ``mesh_scope``: a checkpoint's recompute runs in the
    backward pass, outside the scope its forward ran in."""
    def run(*args):
        with mesh_scope():
            return fn(*args)
    return run


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"].to(cfg.dtype)
    # under a mesh the table is gathered whole (FSDP) and each rank looks up
    # its batch rows: the stream starts batch-sharded over the DP dims
    b = logical_spec(get_mesh(), tokens.shape[:1], ("dp",))[0]
    return local_apply(lambda t, ids: t[ids], (table, tokens), (P(None, None), P(b, None)),
                       P(b, None, None))


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits over the padded vocab; pad entries pushed to -1e30."""
    x = apply_norm(cfg, x, params, "final_norm")
    logits = (x @ params["lm_head"]).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0)
    return logits


def _stream(cfg: ModelConfig, h: torch.Tensor, seq: bool = True) -> torch.Tensor:
    """Between blocks the residual stream (B, S, D) is batch-sharded over
    the DP dims and, under ``seq_parallel`` after an attention block or its
    FFN (Megatron-SP), S-sharded over 'model' (a no-op without a mesh)."""
    return shard(h, "dp", "tp" if seq and cfg.seq_parallel else None, None)


# ------------------------------------------------------------- period bodies
def apply_period_train(
    cfg: ModelConfig,
    h: torch.Tensor,
    layer_params: dict,
    encoder_states: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One period of the layer pattern.  Each sublayer is checkpointed on
    its own when remat is on and the period has more than one."""
    nested = cfg.remat != "none" and len(cfg.pattern) > 1

    def ck(fn, *args):
        return checkpoint(_scoped(fn), *args, use_reentrant=False) if nested else fn(*args)

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for si, (mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        if mixer == "attn":
            h = ck(lambda hh, pp=sp: attn.attn_train(cfg, pp["attn"], hh), h)
        elif mixer == "xattn":
            h = ck(lambda hh, pp=sp: attn.cross_attn(cfg, pp["xattn"], hh, encoder_states), h)
        elif mixer == "mamba":
            h = ck(lambda hh, pp=sp: ssm.mamba_train(cfg, pp["mamba"], hh), h)
        h = _stream(cfg, h, mixer != "mamba")
        h, a = ck(lambda hh, pp=sp, kind=ffn_kind: ffn_mod.apply_ffn(cfg, kind, pp.get(kind, {}),
                                                                     hh), h)
        h = _stream(cfg, h, mixer != "mamba")
        aux = aux + a
    return h, aux


def apply_period_prefill(
    cfg: ModelConfig,
    h: torch.Tensor,
    layer_params: dict,
    encoder_states: Optional[torch.Tensor] = None,
    max_len: int = 0,
) -> tuple[torch.Tensor, dict]:
    """One period of prefill; returns (h, its cache slice).  The k/v are in
    the model's dtype also under ``kv_quant``, as in the JAX package, whose
    prefill never reads that switch."""
    cache_slice: dict = {}
    for si, (mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        if mixer == "attn":
            h, (kc, vc) = attn.attn_prefill(cfg, sp["attn"], h, max_len=max_len)
            cache_slice[str(si)] = {"k": kc, "v": vc}
        elif mixer == "xattn":
            h, (ek, ev) = attn.cross_attn_prefill(cfg, sp["xattn"], h, encoder_states)
            cache_slice[str(si)] = {"ek": ek, "ev": ev}
        elif mixer == "mamba":
            h, (hT, conv) = ssm.mamba_prefill(cfg, sp["mamba"], h)
            cache_slice[str(si)] = {"ssm": hT, "conv": conv}
        h = _stream(cfg, h, mixer != "mamba")
        h, _ = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
        h = _stream(cfg, h, mixer != "mamba")
    return h, cache_slice


def apply_period_decode(
    cfg: ModelConfig,
    h: torch.Tensor,
    layer_params: dict,
    cache_slice: dict,
    position: torch.Tensor,
) -> torch.Tensor:
    """One period of decode; ``cache_slice`` is updated in place."""
    for si, (mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        cs = cache_slice[str(si)]
        if mixer == "attn":
            if cfg.kv_quant:
                h, _ = attn.attn_decode_quant(cfg, sp["attn"], h, cs, position)
            else:
                h, _ = attn.attn_decode(cfg, sp["attn"], h, (cs["k"], cs["v"]), position)
        elif mixer == "xattn":
            h, _ = attn.cross_attn_decode(cfg, sp["xattn"], h, (cs["ek"], cs["ev"]))
        elif mixer == "mamba":
            h, (hn, conv) = ssm.mamba_decode(cfg, sp["mamba"], h, (cs["ssm"], cs["conv"]))
            cs["ssm"].copy_(hn)
            cs["conv"].copy_(conv)
        h = _stream(cfg, h, False)
        h, _ = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
        h = _stream(cfg, h, False)
    return h


# --------------------------------------------------------------------- train
def forward_train(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    encoder_states: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, padded_vocab) in fp32, the MoE
    load-balancing aux loss summed over layers, a scalar).  Each period is
    checkpointed as ``cfg.remat`` says."""
    with mesh_scope():
        x = _embed(cfg, params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        body = _remat(cfg, lambda h, lp: apply_period_train(cfg, h, lp, encoder_states))
        for lp in _unstack(params["layers"], cfg.num_periods):
            x, a = body(x, lp)
            aux = aux + a
        return _unembed(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL over ``batch`` ({"tokens", "labels"} (B, S) int,
    optional "loss_mask" (B, S) and "encoder_states"), plus 0.01 x the MoE
    aux loss: (total, {"nll", "aux"}), 0-d f32 tensors."""
    logits, aux = forward_train(cfg, params, batch["tokens"], batch.get("encoder_states"))
    with mesh_scope():
        logp = torch.log_softmax(logits, dim=-1)
        labels = batch["labels"].long()
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            loss = nll.mean()
        else:
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = loss + 0.01 * aux
    return total, {"nll": loss, "aux": aux}


# -------------------------------------------------------------------- prefill
def prefill(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    encoder_states: Optional[torch.Tensor] = None,
    max_len: int = 0,
) -> tuple[torch.Tensor, Cache]:
    """tokens (B, S) -> (last-position logits (B, V), cache padded to max_len)."""
    with mesh_scope():
        x = _embed(cfg, params, tokens)
        slices = []
        for i in range(cfg.num_periods):
            x, cs = apply_period_prefill(
                cfg, x, _period(params["layers"], i), encoder_states, max_len
            )
            slices.append(cs)
        cache = {
            si: {name: torch.stack([cs[si][name] for cs in slices]) for name in slices[0][si]}
            for si in slices[0]
        }
        logits = _unembed(cfg, params, x[:, -1:, :])[:, 0, :]
        return logits, cache


# --------------------------------------------------------------------- decode
def decode_step(
    cfg: ModelConfig,
    params: dict,
    token: torch.Tensor,  # (B,) current token
    cache: Cache,  # leading num_periods dim on every leaf; updated in place
    position: torch.Tensor,  # (B,) write index (= #tokens so far)
) -> tuple[torch.Tensor, Cache]:
    with mesh_scope():
        x = _embed(cfg, params, token[:, None])  # (B, 1, D)
        for i in range(cfg.num_periods):
            x = apply_period_decode(
                cfg, x, _period(params["layers"], i), _period(cache, i), position
            )
        return _unembed(cfg, params, x)[:, 0, :], cache


# ---------------------------------------------------------------- cache
def _cache_slice_leaves(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{slot: {name: (shape, dtype)}} of one period's cache slice."""
    Dh, Hkv = cfg.hd, cfg.num_kv_heads
    out: dict = {}
    for si, (mixer, _ffn) in enumerate(cfg.pattern):
        if mixer == "attn":
            shape = (batch, Hkv, max_len, Dh)
            if cfg.kv_quant:
                leaves = {"k": (shape, torch.int8), "v": (shape, torch.int8),
                          "k_scale": (shape[:-1], torch.float32),
                          "v_scale": (shape[:-1], torch.float32)}
            else:
                leaves = {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
        elif mixer == "xattn":
            shape = (batch, Hkv, cfg.num_encoder_tokens, Dh)
            leaves = {"ek": (shape, cfg.dtype), "ev": (shape, cfg.dtype)}
        elif mixer == "mamba":
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            leaves = {
                "ssm": ((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
                "conv": ((batch, cfg.ssm_conv_kernel - 1, conv_dim), cfg.dtype),
            }
        else:
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r} in slot {si}")
        out[str(si)] = leaves
    return out


def _cache_of(leaves: dict, lead: tuple, make) -> Cache:
    return {si: {name: make(lead + shape, dtype) for name, (shape, dtype) in slot.items()}
            for si, slot in leaves.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Cache:
    """Zeroed cache (``abstract_cache``, allocated), slot by slot as
    ``Cache`` above says."""
    dev = default_device(device)
    return _cache_of(_cache_slice_leaves(cfg, batch, max_len), (cfg.num_periods,),
                     lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev))


def abstract_cache_slice(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """``meta`` tensors for ONE period's cache slice (no data)."""
    return _cache_of(_cache_slice_leaves(cfg, batch, max_len), (), meta)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """``meta`` tensors for the full cache (leading num_periods dim)."""
    return _cache_of(_cache_slice_leaves(cfg, batch, max_len), (cfg.num_periods,), meta)


# ------------------------------------------------------------------ greedy gen
@torch.no_grad()
def generate(
    cfg: ModelConfig,
    params: dict,
    prompt: torch.Tensor,
    num_steps: int,
    encoder_states: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy generation: prompt (B, S) -> tokens (B, num_steps + 1)."""
    B, S = prompt.shape
    logits, cache = prefill(cfg, params, prompt, encoder_states, max_len=S + num_steps)
    token = logits.argmax(-1).to(prompt.dtype)
    out = [token]
    pos = torch.full((B,), S, dtype=torch.int32, device=prompt.device)
    for _ in range(num_steps):
        logits, cache = decode_step(cfg, params, token, cache, pos)
        token = logits.argmax(-1).to(prompt.dtype)
        out.append(token)
        pos = pos + 1
    return torch.stack(out, dim=1)
