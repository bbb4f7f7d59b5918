"""Model assembly (port of ``repro.models.transformer``).

Entry points (functions of (cfg, params, ...), parameters as nested dicts of
tensors with a leading ``num_periods`` dim on every per-layer leaf):
  forward_train(cfg, params, tokens) -> logits
  prefill(cfg, params, tokens, max_len) -> (last_logits, cache)
  decode_step(cfg, params, token, cache, position) -> (logits, cache)
  generate(cfg, params, prompt, num_steps) -> tokens

The JAX package's ``lax.scan`` over periods is a Python loop here that
indexes the stacked parameters.  ``decode_step`` writes the new k/v into the
cache in place and returns the same cache object.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn as ffn_mod
from .common import ModelConfig, apply_norm, check_supported
from .. import default_device

Cache = dict  # {"<slot>": {"k": (nP,B,Hkv,S,Dh), "v": ...}}


def _period(tree: dict, i: int) -> dict:
    """Period ``i``'s slice of a stacked parameter or cache tree (views)."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"].to(cfg.dtype)[tokens]


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits over the padded vocab; pad entries pushed to -1e30."""
    x = apply_norm(cfg, x, params, "final_norm")
    logits = (x @ params["lm_head"]).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0)
    return logits


# ------------------------------------------------------------- period bodies
def apply_period_train(cfg: ModelConfig, h: torch.Tensor, layer_params: dict) -> torch.Tensor:
    for si, (_mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        h = attn.attn_train(cfg, sp["attn"], h)
        h = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
    return h


def apply_period_prefill(
    cfg: ModelConfig, h: torch.Tensor, layer_params: dict, max_len: int = 0
) -> tuple[torch.Tensor, dict]:
    cache_slice: dict = {}
    for si, (_mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        h, (kc, vc) = attn.attn_prefill(cfg, sp["attn"], h, max_len=max_len)
        cache_slice[str(si)] = {"k": kc, "v": vc}
        h = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
    return h, cache_slice


def apply_period_decode(
    cfg: ModelConfig,
    h: torch.Tensor,
    layer_params: dict,
    cache_slice: dict,
    position: torch.Tensor,
) -> torch.Tensor:
    """One period of decode; ``cache_slice`` is updated in place."""
    for si, (_mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        cs = cache_slice[str(si)]
        h, _ = attn.attn_decode(cfg, sp["attn"], h, (cs["k"], cs["v"]), position)
        h = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
    return h


# --------------------------------------------------------------------- train
def forward_train(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) in fp32."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.num_periods):
        x = apply_period_train(cfg, x, _period(params["layers"], i))
    return _unembed(cfg, params, x)


# -------------------------------------------------------------------- prefill
def prefill(
    cfg: ModelConfig, params: dict, tokens: torch.Tensor, max_len: int = 0
) -> tuple[torch.Tensor, Cache]:
    """tokens (B, S) -> (last-position logits (B, V), cache padded to max_len)."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    slices = []
    for i in range(cfg.num_periods):
        x, cs = apply_period_prefill(cfg, x, _period(params["layers"], i), max_len)
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
    check_supported(cfg)
    x = _embed(cfg, params, token[:, None])  # (B, 1, D)
    for i in range(cfg.num_periods):
        x = apply_period_decode(
            cfg, x, _period(params["layers"], i), _period(cache, i), position
        )
    return _unembed(cfg, params, x)[:, 0, :], cache


# ---------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Cache:
    """Zeroed KV cache (the JAX package's ``abstract_cache``, allocated)."""
    check_supported(cfg)
    dev = default_device(device)
    shape = (cfg.num_periods, batch, cfg.num_kv_heads, max_len, cfg.hd)
    return {
        str(si): {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        }
        for si in range(len(cfg.pattern))
    }


# ------------------------------------------------------------------ greedy gen
@torch.no_grad()
def generate(cfg: ModelConfig, params: dict, prompt: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Greedy generation: prompt (B, S) -> tokens (B, num_steps + 1)."""
    B, S = prompt.shape
    logits, cache = prefill(cfg, params, prompt, max_len=S + num_steps)
    token = logits.argmax(-1).to(prompt.dtype)
    out = [token]
    pos = torch.full((B,), S, dtype=torch.int32, device=prompt.device)
    for _ in range(num_steps):
        logits, cache = decode_step(cfg, params, token, cache, pos)
        token = logits.argmax(-1).to(prompt.dtype)
        out.append(token)
        pos = pos + 1
    return torch.stack(out, dim=1)
