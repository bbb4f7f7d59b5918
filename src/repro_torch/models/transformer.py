"""Model assembly (port of ``repro.models.transformer``).

Entry points (functions of (cfg, params, ...), parameters as nested dicts of
tensors with a leading ``num_periods`` dim on every per-layer leaf):
  forward_train(cfg, params, tokens) -> (logits, aux_loss)
  prefill(cfg, params, tokens, max_len) -> (last_logits, cache)
  decode_step(cfg, params, token, cache, position) -> (logits, cache)
  generate(cfg, params, prompt, num_steps) -> tokens

The JAX package's ``lax.scan`` over periods is a Python loop here that
indexes the stacked parameters.  ``decode_step`` writes the new k/v, and a
mamba layer's new ssm and conv states, into the cache in place and returns
the same cache object.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn as ffn_mod
from . import ssm
from .common import ModelConfig, apply_norm, check_supported
from .. import default_device

Cache = dict  # {"<slot>": {"k", "v": (nP,B,Hkv,S,Dh)} or {"ssm": (nP,B,H,P,N), "conv": (nP,B,K-1,Cd)}}


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
def apply_period_train(
    cfg: ModelConfig, h: torch.Tensor, layer_params: dict
) -> tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for si, (mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        if mixer == "attn":
            h = attn.attn_train(cfg, sp["attn"], h)
        elif mixer == "mamba":
            h = ssm.mamba_train(cfg, sp["mamba"], h)
        h, a = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
        aux = aux + a
    return h, aux


def apply_period_prefill(
    cfg: ModelConfig, h: torch.Tensor, layer_params: dict, max_len: int = 0
) -> tuple[torch.Tensor, dict]:
    cache_slice: dict = {}
    for si, (mixer, ffn_kind) in enumerate(cfg.pattern):
        sp = layer_params[str(si)]
        if mixer == "attn":
            h, (kc, vc) = attn.attn_prefill(cfg, sp["attn"], h, max_len=max_len)
            cache_slice[str(si)] = {"k": kc, "v": vc}
        elif mixer == "mamba":
            h, (hT, conv) = ssm.mamba_prefill(cfg, sp["mamba"], h)
            cache_slice[str(si)] = {"ssm": hT, "conv": conv}
        h, _ = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
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
            h, _ = attn.attn_decode(cfg, sp["attn"], h, (cs["k"], cs["v"]), position)
        elif mixer == "mamba":
            h, (hn, conv) = ssm.mamba_decode(cfg, sp["mamba"], h, (cs["ssm"], cs["conv"]))
            cs["ssm"].copy_(hn)
            cs["conv"].copy_(conv)
        h, _ = ffn_mod.apply_ffn(cfg, ffn_kind, sp.get(ffn_kind, {}), h)
    return h


# --------------------------------------------------------------------- train
def forward_train(
    cfg: ModelConfig, params: dict, tokens: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, padded_vocab) in fp32, the MoE
    load-balancing aux loss summed over layers, a scalar)."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_periods):
        x, a = apply_period_train(cfg, x, _period(params["layers"], i))
        aux = aux + a
    return _unembed(cfg, params, x), aux


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
    """Zeroed cache (the JAX package's ``abstract_cache``, allocated): k/v
    for attention slots, the ssm state (f32) and conv state for mamba slots."""
    check_supported(cfg)
    dev = default_device(device)
    nP = cfg.num_periods
    cache: Cache = {}
    for si, (mixer, _ffn) in enumerate(cfg.pattern):
        if mixer == "attn":
            shape = (nP, batch, cfg.num_kv_heads, max_len, cfg.hd)
            leaves = {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
        else:  # mamba
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            leaves = {
                "ssm": ((nP, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        torch.float32),
                "conv": ((nP, batch, cfg.ssm_conv_kernel - 1, conv_dim), cfg.dtype),
            }
        cache[str(si)] = {
            name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, dtype) in leaves.items()
        }
    return cache


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
