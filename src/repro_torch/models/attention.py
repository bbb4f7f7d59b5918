"""GQA self-attention with RoPE and a KV cache (port of ``repro.models.attention``).

Three entry points:
  - ``attn_train``   : full causal self-attention over the whole sequence
  - ``attn_prefill`` : same, but also returns the populated KV cache
  - ``attn_decode``  : one new token against a cached KV of length S

``attn_train`` and ``attn_prefill`` compute their causal attention through
``kernels.attention.ops.flash_attention``: kernel K4 on the card, the plain
``attention_ref`` on the CPU.  (The JAX package's ``attn_prefill`` uses its
chunked einsum path instead; both compute causal attention with scale
1/sqrt(Dh) and an fp32 softmax.)  ``attn_decode`` stays plain tensor code and
writes the new k/v into the cache **in place**, where the JAX version returns
an updated copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.attention.ops import flash_attention
from .common import ModelConfig, apply_norm


# ---------------------------------------------------------------- RoPE
def rope_freqs(cfg: ModelConfig, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., rot_dim/2), fp32."""
    rot = int(cfg.hd * cfg.rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device) / rot
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B, S, r/2) or (S, r/2). Rotates the first
    ``2*(r/2)`` dims, pass-through for the rest."""
    r2 = cos.shape[-1]
    xr, xp = x[..., : 2 * r2], x[..., 2 * r2 :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    if cos.dim() == 2:  # (S, r/2) -> broadcast over batch and heads
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, r/2)
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    o1 = x1 * cos_ - x2 * sin_
    o2 = x2 * cos_ + x1 * sin_
    rotated = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rotated, xp], dim=-1) if xp.shape[-1] else rotated


# ---------------------------------------------------------------- QKV helpers
def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_src: torch.Tensor):
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, x.shape[1], cfg.num_heads, cfg.hd)
    k = (kv_src @ p["wk"]).reshape(B, kv_src.shape[1], cfg.num_kv_heads, cfg.hd)
    v = (kv_src @ p["wv"]).reshape(B, kv_src.shape[1], cfg.num_kv_heads, cfg.hd)
    return q, k, v


def _causal_self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Shared body of train/prefill: returns (residual output, roped k, v)."""
    h = apply_norm(cfg, x, p, "norm")
    q, k, v = _project_qkv(cfg, p, h, h)
    cos, sin = rope_freqs(cfg, torch.arange(x.shape[1], device=x.device))
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, causal=True)  # kv heads read in place (GQA)
    B, S = x.shape[:2]
    y = x + (out.reshape(B, S, -1) @ p["wo"]).to(x.dtype)
    return y, k, v


# ---------------------------------------------------------------- entry points
def attn_train(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the full sequence."""
    return _causal_self_attention(cfg, p, x)[0]


def attn_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, max_len: int = 0):
    """Returns (residual output, (k_cache, v_cache)) for subsequent decode.
    ``max_len`` pads the cache along S with zeros so decode can append."""
    y, k, v = _causal_self_attention(cfg, p, x)
    S = x.shape[1]
    # cache layout: (B, Hkv, S, Dh), as in the JAX package
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)
    pad = max(max_len - S, 0)
    return y, (F.pad(kc, (0, 0, 0, pad)), F.pad(vc, (0, 0, 0, pad)))


def attn_decode(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, D) current token hidden
    cache: tuple[torch.Tensor, torch.Tensor],  # (B, Hkv, S, Dh) x2, updated in place
    position: torch.Tensor,  # (B,) current write index per sequence
):
    """One-token decode against cached KV; returns (y, cache).

    The new k/v are scattered into ``cache`` in place at each sequence's
    ``position`` (the JAX version returns an updated copy)."""
    kc, vc = cache
    B, Hkv, S, Dh = kc.shape
    h = apply_norm(cfg, x, p, "norm")
    q, k, v = _project_qkv(cfg, p, h, h)  # q:(B,1,H,Dh) k/v:(B,1,Hkv,Dh)
    cos, sin = rope_freqs(cfg, position[:, None])  # (B,1,r/2)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)
    pos = position.long()
    kc[bidx, :, pos] = k[:, 0]  # (B,Hkv,Dh)
    vc[bidx, :, pos] = v[:, 0]
    G = cfg.num_heads // Hkv
    qg = q.reshape(B, 1, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg, kc).float()
    scores = scores * (1.0 / math.sqrt(Dh))
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]  # (B,S)
    scores = scores.masked_fill(~valid[:, None, None, None], -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bhkd->bqhgd", w, vc).reshape(B, 1, -1)
    y = x + (out @ p["wo"]).to(x.dtype)
    return y, (kc, vc)
