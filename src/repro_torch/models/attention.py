"""GQA self-attention with RoPE, cross-attention, and KV caches (port of
``repro.models.attention``).

Three entry points per mixer:
  - ``attn_train``   : full causal self-attention over the whole sequence
  - ``attn_prefill`` : same, but also returns the populated KV cache
  - ``attn_decode``  : one new token against a cached KV of length S
    (``attn_decode_quant`` against an int8 cache, under ``kv_quant``)
  - ``cross_attn``, ``cross_attn_prefill``, ``cross_attn_decode``: the same
    three for attention to encoder states (no RoPE on their keys)

``attn_train`` and ``attn_prefill`` compute their causal attention through
``kernels.attention.ops.flash_attention``: kernel K4 on the card, the plain
``attention_ref`` on the CPU.  (The JAX package's ``attn_prefill`` uses its
chunked einsum path instead; both compute causal attention with scale
1/sqrt(Dh) and an fp32 softmax.)  Cross-attention stays on the plain
``_gqa_scores_full``, as in the JAX package: K4, like the Pallas kernel it
ports, takes only queries and keys of one length.  ``attn_decode`` and
``attn_decode_quant`` stay plain tensor code and write the new k/v into the
cache **in place**, where the JAX version returns an updated copy.
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


def _gqa_scores_full(cfg: ModelConfig, q, k, v):
    """Non-causal attention (B,Sq,H,Dh) x (B,Sk,Hkv,Dh) -> (B,Sq,H,Dh) with
    every score materialized: the kv heads repeated G times (head h reads
    kv head h // G), fp32 scores scaled by 1/sqrt(Dh), the softmax weights
    cast to q's dtype."""
    G = q.shape[2] // cfg.num_kv_heads
    if G > 1:
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


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


def attn_decode_quant(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,  # k/v int8 (B,Hkv,S,Dh) + k_scale/v_scale f32 (B,Hkv,S), updated in place
    position: torch.Tensor,  # (B,)
):
    """Decode against an int8 KV cache; returns (y, cache).

    The new k/v are quantized per (b, head) (scale absmax/127 + 1e-9) and
    written, values and scales, in place at each sequence's ``position``.
    The k scales multiply the scores and the v scales the softmax weights, so
    the cache is only ever read at 1 byte an element, never dequantized."""
    kc, vc, ks, vs = cache["k"], cache["v"], cache["k_scale"], cache["v_scale"]
    B, Hkv, S, Dh = kc.shape
    h = apply_norm(cfg, x, p, "norm")
    q, k, v = _project_qkv(cfg, p, h, h)
    cos, sin = rope_freqs(cfg, position[:, None])
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    def quant(new):  # (B,1,Hkv,Dh) -> int8 (B,Hkv,Dh), scale (B,Hkv)
        a = new[:, 0].float()
        scale = a.abs().amax(-1) / 127.0 + 1e-9
        return torch.round(a / scale[..., None]).clamp(-127, 127).to(torch.int8), scale

    bidx = torch.arange(B, device=x.device)
    pos = position.long()
    for (qv, scale), c, sc in ((quant(k), kc, ks), (quant(v), vc, vs)):
        c[bidx, :, pos] = qv
        sc[bidx, :, pos] = scale

    G = cfg.num_heads // Hkv
    qg = q.reshape(B, 1, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), kc.float())
    scores = scores * ks[:, :, None, None, :]  # dequantize the scores, not the cache
    scores = scores * (1.0 / math.sqrt(Dh))
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]  # (B,S)
    scores = scores.masked_fill(~valid[:, None, None, None], -1e30)
    w = torch.softmax(scores, dim=-1) * vs[:, :, None, None, :]  # fold in the v scales
    out = torch.einsum("bhgqk,bhkd->bqhgd", w, vc.float()).to(x.dtype).reshape(B, 1, -1)
    y = x + (out @ p["wo"]).to(x.dtype)
    return y, cache


def cross_attn(cfg: ModelConfig, p: dict, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Cross-attention to encoder states ``enc`` (B, Se, D), in x's dtype.
    No RoPE on the cross keys (their positions are the encoder's own)."""
    return cross_attn_prefill(cfg, p, x, enc)[0]


def cross_attn_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, enc: torch.Tensor):
    """``cross_attn`` that also returns the encoder k/v cache (B, Hkv, Se,
    Dh) x2 for decode."""
    h = apply_norm(cfg, x, p, "norm")
    q, k, v = _project_qkv(cfg, p, h, enc)
    out = _gqa_scores_full(cfg, q, k, v)
    B, S = x.shape[:2]
    y = x + (out.reshape(B, S, -1) @ p["wo"]).to(x.dtype)
    return y, (k.transpose(1, 2), v.transpose(1, 2))


def cross_attn_decode(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    cache: tuple[torch.Tensor, torch.Tensor],  # encoder k/v (B, Hkv, Se, Dh) x2, only read
):
    """One token's cross-attention against the cached encoder k/v; returns
    (y, cache) with the cache as it was."""
    ek, ev = cache
    B, Hkv, Se, Dh = ek.shape
    h = apply_norm(cfg, x, p, "norm")
    q = (h @ p["wq"]).reshape(B, 1, Hkv, cfg.num_heads // Hkv, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", q, ek).float()
    scores = scores * (1.0 / math.sqrt(Dh))
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bhkd->bqhgd", w, ev).reshape(B, 1, -1)
    return x + (out @ p["wo"]).to(x.dtype), cache
