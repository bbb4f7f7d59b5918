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

Under a mesh the inputs are DTensors.  ``shard()`` stands where the JAX
package constrains its activations, and K4, which takes raw pointers, runs
inside ``local_map`` on each rank's (batch, head) shard: attention is local
per batch row and head; so does cross-attention's plain score path (DTensor's
batched products refuse an einsum whose batch dims are cut over two mesh
dims).  When the kv heads do not split over 'model' but the query heads
do, k and v are first expanded to the query heads, as the JAX package
expands them.  A decode step writes the new k/v into each
rank's own piece of the cache (:func:`write_at`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels.attention.ops import flash_attention
from ..sharding.context import get_mesh, local_apply, logical_spec, shard
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
def _heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n*dh) -> (B, S, n, dh).  Under a mesh the projection is first
    laid out batch over DP and heads over 'model' where n splits over it,
    else replicated there: DTensor cannot cut a dim unevenly as JAX pads."""
    t = shard(t, "dp", None, "tp" if logical_spec(get_mesh(), (n,), ("tp",))[0] else None)
    return t.reshape(t.shape[0], t.shape[1], n, dh)


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_src: torch.Tensor):
    q = _heads(x @ p["wq"], cfg.num_heads, cfg.hd)
    k = _heads(kv_src @ p["wk"], cfg.num_kv_heads, cfg.hd)
    v = _heads(kv_src @ p["wv"], cfg.num_kv_heads, cfg.hd)
    return q, k, v


def _gqa_scores_full(cfg: ModelConfig, q, k, v):
    """Non-causal attention (B,Sq,H,Dh) x (B,Sk,Hkv,Dh) -> (B,Sq,H,Dh) with
    every score materialized: the kv heads repeated G times (head h reads
    kv head h // G), fp32 scores scaled by 1/sqrt(Dh), the softmax weights
    cast to q's dtype."""
    G = q.shape[2] // cfg.num_kv_heads
    if G > 1:
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    # under a mesh local per (batch, head), the layout the reference
    # constrains q, k, v, the scores and the output to
    return _local_heads(_full_scores, q, k, v)


def _full_scores(q, k, v):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _causal_attention(q, k, v):
    """Causal GQA attention through ``flash_attention`` (K4 on the card).
    Under a mesh it runs inside ``local_apply`` on each rank's shard: batch
    over the DP dims and heads over 'model', where they divide."""
    return _local_heads(lambda a, b, c: flash_attention(
        a.contiguous(), b.contiguous(), c.contiguous(), causal=True), q, k, v)


def _local_heads(fn, q, k, v):
    """``fn(q, k, v)`` -> (B, Sq, H, Dh), local per batch row and head:
    under a mesh on each rank's (batch, head) piece.  When the kv heads do
    not split over 'model' but the query heads do, k and v are expanded to
    the query heads first (as the JAX package expands them)."""
    mesh = get_mesh()
    dims = ("dp", None, "tp", None)
    sq = logical_spec(mesh, q.shape, dims)
    if sq[2] is not None and logical_spec(mesh, k.shape, dims)[2] is None:
        G = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    return local_apply(fn, (q, k, v), (sq, sq, sq), sq)


def write_at(cache: torch.Tensor, new: torch.Tensor, position: torch.Tensor) -> None:
    """``cache[b, :, position[b]] = new[b]`` in place, for every b: cache
    (B, Hkv, S, ...) and new (B, Hkv, ...).  On a DTensor cache each rank
    writes into its own piece: new and position follow the cache's batch
    (and trailing) shards, and a rank whose piece of S does not hold the
    position keeps its old values there."""
    if not isinstance(cache, DTensor):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, :, position.long()] = new
        return
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    new_pl, pos_pl, piece = [], [], 0
    for j, pl in enumerate(cache.placements):
        d = pl.dim if isinstance(pl, Shard) else None
        new_pl.append(Shard(d - (d > 2)) if d is not None and d != 2 else Replicate())
        pos_pl.append(Shard(0) if d == 0 else Replicate())
        if d == 2:  # S split over this mesh dim (mesh order is major to minor)
            piece = piece * mesh.size(j) + coord[j]
    local = cache.to_local()
    S_local = local.shape[2]
    whole = [Replicate()] * mesh.ndim
    as_dt = lambda t: t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, whole)
    nl = as_dt(new).redistribute(mesh, new_pl).to_local()
    lp = as_dt(position).redistribute(mesh, pos_pl).to_local().long() - piece * S_local
    inside = ((lp >= 0) & (lp < S_local)).reshape((-1,) + (1,) * (nl.dim() - 1))
    lp = lp.clamp(0, S_local - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    local[bidx, :, lp] = torch.where(inside, nl, local[bidx, :, lp])


def _causal_self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Shared body of train/prefill: returns (residual output, roped k, v)."""
    h = apply_norm(cfg, x, p, "norm")
    q, k, v = _project_qkv(cfg, p, h, h)
    cos, sin = rope_freqs(cfg, torch.arange(x.shape[1], device=x.device))
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = _causal_attention(q, k, v)  # kv heads read in place (GQA)
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
    if pad:
        kc, vc = F.pad(kc, (0, 0, 0, pad)), F.pad(vc, (0, 0, 0, pad))
    return y, (kc, vc)


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
    pos = position.long()
    write_at(kc, k[:, 0], pos)  # (B,Hkv,Dh)
    write_at(vc, v[:, 0], pos)
    G = cfg.num_heads // Hkv
    # the query whole on every 'model' rank: the cache is S-sharded there
    qg = shard(q, "dp", None, None, None).reshape(B, 1, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg, kc).float()
    scores = shard(scores, "dp", None, None, None, "tp")
    scores = scores * (1.0 / math.sqrt(Dh))
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]  # (B,S)
    scores = scores.masked_fill(~valid[:, None, None, None], -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = shard(torch.einsum("bhgqk,bhkd->bqhgd", w, vc), "dp", None, None, None, None)
    y = x + (out.reshape(B, 1, -1) @ p["wo"]).to(x.dtype)
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

    pos = position.long()
    for (qv, scale), c, sc in ((quant(k), kc, ks), (quant(v), vc, vs)):
        write_at(c, qv, pos)
        write_at(sc, scale, pos)

    G = cfg.num_heads // Hkv
    qg = shard(q, "dp", None, None, None).reshape(B, 1, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), kc.float())
    scores = scores * ks[:, :, None, None, :]  # dequantize the scores, not the cache
    scores = shard(scores, "dp", None, None, None, "tp")
    scores = scores * (1.0 / math.sqrt(Dh))
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]  # (B,S)
    scores = scores.masked_fill(~valid[:, None, None, None], -1e30)
    w = torch.softmax(scores, dim=-1) * vs[:, :, None, None, :]  # fold in the v scales
    out = torch.einsum("bhgqk,bhkd->bqhgd", w, vc.float()).to(x.dtype)
    out = shard(out, "dp", None, None, None, None).reshape(B, 1, -1)
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
    q = shard(h @ p["wq"], "dp", None, None).reshape(B, 1, Hkv, cfg.num_heads // Hkv, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", q, ek).float()
    scores = scores * (1.0 / math.sqrt(Dh))
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    # heads whole before they merge (the encoder cache is Dh-sharded)
    out = shard(torch.einsum("bhgqk,bhkd->bqhgd", w, ev), "dp", None, None, None, None)
    return x + (out.reshape(B, 1, -1) @ p["wo"]).to(x.dtype), cache
