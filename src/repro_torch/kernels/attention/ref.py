"""Plain PyTorch oracle for flash attention (causal GQA), the counterpart of
``repro.kernels.attention.ref``.  Accepts any ``S >= 1``."""
from __future__ import annotations

import math

import torch


def attention_ref(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, S, Hkv, Dh)
    v: torch.Tensor,  # (B, S, Hkv, Dh)
    causal: bool = True,
) -> torch.Tensor:
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (1.0 / math.sqrt(Dh))
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)
