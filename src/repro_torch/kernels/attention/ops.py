"""Public flash-attention wrapper (counterpart of ``repro.kernels.attention.ops``).

CPU tensors go to the plain ``attention_ref``; CUDA tensors go to kernel K4
or raise.  ``flash_attention.LAUNCHES`` counts kernel launches, so a run can
show that its path went through the kernel.  Forward only: the
``autograd.Function`` with a backward pass comes with the training slice.
"""
from __future__ import annotations

import torch

from .flash import flash_fwd
from .ref import attention_ref


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Causal (or full) GQA attention: q (B,S,H,Dh), k/v (B,S,Hkv,Dh) -> (B,S,H,Dh)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    out = flash_fwd(q, k, v, causal)
    flash_attention.LAUNCHES += 1
    return out


flash_attention.LAUNCHES = 0

__all__ = ["flash_attention", "attention_ref"]
