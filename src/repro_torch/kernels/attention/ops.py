"""Public flash-attention wrapper (counterpart of ``repro.kernels.attention.ops``).

CPU tensors go to the plain ``attention_ref``, which autograd differentiates
as it is; CUDA tensors go to kernel K4 or raise.  On the card the kernel sits
in :class:`FlashAttention`, a ``torch.autograd.Function`` whose backward
recomputes the plain ``attention_ref`` under autograd and returns its
vector-Jacobian product, as the reference's ``custom_vjp`` does
(``_bwd``: ``jax.vjp`` of ``attention_ref``).  ``flash_attention.LAUNCHES``
counts forward launches of the kernel, so a run can show that its path went
through it; the backward launches no kernel of its own.
"""
from __future__ import annotations

import torch

from .flash import flash_fwd
from .ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """K4 forward, plain-recompute backward; ``causal`` is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return FlashAttention.forward_fn(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_ref(q, k, v, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None

    forward_fn = staticmethod(flash_fwd)  # the kernel; tests swap in the plain version


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Causal (or full) GQA attention: q (B,S,H,Dh), k/v (B,S,Hkv,Dh) -> (B,S,H,Dh)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    out = FlashAttention.apply(q, k, v, causal)
    flash_attention.LAUNCHES += 1
    return out


flash_attention.LAUNCHES = 0

__all__ = ["FlashAttention", "flash_attention", "attention_ref"]
