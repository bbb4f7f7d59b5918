"""K4: the hand-written Hopper flash-attention forward (``csrc/flash_fwd.cu``).

Counterpart of ``repro.kernels.attention.flash``, the Pallas TPU kernel.  The
CUDA source is compiled at first use (``kernels._build``) and called through
its C entry on PyTorch's current stream, without synchronising.  Takes any
``S >= 1``, head widths 64 and 128, float32 or bfloat16; anything else raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take: shapes, dtypes, layout."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B,S,H,Dh) and k, v (B,S,Hkv,Dh); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, Dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != Dh or H % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "(same B, S, Dh; H a multiple of Hkv)"
        )
    if S < 1:
        raise ValueError("empty sequence")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not supported by the kernel; supported: {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes float32 or "
            "bfloat16, the same for q, k and v"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


# q, k, v, o; B, S, H, Hkv, Dh, dtype code, causal
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Launch K4 on CUDA tensors; returns ``o`` (B,S,H,Dh) in q's dtype."""
    check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd launches a CUDA kernel; tensors are on {q.device}")
    B, S, H, Dh = q.shape
    o = torch.empty_like(q)
    _build.launch(
        _build.entry(SOURCE, "flash_fwd", _ARGTYPES), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, H, k.shape[2], Dh, _DTYPE_CODES[q.dtype], int(causal),
    )
    return o
