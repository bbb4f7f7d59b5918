"""K5: the hand-written Hopper SSD chunked scan (``csrc/ssd.cu``).

Counterpart of ``repro.kernels.ssd.ssd.ssd_pallas``, the Pallas TPU kernel.
One launch on PyTorch's current stream, no synchronisation.  The CUDA source
is compiled at first use (``kernels._build``).  Takes head width P and state
width N in {64, 128}, chunks of 1..512 rows that divide L, ``x`` in float32
or bfloat16 and the rest in float32; anything else raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
WIDTHS = (64, 128)  # P and N the kernel is built for
MAX_CHUNK = 512  # ssd_max_chunk() in the source
MAX_BATCH = 65535
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# x, dt, A, Bm, Cm, y, hT; B, L, H, P, N, chunk, x_bf16
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7
_CONSTANTS = (("ssd_max_chunk", MAX_CHUNK),)


def check_inputs(x, dt, A, Bm, Cm, chunk: int) -> None:
    """Raise on what the kernel does not take: shapes, dtypes, layout, devices."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L, H, P); got {tuple(x.shape)}")
    B, L, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (B, L, H), "A": (H,), "Bm": (B, L, N), "Cm": (B, L, N)}
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for x {tuple(x.shape)}; "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"head width P={P} and state width N={N}: the kernel takes {WIDTHS}")
    if not 1 <= chunk <= MAX_CHUNK or L < chunk or L % chunk:
        raise ValueError(f"chunk {chunk} must be 1..{MAX_CHUNK} and divide L={L}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"the kernel takes a batch of 1..{MAX_BATCH}, not {B}")
    tensors = (x, dt, A, Bm, Cm)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if x.device.type != "cuda":
        raise ValueError(f"ssd_fwd launches a CUDA kernel; tensors are on {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, dt, A, Bm and Cm must be contiguous")


def ssd_fwd(x, dt, A, Bm, Cm, chunk: int = 128):
    """Launch K5 on CUDA tensors.  Returns (y (B, L, H, P) in x's dtype,
    hT (B, H, P, N) float32)."""
    check_inputs(x, dt, A, Bm, Cm, chunk)
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    _build.launch(
        _build.entry(SOURCE, "ssd_launch", _ARGTYPES, _CONSTANTS), x.device,
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), hT.data_ptr(), B, L, H, P, N, chunk, _X_DTYPES[x.dtype],
    )
    return y, hT
