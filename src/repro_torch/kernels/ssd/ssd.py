"""K5: the hand-written Hopper SSD chunked scan (``csrc/ssd.cu``).

Counterpart of ``repro.kernels.ssd.ssd.ssd_pallas``, the Pallas TPU kernel.
:data:`LAUNCHES_PER_CALL` launches on PyTorch's current stream (chunk
states, state passing, chunk outputs), no synchronisation; the wrapper
allocates the scratch they share.  The CUDA source is compiled at first use
(``kernels._build``).  Takes head width P and state width N in {64, 128},
chunks of 1..512 rows that divide L, ``x`` in float32 or bfloat16 and the
rest in float32; anything else raises.
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
LAUNCHES_PER_CALL = 3  # ssd_launches_per_call() in the source
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# x, dt, A, Bm, Cm, y, hT, states, cum, decay; B, L, H, P, N, chunk, x_bf16
_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7
_CONSTANTS = (("ssd_max_chunk", MAX_CHUNK), ("ssd_launches_per_call", LAUNCHES_PER_CALL))


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernel copies 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_args(x, dt, A, Bm, Cm, chunk: int) -> tuple:
    """(y, hT, (args, keep)) for one scan of checked inputs: the outputs,
    the C entry's arguments (``ssd_launch``'s, or ``ssd_launch_step``'s
    after the step) and the tensors they point into, scratch included, to
    keep alive until the launch is queued."""
    check_inputs(x, dt, A, Bm, Cm, chunk)
    x, Bm, Cm = (_aligned(t) for t in (x, Bm, Cm))
    B, L, H, P = x.shape
    N, nc = Bm.shape[-1], L // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    hT = torch.empty((B, H, P, N), **f32)
    states = torch.empty((B, nc, H, P, N), **f32)  # S of each chunk, then the state before it
    cum = torch.empty((B, L, H), dtype=torch.float64, device=x.device)  # cumsum(dt A) in each chunk
    decay = torch.empty((B, nc, H), **f32)  # exp of each chunk's total log-decay
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), hT.data_ptr(), states.data_ptr(), cum.data_ptr(), decay.data_ptr(),
            B, L, H, P, N, chunk, _X_DTYPES[x.dtype])
    return y, hT, (args, (x, Bm, Cm, states, cum, decay))


def ssd_fwd(x, dt, A, Bm, Cm, chunk: int = 128):
    """Launch K5 on CUDA tensors.  Returns (y (B, L, H, P) in x's dtype,
    hT (B, H, P, N) float32)."""
    y, hT, (args, _keep) = launch_args(x, dt, A, Bm, Cm, chunk)
    _build.launch(_build.entry(SOURCE, "ssd_launch", _ARGTYPES, _CONSTANTS), x.device, *args)
    return y, hT
