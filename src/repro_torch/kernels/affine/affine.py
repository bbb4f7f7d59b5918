"""K1: the hand-written Hopper kernel of the device stage's affine map
(``csrc/affine.cu``).

Counterpart of ``repro.columnar.device._jax_affine_pallas``, the Pallas TPU
kernel.  One launch covers every column of a staged batch (see
:class:`~.ref.Layout`).  The CUDA source is compiled at first use
(``kernels._build``) and called through its C entry on PyTorch's current
stream, without synchronising.  Anything the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import ALIGN, Layout, Scalars, DTYPES

SOURCE = Path(__file__).resolve().parent / "csrc" / "affine.cu"
MAX_COLS = 64  # kMaxCols in the source


# src, dst; ncols, offsets, rows, codes; ai, bi, af, bf, af32, bf32,
# a_float, b_float
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ctypes.POINTER(ctypes.c_int),
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
)


def _as_int64(v) -> int:
    # an int parameter that reaches the integer path fits the column type
    # (Scalars.check_ints); elsewhere its integer form is unused
    return v if type(v) is int and -(2**63) <= v < 2**63 else 0


def affine_fwd(src: torch.Tensor, layout: Layout, a, b, dst: torch.Tensor) -> torch.Tensor:
    """Launch K1 over every column of ``src`` (uint8, CUDA) into the same
    places of ``dst``; returns ``dst``."""
    for name, t in (("src", src), ("dst", dst)):
        if t.device.type != "cuda":
            raise ValueError(f"affine_fwd launches a CUDA kernel; {name} is on {t.device}")
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 buffer")
        if t.numel() < layout.nbytes:
            raise ValueError(f"{name} holds {t.numel()} bytes, the layout needs {layout.nbytes}")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} is not {ALIGN}-byte aligned")
    if src.device != dst.device:
        raise ValueError(f"src on {src.device}, dst on {dst.device}")
    if not 1 <= layout.width <= MAX_COLS:
        raise ValueError(f"the kernel takes 1..{MAX_COLS} columns, not {layout.width}")
    s = Scalars.of(a, b)
    for code in set(layout.codes):
        if DTYPES[code] in (torch.int64, torch.int32):
            s.check_ints(DTYPES[code])
    n = layout.width
    offsets = (ctypes.c_longlong * n)(*layout.offsets)
    rows = (ctypes.c_longlong * n)(*([layout.rows] * n))
    codes = (ctypes.c_int * n)(*layout.codes)
    _build.launch(
        _build.entry(SOURCE, "affine_launch", _ARGTYPES), src.device,
        src.data_ptr(), dst.data_ptr(), n, offsets, rows, codes,
        _as_int64(s.a), _as_int64(s.b), s.af, s.bf, s.af32, s.bf32,
        int(s.a_float), int(s.b_float),
    )
    return dst
