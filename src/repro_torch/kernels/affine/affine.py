"""K1: the hand-written Hopper kernel of the device stage's affine map
(``csrc/affine.cu``).

Counterpart of ``repro.columnar.device._jax_affine_pallas``, the Pallas TPU
kernel.  One launch covers every column of a staged batch (see
:class:`~.ref.Layout`), read from and written to wherever the buffers lie:
the card's memory, or pinned host memory, which the card reads and writes
over PCIe in place.  The device stage's route reads the batch from the
card's memory (the copy engine brought it there) and writes the pinned
output buffer: no copy out.  The CUDA source is compiled at first use
(``kernels._build``) and called through its C entry on PyTorch's current
stream, without synchronising.

The launch descriptor (:func:`descriptor`: the column codes, ``a`` and ``b``
in every form, and their checks) is built once per column layout and
``(a, b)`` and kept; a call then checks the two buffers and makes one ctypes
call.  Anything the kernel does not take raises: a buffer in pageable host
memory or on another card, a descriptor out of range, and asking for the
card where there is none.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build
from .ref import ALIGN, DTYPES, Layout, Scalars

SOURCE = Path(__file__).resolve().parent / "csrc" / "affine.cu"
MAX_COLS = 64  # kMaxCols in the source
VEC = 16  # bytes a thread moves at a time: the buffers' alignment


class _Params(ctypes.Structure):
    """The source's ``Params``; ``offset`` is filled by the C entry per call."""

    _fields_ = [
        ("offset", ctypes.c_longlong * MAX_COLS), ("code", ctypes.c_int * MAX_COLS),
        ("rows", ctypes.c_longlong), ("ai", ctypes.c_longlong), ("bi", ctypes.c_longlong),
        ("af", ctypes.c_double), ("bf", ctypes.c_double),
        ("af32", ctypes.c_float), ("bf32", ctypes.c_float),
        ("ncols", ctypes.c_int), ("a_float", ctypes.c_int), ("b_float", ctypes.c_int),
    ]


# src, dst, rows, nbytes, descriptor, start event, done event
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
_CONSTANTS = (("affine_params_bytes", ctypes.sizeof(_Params)), ("affine_align", ALIGN))


def _as_int64(v) -> int:
    # an int parameter that reaches the integer path fits the column type
    # (Scalars.check_ints); elsewhere its integer form is unused
    return v if type(v) is int and -(2**63) <= v < 2**63 else 0


def _key(v):
    # 3, 3.0 and True are equal dict keys, and so are 0.0 and -0.0; each
    # gives other bits, so the key holds the type and a float's exact bits
    return (type(v), v.hex() if type(v) is float else v)


def descriptor(codes, a, b) -> _Params:
    """K1's launch descriptor for columns of ``codes`` under ``a`` and ``b``
    (built on the first call for these, then kept and shared: read only; no
    card needed).  Raises where the kernel or NumPy would refuse: a width
    outside 1..64, a typed parameter, an int parameter out of an integer
    column's range."""
    return _descriptor(tuple(codes), _key(a), _key(b))


def _value(key):
    kind, v = key
    return float.fromhex(v) if kind is float else v


@functools.lru_cache(maxsize=256)
def _descriptor(codes, ka, kb) -> _Params:
    if not 1 <= len(codes) <= MAX_COLS:
        raise ValueError(f"the kernel takes 1..{MAX_COLS} columns, not {len(codes)}")
    s = Scalars.of(_value(ka), _value(kb))
    for code in set(codes):
        if code not in DTYPES:
            raise ValueError(f"no column type for code {code}")
        if DTYPES[code] in (torch.int64, torch.int32):
            s.check_ints(DTYPES[code])
    p = _Params()
    p.code[: len(codes)] = codes
    p.ncols = len(codes)
    p.ai, p.bi = _as_int64(s.a), _as_int64(s.b)
    p.af, p.bf, p.af32, p.bf32 = s.af, s.bf, s.af32, s.bf32
    p.a_float, p.b_float = int(s.a_float), int(s.b_float)
    return p


@functools.cache
def _entry():
    """The typed C entry (looked up once: ``_build.entry`` hashes its
    arguments on every call)."""
    return _build.entry(SOURCE, "affine_launch", _ARGTYPES, _CONSTANTS)


def _check(name: str, t: torch.Tensor, layout: Layout, device: torch.device) -> None:
    if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D uint8 buffer")
    if t.numel() < layout.nbytes:
        raise ValueError(f"{name} holds {t.numel()} bytes, the layout needs {layout.nbytes}")
    if t.data_ptr() % VEC:
        raise ValueError(f"{name} is not {VEC}-byte aligned")
    if t.is_cuda:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; the launch is on {device}")
    elif t.device.type != "cpu" or not t.is_pinned():
        raise ValueError(f"{name} lies in pageable host memory ({t.device}); K1 reads and "
                         "writes the card's memory or pinned host memory only")


def affine_fwd(src: torch.Tensor, layout: Layout, a, b, dst: torch.Tensor,
               device="cuda", events=None) -> torch.Tensor:
    """Launch K1 on ``device`` (a card) over every column of ``src`` (uint8)
    into the same places of ``dst``; returns ``dst``.  Each buffer lies in
    that card's memory or in pinned host memory, in any mix.  ``events``, two
    ``torch.cuda.Event`` objects recorded once before, are recorded on the
    stream right before and right after the launch, inside the C entry, so
    that no host work sits between the kernel and them."""
    params = descriptor(layout.codes, a, b)
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"affine_fwd launches a CUDA kernel; asked for {device}")
    on_card = src.is_cuda or dst.is_cuda
    if not on_card and not torch.cuda.is_available():
        raise RuntimeError("K1 runs on an NVIDIA GPU and none is available; ask for "
                           "device='cpu' to run the plain version")
    if device.index is None and on_card:
        device = torch.device("cuda", torch.cuda.current_device())
    _check("src", src, layout, device)
    _check("dst", dst, layout, device)
    start, done = (ev.cuda_event for ev in events) if events else (None, None)
    _build.launch(_entry(), device, src.data_ptr(), dst.data_ptr(), layout.rows,
                  layout.nbytes, ctypes.byref(params), start, done)
    return dst
