"""Plain PyTorch version of K1, ``o = x * a + b`` per column, and the staging
layout K1 shares with it.

It is the only route on the CPU and the yardstick that K1 is held to on the
card.  It must equal ``repro.columnar.device._np_affine`` bit for bit, so it
takes NumPy 2's arithmetic (NEP 50) and not torch's:

- an int parameter applied to an ``i8``/``i4`` column stays in the column's
  integer type and wraps on overflow; one that does not fit the column's
  type raises ``OverflowError``, as NumPy does;
- a float parameter applied to an integer column moves the computation to
  float64 (torch would pick float32), truncated back to the column's type;
- an ``f4`` column computes in float32 with ``a`` and ``b`` rounded to
  float32, an ``f8`` column in float64;
- the product is rounded before the sum (two operations, no fused
  multiply-add).

Only Python ``int``/``float`` (and ``bool``) parameters are taken: a NumPy
scalar is a typed operand under NEP 50 and promotes differently.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

#: dtype code of each column type, as the columnar wire bytes
CODES = {torch.int64: 0, torch.float64: 1, torch.int32: 2, torch.float32: 3}
DTYPES = {code: dt for dt, code in CODES.items()}
# byte alignment of every column in a staging buffer: a 128-byte line, so
# that K1's stores into a pinned buffer leave the card as whole lines
ALIGN = 128

_INT_RANGE = {torch.int64: (-(2**63), 2**63 - 1), torch.int32: (-(2**31), 2**31 - 1)}


@dataclass(frozen=True)
class Scalars:
    """``a`` and ``b`` in every form a column type may need them."""

    a_float: bool
    b_float: bool
    a: object  # the Python values, for the integer paths
    b: object
    af: float  # float64 values
    bf: float
    af32: float  # the float32 roundings, as Python floats
    bf32: float

    @classmethod
    def of(cls, a, b) -> "Scalars":
        vals = []
        for name, v in (("a", a), ("b", b)):
            if type(v) is bool:
                v = int(v)
            if type(v) not in (int, float):
                raise TypeError(
                    f"affine parameter {name}={v!r} ({type(v).__name__}): "
                    "only Python int and float parameters are taken"
                )
            vals.append(v)
        a, b = vals
        with np.errstate(over="ignore"):  # beyond float32: inf, as NumPy gives
            af32, bf32 = float(np.float32(a)), float(np.float32(b))
        return cls(type(a) is float, type(b) is float, a, b, float(a), float(b), af32, bf32)

    def check_ints(self, dtype: torch.dtype) -> None:
        """Raise ``OverflowError`` where NumPy would: an int parameter that
        the integer column's type cannot hold, on the integer path."""
        lo, hi = _INT_RANGE[dtype]
        names = ("a", "b") if not self.a_float else ()
        for name in names:
            v = getattr(self, name)
            if type(v) is int and not lo <= v <= hi:
                raise OverflowError(
                    f"affine parameter {name}={v} out of bounds for {dtype}"
                )


def _scalar(v, dtype: torch.dtype) -> torch.Tensor:
    # a 0-dim CPU tensor of the exact operand type; torch takes it beside
    # CUDA tensors too, without a copy to the card
    return torch.tensor(v, dtype=dtype)


def affine_ref(x: torch.Tensor, a, b) -> torch.Tensor:
    """``x * a + b`` on one column, with NumPy's types and roundings."""
    s = Scalars.of(a, b)
    dt = x.dtype
    if dt == torch.float64:
        return x * _scalar(s.af, dt) + _scalar(s.bf, dt)
    if dt == torch.float32:
        return x * _scalar(s.af32, dt) + _scalar(s.bf32, dt)
    if dt not in _INT_RANGE:
        raise TypeError(f"affine takes int64/int32/float64/float32 columns, not {dt}")
    s.check_ints(dt)
    if s.a_float:
        return (x.double() * _scalar(s.af, torch.float64) + _scalar(s.bf, torch.float64)).to(dt)
    prod = x * _scalar(s.a, dt)
    if s.b_float:
        return (prod.double() + _scalar(s.bf, torch.float64)).to(dt)
    return prod + _scalar(s.b, dt)


@dataclass(frozen=True)
class Layout:
    """Where a batch's columns lie in one staging buffer (uint8): column
    ``j`` holds ``rows`` values of ``DTYPES[codes[j]]`` from byte
    ``offsets[j]``, a multiple of :data:`ALIGN`, one column after another."""

    codes: Tuple[int, ...]
    rows: int
    offsets: Tuple[int, ...]
    nbytes: int

    @classmethod
    def of(cls, dtypes: Sequence[torch.dtype], rows: int) -> "Layout":
        codes, offsets, off = [], [], 0
        for dt in dtypes:
            if dt not in CODES:
                raise TypeError(f"no column code for {dt} (codes: {CODES})")
            codes.append(CODES[dt])
            offsets.append(off)
            off += -(-rows * dt.itemsize // ALIGN) * ALIGN
        return cls(tuple(codes), int(rows), tuple(offsets), off)

    @property
    def width(self) -> int:
        return len(self.codes)

    def column(self, buf: torch.Tensor, j: int) -> torch.Tensor:
        """Column ``j`` of ``buf`` as a typed view (no copy)."""
        dt = DTYPES[self.codes[j]]
        off = self.offsets[j]
        return buf[off : off + self.rows * dt.itemsize].view(dt)

    def stage(self, cols: Sequence[torch.Tensor]) -> torch.Tensor:
        """A new buffer on the columns' device holding ``cols`` at this layout."""
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=cols[0].device)
        for j, c in enumerate(cols):
            self.column(buf, j).copy_(c)
        return buf


class _HostMapped:
    """A pinned host buffer as the card addresses it: with unified
    addressing, pinned memory is mapped into the card's address space at its
    host address, and ``__cuda_array_interface__`` hands that to torch."""

    def __init__(self, t: torch.Tensor):
        self._keep = t
        self.__cuda_array_interface__ = {
            "shape": (t.numel(),), "typestr": "|u1", "data": (t.data_ptr(), False),
            "version": 2}


def on_device(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The staging buffer ``buf`` (uint8, 1-D) as a tensor of ``device``,
    without a copy: a buffer already there as it is, a pinned host buffer as
    the card's view of it (torch's kernels then read and write it over
    PCIe).  Any other placement raises."""
    if buf.device.type == device.type:
        return buf
    if device.type == "cuda" and buf.device.type == "cpu" and buf.is_pinned():
        return torch.as_tensor(_HostMapped(buf), device=device)
    raise ValueError(f"a buffer on {buf.device} (pinned: {buf.is_pinned()}) cannot be "
                     f"worked on by {device} in place")


def affine_staged_ref(src: torch.Tensor, layout: Layout, a, b,
                      dst: torch.Tensor) -> torch.Tensor:
    """The plain version of K1's launch: every column of ``src`` through
    :func:`affine_ref` into the same place in ``dst``; returns ``dst``."""
    for j in range(layout.width):
        layout.column(dst, j).copy_(affine_ref(layout.column(src, j), a, b))
    return dst
