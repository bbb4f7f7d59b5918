"""Plain PyTorch version of K2, the vectorized reorder-commit (paper §3,
fig. 4); the counterpart of ``repro.kernels.reorder.ref``.

State mirrors the non-blocking reorder buffer:
  buf     : (S, W) payload ring, slot i holds serial t with t % S == i
  present : (S,) bool
  next    : () int32 tensor, on the ring's device -- the serial number of
            the next output to send downstream

One ``commit_ref(state, serials, payloads)`` is the batched equivalent of K
workers calling ``send`` concurrently, followed by one drain:
  try_add : serial t accepted iff t >= 0 and next <= t < next + S
  drain   : emit the contiguous run of present slots starting at ``next``

Returns (new_state, emitted (S, W), emit_count () int32, accepted (K,) bool).
Rows of ``emitted`` at or past ``emit_count`` are zero.  The arithmetic is
int32 with wraparound, as the reference's.  The ring is the state: a commit
writes ``buf`` and ``present`` in place and returns those same tensors in
``new_state``, with ``next`` a new tensor, as kernel K2 does; the state passed
in is spent.  (The JAX reference returns new arrays; the values are the same.)
Nothing here reads a value back to the host, so it runs on the card without a
sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ReorderState(NamedTuple):
    buf: torch.Tensor  # (S, W)
    present: torch.Tensor  # (S,) bool
    next: torch.Tensor  # () int32


def init_state(size: int, width: int, dtype=torch.float32, start: int = 0,
               device=None) -> ReorderState:
    """An empty ring of ``size`` slots of ``width`` values, next = ``start``."""
    return ReorderState(
        buf=torch.zeros((size, width), dtype=dtype, device=device),
        present=torch.zeros((size,), dtype=torch.bool, device=device),
        next=torch.tensor(start, dtype=torch.int32, device=device),
    )


def commit_ref(state: ReorderState, serials: torch.Tensor, payloads: torch.Tensor):
    S, W = state.buf.shape
    nxt = state.next.to(torch.int32)
    serials = serials.to(torch.int32)

    # ---- try_add: entry condition (fig. 4 L16)
    in_window = (serials >= 0) & (serials >= nxt) & (serials < nxt + S)
    slot = torch.where(in_window, serials % S, S).long()  # S = dropped
    # scatter into a ring with one spare row that takes the dropped entries,
    # then back into the state's ring
    buf = torch.cat([state.buf, state.buf.new_zeros(1, W)])
    buf = state.buf.copy_(buf.index_copy_(0, slot, payloads.to(buf.dtype))[:S])
    present = torch.cat([state.present, state.present.new_zeros(1)])
    present = present.index_fill_(0, slot, True)[:S]

    # ---- drain: contiguous present prefix starting at ``next``
    idx = torch.arange(S, dtype=torch.int32, device=buf.device)
    pos = (idx - nxt) % S  # ring distance from head (floor-mod)
    emit_count = torch.where(present, S, pos).min()  # first gap == prefix length

    # emitted[i] = buf[(next + i) % S] for i < emit_count
    src = ((nxt + idx) % S).long()
    emitted = torch.where((idx < emit_count)[:, None], buf[src], buf.new_zeros(()))

    present = state.present.copy_(present & (pos >= emit_count))
    new_state = ReorderState(buf=buf, present=present, next=nxt + emit_count)
    return new_state, emitted, emit_count, in_window
