"""K2: the hand-written Hopper reorder-commit (``csrc/reorder.cu``).

Counterpart of ``repro.kernels.reorder.reorder.commit_pallas``, the Pallas
TPU kernel.  One launch a commit on PyTorch's current stream: every block
finds the count itself from the old present flags and the batch's serials,
then scatters its share of the entries and writes its rows of ``emitted``
(the source's header says how, with no grid-wide barrier).  ``next`` and the
count stay on the card, and nothing synchronises.  The ring's ``buf`` and
``present`` are updated in place; ``next`` + count is a new scalar.  The
kernel keeps one completion ticket per device (a 4-byte counter that each
commit leaves at 0), so commits on one device must not run at the same time
on two streams.  The CUDA source is compiled at first use
(``kernels._build``).  Anything the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import ReorderState

SOURCE = Path(__file__).resolve().parent / "csrc" / "reorder.cu"
LAUNCHES_PER_CALL = 1  # commit_launches_per_call() in the source
MAX_SLOTS = 2**30  # commit_max_slots()


# serials, K, payloads, buf, present, next, S, row_bytes, accepted, emitted,
# count, next_out, ticket
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
)
_CONSTANTS = (("commit_launches_per_call", LAUNCHES_PER_CALL), ("commit_max_slots", MAX_SLOTS))
_TICKETS: dict[torch.device, torch.Tensor] = {}  # device -> the kernel's completion counter


def _ticket(device: torch.device) -> torch.Tensor:
    """The device's completion counter, made (zeroed) at its first commit."""
    if device not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("commit K2 once on this device before capturing it in a CUDA graph")
        _TICKETS[device] = torch.zeros((), dtype=torch.int32, device=device)
    return _TICKETS[device]


def check_inputs(state: ReorderState, serials: torch.Tensor, payloads: torch.Tensor) -> None:
    """Raise on what the kernel does not take: shapes, dtypes, layout, devices."""
    buf, present, nxt = state
    if buf.dim() != 2 or buf.shape[0] < 1 or buf.shape[1] < 1:
        raise ValueError(f"buf must be (S, W) with S, W >= 1; got {tuple(buf.shape)}")
    S, W = buf.shape
    if S > MAX_SLOTS:
        raise ValueError(f"the kernel takes at most {MAX_SLOTS} slots, not {S}")
    if present.shape != (S,) or present.dtype != torch.bool:
        raise ValueError(f"present must be ({S},) bool; got {tuple(present.shape)} {present.dtype}")
    if nxt.shape != () or nxt.dtype != torch.int32:
        raise ValueError(f"next must be a 0-d int32 tensor; got {tuple(nxt.shape)} {nxt.dtype}")
    if serials.dim() != 1 or serials.dtype != torch.int32:
        raise ValueError(f"serials must be (K,) int32; got {tuple(serials.shape)} {serials.dtype}")
    if payloads.shape != (serials.shape[0], W):
        raise ValueError(f"payloads must be ({serials.shape[0]}, {W}); got {tuple(payloads.shape)}")
    if payloads.dtype != buf.dtype:
        raise TypeError(f"payloads are {payloads.dtype}, the ring holds {buf.dtype}")
    tensors = (buf, present, nxt, serials, payloads)
    if any(t.device != buf.device for t in tensors):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if buf.device.type != "cuda":
        raise ValueError(f"commit_fwd launches a CUDA kernel; tensors are on {buf.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("buf, present, serials and payloads must be contiguous")


def commit_fwd(state: ReorderState, serials: torch.Tensor, payloads: torch.Tensor):
    """Launch K2 on CUDA tensors.  Returns (new_state, emitted (S, W),
    count () int32, accepted (K,) bool); ``new_state`` holds the same
    ``buf`` and ``present`` tensors, updated in place."""
    check_inputs(state, serials, payloads)
    buf, present, nxt = state
    S, W = buf.shape
    K = serials.shape[0]
    dev = buf.device
    emitted = torch.empty_like(buf)
    accepted = torch.empty(K, dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    next_out = torch.empty((), dtype=torch.int32, device=dev)
    _build.launch(
        _build.entry(SOURCE, "commit_launch", _ARGTYPES, _CONSTANTS), dev,
        serials.data_ptr(), K, payloads.data_ptr(), buf.data_ptr(), present.data_ptr(),
        nxt.data_ptr(), S, W * buf.element_size(), accepted.data_ptr(),
        emitted.data_ptr(), count.data_ptr(), next_out.data_ptr(), _ticket(dev).data_ptr(),
    )
    return ReorderState(buf, present, next_out), emitted, count, accepted
