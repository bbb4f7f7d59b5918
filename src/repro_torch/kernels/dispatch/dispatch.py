"""K3: the hand-written Hopper hybrid-queue dispatch (``csrc/dispatch.cu``).

Counterpart of ``repro.kernels.dispatch.dispatch.dispatch_pallas``, the
Pallas TPU kernel.  A call is one launch on PyTorch's current stream (every
block ranks the tuples of its partition itself, then writes its buffer
rows), with no synchronisation.  Tuple t's payload is row ``t // group`` of
``payloads``, so a caller with k tuples per row (the MoE layer's k choices a
token) hands over its rows as they are.  The CUDA source is compiled at
first use (``kernels._build``).  Takes up to :data:`MAX_TUPLES` tuples and
:data:`MAX_PARTITIONS` partitions, rows of any width and dtype (they are
copied as bytes); anything else raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "dispatch.cu"
LAUNCHES_PER_CALL = 1  # dispatch_launches_per_call() in the source
MAX_PARTITIONS = 1024  # dispatch_max_partitions() in the source
MAX_TUPLES = 1 << 20

# ids, T, payloads, group, row_bytes, P, C, buffers, counts, dest
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
)
_CONSTANTS = (("dispatch_launches_per_call", LAUNCHES_PER_CALL),
              ("dispatch_max_partitions", MAX_PARTITIONS))


def check_inputs(part_ids: torch.Tensor, payloads: torch.Tensor, num_partitions: int,
                 capacity: int, group: int = 1) -> None:
    """Raise on what the kernel does not take: sizes, dtypes, layout, devices."""
    if part_ids.dim() != 1 or part_ids.dtype != torch.int32:
        raise ValueError(f"part_ids must be (T,) int32; got {tuple(part_ids.shape)} {part_ids.dtype}")
    T = part_ids.shape[0]
    if group < 1 or T % group:
        raise ValueError(f"group {group}: needs 1 <= group dividing T = {T}")
    if payloads.dim() != 2 or payloads.shape[0] * group != T or payloads.shape[1] < 1:
        raise ValueError(f"payloads must be ({T // max(group, 1)}, W) with W >= 1 (T / group "
                         f"rows); got {tuple(payloads.shape)}")
    if not 1 <= T <= MAX_TUPLES:
        raise ValueError(f"the kernel takes 1..{MAX_TUPLES} tuples, not {T}")
    if not 1 <= num_partitions <= MAX_PARTITIONS:
        raise ValueError(f"the kernel takes 1..{MAX_PARTITIONS} partitions, not {num_partitions}")
    if capacity < 1 or num_partitions * capacity > 2**31 - 1:
        raise ValueError(f"capacity {capacity}: needs 1 <= C and P * C < 2**31")
    if part_ids.device != payloads.device:
        raise ValueError(f"part_ids on {part_ids.device}, payloads on {payloads.device}")
    if payloads.device.type != "cuda":
        raise ValueError(f"dispatch_fwd launches a CUDA kernel; tensors are on {payloads.device}")
    if not (part_ids.is_contiguous() and payloads.is_contiguous()):
        raise ValueError("part_ids and payloads must be contiguous")


def dispatch_fwd(part_ids: torch.Tensor, payloads: torch.Tensor, num_partitions: int,
                 capacity: int, group: int = 1):
    """Launch K3 on CUDA tensors: tuple t takes payload row ``t // group``.
    Returns (buffers (P, C, W), counts (P,) int32, dest (T,) int32), the
    only tensors it allocates."""
    check_inputs(part_ids, payloads, num_partitions, capacity, group)
    T = part_ids.shape[0]
    W = payloads.shape[1]
    P, C = num_partitions, capacity
    dev = payloads.device
    buffers = torch.empty((P, C, W), dtype=payloads.dtype, device=dev)
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    dest = torch.empty(T, dtype=torch.int32, device=dev)
    _build.launch(
        _build.entry(SOURCE, "dispatch_launch", _ARGTYPES, _CONSTANTS), dev,
        part_ids.data_ptr(), T, payloads.data_ptr(), group, W * payloads.element_size(), P, C,
        buffers.data_ptr(), counts.data_ptr(), dest.data_ptr(),
    )
    return buffers, counts, dest
