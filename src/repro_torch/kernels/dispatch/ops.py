"""Public K3 wrapper, the hybrid-queue dispatch (counterpart of
``repro.kernels.dispatch.ops``).

CPU tensors go to the plain :func:`~.ref.dispatch_ref`; CUDA tensors go to
kernel K3 or raise.  ``dispatch.LAUNCHES`` counts kernel launches (four per
call on the card), so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from .dispatch import LAUNCHES_PER_CALL, dispatch_fwd
from .ref import dispatch_ref


def dispatch(part_ids: torch.Tensor, payloads: torch.Tensor, num_partitions: int,
             capacity: int, *, use_kernel: bool = True):
    """Route tuples (arrival order = index) into bounded per-partition FIFO
    buffers.  ``part_ids`` (T,) holds a partition in [0, ``num_partitions``)
    or -1 for an invalid tuple; any other id is invalid too (dest -1,
    counted nowhere) on both routes.  Returns (buffers (P, C, W),
    counts (P,) int32, dest (T,) int32); see :mod:`.ref`.
    ``use_kernel=False`` takes the plain version on any device."""
    if not use_kernel or payloads.device.type == "cpu":
        return dispatch_ref(part_ids, payloads, num_partitions, capacity)
    out = dispatch_fwd(part_ids.to(torch.int32), payloads, num_partitions, capacity)
    dispatch.LAUNCHES += LAUNCHES_PER_CALL
    return out


dispatch.LAUNCHES = 0

__all__ = ["dispatch"]
