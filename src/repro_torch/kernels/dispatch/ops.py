"""Public K3 wrapper, the hybrid-queue dispatch (counterpart of
``repro.kernels.dispatch.ops``).

CPU tensors go to the plain :func:`~.ref.dispatch_ref`, which autograd
differentiates as it is; CUDA tensors go to kernel K3 or raise.  On the card
the kernel sits in :class:`Dispatch`, a ``torch.autograd.Function`` whose
backward is the plain gather ``grad_rows[t] = grad_buffers.flat[dest[t]]``
(zero where ``dest`` is -1), with each payload row's ``group`` adjacent
tuples summed in a fixed order: K3 fills its buffers through ctypes, so
without it nothing upstream of a dispatch would get a gradient.
``dispatch.LAUNCHES`` counts kernel launches (one a call), so a run can
show that its path went through the kernel; the backward launches no kernel
of its own.
"""
from __future__ import annotations

import torch

from .dispatch import LAUNCHES_PER_CALL, dispatch_fwd
from .ref import dispatch_ref


class Dispatch(torch.autograd.Function):
    """K3 forward, gather backward; differentiable in ``payloads`` only."""

    @staticmethod
    def forward(ctx, part_ids, payloads, num_partitions, capacity, group=1):
        buffers, counts, dest = Dispatch.forward_fn(part_ids, payloads, num_partitions, capacity,
                                                    group)
        ctx.save_for_backward(dest)
        ctx.group = group
        ctx.mark_non_differentiable(counts, dest)
        return buffers, counts, dest

    @staticmethod
    def backward(ctx, grad_buffers, _grad_counts, _grad_dest):
        (dest,) = ctx.saved_tensors
        W = grad_buffers.shape[-1]
        flat = grad_buffers.reshape(-1, W)
        keep = (dest >= 0)[:, None]
        grad = flat[dest.clamp(min=0).long()] * keep.to(flat.dtype)
        # a row's `group` tuples are adjacent: sum them in a fixed order (a
        # scatter-add, index_add_, adds with atomics on the card, in an order
        # that changes from run to run)
        grad = grad.reshape(-1, ctx.group, W).sum(dim=1)
        return None, grad, None, None, None

    forward_fn = staticmethod(dispatch_fwd)  # the kernel; tests swap in the plain version


def dispatch(part_ids: torch.Tensor, payloads: torch.Tensor, num_partitions: int,
             capacity: int, *, group: int = 1, use_kernel: bool = True):
    """Route tuples (arrival order = index) into bounded per-partition FIFO
    buffers.  ``part_ids`` (T,) holds a partition in [0, ``num_partitions``)
    or -1 for an invalid tuple; any other id is invalid too (dest -1,
    counted nowhere) on both routes.  Tuple t's payload is row
    ``t // group`` of ``payloads`` (T / group, W).  Returns (buffers
    (P, C, W), counts (P,) int32, dest (T,) int32); see :mod:`.ref`.
    ``use_kernel=False`` takes the plain version on any device."""
    if not use_kernel or payloads.device.type == "cpu":
        return dispatch_ref(part_ids, payloads, num_partitions, capacity, group)
    out = Dispatch.apply(part_ids.to(torch.int32), payloads, num_partitions, capacity, group)
    dispatch.LAUNCHES += LAUNCHES_PER_CALL
    return out


dispatch.LAUNCHES = 0

__all__ = ["Dispatch", "dispatch"]
