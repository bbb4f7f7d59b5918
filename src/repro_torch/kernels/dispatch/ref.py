"""Plain PyTorch version of K3, the vectorized hybrid-queue dispatch (paper
§4.3); the counterpart of ``repro.kernels.dispatch.ref``.

Given tuples in arrival order with partition ids, produce per-partition FIFO
buffers with bounded capacity:

  buffers[p, r] = payload of the r-th tuple (in arrival order) routed to p
  counts[p]     = number of tuples routed to p (before the capacity clamp)
  dest[t]       = p * capacity + rank, or -1 if invalid or dropped
                  (rank >= capacity)

Buffer rows that no tuple fills are zero.  Arrival order within a partition
is kept: the master-queue property (Theorem 4.1(2)); the capacity is the
bounded-delegation analogue.

A partition id outside [0, P) is invalid (dest -1, counted nowhere), here and
in kernel K3.  The JAX reference counts such an id nowhere too but gives it a
dest past the end of the buffers; for ids in [0, P) and -1 the two agree.
"""
from __future__ import annotations

import torch


def dispatch_ref(part_ids: torch.Tensor, payloads: torch.Tensor, num_partitions: int,
                 capacity: int):
    """part_ids (T,) int32, -1 (or any id outside [0, P)) = invalid;
    payloads (T, W).  Returns (buffers (P, C, W) in the payloads' dtype,
    counts (P,) int32, dest (T,) int32)."""
    T, W = payloads.shape
    P, C = num_partitions, capacity
    part_ids = part_ids.to(torch.int32)
    valid = (part_ids >= 0) & (part_ids < P)
    ids = torch.where(valid, part_ids, P)
    # one-hot with an extra column that takes the invalid tuples
    onehot = torch.zeros((T, P + 1), dtype=torch.int32, device=payloads.device)
    onehot = onehot.scatter_(1, ids.long()[:, None], 1)[:, :P]
    # rank = number of earlier tuples in the same partition (stable order)
    cum = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # exclusive prefix count
    rank = torch.gather(cum, 1, ids.clamp(0, P - 1).long()[:, None])[:, 0]
    counts = onehot.sum(dim=0, dtype=torch.int32)
    keep = valid & (rank < C)
    dest = torch.where(keep, ids * C + rank, -1).to(torch.int32)

    # scatter with one spare row that takes the invalid and dropped tuples
    slot = torch.where(keep, dest, P * C).long()
    buffers = payloads.new_zeros((P * C + 1, W)).index_copy_(0, slot, payloads)
    return buffers[: P * C].reshape(P, C, W), counts, dest
