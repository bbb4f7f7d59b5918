"""Int8 error-feedback gradient compression for the data-parallel all-reduce
(port of ``repro.train.grad_compression``).

Each rank quantizes its gradient (plus the residual it carried from the
last step) to int8 with one symmetric scale per tensor, all-gathers the
int8 payloads and the scales over a ``torch.distributed`` group (a quarter
of the bytes of an f32 all-reduce on the wire), dequantizes and sums them
locally, and keeps its quantization residual as error feedback for the next
step (Karimireddy et al.: error feedback removes the bias of the
quantizer).  :func:`make_compressed_allreduce` runs it over a process group
(gloo on the CPU, NCCL on cards); :func:`make_compressed_psum` over a
mesh's ``pod`` dim, on each DTensor leaf's local shard, as the reference
runs it inside ``shard_map``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..sharding.partitioning import _spec_map, sanitize_spec, to_placements
from ..tree import tree_map


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns (q, scale).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_allreduce_leaf(
    g: torch.Tensor, err: torch.Tensor, group: Optional[dist.ProcessGroup] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's compressed all-reduce over ``group`` (the default group
    when None).  Returns (the sum over ranks in g's dtype, the new f32
    error-feedback residual)."""
    g32 = g.to(torch.float32) + err
    q, scale = _quantize(g32)
    new_err = g32 - _dequantize(q, scale)
    world = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(world)]
    scales = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(scales, scale, group=group)
    total = torch.tensordot(torch.stack(scales), torch.stack(qs).to(torch.float32),
                            dims=([0], [0]))
    return total.to(g.dtype), new_err


def make_compressed_allreduce(group: Optional[dist.ProcessGroup] = None):
    """Returns fn(grads, err_state) -> (summed grads, new err_state) over a
    nested dict of gradient tensors, one compressed all-reduce a leaf."""

    def summed(grads: Any, err: Any) -> tuple[Any, Any]:
        if isinstance(grads, dict):
            outs = {k: summed(grads[k], err[k]) for k in grads}
            return {k: o[0] for k, o in outs.items()}, {k: o[1] for k, o in outs.items()}
        return compress_allreduce_leaf(grads, err, group)

    return summed


def make_compressed_psum(mesh, param_pspecs: Any, abstract_params: Any):
    """Returns fn(grads, err_state) -> (summed grads, new err_state): the
    int8 error-feedback sum over the mesh's 'pod' dim.  Each leaf is a
    DTensor on the (sanitized) param spec, which names no 'pod': its local
    shard is summed over the ranks of its 'pod' group, and the sum and the
    residual come back as DTensors on the same placements."""
    group = mesh.get_group("pod")
    placements = _spec_map(
        lambda s, a: to_placements(mesh, sanitize_spec(mesh, s, tuple(a.shape))),
        param_pspecs, abstract_params)

    def summed(grads: Any, err: Any) -> tuple[Any, Any]:
        def leaf(g, e, pl):
            local = lambda t: (t.redistribute(mesh, pl) if isinstance(t, DTensor)
                               else t).to_local()
            s, ne = compress_allreduce_leaf(local(g), local(e), group)
            wrap = lambda t, like: DTensor.from_local(t, mesh, pl, run_check=False,
                                                      shape=like.shape, stride=like.stride())
            return wrap(s, g), wrap(ne, e)

        def walk(g, e, pl):
            if isinstance(g, dict):
                outs = {k: walk(g[k], e[k], pl[k]) for k in g}
                return {k: o[0] for k, o in outs.items()}, {k: o[1] for k, o in outs.items()}
            return leaf(g, e, pl)

        return walk(grads, err, placements)

    return summed


def init_error_state(params: Any) -> Any:
    """Zero f32 residuals shaped like ``params``, on their devices."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


__all__ = ["compress_allreduce_leaf", "init_error_state", "make_compressed_allreduce",
           "make_compressed_psum"]
