"""Current-mesh context for in-model sharding constraints (port of
``repro.sharding.context``).

Model code calls ``shard(x, "dp", None, "tp", None)`` with *logical* dims;
this resolves them against the current mesh ("dp" -> ('pod', 'data') when
the pod dim exists, else 'data'; "tp" -> 'model') and redistributes a
DTensor to the result, where JAX places a ``with_sharding_constraint``.  It
returns its input unchanged when no mesh is set or the input is a plain
tensor, and leaves a dim replicated when the mesh dims do not divide it.
"""
from __future__ import annotations

import contextlib
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .partitioning import _axes_size, to_placements
from .spec import P

_CURRENT: list = [None]


def set_mesh(mesh) -> None:
    _CURRENT[0] = mesh


def get_mesh():
    return _CURRENT[0]


@contextlib.contextmanager
def use_mesh(mesh):
    prev = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield
    finally:
        _CURRENT[0] = prev


@contextlib.contextmanager
def mesh_scope():
    """The model's entry points run in this: under a mesh, plain tensors
    made inside the model (masks, positions, zeros) count as replicated
    beside DTensors (DTensor's implicit replication, restored on exit so
    that scopes nest: ``implicit_replication()`` resets it); without a mesh
    it does nothing."""
    if _CURRENT[0] is None:
        yield
        return
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


def logical_spec(mesh, shape: tuple, dims) -> P:
    """``dims`` ("dp" | "tp" | None per tensor dim) resolved on ``mesh``;
    every dim replicated when ``mesh`` is None."""
    if mesh is None:
        return P(*([None] * len(dims)))
    spec = []
    for size, d in zip(shape, dims):
        if d == "dp":
            axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
        elif d == "tp":
            axes = "model"
        else:
            axes = None
        if axes is not None and size % _axes_size(mesh, axes) != 0:
            axes = None  # non-divisible: left replicated
        spec.append(axes)
    return P(*spec)


def shard(x: torch.Tensor, *dims) -> torch.Tensor:
    """Constrain ``x`` with logical dims: "dp" | "tp" | None per axis."""
    mesh = _CURRENT[0]
    if mesh is None or not isinstance(x, DTensor):
        return x
    # redistributed also when x already has these placements: the autograd
    # node then gives the gradient the same placements (as a JAX constraint
    # binds the cotangent too)
    return x.redistribute(x.device_mesh, to_placements(mesh, logical_spec(mesh, x.shape, dims)))


def local_apply(fn, args: tuple, specs: tuple, out_specs):
    """``fn`` on each rank's pieces of ``args`` (DTensors, or plain tensors
    taken as replicated), where ``fn`` is local per piece: ``specs`` gives
    each argument's spec (``P``: mesh dim names per tensor dim) on the
    current mesh, ``out_specs`` the outputs' (one spec, or a tuple of them).
    The inputs are redistributed to their specs first.  Gradients follow:
    an input whole on a mesh dim that cuts an output gets a partial sum
    there (each rank's gradient covers its own piece of the work).  With
    no mesh set, or no DTensor among ``args``, it is ``fn(*args)``."""
    mesh = _CURRENT[0]
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    many = isinstance(out_specs, tuple) and not isinstance(out_specs, P)
    outs = [to_placements(mesh, s) for s in (out_specs if many else (out_specs,))]
    ins = [to_placements(mesh, s) for s in specs]
    cut = [any(isinstance(o[j], Shard) for o in outs) for j in range(mesh.ndim)]
    grads = [tuple(Partial() if cut[j] and isinstance(p, Replicate) else p
                   for j, p in enumerate(pl)) for pl in ins]
    whole = [Replicate()] * mesh.ndim
    args = tuple(a if isinstance(a, DTensor) else DTensor.from_local(a, mesh, whole)
                 for a in args)
    # outputs always as a tuple (one placements tuple each): local_map reads
    # a lone placements list as one output in some torch versions and as a
    # list of outputs in others
    out = local_map(lambda *a: _as_tuple(fn(*a)), out_placements=tuple(outs),
                    in_placements=tuple(ins), in_grad_placements=tuple(grads),
                    device_mesh=mesh, redistribute_inputs=True)(*args)
    return tuple(out) if many else out[0]


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


__all__ = ["get_mesh", "local_apply", "logical_spec", "mesh_scope", "set_mesh", "shard",
           "use_mesh"]
