"""Sharding rules on DTensor (port of ``repro.sharding.partitioning``):
batch, cache and activation partition specs for the production meshes (see
``launch/mesh.py``).  Parameter specs live with the parameter definitions in
``models/common.py``; this module holds everything shape-dependent.

A :class:`PartitionSpec` (``P``) is the JAX package's spec as a tuple: per
tensor dim ``None``, a mesh dim name, or a tuple of names in mesh order.
:func:`to_placements` turns it into DTensor placements, one per mesh dim:
``Shard(i)`` where entry i names that mesh dim, ``Replicate()`` elsewhere.
A tensor dim sharded over several mesh dims (``("pod", "data")``) is split
by them in mesh order, major to minor, which is how JAX lays out such a dim.
:class:`NamedSharding` pairs a mesh with a spec; :func:`distribute` places
a tree of tensors by a tree of them.

The spec functions need only a mesh's dim names and sizes, so they take a
``DeviceMesh`` or an :class:`AbstractMesh` alike.

Conventions:
- batch dims shard over the DP mesh dims ('pod', 'data') when divisible,
  else replicate
- decode KV caches shard batch over DP and the *sequence* dim over 'model'
  (flash-decoding style); prefill KV caches shard the head dim over 'model'
- mamba caches shard batch over DP and heads over 'model'
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..models.common import ModelConfig
from .spec import P, PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim sizes and names with no devices (the counterpart of
    ``jax.sharding.AbstractMesh``), for spec functions and bookkeeping."""

    shape: tuple
    mesh_dim_names: tuple

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def axis_size(mesh, name: str) -> int:
    return mesh.shape[list(mesh.mesh_dim_names).index(name)]


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return axis_size(mesh, axes)
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _spec_map(fn, *trees):
    """``fn`` over the specs of ``trees[0]`` (nested dicts), with the
    matching leaves of the other trees."""
    if _is_spec(trees[0]):
        return fn(*trees)
    return {k: _spec_map(fn, *(t[k] for t in trees)) for k in trees[0]}


def to_placements(mesh, spec: PartitionSpec, ndim: int | None = None) -> tuple:
    """DTensor placements for ``spec``: per mesh dim, ``Shard(i)`` where
    entry i names it, else ``Replicate()``.  A tuple entry must list its
    mesh dims in mesh order (JAX's major-to-minor order of such a dim).  A
    mesh dim of size 1 cuts nothing and gets ``Replicate()``, the same
    layout: DTensor's view rules refuse to reshape a dim "sharded" over one
    rank."""
    names = list(mesh.mesh_dim_names)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    out: list = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        group = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in mesh order {tuple(names)}")
        for j in idx:
            if isinstance(out[j], Shard):
                raise ValueError(f"mesh dim {names[j]!r} shards two dims in {spec}")
            out[j] = Shard(i)
    return tuple(Replicate() if mesh.shape[j] == 1 else p for j, p in enumerate(out))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the placements a tensor takes on that mesh."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def dp_size(mesh) -> int:
    return _axes_size(mesh, dp_axes(mesh))


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> P:
    """(B, ...) arrays: shard B over DP axes when divisible."""
    if batch % dp_size(mesh) == 0:
        return P(dp_axes(mesh), *([None] * extra_dims))
    return P(*([None] * (extra_dims + 1)))


def cache_slice_pspecs(cfg: ModelConfig, mesh, batch: int, mode: str = "decode") -> dict:
    """Per-period cache slice specs (no leading period dim).

    mode="decode": attn KV shards its *seq* dim over 'model'.
    mode="prefill": attn KV shards its head dim over 'model', as prefill
    produces it; the hand-off to decode re-shards it once."""
    bspec = dp_axes(mesh) if batch % dp_size(mesh) == 0 else None
    slices: dict[str, dict] = {}
    for si, (mixer, _ffn) in enumerate(cfg.pattern):
        if mixer == "attn":
            if mode == "decode":
                spec = P(bspec, None, "model", None)  # (B,Hkv,S,Dh): S over tp
            else:
                spec = P(bspec, None, None, "model")  # Dh over tp
            slices[str(si)] = {"k": spec, "v": spec}
            if cfg.kv_quant:
                sspec = P(bspec, None, "model")  # scales: (B,Hkv,S)
                slices[str(si)].update({"k_scale": sspec, "v_scale": sspec})
        elif mixer == "xattn":
            spec = P(bspec, None, None, "model")  # enc KV: head-dim over tp
            slices[str(si)] = {"ek": spec, "ev": spec}
        elif mixer == "mamba":
            slices[str(si)] = {
                "ssm": P(bspec, "model", None, None),  # (B, H, Pdim, N): heads over tp
                "conv": P(bspec, None, "model"),  # (B, K-1, conv_dim): channels over tp
            }
    return slices


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, mode: str = "decode") -> dict:
    """Full-cache specs: slice specs with the leading num_periods dim."""
    return _spec_map(lambda s: P(None, *s), cache_slice_pspecs(cfg, mesh, batch, mode))


def named(mesh, tree: Any) -> Any:
    """PartitionSpec tree -> NamedSharding tree."""
    return _spec_map(lambda s: NamedSharding(mesh, s), tree)


def sanitize_spec(mesh, spec: P, shape: tuple) -> P:
    """Drop sharding on dims the mesh axis size does not divide (e.g.
    mamba2's vocab 50280 on a 16-way axis, or 8 kv-heads on 'model')."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, entries):
        if axes is not None and dim % _axes_size(mesh, axes) != 0:
            axes = None
        out.append(axes)
    return P(*out)


def named_sanitized(mesh, pspec_tree: Any, abstract_tree: Any) -> Any:
    """Like ``named`` but checks divisibility against the abstract shapes
    (a tree of tensors, ``meta`` ones included, or of shapes)."""
    shape = lambda a: tuple(a.shape) if hasattr(a, "shape") else tuple(a)
    return _spec_map(lambda s, a: NamedSharding(mesh, sanitize_spec(mesh, s, shape(a))),
                     pspec_tree, abstract_tree)


def place(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the whole logical tensor) as a DTensor on ``sharding``, in
    memory of its own (as ``jax.device_put`` copies): a replicated piece
    that would share ``x``'s storage is copied, so an in-place update of
    the DTensor never writes into ``x``."""
    out = distribute_tensor(x, sharding.mesh, sharding.placements)
    local = out.to_local()
    if local.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        out = DTensor.from_local(local.clone(), out.device_mesh, out.placements,
                                 run_check=False, shape=out.shape, stride=out.stride())
    return out


def distribute(tree: Any, shardings: Any) -> Any:
    """Every tensor of ``tree`` placed by the matching leaf of
    ``shardings`` (a NamedSharding tree of the same nesting, or one
    NamedSharding for every leaf)."""
    if isinstance(shardings, NamedSharding):
        if isinstance(tree, dict):
            return {k: distribute(v, shardings) for k, v in tree.items()}
        return place(tree, shardings)
    if isinstance(tree, dict):
        return {k: distribute(tree[k], shardings[k]) for k in tree}
    return place(tree, shardings)


def constrain_batch(mesh, x):
    """``x`` (a DTensor) with its batch dim on the DP axes, as
    ``batch_spec`` says."""
    pl = to_placements(mesh, batch_spec(mesh, x.shape[0], x.ndim - 1))
    return x.redistribute(mesh, pl)


__all__ = [
    "AbstractMesh", "NamedSharding", "P", "PartitionSpec", "axis_size", "batch_spec",
    "cache_pspecs", "cache_slice_pspecs", "constrain_batch", "distribute", "dp_axes", "dp_size",
    "named", "named_sanitized", "place", "sanitize_spec", "to_placements",
]
