"""Dry-run of the production cells on a fake mesh (port of
``repro.launch.dryrun``).

The reference forces 512 host devices and lowers each (arch, shape, mesh)
cell ahead of time, reading XLA's cost and memory analyses.  Here one
process initialises ``torch.distributed``'s ``fake`` backend with a world
of 256 or 512 ranks (no communication, no other process), builds the
production mesh on it (``launch/mesh.py``, device type ``cpu``), places
fake (``FakeTensorMode``, no memory) parameters, optimizer state and batch
by the ``*_shardings`` of ``train/train_step.py``, and runs one train,
prefill or decode step as rank 0, under :class:`StepCounter`:

- per-device FLOPs: the FLOPs of the local ops DTensor runs on rank 0's
  shards (``torch.utils.flop_counter``'s formulas), which is the global
  count divided by the pieces each output is cut into (a replicated
  result is computed whole on every rank);
- per-device bytes: each local op's input and output bytes.  This is an
  eager, unfused count (every op reads and writes memory), not XLA's fused
  one;
- collective bytes per device, by kind, from the functional collectives
  DTensor issues, with the ring factors of the reference's
  ``collective_bytes_per_device``;
- memory: argument and output bytes from the local shards, temp bytes as
  the peak of the live bytes the step allocates; ``generated_code_bytes``
  is None (an eager program has no compiled code).

The tensors are fake CPU tensors, so every kernel wrapper takes its plain
version: the counts are those of the plain routes (``"counted_routes":
"plain"``), not of K3/K4/K5.

The limits are an NVIDIA H100 SXM5 80GB's (700 W), from its data sheet:
989e12 FLOP/s dense BF16 on the tensor cores and 3.35e12 B/s of HBM3.  The
collective term takes 50e9 B/s a GPU: a 16-wide 'model' dim spans two
8-GPU nodes, so its slowest hop is the inter-node network, one 400 Gb/s
NDR InfiniBand port a GPU (NVLink inside a node carries 450e9 B/s each
way, nine times that).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from ..models.common import abstract_params, count_active_params
from ..sharding.context import use_mesh
from ..sharding.partitioning import NamedSharding
from ..train import train_step as ts
from ..train.optimizer import OptConfig, abstract_opt_state
from ..tree import flatten

# ---------------------------------------------------------------- constants
PEAK_FLOPS = 989e12  # H100 SXM5 80GB, dense BF16 tensor-core FLOP/s (data sheet, 700 W)
HBM_BW = 3.35e12  # H100 SXM5 80GB, HBM3 bytes/s
LINK_BW = 50e9  # bytes/s a GPU across nodes: one 400 Gb/s NDR InfiniBand port

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def init_fake_world(world: int) -> None:
    """The default process group: the ``fake`` backend with ``world``
    ranks, this process rank 0 (re-made when the size differs)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)


def fake_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` on a fake world of its size."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    init_fake_world(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _group_size(func, args) -> int:
    name = func._overloadpacket.__name__
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2] if name == "all_gather_into_tensor" else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


class StepCounter(TorchDispatchMode):
    """Counts rank 0's local work under ``fake_mode``: FLOPs, op bytes,
    collective bytes by kind, and the peak of live allocated bytes.

    DTensor ops are handed on (``NotImplemented``) so that DTensor runs
    them; the local ops and collectives it then issues come back here.  Not
    counted: ops on fake tensors of another mode, and what DTensor's
    sharding propagation runs to learn an output's global shape (the global
    op on fake tensors of the active mode): :meth:`counting` pauses the
    counter around ``ShardingPropagator._propagate_tensor_meta_non_cached``."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.coll: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.paused = 0

    @contextlib.contextmanager
    def counting(self):
        """This counter on the mode stack, paused inside DTensor's shape
        propagation."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = ("_propagate_tensor_meta_non_cached"
                if hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
                else "_propagate_tensor_meta")
        orig = getattr(ShardingPropagator, name)

        def paused(prop, op_schema):
            self.paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                self.paused -= 1

        setattr(ShardingPropagator, name, paused)
        try:
            with self:
                yield self
        finally:
            setattr(ShardingPropagator, name, orig)

    def _ours(self, t) -> bool:
        return isinstance(t, torch.Tensor) and getattr(t, "fake_mode", None) is self.fake_mode

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ins = [a for a in _tensors(args) + _tensors(kwargs) if isinstance(a, torch.Tensor)]
        outs = [o for o in _tensors(out) if isinstance(o, torch.Tensor)]
        if not all(self._ours(t) for t in ins + outs) or not (ins or outs):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            g = _group_size(func, args)
            if g > 1:
                kind = _COLLECTIVES[name]
                nbytes = _nbytes(outs[0]) if kind != "all-to-all" else _nbytes(ins[0])
                factor = {"all-gather": (g - 1) / g, "all-reduce": 2 * (g - 1) / g,
                          "reduce-scatter": g - 1, "all-to-all": (g - 1) / g}[kind]
                self.coll[kind] = self.coll.get(kind, 0.0) + nbytes * factor
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in ("wait_tensor", "detach", "alias"):
            return out
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        seen = {id(t) for t in ins}
        for o in outs:  # a new allocation lives until its tensor dies
            if id(o) in seen or o._is_view():
                continue
            n = _nbytes(o)
            self.live += n
            weakref.finalize(o, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _tensors(x) -> list:
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return [x]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in flatten(tree).values() if isinstance(tree, dict) else _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def place_fake(abstract, shardings):
    """Fake tensors of ``abstract``'s (``meta``) shapes placed by
    ``shardings``: each rank keeps its own piece, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def one(a, sh):
        t = torch.empty(a.shape, dtype=a.dtype)
        return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)

    if isinstance(abstract, dict):
        if isinstance(shardings, NamedSharding):
            return {k: place_fake(v, shardings) for k, v in abstract.items()}
        return {k: place_fake(v, shardings[k]) for k, v in abstract.items()}
    return one(abstract, shardings)


def _steps(cfg, shape, mesh, ocfg):
    """(step fn, placed args, outputs' tree getter) for the cell's kind."""
    aparams = abstract_params(cfg)
    if shape.kind == "train":
        ins, _ = ts.train_step_shardings(cfg, ocfg, mesh, shape)
        args = (place_fake(aparams, ins[0]),
                place_fake(abstract_opt_state(ocfg, aparams), ins[1]),
                place_fake(ts.abstract_train_batch(cfg, shape), ins[2]))
        return ts.make_train_step(cfg, ocfg), args
    if shape.kind == "prefill":
        ins, _ = ts.prefill_shardings(cfg, mesh, shape)
        args = (place_fake(aparams, ins[0]),
                place_fake(ts.abstract_prefill_batch(cfg, shape), ins[1]))
        return ts.make_prefill_step(cfg), args
    ins, _ = ts.serve_shardings(cfg, mesh, shape)
    cache, tok, pos = ts.abstract_serve_inputs(cfg, shape)
    args = (place_fake(aparams, ins[0]), place_fake(cache, ins[1]),
            place_fake(tok, ins[2]), place_fake(pos, ins[3]))
    return ts.make_serve_step(cfg), args


def count_step(fn, args, mesh):
    """Run ``fn(*args)`` (fake placed tensors) under ``use_mesh(mesh)`` and
    a :class:`StepCounter`; returns (counter, outputs, seconds)."""
    mode = _fake_mode(args)
    t0 = time.time()
    with use_mesh(mesh), mode, StepCounter(mode).counting() as c:
        out = fn(*args)
        c.peak = max(c.peak, c.live)
    return c, out, time.time() - t0


def _fake_mode(args):
    from torch.distributed.tensor import DTensor

    for t in _tensors(args) + [v for a in args if isinstance(a, dict)
                               for v in flatten(a).values()]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor) and getattr(t, "fake_mode", None) is not None:
            return t.fake_mode
    raise ValueError("no fake tensor among the step's arguments")


def roofline_terms(flops: float, bytes_: float, coll: float) -> dict:
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_ / HBM_BW,
             "collective_s": coll / LINK_BW}
    return terms


def model_flops(cfg, shape) -> float:
    """6ND for a train step, 2ND for prefill and decode (N active params)."""
    tokens = shape.global_batch if shape.kind == "decode" else shape.global_batch * shape.seq_len
    return (6 if shape.kind == "train" else 2) * count_active_params(cfg) * tokens


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *, cfg=None, shape=None,
               mesh_shape=None):
    """Place and run one (arch, shape, mesh) cell under the counter; returns
    (record, memory analysis dict, cost dict).  ``cfg``, ``shape`` and
    ``mesh_shape`` ((dims, names)) override the registry's config, the
    named shape and the production mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    dims, names = mesh_shape or PRODUCTION[multi_pod]
    t0 = time.time()
    mesh = fake_mesh(dims, names)
    chips = mesh.size()
    ocfg = OptConfig(moment_dtype=cfg.optim_moment_dtype, master_fp32=cfg.optim_master_fp32)
    with FakeTensorMode():
        fn, args = _steps(cfg, shape, mesh, ocfg)
    t_place = time.time() - t0
    c, out, t_run = count_step(fn, args, mesh)

    flops, bytes_ = float(c.flops), float(c.bytes)
    coll = dict(c.coll, total=sum(c.coll.values()))
    mem = {
        "argument_bytes": _local_bytes(list(args)),
        "output_bytes": _local_bytes(list(out)),
        "temp_bytes": c.peak,
        "generated_code_bytes": None,
    }
    terms = roofline_terms(flops, bytes_, coll["total"])
    mf = model_flops(cfg, shape)
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(map(str, dims)),
        "chips": chips,
        "kind": shape.kind,
        "lower_s": round(t_place, 1),
        "compile_s": round(t_run, 1),
        "counted_routes": "plain",
        "bytes_count": "eager, unfused: every local op's inputs and outputs",
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "collective_bytes_per_device": coll,
        **terms,
        "bottleneck": max(terms, key=terms.get).replace("_s", ""),
        "model_flops_global": mf,
        "useful_flops_ratio": mf / (flops * chips) if flops else 0.0,
        "memory_analysis": mem,
    }
    return record, mem, {"flops": flops, "bytes accessed": bytes_}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: applicable)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results_path = os.path.join(args.out, "results.jsonl")
    done = set()
    if args.skip_existing and os.path.exists(results_path):
        with open(results_path) as f:
            for line in f:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"]))

    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else applicable_shapes(cfg)
        for shape_name in shapes:
            for multi_pod in meshes:
                mesh_name = "2x16x16" if multi_pod else "16x16"
                if (arch, shape_name, mesh_name) in done:
                    continue
                tag = f"{arch} x {shape_name} x {mesh_name}"
                print(f"=== {tag} ===", flush=True)
                try:
                    record, mem, cost = lower_cell(arch, shape_name, multi_pod)
                    print(f"memory_analysis: {mem}", flush=True)
                    print("cost: flops={:.3e} bytes={:.3e}".format(
                        record["flops_per_device"], record["bytes_per_device"]), flush=True)
                    print("roofline: compute={compute_s:.4f}s memory={memory_s:.4f}s "
                          "collective={collective_s:.4f}s bottleneck={bottleneck} "
                          "useful={useful_flops_ratio:.2f}".format(**record), flush=True)
                    with open(results_path, "a") as f:
                        f.write(json.dumps(record) + "\n")
                    n_ok += 1
                except Exception:
                    traceback.print_exc()
                    with open(os.path.join(args.out, "failures.log"), "a") as f:
                        f.write(f"{tag}\n{traceback.format_exc()}\n")
                    n_fail += 1
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
