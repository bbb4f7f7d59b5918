"""Port parity: the model and the train step under a mesh on real ranks, a
gloo group on the CPU, against the reference's sharded runs on the same mesh
shape.

The port's side spawns 4 ranks once for the module, a (2,2) ("data",
"model") mesh (``torch.multiprocessing``, ``tcp://localhost``); the
compressed all-reduce over "pod" runs on a (2,1,2) ("pod", "data",
"model") mesh of the same 4 ranks (8 ranks for (2,2,2) would crowd the
cores the other test workers share; the data dim adds nothing to a sum
over "pod").  The
reference's side runs in its own spawned child with 8 forced host devices
and an Auto-axis ``jax.sharding.Mesh`` (``torch_jaxref.sharded_*``), at the
same time.  Both run the smoke configs in f32 on the reference's PRNGKey(0)
parameters, moved over through numpy.
"""
import dataclasses
import os
import pickle
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp

from torch_jaxref import Reference

JAX = Reference(host_devices=8)
_jax_child = JAX.fixture()

MESH = ((2, 2), ("data", "model"))
ARCHS = ("olmo-1b", "qwen2-moe-a2.7b")
STEP_ARCHS = ("olmo-1b", "qwen2-moe-a2.7b", "mamba2-780m")  # one train step each
LOSS_RTOL = 1e-5  # f32 losses: the same function, sum order apart
GNORM_RTOL = 1e-4  # f32 grad norm over every leaf
PARAM_ATOL = 1e-6  # f32 params after one step (lr 3e-6 at step 1)
PSUM_REL = 0.02  # the reference's bound, tests/test_distribution.py:139-140


def _tokens():
    return np.random.RandomState(0).randint(0, 256, (8, 32)).astype(np.int32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _setup(rank, world, port):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)


def _cfg(fields):
    from repro_torch.models.common import from_reference_config

    return from_reference_config(fields)


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _four_ranks(rank, world, port, inputs, out_path, ckpt_dir):
    """Rank body of the (2,2) mesh: sharded losses, one sharded train step,
    a checkpoint of a sharded state and its restore onto the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeSpec
    from repro_torch.models import transformer
    from repro_torch.models.common import abstract_params, param_pspecs
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.sharding.context import use_mesh
    from repro_torch.sharding.partitioning import (NamedSharding, batch_spec, distribute,
                                                   named_sanitized)
    from repro_torch.train import CheckpointManager
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.tree import flatten

    _setup(rank, world, port)
    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    toks = torch.from_numpy(inputs["tokens"])
    out = {}
    for arch in ARCHS:
        cfg = _cfg(inputs["fields"][arch])
        params = params_from_numpy(inputs["params"][arch], device="cpu")
        sp = distribute(params, named_sanitized(mesh, param_pspecs(cfg), abstract_params(cfg)))
        sb = distribute({"tokens": toks, "labels": toks},
                        NamedSharding(mesh, batch_spec(mesh, toks.shape[0], 1)))
        with use_mesh(mesh):
            loss, _ = transformer.loss_fn(cfg, sp, sb)
            if arch == "olmo-1b":  # the residual stream S-sharded over 'model' too
                seq = dataclasses.replace(cfg, seq_parallel=True)
                sp_loss, _ = transformer.loss_fn(seq, sp, sb)
                out["loss/olmo-1b/seq_parallel"] = float(_full(sp_loss))
        out[f"loss/{arch}"] = float(_full(loss))

    # one train step of each STEP_ARCHS under train_step_shardings: olmo's
    # dense path, qwen2-moe's row-wise MoE (per-row dispatch and combine,
    # the router's gradient), mamba2's conv and scan run per shard (their
    # weights' gradients are sums over the batch's ranks)
    ocfg = OptConfig()
    batch = {"tokens": toks, "labels": torch.from_numpy(np.roll(inputs["tokens"], -1, 1))}
    shape = ShapeSpec("t", toks.shape[1], toks.shape[0], "train")
    out["step"] = {}
    for arch in STEP_ARCHS:
        cfg = _cfg(inputs["fields"][arch])
        ins, _ = ts.train_step_shardings(cfg, ocfg, mesh, shape)
        params = params_from_numpy(inputs["params"][arch], device="cpu")
        sp = distribute(params, ins[0])
        so = distribute(init_opt_state(ocfg, params), ins[1])
        with use_mesh(mesh):
            sp, so, metrics = ts.make_train_step(cfg, ocfg)(sp, so, distribute(batch, ins[2]))
        out["step"][arch] = ({k: float(_full(v)) for k, v in metrics.items()},
                             {k: _full(v).numpy() for k, v in flatten(sp).items()})
        if arch == "mamba2-780m":  # and the same step on one device
            _, _, m1 = ts.make_train_step(cfg, ocfg)(params, init_opt_state(ocfg, params), batch)
            out["mamba"] = {k: (out["step"][arch][0][k], float(m1[k]))
                            for k in ("loss", "grad_norm")}
        if arch == "olmo-1b":  # the state the checkpoint below saves
            ckpt_state, ckpt_ins = {"params": sp, "opt": so}, ins

    # checkpoint: the sharded state saved whole, restored onto the mesh
    state, ins = ckpt_state, ckpt_ins
    mgr = CheckpointManager(os.path.join(ckpt_dir, "sharded"))
    mgr.save(1, state, extra={"data_serial": 7})
    whole = _full_tree(state)  # every rank gathers; rank 0 writes it as plain tensors
    if rank == 0:
        CheckpointManager(os.path.join(ckpt_dir, "whole")).save(1, whole,
                                                               extra={"data_serial": 7})
    dist.barrier()
    shardings = {"params": ins[0], "opt": ins[1]}
    step, restored, extra = mgr.restore(shardings=shardings)
    flat_r, flat_s, flat_sh = flatten(restored), flatten(state), flatten(shardings)
    out["restore"] = {
        "step": step, "extra": extra,
        "equal": all(bool(torch.equal(_full(flat_r[k]), _full(flat_s[k]))) for k in flat_s),
        "placements": all(tuple(flat_r[k].placements) == tuple(flat_sh[k].placements)
                          for k in flat_s),
    }

    # the compressed sum over "pod" on a (2,1,2) mesh of the same 4 ranks
    pod_mesh = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("pod", "data", "model"))
    out["psum"] = _pod_psum(pod_mesh, _cfg(inputs["fields"]["olmo-1b"]))
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _full_tree(tree):
    if isinstance(tree, dict):
        return {k: _full_tree(v) for k, v in tree.items()}
    return _full(tree)


def _pod_psum(mesh, cfg) -> list:
    """``make_compressed_psum`` over the "pod" dim of ``mesh`` on per-pod
    gradients, twice (the second with the first's residual): each call's
    error relative to the exact sum."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.common import abstract_params, param_pspecs
    from repro_torch.sharding.partitioning import sanitize_spec, to_placements
    from repro_torch.train import init_error_state, make_compressed_psum
    from repro_torch.tree import flatten, unflatten

    specs, ap = param_pspecs(cfg), abstract_params(cfg)
    pod = mesh.get_coordinate()[0]

    def grads(pod_, seed):
        """One pod's whole gradients (the same on every rank of the pod)."""
        g = torch.Generator().manual_seed(seed * 10 + pod_)
        return {n: torch.randn(a.shape, generator=g) * 0.01 for n, a in flatten(ap).items()}

    fn = make_compressed_psum(mesh, specs, ap)
    flat_specs = flatten(specs)
    rels, err = [], None
    for seed in (1, 2):
        per_pod = [grads(0, seed), grads(1, seed)]
        true = {n: per_pod[0][n] + per_pod[1][n] for n in per_pod[0]}
        dg = {}
        for n, g in per_pod[pod].items():
            # this rank's piece of its own pod's gradient: no data moves
            pl = to_placements(mesh, sanitize_spec(mesh, flat_specs[n], tuple(g.shape)))
            dg[n] = distribute_tensor(g, mesh, pl, src_data_rank=None)
        dg = unflatten(dg)
        if err is None:
            err = init_error_state(dg)
        summed, err = fn(dg, err)
        num = sum(float(((_full(s) - true[n]) ** 2).sum()) for n, s in flatten(summed).items())
        den = sum(float((t ** 2).sum()) for t in true.values())
        rels.append((num / den) ** 0.5)
    return rels


def _spawn(body, world, inputs, tmp):
    """Run ``world`` ranks of ``body``; returns what rank 0 wrote."""
    out = os.path.join(tmp, f"{body.__name__}.pkl")
    mp.start_processes(body, args=(world, _free_port(), inputs, out, tmp), nprocs=world,
                       start_method="spawn")
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    toks = _tokens()
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    ref = {arch: JAX.submit("sharded_losses", "float32", arch, *MESH, toks) for arch in ARCHS}
    ref_step = {a: JAX.submit("sharded_train_step", "float32", a, {}, *MESH, batch)
                for a in STEP_ARCHS}
    inputs = {
        "tokens": toks,
        "fields": {a: JAX("config_fields", a, True, dtype="float32", param_dtype="float32")
                   for a in STEP_ARCHS},
        "params": {a: JAX("model_params", "float32", 0, a) for a in STEP_ARCHS},
    }
    tmp = tmp_path_factory.mktemp("ranks")
    port = _spawn(_four_ranks, 4, inputs, str(tmp))
    return {"port": port, "tmp": tmp,
            "ref": {a: f.result() for a, f in ref.items()},
            "ref_step": {a: f.result() for a, f in ref_step.items()}}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-6)


def test_sharded_olmo_loss_matches_the_reference_sharded_run(runs):
    sharded, single = runs["ref"]["olmo-1b"]
    got = runs["port"]["loss/olmo-1b"]
    assert _rel(got, sharded) < LOSS_RTOL, (got, sharded)
    assert _rel(got, single) < LOSS_RTOL, (got, single)


def test_seq_parallel_under_the_mesh_changes_no_number(runs):
    """``seq_parallel`` only moves the residual stream between ranks: the
    reference's sharded loss, within the same bound."""
    sharded, _ = runs["ref"]["olmo-1b"]
    got = runs["port"]["loss/olmo-1b/seq_parallel"]
    assert _rel(got, sharded) < LOSS_RTOL, (got, sharded)


def test_sharded_moe_loss_follows_the_rows_of_the_mesh(runs):
    """qwen2-moe under a mesh routes R = data rows, each with its own
    capacity, so its sharded loss is not its single-device loss: the port
    must match the former, and the two differ by far more than the bound."""
    sharded, single = runs["ref"]["qwen2-moe-a2.7b"]
    got = runs["port"]["loss/qwen2-moe-a2.7b"]
    assert _rel(sharded, single) > 100 * LOSS_RTOL, (sharded, single)
    assert _rel(got, sharded) < LOSS_RTOL, (got, sharded)


def _step_matches(runs, arch):
    """The port's sharded step of ``arch`` against the reference's on the
    same mesh shape: loss, grad norm, lr and every param after the step."""
    from repro_torch.tree import flatten

    want_metrics, want_params = runs["ref_step"][arch]
    got, got_params = runs["port"]["step"][arch]
    assert _rel(got["loss"], float(want_metrics["loss"])) < LOSS_RTOL, arch
    assert _rel(got["grad_norm"], float(want_metrics["grad_norm"])) < GNORM_RTOL, arch
    assert _rel(got["lr"], float(want_metrics["lr"])) < 1e-6
    want = flatten(want_params)
    assert want.keys() == got_params.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got_params[name], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{arch} {name}")


def test_sharded_train_step_matches_the_reference(runs):
    _step_matches(runs, "olmo-1b")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-780m"])
def test_sharded_train_step_of_moe_and_ssm_matches_the_reference(runs, arch):
    """The backward of the row-wise MoE (per-row dispatch and combine in
    ``local_apply``, the router's gradient) and of mamba2's per-shard conv
    and scan, held to the reference's sharded step."""
    _step_matches(runs, arch)


def test_sharded_mamba_step_matches_the_unsharded_step(runs):
    for key, (meshed, single) in runs["port"]["mamba"].items():
        assert _rel(meshed, single) < (LOSS_RTOL if key == "loss" else GNORM_RTOL), key


def test_restore_onto_the_mesh(runs):
    r = runs["port"]["restore"]
    assert r["step"] == 1 and r["extra"] == {"data_serial": 7}
    assert r["equal"] and r["placements"]


def test_sharded_save_writes_the_files_of_the_whole_state(runs):
    a, b = (runs["tmp"] / d / "step_0000000001" for d in ("sharded", "whole"))
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and "manifest.json" in names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_compressed_psum_over_pod(runs):
    for rel in runs["port"]["psum"]:
        assert rel < PSUM_REL, rel
