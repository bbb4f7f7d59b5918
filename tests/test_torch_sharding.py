"""Port parity: the distribution layer's spec trees (``repro_torch.sharding``,
the ``ParamDef`` specs of ``models/common.py``) and the abstract trees of the
models and train steps, against the JAX package, with no processes.

The reference's spec functions run on a ``jax.sharding.AbstractMesh`` (no
devices) in the spawned child (``torch_jaxref.spec_trees``); the port's on
its own ``AbstractMesh``, for all ten architectures on the production
meshes (16,16) and (2,16,16) and the test meshes (2,4) and (2,2,2).  Specs
are compared as tuples, exactly, with a one-name group written as the name
(``P(("data",))`` is ``P("data")``: JAX itself normalizes it so).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode

from torch_jaxref import Reference
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.models import common, transformer
from repro_torch.sharding import partitioning as part
from repro_torch.sharding.context import get_mesh, shard, use_mesh
from repro_torch.train import optimizer, train_step as ts
from repro_torch.tree import tree_leaves

JAX = Reference()
_jax_child = JAX.fixture()

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
# a batch every mesh's DP dims divide, and one none of them divides
BATCHES = (256, 3)
OCFG = {"moment_dtype": "float32", "master_fp32": True}


def _entry(a):
    if isinstance(a, (tuple, list)):
        return a[0] if len(a) == 1 else tuple(a)
    return a


def _tuples(tree):
    """Specs as plain tuples of None, a name, or a tuple of two or more."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(_entry(a) for a in tree)


def _port_trees(arch, mesh):
    out = {}
    for fsdp in (True, False):
        cfg = dataclasses.replace(get_config(arch), fsdp_params=fsdp)
        out[f"param_pspecs/{fsdp}"] = _tuples(common.param_pspecs(cfg))
        out[f"period_pspecs/{fsdp}"] = _tuples(common.period_pspecs(cfg))
        out[f"sanitized/{fsdp}"] = {
            n: _tuples(part.sanitize_spec(mesh, d.spec, d.shape))
            for n, d in sorted(common.param_defs(cfg).items())}
    for kvq in (False, True):
        cfg = dataclasses.replace(get_config(arch), kv_quant=kvq)
        for mode in ("decode", "prefill"):
            for b in BATCHES:
                out[f"cache/{kvq}/{mode}/{b}"] = _tuples(part.cache_pspecs(cfg, mesh, b, mode))
    for b in BATCHES:
        for extra in (0, 1, 2):
            out[f"batch/{b}/{extra}"] = _tuples(part.batch_spec(mesh, b, extra))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    want = JAX("spec_trees", arch, shape, names, BATCHES, 4096)
    got = _port_trees(arch, part.AbstractMesh(shape, names))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == _tuples(want[key]), key


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_equal_the_reference(arch):
    B, S = 8, 64
    want = JAX("abstract_trees", arch, B, S, OCFG)
    cfg = get_config(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S, global_batch=B)
    ap = common.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(ap))
    got = _shapes({
        "params": ap, "period": common.abstract_period_params(cfg),
        "cache": transformer.abstract_cache(cfg, B, S),
        "cache_slice": transformer.abstract_cache_slice(cfg, B, S),
        "opt": optimizer.abstract_opt_state(optimizer.OptConfig(), ap),
        "train_batch": ts.abstract_train_batch(cfg, shape),
        "prefill_batch": ts.abstract_prefill_batch(cfg, shape),
        "serve": dict(zip(("cache", "token", "position"), ts.abstract_serve_inputs(cfg, shape))),
    })
    assert got == want


def test_to_placements_follows_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = part.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert part.to_placements(mesh, part.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert part.to_placements(mesh, part.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        part.to_placements(mesh, part.P(("data", "pod")))
    with pytest.raises(ValueError, match="shards two dims"):
        part.to_placements(mesh, part.P("data", "data"))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_shard_is_the_identity_without_a_mesh_or_on_a_plain_tensor():
    x = torch.randn(4, 8, 16)
    assert get_mesh() is None
    with _Ops() as ops:
        assert shard(x, "dp", None, "tp") is x
    assert ops.n == 0
    with use_mesh(part.AbstractMesh((2, 4), ("data", "model"))):
        with _Ops() as ops:
            assert shard(x, "dp", None, "tp") is x
        assert ops.n == 0
    assert get_mesh() is None


def test_applicable_shapes_rules():
    """The twin of ``tests/test_models_smoke.py::test_applicable_shapes_rules``."""
    assert "long_500k" in applicable_shapes(get_config("mamba2-780m"))
    assert "long_500k" in applicable_shapes(get_config("jamba-1.5-large-398b"))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.family not in ("ssm", "hybrid"):
            assert "long_500k" not in applicable_shapes(cfg)
        assert {"train_4k", "prefill_32k", "decode_32k"} <= set(applicable_shapes(cfg))


def test_tp_resident_strips_fsdp_axis():
    """The twin of ``tests/test_serving_optimizations.py::test_tp_resident_strips_fsdp_axis``."""
    cfg_tp = dataclasses.replace(get_config("olmo-1b"), fsdp_params=False)

    def has_data(spec):
        return any(a == "data" or (isinstance(a, tuple) and "data" in a) for a in spec)

    for d in common.param_defs(cfg_tp).values():
        assert not has_data(d.spec), d
    for d in common.period_param_defs(cfg_tp).values():
        assert not has_data(d.spec), d
