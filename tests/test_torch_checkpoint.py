"""The port's checkpoints (``repro_torch.train.checkpoint``): the JAX
package's on-disk format, so that a checkpoint written by either framework
restores bit for bit in the other.  The JAX side runs in a spawned child
(``torch_jaxref``)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from torch_parity import leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import tree_map

JAX = Reference()
_jax_child = JAX.fixture()


def _state(seed: int = 0) -> dict:
    """A training state as numpy: bf16 params, f32 moments and master, an
    int32 0-d step, as ``launch/train.py`` saves it."""
    rng = np.random.RandomState(seed)
    draw = lambda: {"embed": rng.randn(16, 8).astype(np.float32),
                    "layers": {"0": {"w": rng.randn(2, 8, 8).astype(np.float32)}}}
    params = draw()
    opt = {"mu": draw(), "nu": draw(), "step": np.int32(7), "master": params}
    return {"params": tree_map(bf16, params), "opt": opt}


def _bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor (bf16 and float8 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.frombuffer(np.ascontiguousarray(x).tobytes(), np.uint8)


def _assert_bit_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)


# twin of tests/test_substrate.py::test_checkpoint_roundtrip_and_gc
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "opt": {"mu": torch.ones(3)}}
    for step in (1, 2, 3):
        mgr.save(step, state, extra={"data_serial": step * 10})
    assert mgr.all_steps() == [2, 3]  # gc keeps 2
    step, restored, extra = mgr.restore(device="cpu")
    assert step == 3 and extra["data_serial"] == 30
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_save_")]


def test_restore_an_earlier_step_and_on_the_cpu(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = params_from_numpy(_state(), "cpu")
    mgr.save(5, state, extra={"data_serial": 50})
    mgr.save(9, state, extra={"data_serial": 90})
    assert mgr.latest_step() == 9
    step, restored, extra = mgr.restore(5, device="cpu")
    assert step == 5 and extra == {"data_serial": 50}
    assert all(t.device.type == "cpu" for _, t in leaves(restored))
    _assert_bit_equal(restored, state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")
    if not torch.cuda.device_count():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mgr.restore()  # the card by default


def test_bf16_float8_and_int32_scalar_leaves_round_trip(tmp_path):
    state = {
        "w": torch.randn(4, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16),
        "f8": torch.linspace(-3, 3, 9).to(torch.float8_e4m3fn),
        "f8b": torch.linspace(-3, 3, 9).to(torch.float8_e5m2),
        "step": torch.tensor(12, dtype=torch.int32),
    }
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, state)
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    assert meta["w"] == {"file": "w.npy", "shape": [4, 5], "dtype": "bfloat16"}
    assert meta["step"] == {"file": "step.npy", "shape": [], "dtype": "int32"}
    assert np.load(os.path.join(path, "w.npy")).dtype == np.uint16
    assert np.load(os.path.join(path, "f8.npy")).dtype == np.uint8
    _, restored, _ = mgr.restore(device="cpu")
    for name, t in state.items():
        assert restored[name].dtype == t.dtype and restored[name].shape == t.shape, name
        np.testing.assert_array_equal(_bits(restored[name]), _bits(t), err_msg=name)


def test_the_reference_restores_what_the_port_saves(tmp_path):
    state = _state(1)
    CheckpointManager(str(tmp_path)).save(4, params_from_numpy(state, "cpu"),
                                          extra={"data_serial": 4, "note": "port"})
    step, restored, extra = JAX("checkpoint_restore", str(tmp_path))
    assert step == 4 and extra == {"data_serial": 4, "note": "port"}
    _assert_bit_equal(restored, state)
    assert str(restored["params"]["embed"].dtype) == "bfloat16"


def test_the_port_restores_what_the_reference_saves(tmp_path):
    state = _state(2)
    assert JAX("checkpoint_save", str(tmp_path), 6, state, {"data_serial": 6}) == [6]
    step, restored, extra = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 6 and extra == {"data_serial": 6}
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32 and restored["opt"]["step"].shape == ()
    _assert_bit_equal(restored, state)


def test_both_frameworks_write_the_same_files(tmp_path):
    """The same state saved by each framework gives the same manifest and
    byte-identical ``.npy`` files."""
    state = _state(3)
    JAX("checkpoint_save", str(tmp_path / "jax"), 2, state, {"data_serial": 2})
    CheckpointManager(str(tmp_path / "port")).save(2, params_from_numpy(state, "cpu"),
                                                   extra={"data_serial": 2})
    dirs = [tmp_path / side / "step_0000000002" for side in ("jax", "port")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    for meta in manifests[0]["leaves"].values():
        assert (dirs[0] / meta["file"]).read_bytes() == (dirs[1] / meta["file"]).read_bytes()
