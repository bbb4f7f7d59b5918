"""A configuration's model code, found by its file's ``family`` key.

The existing configurations' counts, bounds and drawn weights are the
numbers the harness gave before the family lookup (written here, to the
bit); a family no harness file names is found from a configuration file
alone and is the one a serving and a training run use; the harness reaches
model code through the lookup only."""
import ast
import hashlib
import json
import shutil
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from portbench import bench, families, serving, tiny, training, weights  # noqa: E402

# The harness's numbers before the lookup, at the published widths, as
# float.hex: prefill FLOPs, K4 and K3 bounds of a prefill of S tokens; the
# decode FLOPs of four slots at positions 0, 5, 1,499 and 2,047; K3's bound
# of a decode step of 16 and 128 slots; a training step's FLOPs at 8 x
# 1,024 and K4's bound of one call there.
PARENT = {
    "olmo-1b.stream-code": {
        "prefill": {1: ("0x1.1894000000000p+31", "0x1.5016eb12b5c42p-24", "0x0.0p+0"),
                    217: ("0x1.b514480000000p+38", "0x1.1ce36d42dc134p-16", "0x0.0p+0"),
                    1500: ("0x1.88339a0000000p+41", "0x1.38e2b30f48e65p-13", "0x0.0p+0"),
                    2045: ("0x1.0f99138000000p+42", "0x1.22b99ea34e024p-12", "0x0.0p+0"),
                    7936: ("0x1.3412b48000000p+44", "0x1.118a5d14837f8p-8", "0x0.0p+0")},
        "decode_flops": "0x1.2673000000000p+33",
        "decode_k3": {16: "0x0.0p+0", 128: "0x0.0p+0"},
        "train_flops": "0x1.b0db000000000p+45",
        "train_k4_call": "0x1.5016eb12b5c42p-15",
        "tiny_sha256": "5c827f175bc10b3e451de51445afe3f88bb11886dfeab6d6767c5c265850784f",
    },
    "qwen2-moe-a2.7b.stream-code": {
        "prefill": {1: ("0x1.1b75000000000p+32", "0x1.f822609c10a63p-24", "0x1.3f44c56ed60b4p-23"),
                    217: ("0x1.a419220000000p+39", "0x1.ab5523e44a1cep-16", "0x1.0b83bcf81c893p-15"),
                    1500: ("0x1.75c9348000000p+42", "0x1.d5540c96ed598p-13", "0x1.ce460419e02e8p-13"),
                    2045: ("0x1.01fac26000000p+43", "0x1.b4166df4f5036p-12", "0x1.3b1da3cfe26e2p-12"),
                    7936: ("0x1.1bb5ccc000000p+45", "0x1.9a4f8b9ec53f4p-8", "0x1.31b7065be789dp-10")},
        "decode_flops": "0x1.25dc400000000p+34",
        "decode_k3": {16: "0x1.3bce990103b60p-19", 128: "0x1.3b9ae77a9bb54p-16"},
        "train_flops": "0x1.b22d400000000p+46",
        "train_k4_call": "0x1.5016eb12b5c42p-15",
        "tiny_sha256": "73cf95436f21652e8063c7fa78532e82b4fe0f6feca750ad0d8f3960a77f5c02",
    },
}


def _family(workload):
    run = bench.load(workload, 0, 1.0, False)
    return run, families.of(run.config)


@pytest.mark.parametrize("workload", sorted(PARENT))
def test_counts_and_bounds_are_the_parents_to_the_bit(workload):
    run, fam = _family(workload)
    model, want = run.model, PARENT[workload]
    assert families.name_of(run.config) == "transformer"  # no key in the file
    for S, (flops, k4, k3) in want["prefill"].items():
        bounds = fam.prefill_bounds(model, S)
        assert fam.prefill_flops(model, S).hex() == flops
        assert bounds["k4_bound_s"].hex() == k4
        assert bounds.get("k3_bound_s", 0.0).hex() == k3
    assert fam.decode_flops(model, [0, 5, 1499, 2047]).hex() == want["decode_flops"]
    for slots, k3 in want["decode_k3"].items():
        assert fam.decode_bounds(model, slots)["k3_bound_s"].hex() == k3
    assert fam.train_flops(model, 8, 1024).hex() == want["train_flops"]
    one = float.fromhex(want["train_k4_call"])
    assert fam.train_bounds(model, 8, 1024, {"k4": 32})["k4_bound_s"] == 32 * one


@pytest.mark.parametrize("workload", sorted(PARENT))
def test_drawn_weights_at_the_tiny_size_are_the_parents(workload):
    run = tiny.run(workload)
    h = hashlib.sha256()
    layout = families.of(run.config).layout(run.model)
    for name, t in weights.leaves(run.model, layout, 7, "cpu"):
        h.update(name.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == PARENT[workload]["tiny_sha256"]


SPY = '''
"""A family no harness file names: the transformer's code, each call noted."""
from portbench.families import transformer as base

CALLS = []
KERNELS = (("spy_kernel", "spy_bound_s"),)


def _noted(name, fn):
    def call(*args, **kwargs):
        CALLS.append(name)
        return fn(*args, **kwargs)
    return call


layout = _noted("layout", base.layout)
served_logits = _noted("served_logits", base.served_logits)
tiny = _noted("tiny", base.tiny)
train_steps = _noted("train_steps", base.train_steps)
launches = _noted("launches", base.launches)
prefill_flops = _noted("prefill_flops", lambda model, seq: 7.0 * seq)
decode_flops = _noted("decode_flops", lambda model, positions: 3.0 * len(positions))
train_flops = _noted("train_flops", lambda model, batch, seq: 5.0 * batch * seq)
prefill_bounds = _noted("prefill_bounds", lambda model, seq: {"spy_bound_s": 1e-3 * seq})
decode_bounds = _noted("decode_bounds", lambda model, slots: {"spy_bound_s": 1e-6 * slots})
train_bounds = _noted("train_bounds", lambda model, batch, seq, calls: {"spy_bound_s": 2e-3})
'''


@pytest.fixture
def spy_root(tmp_path, monkeypatch):
    """A checkout whose olmo-1b configuration names the family ``spy_fam``,
    whose module lies in a directory of its own on the families' path."""
    (tmp_path / "fam").mkdir()
    (tmp_path / "fam" / "spy_fam.py").write_text(textwrap.dedent(SPY))
    monkeypatch.setattr(families, "__path__", [str(tmp_path / "fam")] + list(families.__path__))
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        if c["name"] == "olmo-1b":
            config = json.loads((bench.ROOT / c["file"]).read_text())
            c["file"] = "configs/spy.json"
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "spy.json").write_text(json.dumps(dict(config, family="spy_fam")))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    yield tmp_path
    mod = sys.modules.pop(f"{families.__name__}.spy_fam", None)
    if mod is not None:
        mod.CALLS.clear()
    shutil.rmtree(tmp_path / "fam")


def _traced(monkeypatch, workload, root, seconds):
    """A traced run of ``workload`` from ``root`` at a test's size; returns
    (result, the readers' ctx, the spy's calls)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    seen = {}

    def read(run, ctx, _read=bench.read_per_layer):
        seen.update(ctx)
        return _read(run, ctx)

    cell = serving if workload.endswith("stream-code") else training
    monkeypatch.setattr(cell, "read_per_layer", read)
    run = tiny.shrink(bench.load(workload, 21, seconds, True, root=root))
    if cell is serving:
        run.mix = dict(run.mix, stretch_at=0.3, stretch_s=0.2)
    else:
        run.mix = dict(run.mix, stretch_at=0.0, stretch_steps=1)
    fam = families.of(run.config)
    assert fam.__name__.endswith(".spy_fam")
    result, checks = cell.run_cell(run)
    assert result["correct"], checks
    return result, seen, list(fam.CALLS)


def test_a_family_is_found_from_the_configuration_file_alone(spy_root, monkeypatch, capsys):
    result, ctx, calls = _traced(monkeypatch, "olmo-1b.stream-code", spy_root, 1.6)
    for name in ("tiny", "layout", "prefill_flops", "decode_flops", "prefill_bounds",
                 "decode_bounds", "served_logits"):
        assert name in calls, name
    assert ctx["kernels"] == {"spy_bound_s": "spy_kernel"}
    steps = ctx["steps"]
    assert {s["kind"] for s in steps} == {"prefill", "decode"}
    for s in steps:  # the spy's counts and bounds, and no other kernel's
        if s["kind"] == "prefill":
            assert s["flops"] == 7.0 * (s["tokens"] - 1)
            assert s["spy_bound_s"] == pytest.approx(1e-3 * (s["tokens"] - 1))
        assert "k4_bound_s" not in s and "k3_bound_s" not in s
    assert "stretch kernels spy_kernel: 0 calls" in capsys.readouterr().err
    # the roofline readers find no kernel of theirs in the spy's list
    assert "k4_roofline.serve" not in result["metrics"]


def test_a_family_trains_from_the_configuration_file_alone(spy_root, monkeypatch, capsys):
    result, ctx, calls = _traced(monkeypatch, "olmo-1b.train", spy_root, 0.5)
    for name in ("tiny", "layout", "launches", "train_steps", "train_flops", "train_bounds"):
        assert name in calls, name
    assert ctx["kernels"] == {"spy_bound_s": "spy_kernel"}
    assert all(s["flops"] == 5.0 * 2 * 16 and s["spy_bound_s"] == 2e-3 for s in ctx["steps"])
    assert "k4_bound_s" not in ctx["steps"][0]
    assert "stretch kernels spy_kernel: 0 calls" in capsys.readouterr().err


def test_a_family_that_lacks_a_piece_is_refused(tmp_path, monkeypatch):
    (tmp_path / "half_fam.py").write_text("def layout(model):\n    return {}\n")
    monkeypatch.setattr(families, "__path__", [str(tmp_path)] + list(families.__path__))
    try:
        with pytest.raises(TypeError, match="lacks"):
            families.of({"family": "half_fam"})
    finally:
        sys.modules.pop(f"{families.__name__}.half_fam", None)
    with pytest.raises(ValueError):
        families.of({"family": "../weights"})
    # a family that serves but does not train is refused for a training cell
    monkeypatch.setattr(families, "TRAINS", families.TRAINS + ("no_such_piece",))
    with pytest.raises(TypeError, match="does not train"):
        families.for_training({})


HARNESS = ("serving.py", "training.py", "calibrate.py", "tiny.py")
SHARED = {"reference": {"gaps"}, "counts": {"bound_s", "k3", "k4", "PEAKS"},
          "weights": {"leaves", "make", "nest"}}


@pytest.mark.parametrize("name", HARNESS)
def test_the_harness_reaches_model_code_only_through_the_lookup(name):
    """No harness module imports a family's module or calls a model's code
    in the shared modules (only their generic pieces)."""
    tree = ast.parse((bench.HERE / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):  # ``from . import families`` alone
            module = node.module or ""
            assert module not in ("families", "portbench.families"), name
            assert not module.startswith(("families.", "portbench.families.")), name
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                and node.value.id in SHARED:
            assert node.attr in SHARED[node.value.id], (name, node.value.id, node.attr)
