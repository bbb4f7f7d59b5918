"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
jax nor the JAX package, and its entry points run on CUDA unless the caller
asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import default_device
from repro_torch.configs import smoke_config
from repro_torch.models.common import init_params
from repro_torch.serve.engine import OrderedServingEngine

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def _imports(path):
    """(line, top-level module) of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_importing_every_module_loads_no_jax_and_no_reference_package():
    mods = list(_port_modules())
    for m in ("repro_torch.kernels.attention.flash", "repro_torch.kernels.affine.affine",
              "repro_torch.columnar.device", "repro_torch.core.procrun",
              "repro_torch.core.api", "repro_torch.analysis.plancheck",
              "repro_torch.launch.stream", "repro_torch.kernels.reorder.reorder",
              "repro_torch.kernels.reorder.ops", "repro_torch.kernels.dispatch.dispatch",
              "repro_torch.kernels.dispatch.ops", "repro_torch.kernels.ssd.ssd",
              "repro_torch.kernels.ssd.ops", "repro_torch.streams.tpcxbb",
              "repro_torch.core.simulate", "repro_torch.serve.mux", "repro_torch.serve.loadgen",
              "repro_torch.analysis.common", "repro_torch.analysis.__main__",
              "repro_torch.launch.bench_core", "repro_torch.train",
              "repro_torch.train.optimizer", "repro_torch.train.checkpoint",
              "repro_torch.train.train_step", "repro_torch.train.grad_compression",
              "repro_torch.train.data", "repro_torch.launch.train", "repro_torch.tree"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "import torch\n"
        "print(torch.cuda.is_initialized())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bad, cuda_initialized = out.stdout.split("\n")[:2]
    assert bad == "[]"
    assert cuda_initialized == "False"  # importing the package does not touch CUDA


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_reference_package(path):
    bad = [(line, name) for line, name in _imports(path) if _is_forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted((REPO / "tests").glob("test_torch_*.py")),
                         ids=lambda p: p.name)
def test_port_tests_import_no_jax_and_no_reference_package(path):
    """The port's tests get every JAX reference value from a spawned child
    (``tests/torch_jaxref.py``, the only module that imports jax or
    ``repro``, and only in the child): a jax computation in a pytest worker
    would break the reference's fork tests that run on it later."""
    bad = [(line, name) for line, name in _imports(path) if _is_forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


# The port's copies of JAX-free reference modules that are verbatim: equal to
# the original apart from the first-line marker and repro_torch -> repro.
# Not listed, for their declared differences (ROADMAP north star):
# core/operators.py and core/api.py (the device backend names, relative
# plancheck imports), core/procrun.py (backend names, the CUDA fork guard,
# kernel build before any fork, one torch thread per device worker,
# device_stats) and columnar/__init__.py (have_cuda, cuda_fork_hazard).
VERBATIM_COPIES = (
    "analysis/plancheck.py", "columnar/block.py", "columnar/codec.py", "core/checkpoint.py",
    "core/costmodel.py", "core/faults.py", "core/hybrid.py", "core/pipeline.py",
    "core/reorder.py", "core/runtime.py", "core/scheduler.py", "core/serial.py", "core/shm.py",
    "streams/sources.py", "streams/parametric.py", "streams/tpcxbb.py", "core/simulate.py",
    "serve/loadgen.py", "serve/mux.py", "analysis/common.py", "analysis/guards.py",
    "analysis/lockgraph.py", "analysis/forksafety.py", "analysis/__main__.py", "train/data.py",
    "configs/shapes.py", "launch/report.py",
)


@pytest.mark.parametrize("rel", VERBATIM_COPIES)
def test_verbatim_copy_equals_its_original(rel):
    copy = (PORT / rel).read_text().splitlines(keepends=True)
    marker = (f"# Port copy of src/repro/{rel} (the port imports nothing of the JAX "
              "package): keep the two in sync by hand.\n")
    assert copy[0] == marker
    original = (REPO / "src" / "repro" / rel).read_text()
    assert "".join(copy[1:]).replace("repro_torch", "repro") == original


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    cfg = smoke_config("olmo-1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OrderedServingEngine(cfg, params)
    eng = OrderedServingEngine(cfg, params, max_slots=2, max_len=24, device="cpu")
    eng.submit(np.arange(5), max_new_tokens=3)
    (comp,) = eng.run_to_completion()
    assert len(comp.tokens) == 3
    assert default_device("cpu") == torch.device("cpu")


def test_launch_serve_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    comps = main(["--device", "cpu", "--requests", "3", "--schedule", "prefill_first"])
    assert [c.serial for c in comps] == [1, 2, 3]
    assert "ordered egress verified" in capsys.readouterr().out


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": ""})


def test_chip_smoke_fails_alone_and_without_a_card(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    runs = [_run_smoke(tmp_path)]
    if not torch.cuda.is_available():
        runs.append(_run_smoke(REPO))
    for out in runs:
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def _wrapper_call(name):
    """A call of one kernel wrapper on tensors that are not on the CPU (the
    ``meta`` device stands in for a card this machine does not have)."""
    meta = dict(device="meta")
    if name == "commit":
        from repro_torch.kernels.reorder.ops import commit
        from repro_torch.kernels.reorder.ref import init_state

        return commit, lambda: commit(init_state(8, 4, **meta), torch.zeros(2, dtype=torch.int32, **meta),
                                      torch.zeros(2, 4, **meta))
    if name == "dispatch":
        from repro_torch.kernels.dispatch.ops import dispatch

        return dispatch, lambda: dispatch(torch.zeros(4, dtype=torch.int32, **meta),
                                          torch.zeros(4, 8, **meta), 2, 2)
    from repro_torch.kernels.ssd.ops import ssd

    B, L, H, P, N = 1, 64, 2, 64, 64
    return ssd, lambda: ssd(torch.zeros(B, L, H, P, **meta), torch.zeros(B, L, H, **meta),
                            torch.zeros(H, **meta), torch.zeros(B, L, N, **meta),
                            torch.zeros(B, L, N, **meta), chunk=64)


@pytest.mark.parametrize("name", ["commit", "dispatch", "ssd"])
def test_kernel_wrappers_raise_off_the_cpu_and_never_fall_back(name):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's binding, which raises when it cannot launch."""
    wrapper, call = _wrapper_call(name)
    before = wrapper.LAUNCHES
    with pytest.raises(ValueError, match="launches a CUDA kernel; tensors are on meta"):
        call()
    assert wrapper.LAUNCHES == before


def test_ptxas_report_gives_one_line_per_kernel():
    from repro_torch.kernels import _build

    src = pathlib.Path("k.cu")
    _build.BUILD_LOGS[str(src)] = "\n".join([
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1av",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 149 registers, used 2 barriers",
        "ptxas warning : wgmma serialization",
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
    ])
    try:
        assert _build.ptxas_report(src) == [
            "_Z1av: Used 149 registers, used 2 barriers; "
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "ptxas warning : wgmma serialization",
            "_Z1bv: Used 80 registers, used 1 barriers; "
            "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        ]
    finally:
        del _build.BUILD_LOGS[str(src)]
