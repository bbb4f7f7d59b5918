"""Nothing the benchmark runs imports JAX or the JAX package, by top-level
name compared whole (the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench import bench

HERE = Path(bench.__file__).resolve().parent


def test_forbidden_names_compare_whole():
    assert bench.FORBIDDEN == {"jax", "jaxlib", "flax", "repro"}
    for name in ("repro_torch", "repro_torch.serve", "jaxtyping", "reprox"):
        assert name.split(".")[0] not in bench.FORBIDDEN
    for name in ("repro", "repro.models", "jax.numpy", "flax.linen"):
        assert name.split(".")[0] in bench.FORBIDDEN


def test_no_source_of_the_benchmark_imports_them():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in bench.FORBIDDEN, (path, n)


def test_the_harness_loads_none_of_them():
    """Import every module a run uses, and the program's serving and
    training entries, in a fresh interpreter; then look at sys.modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import portbench.run, portbench.serving, portbench.training, portbench.calibrate\n"
        "import repro_torch.serve.engine, repro_torch.train.train_step\n"
        "from portbench import bench\n"
        "print(bench.forbidden_modules())\n" % (str(HERE.parent / "src"), str(HERE.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_result_line_carries_every_key_the_checks_last(capsys):
    checks = {"served_logit_gap": {"value": 0.01, "limit": 0.2}}
    bench.emit({"correct": True, "attempted": 3, "failed": 0, "metrics": {},
                "device": {"platform": "gpu"}}, checks)
    out, err = capsys.readouterr()
    import json
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert err.strip().splitlines()[-1] == "check served_logit_gap 0.01 limit 0.2"
