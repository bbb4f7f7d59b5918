"""The port's example twins (``examples/torch_*.py``) run on the CPU and
check their own results: each imports ``repro_torch`` where its original
imports ``repro``; the serving one needs ``--device cpu`` without a card."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    "torch_quickstart.py": ([], "ordered execution verified"),
    "torch_fraud_detection.py": ([], "ordered windowed alerts verified"),
    "torch_streaming_session.py": ([], "process: "),
    "torch_tpcxbb_stream.py": (["q3", "4000", "process"], "egress tuples: "),
    "torch_serve_ordered.py": (["--device", "cpu"], "ordered egress verified for both policies"),
}


def _run(name, args):
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", name), *args],
                          cwd=REPO, capture_output=True, text=True, timeout=110,
                          env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_twin_runs_on_the_cpu(name):
    args, want = EXAMPLES[name]
    out = _run(name, args)
    assert out.returncode == 0, out.stderr[-2000:]
    assert want in out.stdout
    with open(os.path.join(REPO, "examples", name)) as f:
        src = f.read()
    assert "import repro." not in src and "from repro." not in src and "from repro " not in src


@pytest.mark.timeout(120)
def test_serving_example_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.device_count():
        pytest.skip("checks the behaviour of a machine without CUDA")
    out = _run("torch_serve_ordered.py", [])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
