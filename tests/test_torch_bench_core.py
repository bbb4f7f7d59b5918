"""The port's twin of ``benchmarks/bench_core.py``
(``repro_torch.launch.bench_core``) on the CPU: its ``device_offload`` row
(K1's plain version, ``--device cpu``) and its ``serving`` row at a tiny
window carry the reference's row keys, and the offload row's egress is in
order.  The reference's rows run in a spawned child (``torch_jaxref``)."""
import ast
import functools
import inspect
import os

import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.launch import bench_core

# runs the reference package only (no jax computation), one child per call:
# the port's rows below fork workers from this process
JAX = Reference(keep=False)
_reference_child = JAX.fixture()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 0.2
# the keys the twin's device_offload row adds to the reference's
OFFLOAD_EXTRA = {"device_dispatches", "device_launches", "egress_in_order"}


@functools.lru_cache(maxsize=None)
def _reference_keys() -> dict:
    return JAX("bench_core_rows", REPO, SECONDS, 2)


@pytest.mark.timeout(120)
def test_device_offload_row_on_the_cpu():
    row = bench_core._run_device_offload(SECONDS, 2, device="cpu")
    assert set(row) - OFFLOAD_EXTRA == set(_reference_keys()["device_offload"])
    assert (row["device_backend"], row["device_kernel"]) == ("cpu", "affine_pallas")
    assert row["egress_in_order"] and row["tuples"] >= 2000
    assert row["device_dispatches"] > 0 and row["device_launches"] == 0  # the plain version ran
    assert row["throughput_per_s"] > 0


@pytest.mark.timeout(120)
def test_serving_row_keys_equal_reference():
    row = bench_core._run_serving(SECONDS, 2)
    assert set(row) == set(_reference_keys()["serving"])
    assert row["sessions"] == bench_core.SERVING_SESSIONS
    assert row["p50_latency_ms"] <= row["p99_latency_ms"] <= row["p999_latency_ms"]


def test_offload_checks_egress_against_python(monkeypatch):
    """A row whose egress differs from the chain computed in Python raises."""
    monkeypatch.setattr(bench_core, "_offload_expected",
                        lambda n: [(3 * v,) * bench_core.COL_WIDTH for v in range(n)])
    with pytest.raises(RuntimeError, match="not in order or differs"):
        bench_core._run_device_offload(SECONDS, 2, device="cpu")


def test_constants_equal_the_reference():
    """The twin keeps every workload constant of the reference (read from its
    source: importing ``benchmarks`` would import ``repro``)."""
    with open(os.path.join(REPO, "benchmarks", "bench_core.py")) as f:
        tree = ast.parse(f.read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
              for t in node.targets if t.id.isupper()}
    assert len(consts) >= 20
    assert {name: getattr(bench_core, name) for name in consts} == consts


def test_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.device_count():
        pytest.skip("checks the behaviour of a machine without CUDA")
    out = tmp_path / "b.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_core.main(["--smoke", "--out", str(out)])
    assert not out.exists()  # raised before any row
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_core._run_device_offload(SECONDS, 2)


def test_default_output_is_the_ports_own_file():
    """The root's BENCH_core.json stays the reference's."""
    default = inspect.signature(bench_core.run).parameters["out"].default
    assert default == os.path.join("build", "BENCH_core_torch.json")
