"""Port parity: the ordered stream runtime through its device stage
(``repro_torch.core`` + ``repro_torch.columnar``) against the JAX package's.

Each engine's graph is built from that package's own ``OpSpec`` /
``device_op``; the port runs its device stages with ``device_backend="cpu"``
(torch on the CPU through K1's plain version), the reference with
``"numpy"``.  Egress is compared bit for bit (``repr`` of every value, so
float columns match to the last bit and in sign).  K1 itself is held to
its plain version on the card in ``test_torch_affine.py``.  The reference's
engine runs in a spawned child (``torch_jaxref``), never in this process;
the operators and chains are the helper's, shared by both packages.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline env: degrade to seeded randomized sampling
    from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

import torch_jaxref as ref
from torch_jaxref import Reference
import repro_torch.columnar as tcol
import repro_torch.core as tcore
from repro_torch.columnar import device as tdevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 157  # the reference's device-test stream length
# runs the reference package only (no jax computation), one child per call:
# the port's runs below fork workers from this process
JAX = Reference(keep=False)
_reference_child = JAX.fixture()
_pair = ref.pair
_device_chain = ref.device_chain
_run = ref.run_process


# ---------------------------------------------------------------- operators
def _source(code: str) -> list:
    rng = np.random.default_rng(len(code) + ord(code[0]))
    if code == "i8":  # beyond int32, and x*3 overflows int64 for some
        return rng.integers(-(2**62), 2**62, size=N, dtype=np.int64).tolist()
    if code == "i4":  # v*2 fits int32; x*3 wraps for some
        return rng.integers(-(2**29), 2**29, size=N, dtype=np.int64).tolist()
    return (rng.standard_normal(N) * 1e3).tolist()


# ------------------------------------------------ (a) device egress parity
BATCH_SIZES, KERNELS, CODES = [1, 7, 32], ["affine", "square", "affine_pallas"], ["i8", "f8", "i4", "f4"]


@functools.lru_cache(maxsize=None)
def _reference_egress() -> dict:
    """(reference egress, per-value reference) of every case of the test
    below, each as ``repr``, from one child."""
    cases = [(c, k, b) for c in CODES for k in KERNELS for b in BATCH_SIZES]
    return dict(zip(cases, JAX("stream_device_egress_many",
                               [(_source(c), c, k, b) for c, k, b in cases])))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("batch_size", BATCH_SIZES)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("code", CODES)
def test_device_egress_bit_identical_to_reference(code, kernel, batch_size):
    """The port's process-backend egress (``cpu`` backend) equals the JAX
    package's (``numpy`` backend) and the per-value NumPy reference, bit for
    bit, however device batches regroup dispatch units."""
    source = _source(code)
    ours, res = _run(tcore, _device_chain(tcore, tcol, code, kernel, "cpu"), source,
                     "cpu", batch_size)
    theirs, want = _reference_egress()[code, kernel, batch_size]
    assert repr(ours) == theirs == want
    (stats,) = res.target.device_stats
    assert stats["backend"] == "cpu" and stats["rows"] == N
    assert stats["launches"] == 0  # the plain version ran, not K1


# ---------------------------------------- (b) keyed + stateful chain parity
@pytest.mark.timeout(120)
@pytest.mark.parametrize("backend", ["thread", "process"])
def test_keyed_stateful_chain_egress_equal(backend):
    source = list(range(301))
    eng = tcore.Engine(tcore.EngineConfig(
        backend=backend, num_workers=2, batch_size=7, collect_outputs=True))
    outs = [eng.run(ref.keyed_chain(tcore), source).handle().outputs,
            JAX("stream_keyed", source, backend)]
    assert outs[0] == outs[1]
    assert len(outs[0]) == len(source)


# ------------------------------------------------------- (c) explain text
@pytest.mark.parametrize("chain_fn", [ref.golden_device_chain, ref.keyed_chain],
                         ids=["device", "keyed"])
def test_explain_text_equal_apart_from_backend_name(chain_fn):
    ours = ref.explain(tcore, tcol, chain_fn, "cpu")
    theirs = JAX("stream_explain", chain_fn.__name__, "numpy")
    assert ours.replace("backend=cpu", "backend=numpy") == theirs
    # the defaults differ only in the name too: cuda here, auto there
    assert (ref.explain(tcore, tcol, chain_fn, "").replace("backend=cuda", "backend=auto")
            == JAX("stream_explain", chain_fn.__name__, ""))


# --------------------------------------------- (d) executor unit boundaries
@settings(max_examples=15, deadline=None)
@given(
    sizes=st.lists(st.integers(min_value=1, max_value=9), min_size=1,
                   max_size=20),
    batch=st.integers(min_value=1, max_value=16),
)
def test_device_executor_preserves_unit_boundaries(sizes, batch):
    """The port's DeviceExecutor splits completed batches back into the
    exact submitted units — serials and marks untouched — however units
    regroup into device batches (both host backends)."""
    for backend, kernel in (("cpu", "affine_pallas"), ("numpy", "affine")):
        spec = tcol.device_op("dev", kernel, tcol.Schema.of("i8", scalar=True),
                              params={"a": 2, "b": 1}, backend=backend)
        ex = tcol.DeviceExecutor(spec, batch=batch, inflight=2)
        serial = 1
        submitted = []
        outs = []
        for n in sizes:
            vals = list(range(serial, serial + n))
            marks = [(0, f"mark{serial}")]
            blk = tcol.ColumnBlock.from_values(vals, head_serial=serial, marks=marks,
                                               schema=spec.schema)
            submitted.append((serial, vals, marks))
            outs.extend(ex.submit(blk))
            serial += n
        outs.extend(ex.flush())
        assert ex.pending_rows == 0 and ex.inflight == 0
        assert len(outs) == len(submitted)
        for blk, (head, vals, marks) in zip(outs, submitted):
            assert blk.head_serial == head and blk.contiguous_serials()
            assert blk.to_values() == [v * 2 + 1 for v in vals]
            assert blk.marks == marks


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_device_executor_never_reuses_a_buffer_too_early(inflight):
    """A staging buffer is rewritten only after its batch was popped, and the
    blocks a pop hands back stay valid across later dispatches.  On the cpu
    backend a batch's work runs when it is popped, the latest point the card
    could run it, so a ring of ``inflight`` slots (one too few) or popped
    views into a slot would change these values."""
    spec = tcol.device_op("dev", "affine_pallas", tcol.Schema.of("i8", "i4"),
                          params={"a": 3, "b": -1}, backend="cpu")
    ex = tcol.DeviceExecutor(spec, batch=2, inflight=inflight)
    held, want = [], []
    for s in range(1, 41, 2):
        rows = [(s * 10**12, s), (-(s * 10**12) - 1, -s)]
        want.extend((a * 3 - 1, b * 3 - 1) for a, b in rows)
        held.extend(ex.submit(tcol.ColumnBlock.from_values(rows, head_serial=s,
                                                           schema=spec.schema)))
        assert ex.inflight <= inflight
    held.extend(ex.flush())
    assert [v for blk in held for v in blk.to_values()] == want
    assert ex.dispatches == 20 and len(ex._slots) == inflight + 1


@pytest.mark.parametrize("backend", ["cpu", "numpy"])
def test_device_executor_stats_split(backend):
    """``stats()`` reports the split that exists: the kernel (on the card, the
    side stream's interval holding the copy in and the launch), host work and
    waiting; no copy keys, and no buffers on a card."""
    spec = tcol.device_op("dev", "affine_pallas", tcol.Schema.of("i8", "f4"),
                          params={"a": 3, "b": -1}, backend=backend)
    ex = tcol.DeviceExecutor(spec, batch=4, inflight=2)
    for s in range(1, 41, 4):
        rows = [(s + i, float(s + i)) for i in range(4)]
        ex.submit(tcol.ColumnBlock.from_values(rows, head_serial=s, schema=spec.schema))
    ex.flush()
    st = ex.stats()
    assert set(st) == {"backend", "dispatches", "launches", "rows", "host_ms", "wait_ms",
                       "kernel_ms"}
    assert (st["backend"], st["dispatches"], st["rows"], st["launches"]) == (backend, 10, 40, 0)
    assert st["kernel_ms"] > 0 and st["host_ms"] > 0
    for slot in getattr(ex, "_slots", []):
        assert slot.dev_in is None and not hasattr(slot, "dev_out")


# ------------------------------------------ (e) construction and backends
def test_device_op_rejects_bad_construction():
    with pytest.raises(ValueError):
        tcol.device_op("d", "no_such_kernel", tcol.Schema.of("i8"))
    with pytest.raises(ValueError):
        # device ops are 1:1 — a filtering device op would make partial-batch
        # flushes observable
        tcore.OpSpec("d", "device", _pair, selectivity=0.5,
                     schema=tcol.Schema.of("i8"), device_kernel=("affine", ()))
    with pytest.raises(ValueError):
        tcore.OpSpec("d", "device", _pair)  # no kernel/schema
    with pytest.raises(TypeError):
        tcol.ref_apply("not numeric", "affine", (), tcol.Schema.of("i8", scalar=True))


@pytest.mark.parametrize("name", ["auto", "jax", "gpu", ""])
def test_unknown_or_auto_backend_raises_naming_the_three(name):
    with pytest.raises(tcore.ConfigError, match="cuda|cpu|numpy"):
        tcol.device_op("d", "affine", tcol.Schema.of("i8"), backend=name)
    with pytest.raises(tcore.ConfigError, match="cuda|cpu|numpy"):
        tcore.Engine(tcore.EngineConfig(
            backend="process", process=tcore.ProcessOptions(device_backend=name)))
    with pytest.raises(ValueError, match="cuda|cpu|numpy"):
        tcore.ProcessRuntime({}, [], device_backend=name)


def test_cuda_backend_raises_without_a_card():
    if torch.cuda.device_count():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_backend("cuda")
    chain = _device_chain(tcore, tcol, "i8", "affine_pallas", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(tcore, chain, list(range(10)), "cuda", 4)


# ------------------------------------------------------- (f) fork guard
@pytest.mark.timeout(60)
def test_cuda_fork_guard_raises_before_any_fork(monkeypatch):
    """A parent that has initialised CUDA cannot fork ``cuda`` device
    workers: the runtime raises at once, before any ring or process."""
    monkeypatch.setattr(tdevice, "have_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert tdevice.cuda_fork_hazard()
    forks = []
    monkeypatch.setattr(tcore.ProcessRuntime, "_fork_worker",
                        lambda self, *a, **k: forks.append(a))
    chain = _device_chain(tcore, tcol, "i8", "affine_pallas", "cuda")
    with pytest.raises(RuntimeError, match="cannot fork a cuda device worker"):
        _run(tcore, chain, list(range(10)), "cuda", 4)
    assert forks == []


def test_a_device_worker_that_cannot_start_fails_the_run(monkeypatch):
    """A worker whose executor cannot start (as a forked child of a process
    that initialised the CUDA driver) fails the run at once with its error;
    a re-forked replacement would fail the same way, so nothing restarts."""
    parent = os.getpid()

    def failing(params):
        if os.getpid() != parent:
            raise RuntimeError("initialization error")
        return tdevice._torch_affine(params)

    monkeypatch.setitem(tdevice.KERNELS, "failing", (tdevice._np_affine, failing))
    chain = _device_chain(tcore, tcol, "i8", "failing", "cpu")
    with pytest.raises(RuntimeError, match="device worker setup failed.*initialization error"):
        _run(tcore, chain, list(range(50)), "cpu", 4)


def _stream_after(prelude: str):
    script = (
        f"{prelude}\n"
        "from repro_torch.launch.stream import main\n"
        "main(['--tuples', '20000', '--device-batch', '1024'])\n"
    )
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=150, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})


@pytest.mark.cuda
@pytest.mark.timeout(300)
def test_fork_rule_on_the_card():
    """On the card: a stream run from a process that asked
    ``torch.cuda.is_available()`` (which initialises the CUDA driver, so
    forked workers cannot use the card) fails at once with the worker's
    error; one whose process asked ``default_device()`` (NVML) runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bad = _stream_after("import torch; assert torch.cuda.is_available()")
    assert bad.returncode != 0
    assert "device worker setup failed" in bad.stderr
    good = _stream_after(
        "import torch; from repro_torch import default_device; default_device()\n"
        "assert not torch.cuda.is_initialized()")
    assert good.returncode == 0, good.stderr[-2000:]
    assert "bit-identical to NumPy" in good.stdout


# ------------------------------------------- (g) torch thread pool + fork
@pytest.mark.timeout(120)
def test_no_hang_after_the_parent_used_the_torch_thread_pool():
    """A parent that ran a parallel torch CPU op (starting the intra-op
    pool) still runs the stream: device workers drop to one thread."""
    script = (
        "import torch\n"
        "torch.set_num_threads(4)\n"
        "x = torch.randn(4_000_000)\n"
        "print(float((x * 2 + 1).sum()) != 0.0)\n"
        "from repro_torch.launch.stream import main\n"
        "r = main(['--device', 'cpu', '--tuples', '4000', '--device-batch', '256'])\n"
        "print('STREAM', r['dispatches'] > 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=110, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "STREAM True" in proc.stdout
    assert "bit-identical to NumPy" in proc.stdout


# --------------------------------------------------- the slice as a whole
@pytest.mark.timeout(120)
def test_stream_launcher_matches_the_reference_device_chain():
    """``launch.stream`` on the CPU: the reference's own engine, on its own
    graph of the same chain (``numpy`` backend), gives the same egress."""
    from repro_torch.launch import stream

    def segments():
        return {f for f in os.listdir("/dev/shm") if f.startswith("rtorch_")}

    before = segments()
    r = stream.main(["--device", "cpu", "--tuples", "3000", "--device-batch", "256",
                     "--seed", "5"])
    assert segments() == before  # the port's rings are unlinked after the run
    assert r["dispatches"] >= 2 * (3000 // 256)
    source = stream.make_source(3000, 5).tolist()
    theirs = JAX("stream_launcher_reference", source, stream.DEVICE_PARAMS, stream.IO_BATCH)
    np.testing.assert_array_equal(np.array(theirs, dtype=np.int64),
                                  stream.expected(stream.make_source(3000, 5)))
