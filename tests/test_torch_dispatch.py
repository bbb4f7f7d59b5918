"""Port parity: K3's wrapper and plain version (``kernels/dispatch``) against
the JAX package's ``dispatch_ref`` (bit for bit) and its Pallas
``dispatch_pallas`` in interpret mode (1e-5, the tolerance of
``tests/test_kernels.py``).

Inputs are made with numpy from a seed and handed to both frameworks; the
JAX side runs in a spawned child (``torch_jaxref``), never in this process.
On the CPU the wrapper takes the plain version; K3 itself runs only on the
card (``cuda`` marker).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from repro_torch.kernels import parity
from repro_torch.kernels.dispatch import dispatch as k3
from repro_torch.kernels.dispatch.ops import Dispatch, dispatch
from repro_torch.kernels.dispatch.ref import dispatch_ref
from repro_torch.launch import bench_dispatch, profile_serve
from repro_torch.models.convert import tensor_from_numpy

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = Reference()
_jax_child = JAX.fixture()


def _bits(a) -> np.ndarray:
    """The bit patterns of a torch tensor or a numpy/jax array."""
    if isinstance(a, torch.Tensor):
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _payloads(rng, T, W, dtype):
    x = rng.standard_normal((T, W))
    return bf16(x) if dtype == "bfloat16" else x.astype(np.float32)


def _check_against_jax(ids, payloads, P, C, pallas=True):
    before = dispatch.LAUNCHES
    buf, counts, dest = dispatch(torch.from_numpy(ids), tensor_from_numpy(payloads, "cpu"), P, C)
    assert dispatch.LAUNCHES == before  # the CPU path launches nothing
    assert buf.shape == (P, C, payloads.shape[1]) and buf.dtype == tensor_from_numpy(payloads, "cpu").dtype
    assert counts.dtype == torch.int32 and dest.dtype == torch.int32
    (buf_r, counts_r, dest_r), want_p = JAX("dispatch", ids, payloads, P, C, pallas=pallas)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_r))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(dest_r))
    np.testing.assert_array_equal(_bits(buf), _bits(buf_r))
    if pallas:
        buf_p, counts_p, dest_p = want_p
        np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_p))
        np.testing.assert_array_equal(dest.numpy(), np.asarray(dest_p))
        np.testing.assert_allclose(buf.float().numpy(), np.asarray(buf_p, np.float32),
                                   rtol=1e-5, atol=1e-5)
    return buf, counts, dest


@pytest.mark.parametrize("T,P,C,W", [(64, 8, 16, 128), (128, 4, 8, 128), (32, 16, 4, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_matches_jax_ref_and_pallas(T, P, C, W, dtype):
    rng = np.random.RandomState(1)
    ids = rng.randint(-1, P, T).astype(np.int32)
    _check_against_jax(ids, _payloads(rng, T, W, dtype), P, C)


def test_dispatch_preserves_arrival_order():
    """Theorem 4.1(2) vectorized (tests/test_kernels.py:86-95): within a
    partition, buffer order = arrival order."""
    T, P, C, W = 32, 2, 32, 4
    ids = torch.tensor([t % P for t in range(T)], dtype=torch.int32)
    payloads = torch.arange(T, dtype=torch.float32)[:, None] * torch.ones(1, W)
    buf, counts, dest = dispatch(ids, payloads, P, C)
    for p in range(P):
        got = buf[p, : int(counts[p]), 0].numpy()
        np.testing.assert_array_equal(got, np.asarray([t for t in range(T) if t % P == p], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skewed_batch_overflows_and_drops_as_the_reference(dtype):
    """Zipf-skewed ids: hot partitions pass their capacity; the overflow is
    dropped (dest -1, counts before the clamp) and the rest keeps arrival
    order."""
    rng = np.random.RandomState(7)
    T, P, C, W = 512, 8, 24, 32
    ids = parity.zipf_ids(rng, T, P)
    payloads = _payloads(rng, T, W, dtype)
    buf, counts, dest = _check_against_jax(ids, payloads, P, C)
    counts = counts.numpy()
    assert (counts > C).any() and (counts < C).any()
    assert counts.sum() == (ids >= 0).sum()
    dest = dest.numpy()
    kept = dest >= 0
    assert kept.sum() == np.minimum(counts, C).sum()
    for p in range(P):  # arrival order of the kept tuples of each partition
        arrivals = np.flatnonzero(ids == p)[:C]
        np.testing.assert_array_equal(dest[arrivals], p * C + np.arange(len(arrivals)))
    assert not buf.view(-1, W)[np.setdiff1d(np.arange(P * C), dest[kept])].float().any()


def test_moe_routing_matches_the_reference():
    """The documented MoE use (dispatch.py:7-8) at a small size: top-2 of 4
    experts for 48 tokens, capacity as ffn.py computes it."""
    rng = np.random.RandomState(11)
    tokens, E, k, W = 48, 4, 2, 64
    top = np.argsort(rng.standard_normal((tokens, E)), axis=1)[:, :k].astype(np.int32)
    C = max(int(np.ceil(tokens * k / E * 1.25)), 4)
    _check_against_jax(top.reshape(-1), _payloads(rng, tokens * k, W, "bfloat16"), E, C)


def test_ids_past_the_partitions_are_invalid():
    """An id at or past P counts nowhere and fills no row, as in the JAX
    reference; its dest is -1, where the JAX reference gives an index past
    the end of the buffers.  The other tuples rank as if it were absent."""
    rng = np.random.RandomState(5)
    T, P, C, W = 64, 4, 12, 8
    ids = rng.randint(-1, P, T).astype(np.int32)
    past = rng.rand(T) < 0.2
    ids[past] = P + rng.randint(0, 3, int(past.sum()))
    payloads = rng.standard_normal((T, W)).astype(np.float32)
    buf, counts, dest = dispatch(torch.from_numpy(ids), torch.from_numpy(payloads), P, C)
    (buf_r, counts_r, dest_r), _ = JAX("dispatch", ids, payloads, P, C)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_r))
    np.testing.assert_array_equal(_bits(buf), _bits(buf_r))
    dest, dest_r = dest.numpy(), np.asarray(dest_r)
    assert (dest[past] == -1).all() and (dest_r[past] >= P * C).all()
    np.testing.assert_array_equal(dest[~past], dest_r[~past])
    clean = np.where(past, -1, ids)  # the same batch with those ids set to -1
    for a, b in zip((buf, counts, dest), dispatch(torch.from_numpy(clean),
                                                   torch.from_numpy(payloads), P, C)):
        assert torch.equal(torch.as_tensor(a), b)


def test_parity_check_passes_the_plain_version_and_catches_a_wrong_kernel():
    """``parity.check_dispatch`` (run on the card against K3) accepts a
    dispatch equal to the plain version and raises on one that differs."""
    assert parity.check_dispatch(dispatch, device="cpu") == (
        2 * len(parity.DISPATCH_GROUPS) * len(parity.DISPATCH_SWEEP))

    def wrong(ids, payloads, P, C, group=1):
        buf, counts, dest = dispatch_ref(ids, payloads, P, C, group)
        return buf, counts, torch.where(dest >= 0, dest, -2)

    with pytest.raises(RuntimeError, match="K3 disagrees"):
        parity.check_dispatch(wrong, device="cpu")


def test_use_kernel_false_is_the_plain_version():
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(-1, 4, 40).astype(np.int32))
    payloads = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    for a, b in zip(dispatch(ids, payloads, 4, 6, use_kernel=False),
                    dispatch_ref(ids, payloads, 4, 6)):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "T,P,C,W,match",
    [
        (k3.MAX_TUPLES + 1, 4, 4, 1, "tuples"),
        (16, k3.MAX_PARTITIONS + 1, 4, 8, "partitions"),
        (16, 4, 0, 8, "capacity"),
        (16, 1024, 2**21, 8, "capacity"),
        (0, 4, 4, 8, "tuples"),
    ],
)
def test_kernel_binding_rejects_what_the_kernel_does_not_take(T, P, C, W, match):
    ids = torch.zeros(T, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        k3.check_inputs(ids, torch.zeros(T, W), P, C)
    with pytest.raises(ValueError, match="int32"):
        k3.check_inputs(ids.long(), torch.zeros(T, W), 4, 4)


def test_kernel_binding_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        k3.dispatch_fwd(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8), 2, 2)


@pytest.mark.parametrize("T,rows,group", [(16, 16, 4), (16, 8, 4), (15, 5, 2), (16, 4, 0)])
def test_kernel_binding_rejects_a_group_that_does_not_fit(T, rows, group):
    """Tuple t takes payload row t // group: the payloads must have exactly
    T / group rows, and group must divide T."""
    with pytest.raises(ValueError, match="group|payloads"):
        k3.check_inputs(torch.zeros(T, dtype=torch.int32), torch.zeros(rows, 8), 4, 4, group)


# ------------------------------------------------ group: rows read in place
def _routed(rng, tokens, k, P):
    """(ids (tokens*k,) int32 token-major and choice minor, the top-k of
    random gates, with a few -1s)."""
    ids = np.argsort(rng.standard_normal((tokens, P)), axis=1)[:, :k].astype(np.int32).reshape(-1)
    ids[rng.rand(ids.size) < 0.05] = -1
    return ids


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_takes_each_row_for_its_k_tuples(k, dtype):
    """``dispatch_ref(ids, h, P, C, group=k)`` is ``dispatch_ref`` on
    ``h.repeat_interleave(k, 0)`` bit for bit (and so is the wrapper on the
    CPU), and equals the JAX ``dispatch_ref`` on the repeated rows; tight
    capacity drops assignments."""
    rng = np.random.RandomState(20 + k)
    tokens, P, W = 40, 8, 64
    C = max(int(np.ceil(tokens * k / P * 0.5)), 4)
    ids = _routed(rng, tokens, k, P)
    h_np = _payloads(rng, tokens, W, dtype)
    h = tensor_from_numpy(h_np, "cpu")
    got = dispatch_ref(torch.from_numpy(ids), h, P, C, group=k)
    want = dispatch_ref(torch.from_numpy(ids), h.repeat_interleave(k, 0), P, C)
    for a, b, c in zip(got, want, dispatch(torch.from_numpy(ids), h, P, C, group=k)):
        assert parity.bits_equal(a, b) and parity.bits_equal(a, c)
    assert (got[1] > C).any()  # some expert overflows
    (buf_r, counts_r, dest_r), _ = JAX("dispatch", ids, np.repeat(h_np, k, axis=0), P, C,
                                       pallas=False)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(counts_r))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(dest_r))
    np.testing.assert_array_equal(_bits(got[0]), _bits(buf_r))


def test_dispatch_function_backward_sums_each_rows_group():
    """With ``group`` k the backward of K3's Function gives each payload row
    the sum of its k tuples' gathered gradients, in a fixed order, and equals
    autograd through the plain version."""
    ids = torch.tensor([1, 0, 1, 1, -1, 0, 1, 0], dtype=torch.int32)
    h = torch.arange(8, dtype=torch.float32).reshape(4, 2).requires_grad_()
    gbuf = torch.arange(1, 9, dtype=torch.float32).reshape(2, 2, 2)
    orig = Dispatch.forward_fn
    try:
        Dispatch.forward_fn = staticmethod(dispatch_ref)
        buf, counts, dest = Dispatch.apply(ids, h, 2, 2, 2)
    finally:
        Dispatch.forward_fn = staticmethod(orig)
    assert dest.tolist() == [2, 0, 3, -1, -1, 1, -1, -1] and counts.tolist() == [3, 4]
    buf.backward(gbuf)
    rows = [gbuf.reshape(4, 2)[d] if d >= 0 else torch.zeros(2) for d in dest.tolist()]
    want = torch.stack([rows[2 * i] + rows[2 * i + 1] for i in range(4)])
    assert torch.equal(h.grad, want)
    h2 = h.detach().clone().requires_grad_()
    dispatch_ref(ids, h2, 2, 2, group=2)[0].backward(gbuf)
    assert torch.equal(h.grad, h2.grad)


# ---------------------------------------------------- launches and profile
@pytest.mark.parametrize("launches", [k3.LAUNCHES_PER_CALL, 4])
def test_bench_reads_either_c_entry(monkeypatch, launches):
    """``bench_dispatch.source_dispatch`` tells a K3 source's C entry by its
    ``dispatch_launches_per_call()``: this package's own (one launch, with
    ``group``), or the four-launch one from before (scratch from the
    caller), and passes each its own arguments, one per ctypes type."""
    calls = []

    class Lib:
        @staticmethod
        def dispatch_launches_per_call():
            return launches

    def entry(source, symbol, argtypes, constants=()):
        assert source == k3.SOURCE and symbol == "dispatch_launch"
        return argtypes

    monkeypatch.setattr(bench_dispatch._build, "load", lambda source: Lib)
    monkeypatch.setattr(bench_dispatch._build, "entry", entry)
    monkeypatch.setattr(bench_dispatch._build, "launch",
                        lambda fn, dev, *args: calls.append((fn, args)))
    call, got = bench_dispatch.source_dispatch(k3.SOURCE)
    assert got == launches
    T, W, P, C = 12, 6, 3, 5
    buf, counts, dest = call(torch.zeros(T, dtype=torch.int32), torch.zeros(T, W), P, C)
    assert buf.shape == (P, C, W) and counts.shape == (P,) and dest.shape == (T,)
    (argtypes, args), = calls
    assert len(args) == len(argtypes)
    if launches == 1:
        assert argtypes == k3._ARGTYPES
        assert args[1:7] == (T, args[2], 1, W * 4, P, C)  # T, payloads, group 1, row bytes
    else:
        assert argtypes == bench_dispatch._FOUR_LAUNCH_ARGTYPES
        assert args[1] == T and args[3:6] == (W * 4, P, C)


def _global_kernels(source: str) -> list[str]:
    """The names of the ``__global__`` functions of a CUDA source."""
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      source)


def test_profile_groups_every_kernel_of_the_source_as_k3():
    """``profile_serve`` finds K3's device time by kernel name: every
    ``__global__`` function of ``dispatch.cu``, as the profiler names it,
    falls in the K3 group, and none of K5's or a product's does."""
    names = _global_kernels(k3.SOURCE.read_text())
    assert names == ["dispatch_one_kernel"]
    for name in names:
        shown = f"void (anonymous namespace)::{name}<uint4>(int const*, int, uint4 const*)"
        assert profile_serve._group(shown) == "K3 dispatch", name
    assert profile_serve._group("void (anonymous namespace)::ssd_state_kernel(float)") == "K5 ssd"
    assert profile_serve._group("sm90_xmma_gemm_bf16bf16_bf16f32") == "matrix products"
    assert profile_serve._group("void at::native::fill_kernel(float)") == "other"


def test_bench_dispatch_case_on_the_plain_version(monkeypatch):
    """``bench_dispatch.compare_case`` (run on the card) with the plain
    version in place of each build and a stand-in clock: every route checked
    bit for bit, the launches and the bounds (the fused route reads each
    kept token's row once)."""
    def plain(ids, pay, P, C, group=1):
        return dispatch_ref(ids, pay, P, C, group)

    monkeypatch.setattr(k3, "dispatch_fwd", plain)
    monkeypatch.setattr(bench_dispatch, "graph_time_ms", lambda fn, iters: (fn(), 0.5)[1])
    rng = np.random.RandomState(9)
    tokens, k, P, C, W = 32, 4, 6, 8, 16
    ids = torch.from_numpy(_routed(rng, tokens, k, P))
    h = torch.from_numpy(rng.standard_normal((tokens, W)).astype(np.float32))
    other = (lambda i, pay, P_, C_: dispatch_ref(i, pay, P_, C_), 4)
    r = bench_dispatch.compare_case(ids, h, P, C, k, other)
    assert sorted(r["ms"]) == sorted(["K3", "other K3", "route: gather + other K3",
                                      "route: gather + K3", "route: K3 reads h (group k)"])
    assert all(len(t) == 2 for t in r["turns_ms"].values())
    assert r["launches"]["K3"] == 1 and r["launches"]["other K3"] == 4
    assert r["launches"]["route: K3 reads h (group k)"] == 1
    dest = dispatch_ref(ids, h, P, C, k)[2]
    kept = dest >= 0
    assert r["kept"] == int(kept.sum())
    size = 4 * W
    rows_fused = len(set((torch.nonzero(kept).flatten() // k).tolist()))
    fixed = ids.numel() * 8 + P * C * size + P * 4  # ids, dest, buffers, counts
    assert r["bound_ms"]["fused"] == pytest.approx((fixed + rows_fused * size) / 3.35e12 * 1e3)
    assert r["bound_ms"]["gathered"] == pytest.approx((fixed + r["kept"] * size) / 3.35e12 * 1e3)
    lines = bench_dispatch.report({"other": "parent", "shapes": {"case": r}})
    assert len(lines) == 2 + len(r["ms"])

    def wrong(i, pay, P_, C_):
        buf, counts, d = dispatch_ref(i, pay, P_, C_)
        return buf, counts + 1, d

    with pytest.raises(RuntimeError, match="other K3 disagrees"):
        bench_dispatch.compare_case(ids, h, P, C, k, (wrong, 4))


# ------------------------------------------------------------- on the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 is a CUDA kernel with no CPU mode)")


@pytest.mark.cuda
def test_dispatch_kernel_matches_plain_on_card():
    """K3 through the wrapper over the sweep, one and four tuples a row,
    bit for bit; one launch a call."""
    _need_card()
    before = dispatch.LAUNCHES
    cases = parity.check_dispatch(dispatch)
    assert k3.LAUNCHES_PER_CALL == 1
    assert dispatch.LAUNCHES == before + k3.LAUNCHES_PER_CALL * cases


@pytest.mark.cuda
def test_dispatch_kernel_at_the_tuple_limit_on_card():
    """A call of MAX_TUPLES tuples, four a row, through the wrapper: one
    launch, bit for bit; one more tuple is refused."""
    _need_card()
    rng = np.random.RandomState(6)
    T = k3.MAX_TUPLES
    ids = torch.from_numpy(parity.zipf_ids(rng, T, 32)).cuda()
    h = torch.from_numpy(rng.standard_normal((T // 4, 24)).astype(np.float32)).cuda()
    before = dispatch.LAUNCHES
    got = dispatch(ids, h, 32, 16384, group=4)
    assert dispatch.LAUNCHES == before + 1
    assert all(parity.bits_equal(a, b) for a, b in zip(got, dispatch_ref(ids, h, 32, 16384, 4)))
    with pytest.raises(ValueError, match="tuples"):
        dispatch(torch.zeros(T + 4, dtype=torch.int32, device="cuda"),
                 torch.zeros((T + 4) // 4, 24, device="cuda"), 32, 16384, group=4)


@pytest.mark.cuda
def test_dispatch_function_gradients_match_plain_on_card():
    """K3's Function with ``group`` k on the card: buffers and the gradient
    with respect to the token rows equal autograd through the plain version
    bit for bit in f32, with drops."""
    _need_card()
    rng = np.random.RandomState(8)
    for k in (1, 2, 4):
        tokens, P, W = 64, 8, 32
        C = max(int(np.ceil(tokens * k / P * 0.5)), 4)
        ids = torch.from_numpy(_routed(rng, tokens, k, P)).cuda()
        h = torch.from_numpy(rng.standard_normal((tokens, W)).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.standard_normal((P, C, W)).astype(np.float32)).cuda()
        grads = []
        for route in (lambda x: dispatch(ids, x, P, C, group=k),
                      lambda x: dispatch(ids, x, P, C, group=k, use_kernel=False)):
            x = h.clone().requires_grad_()
            buf = route(x)[0]
            buf.backward(g)
            grads.append((buf.detach(), x.grad))
        assert parity.bits_equal(grads[0][0], grads[1][0])
        assert parity.bits_equal(grads[0][1], grads[1][1])
