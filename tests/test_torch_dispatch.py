"""Port parity: K3's wrapper and plain version (``kernels/dispatch``) against
the JAX package's ``dispatch_ref`` (bit for bit) and its Pallas
``dispatch_pallas`` in interpret mode (1e-5, the tolerance of
``tests/test_kernels.py``).

Inputs are made with numpy from a seed and handed to both frameworks; the
JAX side runs in a spawned child (``torch_jaxref``), never in this process.
On the CPU the wrapper takes the plain version; K3 itself runs only on the
card (``cuda`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from repro_torch.kernels import parity
from repro_torch.kernels.dispatch import dispatch as k3
from repro_torch.kernels.dispatch.ops import dispatch
from repro_torch.kernels.dispatch.ref import dispatch_ref
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
    assert parity.check_dispatch(dispatch, device="cpu") == 2 * len(parity.DISPATCH_SWEEP)

    def wrong(ids, payloads, P, C):
        buf, counts, dest = dispatch_ref(ids, payloads, P, C)
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


@pytest.mark.cuda
def test_dispatch_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 is a CUDA kernel with no CPU mode)")
    before = dispatch.LAUNCHES
    cases = parity.check_dispatch(dispatch)
    assert dispatch.LAUNCHES == before + k3.LAUNCHES_PER_CALL * cases
