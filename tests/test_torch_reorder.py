"""Port parity: K2's wrapper and plain version (``kernels/reorder``) against
the JAX package's ``commit_ref`` (bit for bit) and its Pallas
``commit_pallas`` in interpret mode (rtol 1e-5, the tolerance of
``tests/test_kernels.py``).

Inputs are made with numpy from a seed and handed to both frameworks; jax is
imported only inside the tests.  On the CPU the wrapper takes the plain
version; K2 itself runs only on the card (``cuda`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import parity
from repro_torch.kernels.reorder import reorder as k2
from repro_torch.kernels.reorder.ops import commit
from repro_torch.kernels.reorder.ref import ReorderState, commit_ref, init_state
from repro_torch.models.convert import reorder_state_from_numpy, tensor_from_numpy

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
K = parity.COMMIT_K  # entries per commit, as in tests/test_kernels.py


def _bits(a) -> np.ndarray:
    """The bit patterns of a torch tensor or a numpy/jax array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bool:
            return a.numpy().view(np.uint8)
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_same_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _payloads(rng, width, dtype):
    import jax.numpy as jnp

    return np.array(jnp.asarray(rng.standard_normal((K, width)), getattr(jnp, dtype)))


@pytest.mark.parametrize("size,width", [(8, 128), (64, 128), (32, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_commit_matches_jax_ref_and_pallas(size, width, dtype):
    import jax.numpy as jnp
    from repro.kernels.reorder import ops as jax_ops
    from repro.kernels.reorder.ref import commit_ref as jax_commit_ref
    from repro.kernels.reorder.ref import init_state as jax_init_state

    rng = np.random.RandomState(0)
    st = init_state(size, width, TORCH_DTYPES[dtype])
    st_ref = st_pallas = jax_init_state(size, width, getattr(jnp, dtype))
    emitted_serials = []
    before = commit.LAUNCHES
    for serials in parity.commit_batches(rng, size, 3 * size):
        payloads = _payloads(rng, width, dtype)
        payloads[:, 0] = serials  # the serial rides in column 0 (exact in bf16 below 256)
        st, em, cnt, acc = commit(st, torch.from_numpy(serials), tensor_from_numpy(payloads, "cpu"))
        st_ref, em_r, cnt_r, acc_r = jax_commit_ref(st_ref, jnp.asarray(serials),
                                                    jnp.asarray(payloads))
        st_pallas, em_p, cnt_p, acc_p = jax_ops.commit(st_pallas, jnp.asarray(serials),
                                                       jnp.asarray(payloads), use_kernel=True)
        n = int(cnt)
        assert cnt.dtype == torch.int32 and cnt.shape == () and n == int(cnt_r) == int(cnt_p)
        assert st.next.dtype == torch.int32 and int(st.next) == int(st_ref.next) == int(st_pallas.next)
        assert acc.dtype == torch.bool
        np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_r))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_p))
        np.testing.assert_array_equal(st.present.numpy(), np.asarray(st_ref.present))
        np.testing.assert_array_equal(st.present.numpy(), np.asarray(st_pallas.present))
        # every row of emitted (the zero rows past the count too) and the ring
        _assert_same_bits(em, em_r)
        _assert_same_bits(st.buf, st_ref.buf)
        assert not em[n:].any()
        np.testing.assert_allclose(em[:n].float().numpy(), np.asarray(em_p[:n], np.float32),
                                   rtol=1e-5)
        emitted_serials += em[:n, 0].float().numpy().astype(int).tolist()
    assert commit.LAUNCHES == before  # the CPU path launches nothing
    assert emitted_serials == list(range(3 * size))  # everything drained, in order
    assert not st.present.any()


def test_commit_emits_in_serial_order():
    """tests/test_kernels.py:55-63 on the port: one serial per commit, out of
    order, comes out in serial order."""
    state = init_state(16, 4)
    emitted = []
    for t in [3, 1, 0, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14]:
        state, em, c, acc = commit(state, torch.tensor([t], dtype=torch.int32),
                                   torch.full((1, 4), float(t)))
        assert bool(acc[0])
        emitted += em[: int(c), 0].int().tolist()
    assert emitted == list(range(16))
    assert int(state.next) == 16


@pytest.mark.parametrize("start", [0, 5, 1000, 2**31 - 6])
def test_window_matches_jax_ref_at_the_edges(start):
    """Stale, in-window, past-window and empty serials, and int32 wraparound
    of next + S near 2**31, decided as the reference decides them."""
    import jax.numpy as jnp
    from repro.kernels.reorder.ref import commit_ref as jax_commit_ref
    from repro.kernels.reorder.ref import init_state as jax_init_state

    S, W = 8, 4
    cand = [start - 1, start, start + 1, start + S - 1, start + S, start + 3 * S, -1, -7]
    serials = np.asarray([s for s in cand if -(2**31) <= s < 2**31], np.int32)
    payloads = np.arange(len(serials) * W, dtype=np.float32).reshape(-1, W)
    st, em, cnt, acc = commit(init_state(S, W, start=start), torch.from_numpy(serials),
                              torch.from_numpy(payloads))
    _, em_r, cnt_r, acc_r = jax_commit_ref(jax_init_state(S, W, start=start),
                                           jnp.asarray(serials), jnp.asarray(payloads))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_r))
    assert int(cnt) == int(cnt_r)
    _assert_same_bits(em, em_r)
    if start < 2**31 - S:
        # start and start+1 are accepted and emitted; the rest is refused
        assert acc.tolist() == [s in (start, start + 1, start + S - 1) for s in serials.tolist()]
        assert int(cnt) == 2 and int(st.next) == start + 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_carried_from_jax_goes_on_in_the_port(dtype):
    """A ring filled by the JAX package, moved over mid-stream with
    ``reorder_state_from_numpy``, drains in the port exactly as in JAX."""
    import jax.numpy as jnp
    from repro.kernels.reorder.ref import commit_ref as jax_commit_ref
    from repro.kernels.reorder.ref import init_state as jax_init_state

    rng = np.random.RandomState(3)
    size, width = 16, 128
    st_ref = jax_init_state(size, width, getattr(jnp, dtype), start=40)
    batches = list(parity.commit_batches(rng, size, 4 * size, start=40))
    payloads = [_payloads(rng, width, dtype) for _ in batches]
    half = len(batches) // 2
    for serials, pl in zip(batches[:half], payloads[:half]):
        st_ref, *_ = jax_commit_ref(st_ref, jnp.asarray(serials), jnp.asarray(pl))
    assert np.asarray(st_ref.present).any()  # carried with slots waiting
    st = reorder_state_from_numpy(*(np.asarray(f) for f in st_ref), device="cpu")
    assert isinstance(st, ReorderState)
    assert st.buf.dtype == TORCH_DTYPES[dtype] and st.present.dtype == torch.bool
    assert st.next.dtype == torch.int32 and st.next.shape == ()
    _assert_same_bits(st.buf, st_ref.buf)
    for serials, pl in zip(batches[half:], payloads[half:]):
        st, em, cnt, acc = commit(st, torch.from_numpy(serials), tensor_from_numpy(pl, "cpu"))
        st_ref, em_r, cnt_r, acc_r = jax_commit_ref(st_ref, jnp.asarray(serials), jnp.asarray(pl))
        assert int(cnt) == int(cnt_r) and int(st.next) == int(st_ref.next)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_r))
        np.testing.assert_array_equal(st.present.numpy(), np.asarray(st_ref.present))
        _assert_same_bits(em, em_r)
    assert int(st.next) == 40 + 4 * size


@pytest.mark.parametrize("use_kernel", [True, False])
def test_commit_updates_the_ring_in_place(use_kernel):
    """Both routes keep one contract: the commit writes the ring (buf and
    present) it was given and returns those same tensors; next is new."""
    st = init_state(8, 4, start=3)
    new, em, cnt, acc = commit(st, torch.tensor([4, 3, 20], dtype=torch.int32),
                               torch.arange(12, dtype=torch.float32).reshape(3, 4),
                               use_kernel=use_kernel)
    assert new.buf is st.buf and new.present is st.present
    assert int(st.next) == 3 and int(new.next) == 5 and int(cnt) == 2
    assert acc.tolist() == [True, True, False]
    assert st.buf[4].tolist() == [0, 1, 2, 3] and st.buf[3].tolist() == [4, 5, 6, 7]
    assert not st.present.any()  # both emitted, so cleared behind the drain


def test_parity_check_passes_the_plain_version_and_catches_a_wrong_kernel():
    """``parity.check_reorder`` (run on the card against K2) accepts a
    commit equal to the plain version and raises on one that differs."""
    assert parity.check_reorder(commit, device="cpu") > 0

    def wrong(state, serials, payloads):
        new, em, cnt, acc = commit_ref(state, serials, payloads)
        return new, em * 2, cnt, acc

    with pytest.raises(RuntimeError, match="K2 disagrees"):
        parity.check_reorder(wrong, device="cpu")


def _bad_inputs(what):
    st = init_state(8, 4)
    serials, payloads = torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4)
    return {
        "present must": (st._replace(present=st.present.int()), serials, payloads),
        "next must": (st._replace(next=st.next.long()), serials, payloads),
        "serials must": (st, serials.long(), payloads),
        "payloads must": (st, serials, torch.zeros(3, 4)),
        "payloads are": (st, serials, payloads.double()),
    }[what]


@pytest.mark.parametrize("what", ["present must", "next must", "serials must",
                                  "payloads must", "payloads are"])
def test_kernel_binding_rejects_what_the_kernel_does_not_take(what):
    with pytest.raises((ValueError, TypeError), match=what):
        k2.check_inputs(*_bad_inputs(what))


def test_kernel_binding_refuses_cpu_tensors():
    st = init_state(8, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k2.commit_fwd(st, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4))


@pytest.mark.cuda
def test_reorder_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K2 is a CUDA kernel with no CPU mode)")
    before = commit.LAUNCHES
    commits = parity.check_reorder(commit)
    assert commit.LAUNCHES == before + k2.LAUNCHES_PER_CALL * commits
