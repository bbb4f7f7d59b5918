"""Port parity: K2's wrapper and plain version (``kernels/reorder``) against
the JAX package's ``commit_ref`` (bit for bit) and its Pallas
``commit_pallas`` in interpret mode (rtol 1e-5, the tolerance of
``tests/test_kernels.py``).

Inputs are made with numpy from a seed and handed to both frameworks; the
JAX side runs in a spawned child (``torch_jaxref``), never in this process.
On the CPU the wrapper takes the plain version; K2 itself runs only on the
card (``cuda`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from repro_torch.kernels import parity
from repro_torch.kernels.reorder import reorder as k2
from repro_torch.kernels.reorder.ops import commit
from repro_torch.kernels.reorder.ref import ReorderState, commit_ref, init_state
from repro_torch.models.convert import reorder_state_from_numpy, tensor_from_numpy

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
K = parity.COMMIT_K  # entries per commit, as in tests/test_kernels.py
JAX = Reference()
_jax_child = JAX.fixture()


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


def _payloads(rng, width, dtype, k=K):
    x = rng.standard_normal((k, width))
    return bf16(x) if dtype == "bfloat16" else x.astype(np.float32)


@pytest.mark.parametrize("size,width", [(8, 128), (64, 128), (32, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_commit_matches_jax_ref_and_pallas(size, width, dtype):
    rng = np.random.RandomState(0)
    st = init_state(size, width, TORCH_DTYPES[dtype])
    batches, payloads = [], []
    for serials in parity.commit_batches(rng, size, 3 * size):
        pl = _payloads(rng, width, dtype)
        pl[:, 0] = serials  # the serial rides in column 0 (exact in bf16 below 256)
        batches.append(serials)
        payloads.append(pl)
    want = JAX("reorder_drain", size, width, dtype, batches, payloads, pallas=True)
    emitted_serials = []
    before = commit.LAUNCHES
    for serials, pl, r in zip(batches, payloads, want):
        st, em, cnt, acc = commit(st, torch.from_numpy(serials), tensor_from_numpy(pl, "cpu"))
        n = int(cnt)
        assert cnt.dtype == torch.int32 and cnt.shape == () and n == int(r["count"]) == int(r["p_count"])
        assert st.next.dtype == torch.int32 and int(st.next) == int(r["next"]) == int(r["p_next"])
        assert acc.dtype == torch.bool
        np.testing.assert_array_equal(acc.numpy(), r["accepted"])
        np.testing.assert_array_equal(acc.numpy(), r["p_accepted"])
        np.testing.assert_array_equal(st.present.numpy(), r["present"])
        np.testing.assert_array_equal(st.present.numpy(), r["p_present"])
        # every row of emitted (the zero rows past the count too) and the ring
        _assert_same_bits(em, r["emitted"])
        _assert_same_bits(st.buf, r["buf"])
        assert not em[n:].any()
        np.testing.assert_allclose(em[:n].float().numpy(), r["p_emitted"][:n].astype(np.float32),
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
    S, W = 8, 4
    cand = [start - 1, start, start + 1, start + S - 1, start + S, start + 3 * S, -1, -7]
    serials = np.asarray([s for s in cand if -(2**31) <= s < 2**31], np.int32)
    payloads = np.arange(len(serials) * W, dtype=np.float32).reshape(-1, W)
    st, em, cnt, acc = commit(init_state(S, W, start=start), torch.from_numpy(serials),
                              torch.from_numpy(payloads))
    (r,) = JAX("reorder_drain", S, W, "float32", [serials], [payloads], start=start)
    np.testing.assert_array_equal(acc.numpy(), r["accepted"])
    assert int(cnt) == int(r["count"])
    _assert_same_bits(em, r["emitted"])
    if start < 2**31 - S:
        # start and start+1 are accepted and emitted; the rest is refused
        assert acc.tolist() == [s in (start, start + 1, start + S - 1) for s in serials.tolist()]
        assert int(cnt) == 2 and int(st.next) == start + 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_carried_from_jax_goes_on_in_the_port(dtype):
    """A ring filled by the JAX package, moved over mid-stream with
    ``reorder_state_from_numpy``, drains in the port exactly as in JAX."""
    rng = np.random.RandomState(3)
    size, width = 16, 128
    batches = list(parity.commit_batches(rng, size, 4 * size, start=40))
    payloads = [_payloads(rng, width, dtype) for _ in batches]
    want = JAX("reorder_drain", size, width, dtype, batches, payloads, start=40)
    half = len(batches) // 2
    carried = want[half - 1]  # the JAX ring after the first half
    assert carried["present"].any()  # carried with slots waiting
    st = reorder_state_from_numpy(carried["buf"], carried["present"], carried["next"],
                                  device="cpu")
    assert isinstance(st, ReorderState)
    assert st.buf.dtype == TORCH_DTYPES[dtype] and st.present.dtype == torch.bool
    assert st.next.dtype == torch.int32 and st.next.shape == ()
    _assert_same_bits(st.buf, carried["buf"])
    for serials, pl, r in zip(batches[half:], payloads[half:], want[half:]):
        st, em, cnt, acc = commit(st, torch.from_numpy(serials), tensor_from_numpy(pl, "cpu"))
        assert int(cnt) == int(r["count"]) and int(st.next) == int(r["next"])
        np.testing.assert_array_equal(acc.numpy(), r["accepted"])
        np.testing.assert_array_equal(st.present.numpy(), r["present"])
        _assert_same_bits(em, r["emitted"])
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


# ---------------------------------------------------------------- the one-launch design
TILE = 2048  # kTile of csrc/reorder.cu: ring distances per step of the count walk


def _emulate_one_launch_commit(state, serials, payloads):
    """K2's one-launch design on the CPU, by its ownership rules: the count
    from the old present flags OR the fresh distances, walked in tiles (or,
    where a slot's distance from next wraps int32, slot by slot with the
    reference's formula); the scatter writes the accepted rows, their final
    present flags and their emitted rows below count; the emit side copies
    the other rows below count from the ring as it was before the commit
    and zeroes the rest; the last block clears the slots below count.  Every
    read of the ring is checked to touch no slot that this commit writes."""
    buf, present, nxt = state
    S = buf.shape[0]
    old_buf, old_present = buf.clone(), present.clone()
    n, ser = int(nxt), serials.tolist()
    hi = (n + S + 2**31) % 2**32 - 2**31  # int32 wraparound
    dist = [t - n if (t >= 0 and t >= n and t < hi) else -1 for t in ser]
    fresh = {d for d in dist if d >= 0}
    regular = n >= S - 1 - (2**31 - 1)
    base = n % S
    count = S
    if regular:
        for d0 in range(0, S, TILE):
            gaps = [d for d in range(d0, min(S, d0 + TILE))
                    if not old_present[(base + d) % S] and d not in fresh]
            if gaps:
                count = gaps[0]
                break
    else:
        assert not fresh  # nothing is accepted where the distance wraps
        pos = [((i - n + 2**31) % 2**32 - 2**31) % S for i in range(S)]
        count = min([p for i, p in enumerate(pos) if not old_present[i]], default=S)
    emitted = torch.full_like(buf, float("nan"))  # every row must be written
    written = set()
    for k, d in enumerate(dist):  # scatter
        if d >= 0:
            slot = (base + d) % S
            buf[slot] = payloads[k]
            present[slot] = d >= count
            written.add(slot)
            if d < count:
                emitted[d] = payloads[k]
    for i in range(S):  # emit
        if i >= count:
            emitted[i] = 0
        elif i not in fresh:
            src = ((n + i + 2**31) % 2**32 - 2**31) % S  # the reference's wrapped slot
            assert src not in written and bool(old_present[src]) or not regular
            emitted[i] = old_buf[src]
    for d in range(count):  # clear, by the last block
        if regular:
            present[(base + d) % S] = False
    if not regular:
        for i in range(S):
            if pos[i] < count:
                present[i] = False
    accepted = torch.tensor([d >= 0 for d in dist])
    new_next = torch.tensor((n + count + 2**31) % 2**32 - 2**31, dtype=torch.int32)
    return ReorderState(buf, present, new_next), emitted, torch.tensor(count, dtype=torch.int32), accepted


def test_one_launch_design_matches_commit_ref_over_the_sweep():
    """The card's sweep (drains and ``REORDER_CASES``) through the design's
    emulation: bit for bit equal to ``commit_ref`` at every commit."""
    assert parity.check_reorder(_emulate_one_launch_commit, device="cpu") > 0


def test_reorder_sweep_cases_drain_through_commit_ref():
    """The extended sweep's sequences reach the edges they were built for,
    through the plain version: a count across two tile boundaries, a full
    ring (count == S), K > S entries, a serial re-sent while present, the
    int32 window wrap, and the wrapped rings."""
    cases = list(parity.reorder_cases(np.random.RandomState(0)))
    assert [c[0] for c in cases][:3] == list(parity.REORDER_CASES)
    seen = set()
    for name, S, W, (start, present), batches, counts in cases:
        st = init_state(S, W, start=start)
        if present is not None:
            st.present.copy_(torch.from_numpy(present))
        got = []
        for serials in batches:
            before = st.present.clone()
            st, em, cnt, acc = commit_ref(st, torch.from_numpy(serials), torch.zeros(len(serials), W))
            got.append(int(cnt))
            slots = torch.from_numpy(serials[acc.numpy()].astype(np.int64) % S)
            if bool(before[slots].any()):
                seen.add("re-sent while present")
            if len(serials) > S and (~acc).any():
                seen.add("K > S with refused entries")
        assert got == counts, name
        if name == "tiles and a full ring":
            assert max(counts) == S and any(2 * TILE < c < S for c in counts)
            assert int(st.next) == sum(counts) and not st.present.any()
    assert seen == {"re-sent while present", "K > S with refused entries"}
