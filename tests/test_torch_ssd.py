"""Port parity: K5's wrapper and plain version (``kernels/ssd``) against the
JAX package's ``ssd_chunked`` and its Pallas ``ssd_pallas`` in interpret
mode, within 2e-4 (the tolerance of ``tests/test_kernels.py:151-152``), and
``segsum`` / ``ssd_decode_step`` against theirs.

Inputs are made with numpy from a seed, as the reference test draws them
(softplus dt, negative A, B and C scaled by 0.3), and handed to both
frameworks; the JAX side runs in a spawned child (``torch_jaxref``), never
in this process.  On the CPU the wrapper takes the plain version; K5 itself
runs only on the card (``cuda`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from repro_torch.kernels import parity
from repro_torch.kernels.ssd import ssd as k5
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import segsum, ssd_chunked, ssd_decode_step, ssd_scan_ref

TOL = parity.SSD_TOL
# the shapes of tests/test_kernels.py:141, then chunk=256 (mamba2-780m's)
SHAPES = list(parity.SSD_SWEEP[:4])
JAX = Reference()
_jax_child = JAX.fixture()


def _t(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("B,L,H,P,N,chunk", SHAPES)
def test_ssd_matches_jax_chunked_and_pallas(B, L, H, P, N, chunk):
    arrays = parity.ssd_inputs(B, L, H, P, N)
    before = ssd.LAUNCHES
    y, hT = ssd(*_t(arrays), chunk=chunk)
    assert ssd.LAUNCHES == before  # the CPU path launches nothing
    assert y.shape == (B, L, H, P) and y.dtype == torch.float32
    assert hT.shape == (B, H, P, N) and hT.dtype == torch.float32
    (y_r, h_r), (y_p, h_p) = JAX("ssd", *arrays, chunk=chunk)
    for got, want in ((y, y_r), (hT, h_r), (y, y_p), (hT, h_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_ssd_bf16_x_matches_pallas():
    """x in bf16: y comes back in bf16, from the same f32 scan.  Both sides
    round an f32 value within 2e-4 of the other to bf16, so they agree to
    2e-4 plus one bf16 step (2**-7 relative)."""
    x, dt, A, Bm, Cm = parity.ssd_inputs(1, 256, 2, 64, 128, seed=5)
    xb = bf16(x)
    _, (y_p, h_p) = JAX("ssd", xb, dt, A, Bm, Cm, chunk=128, x_dtype="bfloat16")
    xt = torch.from_numpy(xb.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    y, hT = ssd(xt, *_t((dt, A, Bm, Cm)), chunk=128)
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_p, np.float32),
                               rtol=2**-7, atol=TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_p), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunk", [64, 256])
def test_ssd_chunked_with_h0_matches_jax(chunk):
    B, L, H, P, N = 2, 256, 3, 64, 32
    arrays = parity.ssd_inputs(B, L, H, P, N, seed=6)
    h0 = (np.random.RandomState(9).standard_normal((B, H, P, N)) * 0.5).astype(np.float32)
    y, hT = ssd_chunked(*_t(arrays), chunk=chunk, h0=torch.from_numpy(h0))
    (y_r, h_r), _ = JAX("ssd", *arrays, chunk=chunk, h0=h0, pallas=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_r), rtol=TOL, atol=TOL)


def test_ssd_wrapper_refuses_h0():
    arrays = _t(parity.ssd_inputs(1, 64, 1, 64, 64))
    with pytest.raises(ValueError, match="h0"):
        ssd(*arrays, chunk=64, h0=torch.zeros(1, 1, 64, 64))


def test_ssd_decode_step_matches_jax():
    rng = np.random.RandomState(8)
    B, H, P, N = 2, 3, 16, 8
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, B, N)) * 0.3).astype(np.float32)
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    y, h_new = ssd_decode_step(*_t((x, dt, A, Bm, Cm, h)))
    y_r, h_r = JAX("ssd_decode_step", x, dt, A, Bm, Cm, h)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(h_r), rtol=TOL, atol=TOL)


def test_decode_steps_replay_the_chunked_scan():
    """The recurrent step, token by token, gives the chunked scan's outputs
    and final state (the duality the chunked form rests on)."""
    B, L, H, P, N = 1, 32, 2, 16, 8
    x, dt, A, Bm, Cm = _t(parity.ssd_inputs(B, L, H, P, N, seed=12))
    y, hT = ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    h = torch.zeros(B, H, P, N)
    for t in range(L):
        y_t, h = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        np.testing.assert_allclose(y_t.numpy(), y[:, t].numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), hT.numpy(), rtol=TOL, atol=TOL)


def test_segsum_matches_jax():
    a = np.random.RandomState(13).standard_normal((3, 2, 17)).astype(np.float32)
    got = segsum(torch.from_numpy(a)).numpy()
    want = JAX("segsum", a)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape,chunk,match",
    [
        ((1, 128, 2, 32, 64), 64, "head width"),
        ((1, 128, 2, 64, 96), 64, "state width"),
        ((1, 128, 2, 64, 64), 48, "chunk"),
        ((1, 1024, 1, 64, 64), 1024, "chunk"),
    ],
)
def test_kernel_binding_rejects_what_the_kernel_does_not_take(shape, chunk, match):
    x, dt, A, Bm, Cm = _t(parity.ssd_inputs(*shape))
    with pytest.raises(ValueError, match=match):
        k5.check_inputs(x, dt, A, Bm, Cm, chunk)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k5.check_inputs(x.half(), dt, A, Bm, Cm, 64)


def test_kernel_binding_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        k5.ssd_fwd(*_t(parity.ssd_inputs(1, 128, 2, 64, 64)), chunk=64)


def _wrapper(x, dt, A, Bm, Cm, chunk):
    return ssd(x, dt, A, Bm, Cm, chunk=chunk)


def test_parity_check_passes_the_plain_version_and_catches_a_wrong_kernel():
    """``parity.check_ssd`` (run on the card against K5) accepts a scan equal
    to the plain version and raises on one that is off by more than the
    tolerance."""
    rows = parity.check_ssd(_wrapper, device="cpu")
    assert len(rows) == 2 * len(parity.SSD_SWEEP) and max(err for _, err in rows) == 0

    def wrong(x, dt, A, Bm, Cm, chunk):
        y, hT = ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
        return y, hT + 3 * TOL

    with pytest.raises(RuntimeError, match="K5 disagrees"):
        parity.check_ssd(wrong, device="cpu")


@pytest.mark.cuda
def test_ssd_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K5 is a CUDA kernel with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = ssd.LAUNCHES
    rows = parity.check_ssd(_wrapper)
    assert ssd.LAUNCHES == before + k5.LAUNCHES_PER_CALL * len(rows)


# ---- K5's decomposition, emulated on the CPU with its TF32 rounding
def _tf32(a):
    """``cvt.rna.tf32.f32``: 10 mantissa bits, rounded to nearest, ties away
    from zero (adding half an ulp to the bit pattern rounds the magnitude)."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_split(a, b):
    """a @ b as K5 computes it: each operand split into hi = tf32(v) and lo =
    tf32(v - hi), three TF32 products lo.hi + hi.lo + hi.hi summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """a @ b from TF32 operands with no split."""
    return _tf32(a) @ _tf32(b)


def _ssd_steps(x, dt, A, Bm, Cm, chunk, mm):
    """K5's three steps in PyTorch, every product through ``mm``: chunk
    states S = (dt exp(total - cum) x)^T B; the state before each chunk,
    h <- exp(total) h + S; y = exp(cum_q) C h^T + (Lmask o C B^T) (dt x),
    with dt folded into the mask and exp(cum_q - cum_k) taken as one exp of
    an f64 difference (cum is an f64 sum)."""
    B_, L, H, P = x.shape
    N, nc = Bm.shape[-1], L // chunk
    xc = x.reshape(B_, nc, chunk, H, P).permute(0, 1, 3, 2, 4)  # (B,nc,H,cl,P)
    dtc = dt.reshape(B_, nc, chunk, H).permute(0, 1, 3, 2)  # (B,nc,H,cl)
    Bc, Cc = Bm.reshape(B_, nc, chunk, N), Cm.reshape(B_, nc, chunk, N)
    cum = torch.cumsum(dtc.double() * A[:, None].double(), dim=-1)  # in f64, as K5
    total = cum[..., -1]  # (B,nc,H)
    w = (dtc * torch.exp(total[..., None] - cum)).float()
    S = mm((xc * w[..., None]).transpose(-1, -2), Bc[:, :, None])  # (B,nc,H,P,N)
    h, before = torch.zeros(B_, H, P, N), []
    for c in range(nc):
        before.append(h)
        h = torch.exp(total[:, c]).float()[..., None, None] * h + S[:, c]
    hb = torch.stack(before, dim=1)
    scores = mm(Cc, Bc.transpose(-1, -2))[:, :, None]  # (B,nc,1,cl,cl)
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).float()) * dtc[..., None, :]
    M = torch.where(causal, scores * decay, torch.zeros(()))
    y = torch.exp(cum.float())[..., None] * mm(Cc[:, :, None], hb.transpose(-1, -2)) + mm(M, xc)
    return y.permute(0, 1, 3, 2, 4).reshape(B_, L, H, P), h


@pytest.mark.parametrize("B,L,H,P,N,chunk", parity.SSD_SWEEP)
def test_split_tf32_steps_match_jax_chunked(B, L, H, P, N, chunk):
    """K5's decomposition with its split TF32 products holds the JAX
    ``ssd_chunked`` within 2e-4 at every shape of the card's sweep."""
    arrays = parity.ssd_inputs(B, L, H, P, N)
    y, hT = _ssd_steps(*_t(arrays), chunk, _mm_split)
    (y_r, h_r), _ = JAX("ssd", *arrays, chunk=chunk, pallas=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_r), rtol=TOL, atol=TOL)


def test_tf32_without_the_split_misses_the_tolerance():
    """The same steps from plain TF32 operands fail ``ssd_close`` by far,
    which is why K5 splits every operand."""
    arrays = parity.ssd_inputs(1, 512, 2, 128, 64)
    (y_r, h_r), _ = JAX("ssd", *arrays, chunk=128, pallas=False)
    want = (torch.from_numpy(np.asarray(y_r)), torch.from_numpy(np.asarray(h_r)))
    ok, err = parity.ssd_close(_ssd_steps(*_t(arrays), 128, _mm_tf32), want, TOL)
    assert not ok and err > 5 * TOL
    ok, err = parity.ssd_close(_ssd_steps(*_t(arrays), 128, _mm_split), want, TOL)
    assert ok and err < TOL
