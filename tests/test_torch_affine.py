"""Port parity: K1's plain version (``kernels/affine/ref.py``) against the JAX
package's NumPy reference ``repro.columnar.device._np_affine``, bit for bit.

The cases cover every column type with int and float parameters where the
reference defines the result (no float-to-int cast out of range): integer
wraparound, the float64 promotion of an integer column times a float, and
NumPy's separate roundings of the product and the sum.  K1 itself runs only
on the card (``cuda`` marker), held to the plain version there.  The
reference runs in a spawned child (``torch_jaxref``), never in this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.columnar.device import make_kernel
from repro_torch.kernels.affine import affine as k1
from repro_torch.kernels.affine.ops import affine_staged
from repro_torch.kernels.affine.ref import ALIGN, Layout, affine_ref, affine_staged_ref

JAX = Reference()
_jax_child = JAX.fixture()
NP = {"i8": np.int64, "i4": np.int32, "f8": np.float64, "f4": np.float32}


def _column(code: str, n: int, seed: int, float_param: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if code == "i8":  # beyond int32; x*a overflows int64 on the int path
        hi = 2**61 if float_param else 2**62
        return rng.integers(-hi, hi, size=n, dtype=np.int64)
    if code == "i4":
        hi = 2**29 if float_param else 2**31 - 1
        return rng.integers(-hi, hi, size=n, dtype=np.int32)
    return (rng.standard_normal(n) * 1e3).astype(NP[code])


def _np_ref(x: np.ndarray, a, b) -> np.ndarray:
    return JAX("np_affine", x, a, b)


def _bits(t) -> np.ndarray:
    arr = t.numpy() if isinstance(t, torch.Tensor) else t
    return arr.view(np.uint8)


PARAMS = [(3, -1), (1, 5), (-7, 2**20), (2.5, -1), (3, 0.75), (0.1, 0.3), (-1.5, 2.25)]


@pytest.mark.parametrize("a,b", PARAMS, ids=lambda v: repr(v))
@pytest.mark.parametrize("code", ["i8", "i4", "f8", "f4"])
def test_affine_ref_matches_numpy_bit_for_bit(code, a, b):
    x = _column(code, 1037, seed=PARAMS.index((a, b)) * 4 + len(code) + ord(code[0]),
                float_param=isinstance(a, float) or isinstance(b, float))
    want = _np_ref(x, a, b)
    got = affine_ref(torch.from_numpy(x), a, b)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_integer_overflow_wraps_like_numpy():
    x = np.array([2**62, -(2**62), 2**63 - 1, -(2**63)], dtype=np.int64)
    got = affine_ref(torch.from_numpy(x), 3, -1).numpy()
    np.testing.assert_array_equal(got, _np_ref(x, 3, -1))
    assert got[0] == -4611686018427387905  # 2**62*3 - 1, wrapped
    x4 = np.array([2**30, -(2**31), 2**31 - 1], dtype=np.int32)
    np.testing.assert_array_equal(affine_ref(torch.from_numpy(x4), 5, 9).numpy(),
                                  _np_ref(x4, 5, 9))


def test_integer_column_times_float_is_float64_then_truncated():
    # torch alone would compute int64 * 2.5 in float32, which loses these
    x = np.array([2**40 + 1, -(2**40) - 3, 7, -7], dtype=np.int64)
    assert (torch.tensor([1, 2]) * 2.5).dtype == torch.float32
    got = affine_ref(torch.from_numpy(x), 2.5, -1).numpy()
    np.testing.assert_array_equal(got, _np_ref(x, 2.5, -1))
    assert got[0] == int((2**40 + 1) * 2.5 - 1)
    assert got.dtype == np.int64


def test_product_and_sum_round_separately():
    """NumPy rounds x*a and then x*a+b; a fused multiply-add would not, and
    differs on some of these inputs, so the test can tell the two apart."""
    x = _column("f4", 4096, seed=3, float_param=True)
    a, b = 0.1, 0.3
    got = affine_ref(torch.from_numpy(x), a, b).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_np_ref(x, a, b)))
    a32, b32 = np.float64(np.float32(a)), np.float64(np.float32(b))
    fused = (x.astype(np.float64) * a32 + b32).astype(np.float32)  # exact product, one rounding
    assert (fused != got).any()


def test_out_of_range_int_parameter_raises_like_numpy():
    x = np.arange(4, dtype=np.int32)
    with pytest.raises(OverflowError):
        _np_ref(x, 2**40, 0)
    with pytest.raises(OverflowError):
        affine_ref(torch.from_numpy(x), 2**40, 0)
    # the same parameter on a float column is a float64 operand
    xf = np.arange(4, dtype=np.float64)
    np.testing.assert_array_equal(affine_ref(torch.from_numpy(xf), 2**40, 0).numpy(),
                                  _np_ref(xf, 2**40, 0))


def test_typed_parameters_are_refused():
    with pytest.raises(TypeError):
        affine_ref(torch.arange(3), np.float32(2.0), 0)


@pytest.mark.parametrize("rows", [0, 1, 3, 17, 1000])
def test_staged_batch_of_mixed_columns_matches_numpy(rows):
    codes = ["i8", "f4", "i4", "f8", "i8"]
    cols = [_column(c, rows, seed=i, float_param=False) for i, c in enumerate(codes)]
    layout = Layout.of([torch.from_numpy(c).dtype for c in cols], rows)
    assert all(off % ALIGN == 0 for off in layout.offsets)
    src = layout.stage([torch.from_numpy(c) for c in cols])
    dst = affine_staged_ref(src, layout, 3, -1, torch.empty_like(src))
    for j, c in enumerate(cols):
        np.testing.assert_array_equal(_bits(layout.column(dst, j)), _bits(_np_ref(c, 3, -1)))
    # the device stage's kernel takes the plain version on CPU tensors, uncounted
    before = affine_staged.LAUNCHES
    fn = make_kernel("affine_pallas", "cpu", (("a", 3), ("b", -1)))
    outs = fn(*(torch.from_numpy(c) for c in cols))
    assert affine_staged.LAUNCHES == before
    for o, c in zip(outs, cols):
        np.testing.assert_array_equal(_bits(o), _bits(_np_ref(c, 3, -1)))


def test_kernel_wrapper_refuses_cpu_buffers():
    layout = Layout.of([torch.int64], 4)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        k1.affine_fwd(buf, layout, 3, -1, buf.clone())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is a CUDA kernel with no CPU mode)")
    codes = ["i8", "f8", "i4", "f4"]
    for rows in (1, 7, 4093, 16384 + 5):  # 4093: not a multiple of any tile
        for a, b in PARAMS:
            fp = isinstance(a, float) or isinstance(b, float)
            cols = [_column(c, rows, seed=rows + i, float_param=fp) for i, c in enumerate(codes)]
            # one batch whose columns mix every dtype, and one column per dtype
            batches = [cols] + [[c] for c in cols]
            for batch in batches:
                dts = [torch.from_numpy(c).dtype for c in batch]
                layout = Layout.of(dts, rows)
                src = layout.stage([torch.from_numpy(c).cuda() for c in batch])
                before = affine_staged.LAUNCHES
                dst = affine_staged(src, layout, a, b, torch.empty_like(src))
                torch.cuda.synchronize()
                assert affine_staged.LAUNCHES == before + 1
                # the plain version, on the card and on the host
                ref = affine_staged_ref(src, layout, a, b, torch.empty_like(src)).cpu()
                got = dst.cpu()
                for j, c in enumerate(batch):
                    np.testing.assert_array_equal(_bits(layout.column(got, j)),
                                                  _bits(layout.column(ref, j)))
                    np.testing.assert_array_equal(_bits(layout.column(got, j)),
                                                  _bits(_np_ref(c, a, b)))
