"""Port parity: K1's plain version (``kernels/affine/ref.py``) against the JAX
package's NumPy reference ``repro.columnar.device._np_affine``, bit for bit.

The cases cover every column type with int and float parameters where the
reference defines the result (no float-to-int cast out of range): integer
wraparound, the float64 promotion of an integer column times a float, and
NumPy's separate roundings of the product and the sum.  The wrapper's route
follows the device the caller names; K1's launch descriptor is built once
per column layout and (a, b), on any machine.  K1 itself runs only on the
card (``cuda`` marker), held to the plain version there on the device
stage's route (the card's memory into the pinned output buffer), pinned to
pinned, and on the card's memory.  The reference runs in a
spawned child (``torch_jaxref``), never in this process.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.columnar.device import make_kernel
from repro_torch.kernels.affine import affine as k1
from repro_torch.kernels import _build, parity
from repro_torch.kernels.affine.ops import affine_staged
from repro_torch.kernels.affine.ref import (ALIGN, Layout, affine_ref, affine_staged_ref,
                                            on_device)

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


def test_route_follows_the_named_device():
    """``device="cpu"`` runs the plain version on host buffers (uncounted)
    and equals the reference; it refuses nothing on the host, and the route
    does not depend on where the buffers lie."""
    cols = [_column(c, 301, seed=i, float_param=False) for i, c in enumerate(["i8", "f4", "i4"])]
    layout = Layout.of([torch.from_numpy(c).dtype for c in cols], 301)
    src = layout.stage([torch.from_numpy(c) for c in cols])
    before = affine_staged.LAUNCHES
    dst = affine_staged(src, layout, 3, -1, torch.empty_like(src), device="cpu")
    assert affine_staged.LAUNCHES == before
    for j, c in enumerate(cols):
        np.testing.assert_array_equal(_bits(layout.column(dst, j)), _bits(_np_ref(c, 3, -1)))
    with pytest.raises(TypeError):  # the device is named, never guessed
        affine_staged(src, layout, 3, -1, torch.empty_like(src))


def test_asking_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layout = Layout.of([torch.int64], 4)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    before = affine_staged.LAUNCHES
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        affine_staged(buf, layout, 3, -1, buf.clone(), device="cuda")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        affine_staged(buf, layout, 3, -1, buf.clone(), device="cuda:0")
    assert affine_staged.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_buffers(monkeypatch):
    """K1's binding refuses what it cannot launch on: a device that is not a
    card, pageable host buffers (even where a card exists), and the plain
    route refuses nothing the caller did not ask for."""
    layout = Layout.of([torch.int64], 4)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        k1.affine_fwd(buf, layout, 3, -1, buf.clone(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # past the card check
    with pytest.raises(ValueError, match="pageable"):
        k1.affine_fwd(buf, layout, 3, -1, buf.clone())
    with pytest.raises(ValueError, match="uint8"):
        k1.affine_fwd(buf.view(torch.int64), layout, 3, -1, buf.clone())
    with pytest.raises(ValueError, match="holds"):
        k1.affine_fwd(buf[:16], layout, 3, -1, buf.clone())
    with pytest.raises(ValueError, match="aligned"):
        k1.affine_fwd(torch.zeros(layout.nbytes + 8, dtype=torch.uint8)[8:], layout, 3, -1,
                      buf.clone())
    with pytest.raises(ValueError, match="in place"):  # no card's view of pageable memory
        on_device(buf, torch.device("cuda"))
    assert on_device(buf, torch.device("cpu")) is buf


def test_launch_descriptor_is_built_once_per_layout():
    """The descriptor (codes, a and b in every form, their checks) is built
    on the first call for a column layout and (a, b) and kept: other row
    counts and repeated calls reuse it.  Parameters that compare equal in
    Python but give other bits (3, 3.0 and True; 0.0 and -0.0) get their
    own."""
    k1._descriptor.cache_clear()
    codes = Layout.of([torch.int64, torch.float32, torch.int32], 1).codes
    first = k1.descriptor(codes, 3, -1)
    for rows in (1, 17, 16384):
        assert k1.descriptor(Layout.of([torch.int64, torch.float32, torch.int32], rows).codes,
                             3, -1) is first
    info = k1._descriptor.cache_info()
    assert (info.misses, info.hits) == (1, 3)
    assert (first.ncols, list(first.code[:3]), first.ai, first.bi) == (3, list(codes), 3, -1)
    assert (first.a_float, first.b_float) == (0, 0)
    as_float = k1.descriptor(codes, 3.0, -1)
    assert as_float is not first and (as_float.a_float, as_float.af) == (1, 3.0)
    as_bool = k1.descriptor(codes, True, -1)
    assert as_bool is not first and as_bool.ai == 1
    neg, pos = k1.descriptor(codes, 2.0, -0.0), k1.descriptor(codes, 2.0, 0.0)
    assert neg is not pos and np.signbit(neg.bf) and not np.signbit(pos.bf)
    assert k1._descriptor.cache_info().misses == 5
    assert ctypes.sizeof(k1._Params) == 832  # the source's sizeof(Params), checked at load


def test_launch_descriptor_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="1..64"):
        k1.descriptor((0,) * 65, 3, -1)
    with pytest.raises(ValueError, match="1..64"):
        k1.descriptor((), 3, -1)
    with pytest.raises(TypeError):
        k1.descriptor((0,), np.float32(2.0), 0)
    with pytest.raises(OverflowError):
        k1.descriptor((2,), 2**40, 0)  # an i4 column
    k1.descriptor((1,), 2**40, 0)  # the same parameter on an f8 column is a float64


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is a CUDA kernel with no CPU mode)")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Through the public wrapper, on every placement of
    ``parity.AFFINE_ROUTES``: every column type alone and mixed, int and
    float a, b, ragged rows, against the plain version and NumPy, bit for
    bit."""
    _card()
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
                staged = layout.stage([torch.from_numpy(c) for c in batch])
                ref = affine_staged_ref(staged.cuda(), layout, a, b,
                                        torch.empty_like(staged.cuda())).cpu()
                for place_in, place_out in parity.AFFINE_ROUTES:
                    src = parity.staging_buffer(layout.nbytes, place_in)
                    src.copy_(staged)
                    before = affine_staged.LAUNCHES
                    dst = affine_staged(src, layout, a, b,
                                        parity.staging_buffer(layout.nbytes, place_out),
                                        device="cuda")
                    torch.cuda.synchronize()
                    assert affine_staged.LAUNCHES == before + 1
                    got = dst.cpu()
                    for j, c in enumerate(batch):
                        np.testing.assert_array_equal(_bits(layout.column(got, j)),
                                                      _bits(layout.column(ref, j)))
                        np.testing.assert_array_equal(_bits(layout.column(got, j)),
                                                      _bits(_np_ref(c, a, b)))


@pytest.mark.cuda
def test_kernel_sweep_on_the_card():
    """``parity.check_affine``, the sweep of ``chip_smoke.py`` phase 4, through
    the public wrapper on both routes."""
    _card()

    def fwd(src, layout, a, b, dst):
        return affine_staged(src, layout, a, b, dst, device="cuda")

    assert parity.check_affine(fwd) == (len(parity.AFFINE_ROWS) * len(parity.AFFINE_PARAMS) * 5
                                        * len(parity.AFFINE_ROUTES))


@pytest.mark.cuda
def test_kernel_refuses_pageable_host_memory_on_the_card():
    _card()
    layout = Layout.of([torch.int64, torch.float32], 100)
    pinned = parity.staging_buffer(layout.nbytes, "pinned")
    pageable = torch.zeros(layout.nbytes, dtype=torch.uint8)
    before = affine_staged.LAUNCHES
    for src, dst in ((pageable, pinned), (pinned, pageable), (pageable, pageable)):
        with pytest.raises(ValueError, match="pageable"):
            affine_staged(src, layout, 3, -1, dst, device="cuda")
    with pytest.raises(ValueError, match="cpu"):  # the plain route takes no card buffer
        affine_staged(pinned.cuda(), layout, 3, -1, pinned, device="cpu")
    assert affine_staged.LAUNCHES == before
    # below the binding's checks, the C entry refuses pageable memory itself
    with pytest.raises(RuntimeError, match="cudaError"):
        _build.launch(k1._entry(), torch.device("cuda", torch.cuda.current_device()),
                      pageable.data_ptr(), pinned.data_ptr(), layout.rows, layout.nbytes,
                      ctypes.byref(k1.descriptor(layout.codes, 3, -1)), None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["affine_pallas", "affine", "square"])
def test_device_executor_on_the_card(kernel):
    """The device stage on the ``cuda`` backend: the copy in, then the kernel
    (K1, or torch's kernels) writing the pinned output buffer in place; one
    buffer on the card (the copy's), results equal to NumPy bit for bit."""
    _card()
    from repro_torch import columnar as tcol
    from repro_torch.columnar.device import make_kernel as make

    params = {"a": 3, "b": -1}
    spec = tcol.device_op("dev", kernel, tcol.Schema.of("i8", "f8", "i4", "f4"),
                          params=params, backend="cuda")
    ex = tcol.DeviceExecutor(spec, batch=64, inflight=2)
    rng = np.random.default_rng(9)
    n = 1000
    cols = [rng.integers(-(2**62), 2**62, size=n, dtype=np.int64),
            rng.standard_normal(n) * 1e3,
            rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int32),
            (rng.standard_normal(n) * 1e3).astype(np.float32)]
    out = []
    for head in range(0, n, 7):
        block = tcol.ColumnBlock(spec.schema, [c[head : head + 7] for c in cols],
                                 np.arange(head + 1, min(head + 7, n) + 1, dtype=np.int64))
        out.extend(ex.submit(block))
    out.extend(ex.flush())
    want = make(kernel, "numpy", tuple(sorted(params.items())))(*cols)
    for j, w in enumerate(want):
        got = np.concatenate([blk.columns[j] for blk in out])
        np.testing.assert_array_equal(_bits(got), _bits(w))
    st = ex.stats()
    assert st["dispatches"] >= n // 64
    assert st["launches"] == (st["dispatches"] if kernel == "affine_pallas" else 0)
    for slot in ex._slots:
        if slot is not None:
            assert slot.host_in.is_pinned() and slot.host_out.is_pinned()
            assert slot.dev_in.is_cuda and not hasattr(slot, "dev_out")
            assert len(slot.events) == 3
