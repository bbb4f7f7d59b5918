"""Kernels K1-K5 held to their plain versions on the same inputs.

``check_affine``, ``check_reorder``, ``check_dispatch``, ``check_flash`` and
``check_ssd`` run one sweep each through a kernel call given by the caller
(the public wrapper or the binding) and through the plain version, and raise
``RuntimeError`` at the first disagreement: K1, K2 and K3 bit for bit
(tolerance 0), K4 within
:data:`FLASH_TOL`, K5 within :data:`SSD_TOL`.  ``chip_smoke.py`` and the ``cuda``-marked tests run them on
the card; the CPU tests share the input makers below.  Inputs are drawn with
numpy from a seed.
"""
from __future__ import annotations

import numpy as np
import torch

from .affine.ref import Layout, affine_staged_ref
from .attention.ref import attention_ref
from .dispatch.ref import dispatch_ref
from .reorder.ref import ReorderState, commit_ref, init_state
from .ssd.ref import ssd_scan_ref

# K1: row counts that fill no tile (and one that fills no 16-byte vector),
# and the stream's batch; every column type alone and all four mixed in one
# batch; int and float a, b; (src, dst) placements: the device stage's route
# (the card's memory into the pinned output buffer), pinned to pinned, and
# the card's memory alone
AFFINE_ROWS = (7, 4093, 16384)
AFFINE_PARAMS = ((3, -1), (1, 5), (2.5, -1), (3, 0.75), (0.1, 0.3))
AFFINE_DTYPES = (torch.int64, torch.float64, torch.int32, torch.float32)
AFFINE_ROUTES = (("device", "pinned"), ("pinned", "pinned"), ("device", "device"))
COMMIT_K = 8  # entries per commit in the reorder sweep, as the reference tests
REORDER_SWEEP = ((8, 128), (64, 128), (32, 256), (1000, 3))  # (S, W) of the drains
# commit sequences at the edges of K2's one-launch design (reorder_cases)
REORDER_CASES = ("tiles and a full ring", "int32 window wrap", "wrapped states")
INT32_MAX = 2**31 - 1
# (T, P, C, W): the reference tests' shapes, then odd widths, a skewed keyed
# batch that overflows, one slot per partition at the largest P, and
# qwen2-moe's served shapes (60 experts, d_model 2048): a decode step of four
# slots (4 tokens top-4, C = 4) and a 512-token prefill (C = 43)
DISPATCH_SWEEP = ((64, 8, 16, 128), (128, 4, 8, 128), (32, 16, 4, 256), (1000, 7, 50, 3),
                  (16384, 64, 512, 32), (300, 1024, 1, 5), (16, 60, 4, 2048),
                  (2048, 60, 43, 2048))
DISPATCH_GROUPS = (1, 4)  # tuples a payload row (4: the MoE layer's top-4 choices a token)
# (B, L, H, P, N, chunk): the reference tests' shapes, chunk=256, a chunk
# that is no multiple of the 64-row tile, a short one, 32 chunks through
# the state passing, and the longest chunk at P = N = 128 with a head count
# that fills no whole group of K5's four heads
SSD_SWEEP = ((1, 128, 2, 64, 128, 64), (2, 256, 4, 64, 128, 128), (1, 512, 2, 128, 64, 128),
             (1, 512, 2, 64, 128, 256), (1, 300, 3, 64, 64, 100), (2, 128, 1, 128, 128, 32),
             (1, 2048, 3, 64, 128, 64), (1, 1024, 5, 128, 128, 512))
SSD_TOL = 2e-4  # tests/test_kernels.py:153-154
# (B, S, H, Hkv, Dh): olmo-1b's attention (H = Hkv = 16, Dh = 128; also
# qwen2-moe's) at the edges of K4's 64-row tiles and at the longest served
# prompt, two ragged batches, GQA at both head widths, and the served dense
# configs' heads: glm4-9b and chatglm3-6b (32 / 2, G = 16), starcoder2-15b
# (48 / 4, G = 12), musicgen-large (32 / 32 at Dh = 64)
FLASH_SWEEP = tuple((1, S, 16, 16, 128) for S in (1, 13, 63, 64, 65, 128, 129, 200, 512)) + (
    (2, 65, 16, 16, 128), (1, 200, 16, 4, 128), (1, 200, 16, 4, 64), (1, 200, 32, 2, 128),
    (1, 200, 48, 4, 128), (1, 200, 32, 32, 64))
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
DTYPES = (torch.float32, torch.bfloat16)


def commit_batches(rng, size: int, total: int, start: int = 0, k: int = COMMIT_K):
    """Commit batches of ``k`` serials (padded with -1) that drain ``total``
    serials from ``start`` through a ring of ``size`` slots.  Each batch
    takes distinct serials inside the window; some entries are serials the
    ring must refuse (already emitted, or past the window)."""
    pool = list(start + rng.permutation(total))
    nxt, done = start, set()  # the ring's next at each commit
    while pool:
        batch = [s for s in pool if nxt <= s < nxt + size][: k - 2]
        extra = []
        if rng.rand() < 0.5 and nxt > start:
            extra.append(nxt - 1)  # stale: already emitted
        if rng.rand() < 0.5:
            extra.append(nxt + size + int(rng.randint(0, 3)) + 100 * total)  # past the window
        for s in batch:
            pool.remove(s)
            done.add(s)
        while nxt in done:
            nxt += 1
        entries = batch + extra + [-1] * (k - len(batch) - len(extra))
        yield np.asarray(entries, np.int32)[rng.permutation(k)]


def _entries(rng, serials, pads: int = 0) -> np.ndarray:
    """``serials`` and ``pads`` -1s, shuffled, as an int32 batch."""
    out = np.concatenate([np.asarray(serials, np.int64), np.full(pads, -1)])
    return out[rng.permutation(len(out))].astype(np.int32)


def reorder_cases(rng):
    """The commit sequences of :data:`REORDER_CASES`, each as (name, S, W,
    start state, batches, expected counts).  The start state is (next,
    present) with present None for an empty ring, or a bool array (the ring's
    rows are then random); a batch is an int32 array of serials.

    - tiles and a full ring, S = 16,384, W = 128 (several blocks and count
      tiles of the kernel): 5,000 serials wait behind a gap; the gap, 100 new
      serials and 17 of the waiting ones sent again (their new payloads must
      come out) give a count of 5,101, across two tile boundaries; then
      S - 1 serials and refused ones (K > S) wait behind the next gap, which
      the last commit fills: count == S, the whole ring.
    - int32 window wrap, S = 1,000, W = 3, next near 2**31 - 1: the run
      advances until next + S wraps int32; from then on the window accepts
      nothing.
    - wrapped states, S = 1,000, W = 3: rings set up directly, with next
      near 2**31 - 1 (a run whose emitted rows read slots past the int32
      wrap, and a full one) and next just past the wrap, at INT32_MIN + 5
      (where the distance of a slot from next wraps too).
    """
    S = 16384
    tiles = [
        _entries(rng, list(range(1, 5001)) + [S + 7, S + 9000], pads=10),
        _entries(rng, [0] + list(range(5001, 5101)) + list(rng.choice(np.arange(1, 5001), 17,
                                                                      replace=False))
                 + [S + 5101 + 3], pads=3),
        _entries(rng, list(range(5102, 5101 + S)) + [100, 5100, 5101 + S, 5101 + S + 50], pads=5),
        _entries(rng, [5101, 3, 5101 + 2 * S]),
    ]
    yield "tiles and a full ring", S, 128, (0, None), tiles, [0, 5101, 0, S]

    S, start = 1000, INT32_MAX - 1500
    wrap = [
        _entries(rng, [start + i for i in range(1, 1000) if i != 400], pads=2),
        _entries(rng, [start, start - 1]),
        _entries(rng, [start + 400] + [start + i for i in range(1000, 1200) if i != 1100]),
        _entries(rng, [start + 1100, INT32_MAX, INT32_MAX - 1, start + 1101], pads=1),
    ]
    yield "int32 window wrap", S, 3, (start, None), wrap, [0, 400, 700, 0]

    present = np.ones(S, bool)
    present[(INT32_MAX - 10 + 700) % S] = False  # the gap at distance 700
    probe = [_entries(rng, [INT32_MAX - 10, 5, INT32_MAX], pads=1)]
    yield "wrapped states", S, 3, (INT32_MAX - 10, present), probe, [700]
    yield "wrapped states", S, 3, (INT32_MAX - 10, np.ones(S, bool)), probe, [S]
    past = -(2**31) + 5
    present = rng.rand(S) < 0.9
    want = min((i - past) % S if -(2**31) <= i - past < 2**31 else (i - past - 2**32) % S
               for i in np.flatnonzero(~present).tolist())
    yield "wrapped states", S, 3, (past, present), [_entries(rng, [0, 1, past], pads=1)], [want]


def zipf_ids(rng, T: int, P: int, s: float = 1.1, invalid: float = 0.05) -> np.ndarray:
    """Partition ids with Zipf(s) skew over P partitions (partition 0 the
    hottest), and a share of -1s."""
    w = 1.0 / np.arange(1, P + 1) ** s
    ids = rng.choice(P, size=T, p=w / w.sum()).astype(np.int32)
    ids[rng.rand(T) < invalid] = -1
    return ids


def ssd_inputs(B, L, H, P, N, seed: int = 4):
    """The reference test's draw: x, softplus dt, negative A, B and C x 0.3,
    as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)  # softplus
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, L, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Every bit of two tensors of one dtype and shape equal (NaN and -0.0
    included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def affine_column(dtype: torch.dtype, rows: int, rng, float_param: bool) -> np.ndarray:
    """A column for K1: ``i8`` beyond int32 (``x*3`` overflows on the int
    path), ``i4`` near its edges, floats spread to 1e3.  With a float
    parameter, integers stay where the float64 result converts back."""
    if dtype == torch.int64:
        hi = 2**61 if float_param else 2**62
        return rng.integers(-hi, hi, size=rows, dtype=np.int64)
    if dtype == torch.int32:
        hi = 2**29 if float_param else 2**31 - 1
        return rng.integers(-hi, hi, size=rows, dtype=np.int32)
    return (rng.standard_normal(rows) * 1e3).astype(
        np.float64 if dtype == torch.float64 else np.float32)


def staging_buffer(nbytes: int, place: str) -> torch.Tensor:
    """An empty staging buffer for K1 in ``place``: ``pinned`` host memory
    or the card's memory (``device``)."""
    if place == "pinned":
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return torch.empty(nbytes, dtype=torch.uint8, device="cuda")


def check_affine(affine_fn, routes=AFFINE_ROUTES, seed: int = 1) -> int:
    """K1 over every column type alone and all four in one batch, at
    :data:`AFFINE_ROWS`, under :data:`AFFINE_PARAMS`, on each (src, dst)
    placement of ``routes``: ``affine_fn(src, layout, a, b, dst)`` on
    buffers there against ``affine_staged_ref`` on the card, every byte of
    every column equal.  Returns the number of batches checked."""
    rng = np.random.default_rng(seed)
    checks = 0
    for rows in AFFINE_ROWS:
        for a, b in AFFINE_PARAMS:
            fp = isinstance(a, float) or isinstance(b, float)
            cols = [torch.from_numpy(affine_column(dt, rows, rng, fp)) for dt in AFFINE_DTYPES]
            for batch in [cols] + [[c] for c in cols]:
                layout = Layout.of([c.dtype for c in batch], rows)
                staged = layout.stage(batch)
                ref = affine_staged_ref(staged.cuda(), layout, a, b,
                                        torch.empty(layout.nbytes, dtype=torch.uint8,
                                                    device="cuda"))
                for place_in, place_out in routes:
                    src = staging_buffer(layout.nbytes, place_in)
                    src.copy_(staged)
                    dst = affine_fn(src, layout, a, b, staging_buffer(layout.nbytes, place_out))
                    torch.cuda.synchronize()
                    got = dst.cuda()
                    if not all(bits_equal(layout.column(got, j), layout.column(ref, j))
                               for j in range(layout.width)):
                        raise RuntimeError(
                            f"K1 disagrees with its plain version: {place_in} to {place_out}, "
                            f"rows {rows}, "
                            f"a={a} b={b}, dtypes {[c.dtype for c in batch]}")
                    checks += 1
    return checks


def _commit_both(commit_fn, st, st_ref, serials, pay, label):
    """One commit through ``commit_fn`` and ``commit_ref``; raises unless
    every output and the ring are equal bit for bit."""
    st, em, cnt, acc = commit_fn(st, serials, pay)
    st_ref, em_r, cnt_r, acc_r = commit_ref(st_ref, serials, pay)
    same = (int(cnt) == int(cnt_r) and int(st.next) == int(st_ref.next)
            and torch.equal(acc, acc_r) and torch.equal(st.present, st_ref.present)
            and bits_equal(em, em_r) and bits_equal(st.buf, st_ref.buf))
    if not same:
        shown = serials.tolist()
        shown = shown if len(shown) <= 16 else f"{shown[:16]}... ({len(shown)} entries)"
        raise RuntimeError(f"K2 disagrees with commit_ref: {label}, serials {shown}")
    return st, st_ref, em, int(cnt), acc


def check_reorder(commit_fn, device="cuda", seed: int = 0) -> int:
    """Multi-commit drains of 3 S serials over :data:`REORDER_SWEEP`, then
    the sequences of :data:`REORDER_CASES`, f32 and bf16, with -1 padding
    and refused serials, through ``commit_fn(state, serials, payloads)`` and
    ``commit_ref``; every output and the ring equal bit for bit, and each
    case's counts are the ones it was built for (in the tiles case, the
    emitted rows are each serial's latest payload, in serial order).
    Returns the number of commits."""
    rng = np.random.RandomState(seed)
    commits = 0
    for size, width in REORDER_SWEEP:
        for dtype in DTYPES:
            st = init_state(size, width, dtype, device=device)
            st_ref = ReorderState(*(t.clone() for t in st))
            for serials in commit_batches(rng, size, 3 * size):
                s = torch.from_numpy(serials).to(device)
                pay = torch.from_numpy(rng.standard_normal((len(serials), width))).to(device, dtype)
                st, st_ref, *_ = _commit_both(commit_fn, st, st_ref, s, pay,
                                              f"S={size} W={width} {dtype}")
                commits += 1
            if int(st.next) != 3 * size or bool(st.present.any()):
                raise RuntimeError(f"K2 sweep S={size} W={width} {dtype} did not drain")
    for dtype in DTYPES:
        for name, size, width, (start, present), batches, counts in reorder_cases(rng):
            label = f"{name}, S={size} W={width} {dtype}"
            st = init_state(size, width, dtype, start=start, device=device)
            if present is not None:
                st.present.copy_(torch.from_numpy(present))
                st.buf.copy_(torch.from_numpy(rng.standard_normal((size, width))))
            st_ref = ReorderState(*(t.clone() for t in st))
            latest, emitted, got = {}, [], []
            for serials in batches:
                s = torch.from_numpy(serials).to(device)
                pay = torch.from_numpy(rng.standard_normal((len(serials), width))).to(device, dtype)
                st, st_ref, em, cnt, acc = _commit_both(commit_fn, st, st_ref, s, pay, label)
                for k in torch.nonzero(acc).flatten().tolist():
                    latest[int(serials[k])] = pay[k]
                emitted += list(em[:cnt])
                got.append(cnt)
                commits += 1
            if got != counts:
                raise RuntimeError(f"K2 sweep {label}: counts {got}, built for {counts}")
            if present is None and start == 0 and not all(
                    bits_equal(row, latest[t]) for t, row in enumerate(emitted)):
                raise RuntimeError(f"K2 sweep {label}: emitted rows are not the latest payloads")
    return commits


def check_dispatch(dispatch_fn, device="cuda", seed: int = 1) -> int:
    """:data:`DISPATCH_SWEEP`, f32 and bf16, each group of
    :data:`DISPATCH_GROUPS`, Zipf-skewed ids with -1s and some ids past P,
    through ``dispatch_fn(ids, payloads, P, C, group=group)`` (payloads
    (T / group, W)) and ``dispatch_ref``; buffers, counts and dest equal bit
    for bit.  Returns the number of cases."""
    rng = np.random.RandomState(seed)
    cases = 0
    for T, P, C, W in DISPATCH_SWEEP:
        for dtype in DTYPES:
            for group in DISPATCH_GROUPS:
                ids = zipf_ids(rng, T, P)
                past = rng.rand(T) < 0.02
                ids[past] = P + rng.randint(0, 5, int(past.sum()))  # invalid too
                ids = torch.from_numpy(ids).to(device)
                pay = torch.from_numpy(rng.standard_normal((T // group, W))).to(device, dtype)
                got = dispatch_fn(ids, pay, P, C, group=group)
                want = dispatch_ref(ids, pay, P, C, group=group)
                if not all(bits_equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"K3 disagrees with dispatch_ref at T,P,C,W={T, P, C, W} "
                                       f"{dtype} group {group}")
                cases += 1
    return cases


def flash_inputs(B, S, H, Hkv, Dh, seed: int = 2):
    """q, k, v standard normal, as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))


def check_flash(flash_fn, shapes=FLASH_SWEEP, device="cuda",
                seed: int = 2) -> list[tuple[str, float]]:
    """``shapes`` (B, S, H, Hkv, Dh) in f32 and bf16, causal and not, through
    ``flash_fn(q, k, v, causal)`` and ``attention_ref``: every element within
    :data:`FLASH_TOL` + the same share of |ref|, and the largest error within
    :data:`FLASH_TOL`.  Returns (line, max |err|) per case; the line gives
    the error and, for bf16, both sides' error against the f32 computation."""
    rows = []
    for shape in shapes:
        qkv = [torch.from_numpy(a).to(device) for a in flash_inputs(*shape, seed=seed)]
        for dtype in DTYPES:
            q, k, v = (t.to(dtype) for t in qkv)
            for causal in (True, False):
                out = flash_fn(q, k, v, causal)
                ref = attention_ref(q, k, v, causal)
                tol = FLASH_TOL[dtype]
                diff = (out.float() - ref.float()).abs()
                err = float(diff.max())
                label = f"B,S,H,Hkv,Dh={shape} {str(dtype)[6:]} causal={causal}"
                if out.shape != ref.shape or out.dtype != dtype or err > tol or not bool(
                        (diff <= tol + tol * ref.float().abs()).all()):
                    raise RuntimeError(f"K4 disagrees with attention_ref at {label}: "
                                       f"max|err| {err:.3g} (tol {tol})")
                line = f"{label}: max|err| {err:.3g} (tol {tol}) ok"
                if dtype != torch.float32:
                    exact = attention_ref(*(t.float() for t in (q, k, v)), causal)
                    line += (f"; vs f32: kernel {float((out.float() - exact).abs().max()):.3g}, "
                             f"plain {float((ref.float() - exact).abs().max()):.3g}")
                rows.append((line, err))
    return rows


def ssd_close(got, want, rtol: float) -> tuple[bool, float]:
    """(y and hT within SSD_TOL + rtol |y_ref| and SSD_TOL (1 + |hT_ref|),
    the largest absolute difference)."""
    (y, hT), (y_r, h_r) = got, want
    err = max(float((y.float() - y_r.float()).abs().max()), float((hT - h_r).abs().max()))
    ok = all(bool(((a.float() - b.float()).abs() <= SSD_TOL + r * b.float().abs()).all())
             for a, b, r in ((y, y_r, rtol), (hT, h_r, SSD_TOL)))
    return ok, err


def check_ssd(ssd_fn, device="cuda", seed: int = 4) -> list[tuple[str, float]]:
    """:data:`SSD_SWEEP` with x in f32 and in bf16 through ``ssd_fn(x, dt, A,
    Bm, Cm, chunk)`` and ``ssd_scan_ref``, within :data:`SSD_TOL` (a bf16 x
    adds one bf16 step, 2**-7 relative, to y).  Returns (case, max |err|)
    for each case."""
    rows = []
    for B, L, H, P, N, chunk in SSD_SWEEP:
        x, dt, A, Bm, Cm = (torch.from_numpy(a).to(device) for a in ssd_inputs(B, L, H, P, N, seed))
        for xd in (x, x.to(torch.bfloat16)):
            label = f"B,L,H,P,N,chunk={B, L, H, P, N, chunk} x {str(xd.dtype)[6:]}"
            rtol = 2**-7 if xd.dtype == torch.bfloat16 else SSD_TOL
            ok, err = ssd_close(ssd_fn(xd, dt, A, Bm, Cm, chunk),
                                ssd_scan_ref(xd, dt, A, Bm, Cm, chunk), rtol)
            if not ok:
                raise RuntimeError(f"K5 disagrees with ssd_chunked at {label}: max|err| {err:.3g}")
            rows.append((label, err))
    return rows
