#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. Device: the card's name and power limit (``nvidia-smi``).  Without CUDA
   the script stops here.  Then every kernel source is compiled with nvcc
   for sm_90a, all at once (one nvcc per source).
2. Kernels: K4 (``kernels/attention/csrc/flash_fwd.cu``; bf16 on the
   tensor cores, f32 on the CUDA cores).  Its library's launch plan is held
   to ``flash.plan()``; then the kernel is held to the plain
   ``attention_ref`` on the card (max error within 2e-2 in bf16, 2e-5 in
   f32, the tolerances of the kernel tests) over ``parity.FLASH_SWEEP``:
   olmo-1b's attention (B=1, H=Hkv=16, Dh=128) at S in {1, 13, 63, 64, 65,
   128, 129, 200, 512}, B=2 at S=65, and GQA (H=16, Hkv=4) at Dh=128 and
   Dh=64, bf16 and f32, causal and not.  Then, at every served prompt
   length, the device time of the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) by CUDA-graph replay, and beside it the eager call time of the
   kernel and of SDPA (host launch cost included).
3. Serving: olmo-1b at full width (16 layers, d_model 2048, vocab 50304) with
   random bf16 weights from a seeded generator, through
   ``OrderedServingEngine(max_slots=4, max_len=1024)``: eight requests, both
   schedules.  Egress must be in serial order, every token inside the vocab,
   and K4 launched exactly prefills x 16 times.  One request is then served
   again in f32 and checked token for token against ``generate``.
4. K1 (``kernels/affine/csrc/affine.cu``, the device stage's affine map,
   which writes the pinned output buffer over PCIe, so a batch is the copy
   in and one launch): held to its plain version on the card bit for bit
   (tolerance 0) with ``parity.check_affine``, from the card's memory into
   pinned memory (the device stage's route), pinned to pinned and on the
   card's memory, for every column type with int and float parameters,
   alone and in one batch that mixes the types, at row counts that fill no
   tile; a pageable host buffer must be refused.  Then
   ``launch/bench_affine.py`` at the stream's device batch (16384 rows of
   12 ``i8`` columns): the device stage's route, the one-launch pinned to
   pinned design and, where the parent commit is unpacked under
   ``build/parent/`` (``git archive``), the parent's route (copy in, its
   K1, copy out), in turns (A B C C B A), by graph replay and eagerly; then
   the kernel alone, the copies, the plain version and
   ``torch.add(b, x, alpha=a)`` on each column (a yardstick only; the port
   never calls it), each beside its bound (PCIe for what crosses the link,
   from the link's generation and width; HBM for the card's memory).
5. Stream: ``python -m repro_torch.launch.stream`` as a subprocess (this
   process holds a CUDA context, and device workers are forked): 1,048,576
   tuples through ``widen -> dev0 -> dev1`` on the process runtime, K1 on
   both device stages.  Egress must be in serial order and bit-identical to
   NumPy, and K1 launched once per dispatch of the two stages.

Phases 6-8 hold each kernel to its plain version with the sweeps of
``repro_torch.kernels.parity``, which the ``cuda``-marked tests run too.

6. K2 (``kernels/reorder/csrc/reorder.cu``, the reorder-commit in one
   launch): held to ``commit_ref`` on the card bit for bit (tolerance 0)
   over multi-commit drains (S in {8, 64, 32, 1000} x W in {128, 256, 3},
   f32 and bf16) with -1 padding and refused serials (stale and past the
   window), and over ``parity.REORDER_CASES`` (a 16,384 x 128 ring whose
   counts cross the kernel's tiles and fill the whole ring, K > S, a serial
   re-sent while present, next near 2**31 - 1 and past the int32 wrap);
   then one ordering point at a real size through ``ops.commit``: a ring of
   16,384 slots x 128 f32 takes 1,048,576 serials, shuffled within blocks
   of 8,192 so that all are accepted, in commits of 512 with 1 entry in 16
   padded -1.  The emitted rows must equal the payload table in serial
   order, bit for bit, and K2 launched once per commit.  One commit is
   timed by graph replay, with the plain version beside it.  Where the
   parent commit's three-launch K2 is unpacked under ``build/parent/``
   (``git archive``), it is timed beside the new one in turns (A B B A),
   and each of its three launches alone (``launch/bench_reorder.py``).
7. K3 (``kernels/dispatch/csrc/dispatch.cu``, the hybrid-queue dispatch):
   held to ``dispatch_ref`` bit for bit on a sweep of six shapes with
   Zipf-skewed ids, -1s and ids past P, then through
   ``ops.dispatch`` on ``kernel_bench``'s shape (T=256, P=16, C=32, W=128
   f32), a Zipf(1.1)-skewed keyed batch (T=16384, P=64, C=512, W=32 f32,
   with -1s; hot partitions overflow and drop) and MoE routing at
   phi3.5-moe's widths (4,096 tokens top-2 of 16 experts, C=640, W=4,096
   bf16); K3 launched 4 x calls times.  Timed at the MoE shape.
8. K5 (``kernels/ssd/csrc/ssd.cu``, the SSD chunked scan split across
   chunks: chunk states, state passing, chunk outputs, three launches, the
   products as split TF32 on the tensor cores): held to the plain
   ``ssd_chunked`` on the card within 2e-4 (the kernel tests' tolerance; a
   bf16 ``x`` adds one bf16 step, 2**-7 relative) over
   ``parity.SSD_SWEEP``, then through ``ops.ssd`` at mamba2-780m's widths
   (H=48, P=64, N=128, chunk=256, B=1, L=2048, f32), launched
   ``LAUNCHES_PER_CALL`` times, and timed there by graph replay and
   eagerly; both sides' ``y`` is printed against an f64 computation, and
   the bound is that of the units the kernel uses.  Where the parent
   commit's one-launch K5 is unpacked under ``build/parent/`` (``git
   archive``), it is timed beside the new one in turns (A B B A), and each
   launch of the new one alone (``launch/bench_ssd.py``).

Output: human-readable lines, then a ``{"kernels": [...]}`` JSON line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch.timing import graph_time_ms, time_ms  # noqa: E402

# H100 SXM data-sheet peaks (dense): device memory rate, and the operation
# rate for each input type (bf16 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_OPS_PER_S = 495e12  # TF32 on the tensor cores
SERVED_PROMPT_LENS = (17, 128, 200, 333, 512, 64, 45, 300)
REPLACES = "src/repro/kernels/attention/flash.py:22 (_flash_kernel; pallas_call at :112)"
K1_REPLACES = "src/repro/columnar/device.py:127 (_pallas_affine_body; pallas_call at :141)"
STREAM_ARGS = ["--tuples", str(1 << 20), "--device-batch", "16384", "--inflight", "2"]
STREAM_TIMEOUT_S = 300
K2_REPLACES = "src/repro/kernels/reorder/reorder.py:27 (_commit_kernel; pallas_call at :110)"
K3_REPLACES = "src/repro/kernels/dispatch/dispatch.py:23 (_dispatch_kernel; pallas_call at :79)"
K5_REPLACES = "src/repro/kernels/ssd/ssd.py:24 (_ssd_kernel; pallas_call at :98)"


def log(msg: str) -> None:
    print(msg, flush=True)


def attention_bound(B, S, H, Hkv, Dh, dtype, causal) -> tuple[float, str]:
    """Least time for the work: q, k, v read once and o written once against
    the QK^T and PV multiply-adds over the (causal) key pairs."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = B * S * (2 * H + 2 * Hkv) * Dh * itemsize
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 4 * B * H * Dh * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return name


def phase_build() -> None:
    """Compile every kernel source at once, one nvcc for each."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.affine import affine
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.dispatch import dispatch
    from repro_torch.kernels.reorder import reorder
    from repro_torch.kernels.ssd import ssd

    sources = [flash.SOURCE, affine.SOURCE, reorder.SOURCE, dispatch.SOURCE, ssd.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    log(f"[build] built {', '.join(os.path.relpath(s, ROOT) for s in sources)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for src in sources:
        for line in _build.ptxas_report(src):
            log(f"[build]   {src.name} ptxas: {line}")


# ---------------------------------------------------------------- phase 2
def _qkv(B, S, H, Hkv, Dh, dtype, gen):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    return randn(B, S, H, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh)


def phase_kernels() -> dict:
    from repro_torch.kernels import parity
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash._entry()  # builds, loads and holds the library's plan to flash.plan()
    p = flash.plan(1, 512, 16, 128, torch.bfloat16)
    log(f"[kernels] K4 launch plan equals flash.plan(); bf16 at S=512 Dh=128: {p.path}, "
        f"{p.block_rows} rows x {p.key_tile}-key tiles, {p.threads} threads, grid {p.grid}, "
        f"{p.smem_bytes} B shared memory")
    max_err = 0.0
    for line, err in parity.check_flash(flash.flash_fwd):
        log(f"[kernels] K4 {line}")
        max_err = max(max_err, err)

    # times at the served shapes: olmo-1b prefill, bf16, causal
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Dh, dtype = 16, 128, torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for S in sorted(set(SERVED_PROMPT_LENS)):
        q, k, v = _qkv(1, S, H, H, Dh, dtype, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel = lambda: flash.flash_fwd(q, k, v, True)  # noqa: E731
        plain = lambda: attention_ref(q, k, v, True)  # noqa: E731
        library = lambda: sdpa(qt, kt, vt, is_causal=True)  # noqa: E731
        ms, plain_ms, library_ms = (graph_time_ms(f) for f in (kernel, plain, library))
        call_ms, library_call_ms = (time_ms(f, iters=200) for f in (kernel, library))
        bound_ms, bound_by = attention_bound(1, S, H, H, Dh, dtype, True)
        rows[S] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernels] K4 S={S} device time (graph replay): kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, sdpa {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), share of bound {bound_ms / ms:.4f}; eager call: kernel "
            f"{call_ms:.5f} ms, sdpa {library_call_ms:.5f} ms")
    top = rows[max(rows)]
    log(f"[kernels] the kernels line reports K4 at B=1 S={max(rows)} H=Hkv=16 Dh=128 bf16 "
        "causal (the largest served prompt), graph-replay times")
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": os.path.relpath(flash.SOURCE, ROOT),
        "replaces": REPLACES,
        "launches": 0,  # filled from the serving run
        "max_abs_err": max_err,
        **top,
    }


# ---------------------------------------------------------------- phase 3
def _serve(cfg, params, requests, schedule):
    from repro_torch.serve.engine import OrderedServingEngine

    eng = OrderedServingEngine(cfg, params, max_slots=4, max_len=1024, schedule=schedule,
                               device="cuda")
    serials = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [c.serial for c in comps] != sorted(serials):
        raise RuntimeError(f"{schedule}: egress out of serial order")
    for c in comps:
        if c.tokens.min() < 0 or c.tokens.max() >= cfg.vocab_size:
            raise RuntimeError(f"{schedule}: token outside the vocab in request {c.serial}")
    return eng, comps, wall


def phase_serving() -> int:
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params, init_params

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {count_params(cfg) / 1e9:.3f} B params (bf16) made in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.RandomState(0)
    new_tokens = rng.randint(16, 65, size=len(SERVED_PROMPT_LENS))
    requests = [
        (rng.randint(0, cfg.vocab_size, size=S).astype(np.int32), int(n))
        for S, n in zip(SERVED_PROMPT_LENS, new_tokens)
    ]
    _serve(cfg, params, requests[:1], "interleave")  # warm-up: cuBLAS, caches

    flash_attention.LAUNCHES = 0
    runs = {}
    for schedule in ("interleave", "prefill_first"):
        runs[schedule] = _serve(cfg, params, requests, schedule)
    launches = flash_attention.LAUNCHES

    prefills = 0
    for schedule, (eng, comps, wall) in runs.items():
        ntok = sum(len(c.tokens) for c in comps)
        prefills += eng.stats["prefills"]
        log(f"[serve] {schedule}: {len(comps)} requests, {ntok} tokens in {wall:.3f}s "
            f"({ntok / wall:.1f} tok/s); prefills {eng.stats['prefills']}, decode steps "
            f"{eng.stats['decode_steps']}; egress in serial order")
        for c in comps:
            log(f"[serve]   #{c.serial} ({len(c.tokens)} tokens, {c.latency_s:.3f}s): "
                f"{c.tokens.tolist()}")
    same = all(
        np.array_equal(a.tokens, b.tokens)
        for a, b in zip(runs["interleave"][1], runs["prefill_first"][1])
    )
    log(f"[serve] the two schedules gave the same tokens: {same}")
    if launches != prefills * cfg.num_layers:
        raise RuntimeError(f"K4 launched {launches} times, expected {prefills} x {cfg.num_layers}")
    log(f"[serve] K4 launches on the main path: {launches} = {prefills} prefills x "
        f"{cfg.num_layers} layers")

    # f32, where rounding cannot flip a greedy choice: engine vs generate
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    del runs
    params32 = _tree_map(lambda t: t.float(), params)
    del params
    prompt, n_new = requests[0]
    _, comps, _ = _serve(cfg32, params32, [(prompt, n_new)], "interleave")
    ref = transformer.generate(cfg32, params32, torch.from_numpy(prompt)[None].long().cuda(), n_new - 1)
    ref = ref[0].cpu().numpy()
    if not np.array_equal(comps[0].tokens, ref):
        raise RuntimeError(f"f32 engine tokens {comps[0].tokens.tolist()} != generate {ref.tolist()}")
    log(f"[serve] f32 check: engine tokens equal generate for request 1 ({n_new} tokens)")
    return launches


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ---------------------------------------------------------------- phase 4
K1_PARENT = os.path.join(ROOT, "build", "parent", "src", "repro_torch", "kernels", "affine",
                         "csrc", "affine.cu")


def phase_k1() -> dict:
    from repro_torch.kernels import parity
    from repro_torch.kernels.affine import affine as k1
    from repro_torch.kernels.affine.ref import Layout
    from repro_torch.launch import bench_affine

    checks = parity.check_affine(k1.affine_fwd)
    routes = ", ".join(f"{i} to {o}" for i, o in parity.AFFINE_ROUTES)
    log(f"[k1] {checks} batches (i8/f8/i4/f4 alone and mixed, rows {parity.AFFINE_ROWS}, int and "
        f"float a, b; {routes}) equal the plain version bit for bit (tolerance 0)")
    layout = Layout.of([torch.int64], 64)
    pageable = torch.zeros(layout.nbytes, dtype=torch.uint8)
    try:
        k1.affine_fwd(pageable, layout, 3, -1, pageable.clone())
    except ValueError as e:
        log(f"[k1] a pageable host buffer is refused: {e}")
    else:
        raise RuntimeError("K1 took a pageable host buffer")

    # the stream's batch on every route, the parent's route beside the new one
    parent = Path(K1_PARENT) if os.path.exists(K1_PARENT) else None
    if parent is None:
        log(f"[k1] the parent's K1 is not unpacked at {os.path.relpath(K1_PARENT, ROOT)}: its "
            "route (copy in, K1, copy out) is not timed beside the new one")
    r = bench_affine.compare(parent)
    log(f"[k1] {bench_affine.card()}")
    for line in bench_affine.report(r):
        log(f"[k1] {line}")
    # the kernel as the main path launches it: the card's memory into the
    # pinned output buffer; its bound is the link (the reads come from HBM)
    return {
        "name": "affine",
        "route": "cuda",
        "source": os.path.relpath(k1.SOURCE, ROOT),
        "replaces": K1_REPLACES,
        "launches": 0,  # filled from the stream run
        "max_abs_err": r["max_abs_err"]["kernel"],
        "ms": r["graph_ms"]["kernel"], "plain_ms": r["graph_ms"]["plain"],
        "bound_ms": r["bound_ms"]["pcie"], "bound_by": "bytes",
        "library_ms": r["graph_ms"]["library"],
    }


# ---------------------------------------------------------------- phase 5
def phase_stream() -> int:
    """The stream in a fresh process; returns K1's launches on its path."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", *STREAM_ARGS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=STREAM_TIMEOUT_S,
    )
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"stream run failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    r = json.loads(lines[-1])["stream"]
    if r["tuples"] < 1 << 20 or r["device_batch"] < 16384:
        raise RuntimeError(f"stream ran below its size: {r['tuples']} tuples, batch {r['device_batch']}")
    if r["launches"] != r["dispatches"] or r["launches"] == 0:
        raise RuntimeError(f"K1 launched {r['launches']} times for {r['dispatches']} dispatches")
    log(f"[stream] {r['tuples']} tuples in {r['wall_s']:.3f}s: {r['throughput_per_s']:.1f} "
        f"tuples/s, p99 latency {r['p99_latency_ms']:.3f} ms; K1 launches on the main path: "
        f"{r['launches']} = dispatches of both device stages")
    return r["launches"]


# ---------------------------------------------------------------- phase 6
K2_RING, K2_WIDTH, K2_SERIALS, K2_BATCH = 16384, 128, 1 << 20, 512
K2_PARENT = os.path.join(ROOT, "build", "parent", "src", "repro_torch", "kernels", "reorder",
                         "csrc", "reorder.cu")


def commit_bound(S, W, itemsize, K, accepted, count, fresh) -> float:
    """Least time of one commit, in ms: the serials, the accepted payload
    rows, present flags and next read once; the accepted mask, the accepted
    rows into the ring, the present flags, the whole (S, W) ``emitted``,
    count and next written once; and the emitted rows that this batch did
    not bring read from the ring.  Bytes bound it (no arithmetic to speak
    of)."""
    row = W * itemsize
    nbytes = (K * 4 + accepted * row + S + 4) + (K + accepted * row + S + S * row + 8) \
        + (count - fresh) * row
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_k2() -> dict:
    from repro_torch.kernels import parity
    from repro_torch.kernels.reorder import reorder as k2
    from repro_torch.kernels.reorder.ops import commit
    from repro_torch.kernels.reorder.ref import ReorderState, commit_ref, init_state
    from repro_torch.launch import bench_reorder

    checks = parity.check_reorder(k2.commit_fwd)
    log(f"[k2] {checks} commits (drains over S x W in {parity.REORDER_SWEEP}, f32 and bf16, -1 "
        "padding, stale and past-window serials refused; and the cases "
        f"{list(parity.REORDER_CASES)}) equal commit_ref bit for bit (tolerance 0)")

    # one ordering point at a real size, through the public wrapper
    S, W, N, K = K2_RING, K2_WIDTH, K2_SERIALS, K2_BATCH
    gen = torch.Generator(device="cuda").manual_seed(2)
    table = torch.randn(N, W, generator=gen, device="cuda")  # payload of serial t = row t
    block = torch.arange(N, device="cuda") // (S // 2)
    order = torch.argsort(torch.rand(N, generator=gen, device="cuda", dtype=torch.float64)
                          + block.double()).to(torch.int32)  # shuffled within blocks of S/2
    per = K - K // 16  # serials per commit; 1 entry in 16 is -1
    commits = -(-N // per)
    keep = torch.ones(commits, K, dtype=torch.bool, device="cuda")
    pads = torch.rand(commits, K, generator=gen, device="cuda").argsort(dim=1)[:, : K // 16]
    keep.scatter_(1, pads, False)
    entries = torch.full((commits, K), -1, dtype=torch.int32, device="cuda")
    entries[keep] = torch.cat([order, order.new_full((commits * per - N,), -1)])
    out = torch.empty(N + S, W, device="cuda")  # rows past a commit's count land in the tail
    ar = torch.arange(S, device="cuda", dtype=torch.int32)
    refused = torch.zeros((), dtype=torch.int64, device="cuda")
    state = init_state(S, W, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    commit.LAUNCHES = 0
    for i in range(commits):
        serials = entries[i]
        head = state.next
        state, em, cnt, acc = commit(state, serials, table[serials.clamp(min=0).long()])
        out.index_copy_(0, torch.where(ar < cnt, head + ar, N + ar).long(), em)
        refused += (acc != (serials >= 0)).sum()
    launches = commit.LAUNCHES
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if int(state.next) != N or int(refused) != 0 or bool(state.present.any()):
        raise RuntimeError(f"K2 drain: next {int(state.next)} of {N}, {int(refused)} serials "
                           "refused or accepted wrongly")
    if not parity.bits_equal(out[:N], table):
        raise RuntimeError("K2 drain: the emitted rows differ from the payload table")
    if launches != commits or k2.LAUNCHES_PER_CALL != 1:
        raise RuntimeError(f"K2 launched {launches} times for {commits} commits")
    log(f"[k2] drain: {N} serials through a {S} x {W} f32 ring in {commits} commits of {K} "
        f"({per} serials, {K - per} pads) in {wall:.3f}s; emitted rows equal the payload table "
        f"in serial order bit for bit; K2 launches on the main path: {launches} = "
        f"{commits} commits, one launch each")
    del table, order, entries, keep, out

    # one commit timed by graph replay: `per` serials fill the head of a ring
    # in which a quarter of the window is already waiting, past a gap; from
    # the second replay on, each commit accepts the `per` and emits them
    state, serials, payloads, per = bench_reorder.timing_commit(gen)
    k2.commit_fwd(state, serials, payloads)
    _, em, cnt, acc = k2.commit_fwd(state, serials, payloads)
    ref = commit_ref(ReorderState(*(t.clone() for t in state)), serials, payloads)
    if not (parity.bits_equal(em, ref[1]) and int(cnt) == int(ref[2]) == per):
        raise RuntimeError("K2 timing commit disagrees with commit_ref")
    ms = graph_time_ms(lambda: k2.commit_fwd(state, serials, payloads))
    plain_ms = graph_time_ms(lambda: commit_ref(state, serials, payloads))
    bound_ms = commit_bound(S, W, 4, K, int(acc.sum()), int(cnt), per)
    log(f"[k2] one commit at S={S} W={W} f32, K={K} ({per} accepted and emitted), device time "
        f"(graph replay): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"(bytes), share of bound {bound_ms / ms:.4f}")
    if os.path.exists(K2_PARENT):
        log(f"[k2] against the parent's three-launch K2 ({os.path.relpath(K2_PARENT, ROOT)}):")
        for line in bench_reorder.report(bench_reorder.compare(["package", K2_PARENT])):
            log(f"[k2] {line}")
    else:
        log(f"[k2] the parent's three-launch K2 is not unpacked at "
            f"{os.path.relpath(K2_PARENT, ROOT)}: not timed beside the new one")
    return {
        "name": "reorder_commit", "route": "cuda",
        "source": os.path.relpath(k2.SOURCE, ROOT), "replaces": K2_REPLACES,
        "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }


# ---------------------------------------------------------------- phase 7
def dispatch_bound(T, P, C, W, itemsize, kept) -> float:
    """Least time of one dispatch, in ms: the ids and the ``kept`` payload
    rows (those that land in a buffer) read once, the whole zero-filled
    buffers, counts and dest written once.  Bytes bound it."""
    nbytes = T * 4 + kept * W * itemsize + P * C * W * itemsize + P * 4 + T * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_k3() -> dict:
    from repro_torch.kernels import parity
    from repro_torch.kernels.dispatch import dispatch as k3
    from repro_torch.kernels.dispatch.ops import dispatch
    from repro_torch.kernels.dispatch.ref import dispatch_ref

    rng = np.random.RandomState(3)

    def same(got, want):
        return all(parity.bits_equal(a, b) for a, b in zip(got, want))

    checks = parity.check_dispatch(k3.dispatch_fwd)
    log(f"[k3] {checks} sweep cases (T,P,C,W in {parity.DISPATCH_SWEEP}, f32 and bf16, "
        "Zipf ids with -1s and ids past P) equal dispatch_ref bit for bit (tolerance 0)")

    # the main path, through the public wrapper
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens, experts, top_k, d_model = 4096, 16, 2, 4096  # phi3.5-moe
    cap = max(int(np.ceil(tokens * top_k / experts * 1.25)), 4)  # ffn.py:114
    gates = torch.randn(tokens, experts, generator=gen, device="cuda")
    moe_ids = gates.topk(top_k, dim=1).indices.to(torch.int32).reshape(-1)
    hidden = torch.randn(tokens, d_model, generator=gen, device="cuda").to(torch.bfloat16)
    cases = {
        "kernel_bench": (torch.from_numpy(rng.randint(-1, 16, 256).astype(np.int32)).cuda(),
                         torch.randn(256, 128, generator=gen, device="cuda"), 16, 32),
        "skewed keyed": (torch.from_numpy(parity.zipf_ids(rng, 16384, 64)).cuda(),
                         torch.randn(16384, 32, generator=gen, device="cuda"), 64, 512),
        "moe": (moe_ids, hidden.repeat_interleave(top_k, dim=0), experts, cap),
    }
    torch.cuda.synchronize()
    dispatch.LAUNCHES = 0
    outs = {name: dispatch(*args) for name, args in cases.items()}
    launches = dispatch.LAUNCHES
    torch.cuda.synchronize()
    if launches != k3.LAUNCHES_PER_CALL * len(cases):
        raise RuntimeError(f"K3 launched {launches} times for {len(cases)} dispatches")
    for name, args in cases.items():
        ids, pay, P, C = args
        if not same(outs[name], dispatch_ref(*args)):
            raise RuntimeError(f"K3 disagrees with dispatch_ref on the {name} batch")
        counts = outs[name][1]
        dropped = int((outs[name][2] < 0).sum()) - int((ids < 0).sum())
        log(f"[k3] {name}: T={ids.numel()} P={P} C={C} W={pay.shape[1]} {str(pay.dtype)[6:]}: "
            f"equal to dispatch_ref bit for bit; counts max {int(counts.max())} min "
            f"{int(counts.min())}, {dropped} tuples dropped past capacity")
    if int((outs["skewed keyed"][1] > 512).sum()) == 0:
        raise RuntimeError("the skewed keyed batch overflowed no partition")
    log(f"[k3] K3 launches on the main path: {launches} = {k3.LAUNCHES_PER_CALL} x "
        f"{len(cases)} dispatches")

    ids, pay, P, C = cases["moe"]
    kept = int((outs["moe"][2] >= 0).sum())
    ms = graph_time_ms(lambda: k3.dispatch_fwd(ids, pay, P, C), iters=20)
    plain_ms = graph_time_ms(lambda: dispatch_ref(ids, pay, P, C), iters=20)
    bound_ms = dispatch_bound(ids.numel(), P, C, pay.shape[1], pay.element_size(), kept)
    log(f"[k3] MoE dispatch T={ids.numel()} P={P} C={C} W={pay.shape[1]} bf16 ({kept} rows "
        f"kept), device time "
        f"(graph replay): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"(bytes), share of bound {bound_ms / ms:.4f}")
    return {
        "name": "dispatch", "route": "cuda",
        "source": os.path.relpath(k3.SOURCE, ROOT), "replaces": K3_REPLACES,
        "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }


# ---------------------------------------------------------------- phase 8
K5_PARENT = os.path.join(ROOT, "build", "parent", "src", "repro_torch", "kernels", "ssd", "csrc",
                         "ssd.cu")


def ssd_bound(B, L, H, P, N, chunk, x_itemsize, units="tensor") -> tuple[float, str]:
    """Least time of the scan, in ms, on the units a kernel uses: x, dt, A,
    B, C read and y, hT written once, against the f32 multiply-adds the
    function needs: C B^T once per (b, chunk), since B and C are shared by
    the heads, and only its causal lower triangle, cl (cl + 1) / 2 pairs of
    N; per (b, h, chunk) the masked product with dt x over the same pairs (P
    each), the state update (cl P N), and C state^T (cl P N) in every chunk
    but the first, where the state is zero.  ``units="cuda"``: those
    operations in f32 on the CUDA cores (67 TF/s); ``"tensor"``: three TF32
    products on the tensor cores (495 TF/s) for each, as the 3-term split
    needs.  A kernel that recomputes C B^T per head, or computes the zeroed
    upper triangle, does more than this."""
    chunks, pairs = L // chunk, chunk * (chunk + 1) // 2
    macs = B * chunks * pairs * N + B * H * (
        chunks * (pairs * P + chunk * P * N) + (chunks - 1) * chunk * P * N)
    ops = 2 * macs
    nbytes = (B * L * H * P * x_itemsize * 2 + B * L * H * 4 + H * 4 + 2 * B * L * N * 4
              + B * H * P * N * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] if units == "cuda" else 3 * ops / TF32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_k5() -> dict:
    from repro_torch.kernels import parity
    from repro_torch.kernels.ssd import ssd as k5
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_scan_ref
    from repro_torch.launch import bench_ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)

    for label, err in parity.check_ssd(k5.ssd_fwd):
        log(f"[k5] {label}: max|err| {err:.3g} (tol {parity.SSD_TOL} + rtol x |ref|) ok")

    # the main path, through the public wrapper, at mamba2-780m's widths
    B, L, H, P, N, chunk = bench_ssd.MAIN
    x, dt, A, Bm, Cm = bench_ssd.inputs(B, L, H, P, N, gen)
    torch.cuda.synchronize()
    ssd.LAUNCHES = 0
    got = ssd(x, dt, A, Bm, Cm, chunk=chunk)
    launches = ssd.LAUNCHES
    torch.cuda.synchronize()
    if launches != k5.LAUNCHES_PER_CALL:
        raise RuntimeError(f"K5 launched {launches} times for one scan, not "
                           f"{k5.LAUNCHES_PER_CALL}")
    if not all(bool(t.isfinite().all()) for t in got):
        raise RuntimeError("K5 output is not finite at mamba2-780m")
    plain = ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    ok, max_err = parity.ssd_close(got, plain, parity.SSD_TOL)
    log(f"[k5] mamba2-780m B,L,H,P,N,chunk={bench_ssd.MAIN} f32 (main path): max|err| "
        f"{max_err:.3g} (tol {parity.SSD_TOL} + {parity.SSD_TOL} x |ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("K5 disagrees with ssd_chunked at mamba2-780m")
    exact = ssd_chunked(*(t.double() for t in (x, dt, A, Bm, Cm)), chunk)
    log(f"[k5] vs the f64 computation: y kernel {float((got[0] - exact[0]).abs().max()):.3g}, "
        f"plain {float((plain[0] - exact[0]).abs().max()):.3g}; hT kernel "
        f"{float((got[1] - exact[1]).abs().max()):.3g}, plain "
        f"{float((plain[1] - exact[1]).abs().max()):.3g}; max|y| {float(exact[0].abs().max()):.4g}")
    del exact
    kernel = lambda: k5.ssd_fwd(x, dt, A, Bm, Cm, chunk)  # noqa: E731
    plain_fn = lambda: ssd_scan_ref(x, dt, A, Bm, Cm, chunk)  # noqa: E731
    ms, plain_ms = graph_time_ms(kernel, iters=20), graph_time_ms(plain_fn, iters=10)
    call_ms = time_ms(kernel, iters=20, warmup=2)
    plain_call_ms = time_ms(plain_fn, iters=10, warmup=2)
    bound_ms, bound_by = ssd_bound(B, L, H, P, N, chunk, 4, units="tensor")
    cuda_ms, cuda_by = ssd_bound(B, L, H, P, N, chunk, 4, units="cuda")
    log(f"[k5] K5 launches on the main path: {launches} ({k5.LAUNCHES_PER_CALL} a scan); device "
        f"time at mamba2-780m (graph replay): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms; eager "
        f"call: kernel {call_ms:.5f} ms, plain {plain_call_ms:.5f} ms; bound on the units it "
        f"uses (split TF32, tensor cores) {bound_ms:.5f} ms ({bound_by}), share of bound "
        f"{bound_ms / ms:.4f}; the f32 CUDA-core bound {cuda_ms:.5f} ms ({cuda_by})")
    if os.path.exists(K5_PARENT):
        log(f"[k5] against the parent's one-launch K5 ({os.path.relpath(K5_PARENT, ROOT)}):")
        for line in bench_ssd.report(bench_ssd.compare(["package", K5_PARENT])):
            log(f"[k5] {line}")
    else:
        log(f"[k5] the parent's one-launch K5 is not unpacked at "
            f"{os.path.relpath(K5_PARENT, ROOT)}: not timed beside the new one")
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": os.path.relpath(k5.SOURCE, ROOT), "replaces": K5_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def main() -> None:
    name = phase_device()
    phase_build()
    flash_entry = phase_kernels()
    flash_entry["launches"] = phase_serving()
    affine_entry = phase_k1()
    affine_entry["launches"] = phase_stream()
    entries = [flash_entry, affine_entry, phase_k2(), phase_k3(), phase_k5()]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
