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
   128, 129, 200, 512}, B=2 at S=65, GQA (H=16, Hkv=4) at Dh=128 and
   Dh=64, and the dense configs' heads at S=200 (32/2 and 48/4 at Dh=128,
   GQA groups of 16 and 12; 32/32 at Dh=64), bf16 and f32, causal and
   not.  Then, at every served prompt
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
7. K3 (``kernels/dispatch/csrc/dispatch.cu``, the hybrid-queue dispatch in
   one launch a call): held to ``dispatch_ref`` bit for
   bit on ``parity.DISPATCH_SWEEP`` (eight shapes, qwen2-moe's decode and
   prefill among them) with Zipf-skewed ids, -1s and ids past P, each with
   one and four tuples a payload row (``group``), then through
   ``ops.dispatch`` on ``kernel_bench``'s shape (T=256, P=16, C=32, W=128
   f32), a Zipf(1.1)-skewed keyed batch (T=16384, P=64, C=512, W=32 f32,
   with -1s; hot partitions overflow and drop) and MoE routing at
   phi3.5-moe's widths (4,096 tokens top-2 of 16 experts, C=640, W=4,096
   bf16, the token rows with group 2, as ``ffn.moe`` calls it); K3 launched
   once a call.  Then ``launch/bench_dispatch.py``: the served decode and
   prefill shapes, phi3.5's and the keyed batch; where the parent commit is
   unpacked under ``build/parent/`` (``git archive``), its K3 beside the new
   one in turns (A B ... B A); and the gather-then-dispatch route against
   K3 reading the token rows itself.
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

Phases 9-12 serve the other families through the port's entry points
(random bf16 weights from a seeded generator; every count set to 0 just
before a path is driven and read just after):

9. MoE: qwen2-moe-a2.7b at full width (the published config, no cuts: 24
   layers, d_model 2048, 60 experts top-4 + 4 shared, vocab 151,936, 14.3 B
   params) through the engine as in phase 3.  K3 must be launched (prefills
   + decode steps) x 24 times (one launch a call) and K4 prefills x 24.
   The dispatch of layer 0 in the 512-token prefill and in the first decode
   step (four slots), as the served run makes them, is held to
   ``dispatch_ref`` bit for bit (buffers, counts, dest) and timed at both
   shapes, beside the parent's K3 where it is unpacked; then an f32 cut of
   the model (full widths, 4 layers, the bf16 copy freed first) is served
   against ``generate``, token for token.
10. phi3.5-moe-42b-a6.6b at its published widths with 4 of its 32 layers
    (78 GiB of parameters do not fit beside a cache): one ``generate``,
    K3 launched (1 + steps) x 4 times, K4 4 times.
11. SSM: mamba2-780m at full width (48 layers, d_model 1536, 48 heads of
    64, state 128, chunk 256) through the engine.  K5 must be launched
    prefills x 48 x 3 times and K4 never.  The scan of layer 0 in the
    512-token prefill is held to ``ssd_chunked`` within 2e-4 and timed
    there; then the model in f32 is served against ``generate``.
12. glm4-9b, chatglm3-6b, starcoder2-15b and musicgen-large at their
    widths with 4 layers: one ``generate`` each, K4 launched 4 times each.

Phases 13-14 serve the last two architectures, whose kernels phases 2, 7
and 8 first hold to their plain versions at these shapes
(``parity.FLASH_SWEEP``, ``DISPATCH_SWEEP`` and ``SSD_SWEEP`` hold them):

13. Hybrid: jamba-1.5-large-398b at its published widths (d_model 8192,
    64 / 8 heads of 128, 16 experts top-2, 256 SSM heads of 64, state 128,
    chunk 256, vocab 65,536) with one period of 8 layers (seven mamba, one
    attention, MoE on the four odd slots) and one cut: d_ff = moe_d_ff
    8,192 (published 24,576; 33.1 GiB where a published period takes
    84.1 GiB), through the engine as in phase 3.  K3 must be launched
    (prefills + decode steps) x 4 times, K4 prefills x 1 and K5 prefills x
    7 x 3.  The first MoE layer's dispatch in the 512-token prefill and in
    the first four-slot decode step, as the served run makes them, is held
    to ``dispatch_ref`` bit for bit and timed; the first mamba layer's scan
    and the attention layer of a 512-token prefill to ``ssd_chunked``
    within 2e-4 and to ``attention_ref`` within 2e-2, each timed by graph
    replay beside its bound; then an f32 cut (d_ff = moe_d_ff 4,096, one
    period, 40.6 GiB), built after the bf16 copy is freed, is served
    against ``generate``, token for token.
14. Cross-attention: llama-3.2-vision-90b at its published widths with 4 of
    its 20 periods (16 self-attention and 4 cross-attention layers, 35.8
    GiB): one ``generate`` (B = 2, 200-token prompts, 16 steps) with seeded
    encoder states (2, 576, 8192); K4 launched exactly 16 times (the cross
    layers stay on the plain path).  Decode at position S-1 after a prefill
    of S-1 tokens within 3e-2 x max(|logits|, 1) of ``forward_train``'s
    logits there; prefill logits that move when the encoder states do; and
    the prefill cache made int8 by the JAX package's test rule (this
    script's ``quantize_cache``), one ``kv_quant`` decode step within 0.08 x
    max|logits| of ``forward_train``'s, with k/v still int8 and ek/ev bf16.

Phase 15 drives the stream side: the paper's workloads and the serving
tier, in subprocesses (this process holds a CUDA context, and the runtime
forks its workers), each number printed beside the card's name and power
limit.

15. Stream workloads.  (a) ``python3 chip_smoke.py --stream-workloads``:
    each TPCx-BB query of ``streams/tpcxbb.QUERIES`` on the port's process
    runtime (``num_workers="auto"``, ``batch_size=32``) and the three DAG
    forms of ``DAG_QUERIES`` through ``GraphPipeline``, at 200,000 tuples,
    Q2 cut to 6,000 (its viewed-together state grows with the square of a
    session's views; the cut is printed).  Egress must equal, tuple for
    tuple and in serial order, :func:`sequential_oracle` (a loop that
    applies each spec in turn, apart from the runtime); tuples/s and p99
    are printed for each.  Then a ``SessionMux`` open loop on the process
    backend: eight sessions, Poisson arrivals at half the probed capacity,
    p50/p99/p999 printed, after eight interleaved sessions each got exactly
    their own outputs in order.  (b) ``python -m
    repro_torch.launch.bench_core --smoke``: every row printed; the
    ``device_offload`` row must have run on ``cuda`` with K1 launched once
    per dispatch and egress in order.  The phase prints its wall time.

Phase 16 drives the port's trainer (``repro_torch.train``) on the card,
through ``make_train_step`` with the optimizer settings of
``launch/train.py`` (``opt_config``), on ``OrderedTokenPipeline(seed 0)``:

16. Training.  (a) olmo-1b at its published widths and depth (16 layers,
    1.28 B params, ``remat="full"``, bf16 params, f32 master and moments),
    B 8 x S 1,024, 12 steps: every loss finite, the last below the first,
    K4 launched 2 x 16 times a step (each attention layer's forward and its
    recompute); prints each step's loss, lr and grad norm, the median step
    time over steps 2-12, tokens/s, the model-FLOPs share of the step
    (:func:`train_model_flops` over the step time at the bf16 peak) and
    ``max_memory_allocated``; then one more step under ``torch.profiler``
    (device time by group, busy share), the AdamW update alone, and layer
    0's attention of step 1, as the step called K4, held through K4 to
    ``attention_ref`` within 2e-2 and timed beside its bound.  (b) K4 held
    to its plain version on the training path: olmo-1b with 2 of 16
    layers, one step from the same parameters and batch with
    ``FlashAttention.forward_fn`` the kernel, then ``attention_ref``, then
    a planted wrong forward (K4 with its causal mask dropped): the
    kernel's loss within 1e-5 and grad norm within 1e-3 relative of the
    plain version's, the planted forward's outside both.  (c)
    qwen2-moe-a2.7b at its widths with 2 of 24 layers (14.3 B params do
    not fit with their optimizer state), B 4, 4 steps: K3 launched 2 x 2
    times a step, finite losses and aux; layer 0's dispatch of step 1 (T =
    16,384 tuples, 60 experts, W 2,048, group 4), as the step called K3,
    held to ``dispatch_ref`` bit for bit on every route and timed.  (d) Checkpoint
    and resume on the card: the 2-layer olmo-1b cut trains 4 steps straight
    and is saved after step 2 (under ``build/``, removed after); restored
    into new tensors on the card, every leaf equal to the saved one bit for
    bit, the pipeline seeked to the saved cursor, steps 3-4 run again
    within 1e-3 relative of the straight run's losses (bit-equality is
    printed); the bytes written and the save and restore times.  The phase
    prints its wall time.

The kernels line gives K3 and K5 at the served layer's shape of phases 9
and 11 and K4 at phase 2's, and each kernel's launches summed over every
path that runs it (phases 13-16 included); K3, K4 and K5 at jamba's served
shapes and K3 and K4 at the training shapes of phase 16 are printed on
lines of their own.

Output: human-readable lines, then a ``{"kernels": [...]}`` JSON line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch.timing import graph_time_ms, time_ms  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

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


def _parent(path: str, source: Path) -> str | None:
    """``path``, the parent commit's copy of the kernel source ``source``
    unpacked under ``build/parent/``, where it exists and differs from the
    package's (an unchanged source is not timed against itself)."""
    if os.path.exists(path) and Path(path).read_bytes() != source.read_bytes():
        return path
    return None


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
    # the parent commit's sources where unpacked; one build per target (an
    # unchanged source hashes to the package's)
    parents = [Path(p) for p in (K1_PARENT, K2_PARENT, K3_PARENT, K5_PARENT) if os.path.exists(p)]
    targets = {_build._target(s) for s in sources}
    sources += [p for p in parents if _build._target(p) not in targets]
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


def _requests(cfg):
    """The eight served requests: SERVED_PROMPT_LENS prompts, 16-64 new
    tokens, drawn with numpy from seed 0."""
    rng = np.random.RandomState(0)
    new_tokens = rng.randint(16, 65, size=len(SERVED_PROMPT_LENS))
    return [
        (rng.randint(0, cfg.vocab_size, size=S).astype(np.int32), int(n))
        for S, n in zip(SERVED_PROMPT_LENS, new_tokens)
    ]


def _made(tag, cfg, t0, cut="") -> None:
    from repro_torch.models.common import count_params

    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers{cut}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {count_params(cfg) / 1e9:.3f} B params ({str(cfg.param_dtype)[6:]}) "
        f"made in {time.perf_counter() - t0:.1f}s")


def _serve_both(tag, cfg, params, requests, counters) -> tuple[dict, dict, int, int]:
    """A one-request warm-up (cuBLAS, caches), then every count in
    ``counters`` (wrappers with a ``LAUNCHES`` count) set to 0 and the
    requests served under both schedules.  Returns (runs, launches in the
    two runs, prefills, decode steps)."""
    _serve(cfg, params, requests[:1], "interleave")
    for fn in counters.values():
        fn.LAUNCHES = 0
    runs = {schedule: _serve(cfg, params, requests, schedule)
            for schedule in ("interleave", "prefill_first")}
    launches = {name: fn.LAUNCHES for name, fn in counters.items()}
    prefills = steps = 0
    for schedule, (eng, comps, wall) in runs.items():
        ntok = sum(len(c.tokens) for c in comps)
        prefills += eng.stats["prefills"]
        steps += eng.stats["decode_steps"]
        log(f"[{tag}] {schedule}: {len(comps)} requests, {ntok} tokens in {wall:.3f}s "
            f"({ntok / wall:.1f} tok/s); prefills {eng.stats['prefills']}, decode steps "
            f"{eng.stats['decode_steps']}; egress in serial order")
        for c in comps:
            log(f"[{tag}]   #{c.serial} ({len(c.tokens)} tokens, {c.latency_s:.3f}s): "
                f"{c.tokens.tolist()}")
    same = all(
        np.array_equal(a.tokens, b.tokens)
        for a, b in zip(runs["interleave"][1], runs["prefill_first"][1])
    )
    log(f"[{tag}] the two schedules gave the same tokens: {same}")
    return runs, launches, prefills, steps


def _f32_check(tag, cfg32, params32, request) -> None:
    """One request through the engine in f32, where rounding cannot flip a
    greedy choice, token for token against ``generate``."""
    from repro_torch.models import transformer

    prompt, n_new = request
    _, comps, _ = _serve(cfg32, params32, [(prompt, n_new)], "interleave")
    ref = transformer.generate(cfg32, params32, torch.from_numpy(prompt)[None].long().cuda(),
                               n_new - 1)[0].cpu().numpy()
    if not np.array_equal(comps[0].tokens, ref):
        raise RuntimeError(f"{tag}: f32 engine tokens {comps[0].tokens.tolist()} != generate "
                           f"{ref.tolist()}")
    log(f"[{tag}] f32 check ({cfg32.num_layers} layers): engine tokens equal generate for a "
        f"{len(prompt)}-token prompt ({n_new} tokens)")


def _expect(tag, what, got, want, how) -> None:
    if got != want:
        raise RuntimeError(f"{tag}: {what} launched {got} times, expected {want} = {how}")
    log(f"[{tag}] {what} launches on the main path: {got} = {how}")


def phase_serving() -> int:
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.models.common import init_params

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _made("serve", cfg, t0)
    requests = _requests(cfg)
    runs, launches, prefills, _ = _serve_both("serve", cfg, params, requests,
                                              {"K4": flash_attention})
    _expect("serve", "K4", launches["K4"], prefills * cfg.num_layers,
            f"{prefills} prefills x {cfg.num_layers} layers")

    # f32, where rounding cannot flip a greedy choice: engine vs generate
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    del runs
    params32 = tree_map(lambda t: t.float(), params)
    del params
    _f32_check("serve", cfg32, params32, requests[0])
    return launches["K4"]


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
    parent = _parent(K1_PARENT, k1.SOURCE)
    if parent is None:
        log(f"[k1] no parent K1 that differs from the package's is unpacked at "
            f"{os.path.relpath(K1_PARENT, ROOT)}: its route (copy in, K1, copy out) is not timed "
            "beside the new one")
    r = bench_affine.compare(Path(parent) if parent else None)
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
    if _parent(K2_PARENT, k2.SOURCE):
        log(f"[k2] against the parent's K2 ({os.path.relpath(K2_PARENT, ROOT)}):")
        for line in bench_reorder.report(bench_reorder.compare(["package", K2_PARENT])):
            log(f"[k2] {line}")
    else:
        log(f"[k2] no parent K2 that differs from the package's is unpacked at "
            f"{os.path.relpath(K2_PARENT, ROOT)}: not timed beside the new one")
    return {
        "name": "reorder_commit", "route": "cuda",
        "source": os.path.relpath(k2.SOURCE, ROOT), "replaces": K2_REPLACES,
        "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }


# ---------------------------------------------------------------- phase 7
K3_PARENT = os.path.join(ROOT, "build", "parent", "src", "repro_torch", "kernels", "dispatch",
                         "csrc", "dispatch.cu")


def phase_k3() -> dict:
    from repro_torch.kernels import parity
    from repro_torch.kernels.dispatch import dispatch as k3
    from repro_torch.kernels.dispatch.ops import dispatch
    from repro_torch.kernels.dispatch.ref import dispatch_ref
    from repro_torch.launch import bench_dispatch

    rng = np.random.RandomState(3)

    def same(got, want):
        return all(parity.bits_equal(a, b) for a, b in zip(got, want))

    checks = parity.check_dispatch(k3.dispatch_fwd)
    log(f"[k3] {checks} sweep cases (T,P,C,W in {parity.DISPATCH_SWEEP}, f32 and bf16, groups "
        f"{parity.DISPATCH_GROUPS}, Zipf ids with -1s and ids past P) equal dispatch_ref bit for "
        "bit (tolerance 0)")

    # the main path, through the public wrapper; the MoE batch as ffn.moe
    # hands it over: the token rows, k assignments a row
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens, experts, top_k, d_model = 4096, 16, 2, 4096  # phi3.5-moe
    moe_ids, hidden, cap = bench_dispatch.moe_inputs(tokens, experts, top_k, d_model,
                                                     torch.bfloat16, gen)
    cases = {
        "kernel_bench": ((torch.from_numpy(rng.randint(-1, 16, 256).astype(np.int32)).cuda(),
                          torch.randn(256, 128, generator=gen, device="cuda"), 16, 32), 1),
        "skewed keyed": ((torch.from_numpy(parity.zipf_ids(rng, 16384, 64)).cuda(),
                          torch.randn(16384, 32, generator=gen, device="cuda"), 64, 512), 1),
        "moe": ((moe_ids, hidden, experts, cap), top_k),
    }
    torch.cuda.synchronize()
    dispatch.LAUNCHES = 0
    outs = {name: dispatch(*args, group=group) for name, (args, group) in cases.items()}
    launches = dispatch.LAUNCHES
    torch.cuda.synchronize()
    if launches != len(cases):
        raise RuntimeError(f"K3 launched {launches} times for {len(cases)} dispatches, not one each")
    for name, (args, group) in cases.items():
        ids, pay, P, C = args
        if not same(outs[name], dispatch_ref(*args, group=group)):
            raise RuntimeError(f"K3 disagrees with dispatch_ref on the {name} batch")
        counts = outs[name][1]
        dropped = int((outs[name][2] < 0).sum()) - int((ids < 0).sum())
        log(f"[k3] {name}: T={ids.numel()} P={P} C={C} W={pay.shape[1]} {str(pay.dtype)[6:]} "
            f"group {group}: equal to dispatch_ref bit for bit; counts max {int(counts.max())} "
            f"min {int(counts.min())}, {dropped} tuples dropped past capacity")
    if int((outs["skewed keyed"][1] > 512).sum()) == 0:
        raise RuntimeError("the skewed keyed batch overflowed no partition")
    log(f"[k3] K3 launches through the wrapper: {launches} = {len(cases)} dispatches x 1 launch")
    del outs, cases, moe_ids, hidden

    parent = _parent(K3_PARENT, k3.SOURCE)
    if parent is None:
        log(f"[k3] no parent K3 that differs from the package's is unpacked at "
            f"{os.path.relpath(K3_PARENT, ROOT)}: not timed beside the new one")
    r = bench_dispatch.compare(parent)
    log(f"[k3] {bench_dispatch.card()}")
    for line in bench_dispatch.report(r):
        log(f"[k3] {line}")
    phi = r["shapes"]["phi3.5 synthetic"]
    return {
        "name": "dispatch", "route": "cuda",
        "source": os.path.relpath(k3.SOURCE, ROOT), "replaces": K3_REPLACES,
        "launches": launches, "max_abs_err": 0.0,
        "ms": phi["ms"]["route: K3 reads h (group k)"], "plain_ms": phi["plain_ms"],
        "bound_ms": phi["bound_ms"]["fused"], "bound_by": "bytes", "library_ms": None,
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


def _ssd_vs_f64(tag, got, plain, inputs, chunk) -> None:
    """Print how far the kernel's and the plain version's y and hT are from
    ``ssd_chunked`` computed in f64, absolute and as a share of 1 + |y|."""
    from repro_torch.kernels.ssd.ref import ssd_chunked

    exact = ssd_chunked(*(t.double() for t in inputs), chunk)
    scale = 1 + exact[0].abs()

    def err(side):
        d = (side[0].double() - exact[0]).abs()
        return (f"{float(d.max()):.3g} ({float((d / scale).max()):.3g} of 1+|y|), hT "
                f"{float((side[1].double() - exact[1]).abs().max()):.3g}")
    log(f"[{tag}] vs the f64 computation: y kernel {err(got)}; plain {err(plain)}; max|y| "
        f"{float(exact[0].abs().max()):.4g}")


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
    log(f"[k5] mamba2-780m B,L,H,P,N,chunk={bench_ssd.MAIN} f32 (one long scan): max|err| "
        f"{max_err:.3g} (tol {parity.SSD_TOL} + {parity.SSD_TOL} x |ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("K5 disagrees with ssd_chunked at mamba2-780m")
    _ssd_vs_f64("k5", got, plain, (x, dt, A, Bm, Cm), chunk)
    kernel = lambda: k5.ssd_fwd(x, dt, A, Bm, Cm, chunk)  # noqa: E731
    plain_fn = lambda: ssd_scan_ref(x, dt, A, Bm, Cm, chunk)  # noqa: E731
    ms, plain_ms = graph_time_ms(kernel, iters=20), graph_time_ms(plain_fn, iters=10)
    call_ms = time_ms(kernel, iters=20, warmup=2)
    plain_call_ms = time_ms(plain_fn, iters=10, warmup=2)
    bound_ms, bound_by = ssd_bound(B, L, H, P, N, chunk, 4, units="tensor")
    cuda_ms, cuda_by = ssd_bound(B, L, H, P, N, chunk, 4, units="cuda")
    log(f"[k5] K5 launches through the wrapper: {launches} ({k5.LAUNCHES_PER_CALL} a scan); device "
        f"time at mamba2-780m (graph replay): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms; eager "
        f"call: kernel {call_ms:.5f} ms, plain {plain_call_ms:.5f} ms; bound on the units it "
        f"uses (split TF32, tensor cores) {bound_ms:.5f} ms ({bound_by}), share of bound "
        f"{bound_ms / ms:.4f}; the f32 CUDA-core bound {cuda_ms:.5f} ms ({cuda_by})")
    if _parent(K5_PARENT, k5.SOURCE):
        log(f"[k5] against the parent's K5 ({os.path.relpath(K5_PARENT, ROOT)}):")
        for line in bench_ssd.report(bench_ssd.compare(["package", K5_PARENT])):
            log(f"[k5] {line}")
    else:
        log(f"[k5] no parent K5 that differs from the package's is unpacked at "
            f"{os.path.relpath(K5_PARENT, ROOT)}: not timed beside the new one")
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": os.path.relpath(k5.SOURCE, ROOT), "replaces": K5_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


# ---------------------------------------------------------------- phases 9-12
MOE_ARCH, PHI_ARCH, SSM_ARCH = "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "mamba2-780m"
DENSE_ARCHS = ("glm4-9b", "chatglm3-6b", "starcoder2-15b", "musicgen-large")
CUT_LAYERS = 4  # depth of the configs held at their widths with fewer layers
JAMBA_F32_D_FF = 4096  # jamba's f32 cut: one period, 40.6 GiB


@contextlib.contextmanager
def _first_call(module, name: str, when=lambda *args, **kwargs: True):
    """Inside the block, ``module.name`` records the (args, kwargs) of its
    first call for which ``when(*args, **kwargs)`` holds (into the yielded
    list) and calls through."""
    inner = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        if not seen and when(*args, **kwargs):
            seen.append((args, kwargs))
        return inner(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, inner)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _cut(cfg, **changes):
    return dataclasses.replace(cfg, num_layers=CUT_LAYERS, **changes)


def phase_moe() -> dict:
    """qwen2-moe-a2.7b at full width through the engine: K3 on every MoE
    layer of every prefill and decode step, K4 on every prefill's attention;
    one layer's dispatch at the prefill and at the decode shape held to
    ``dispatch_ref`` bit for bit and timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.dispatch import dispatch as k3
    from repro_torch.kernels.dispatch.ops import dispatch
    from repro_torch.launch import bench_dispatch
    from repro_torch.models import ffn
    from repro_torch.models.common import count_active_params, init_params

    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _made("moe", cfg, t0)
    log(f"[moe] {cfg.num_experts} experts top-{cfg.top_k} + {cfg.num_shared_experts} shared "
        f"(expert d_ff {cfg.moe_d_ff}), {count_active_params(cfg) / 1e9:.3f} B active params "
        "a token")
    requests = _requests(cfg)
    # layer 0's dispatch at each served shape, as the served run gives it:
    # the first call with the longest prompt's tokens (its prefill) and the
    # first with the four slots' (a decode step)
    prompt_len = max(len(p) for p, _ in requests)

    def tuples(n):
        return lambda ids, *args, **kwargs: ids.numel() == n * cfg.top_k

    with _first_call(ffn, "dispatch", tuples(prompt_len)) as seen, \
            _first_call(ffn, "dispatch", tuples(4)) as seen_decode:
        _, launches, prefills, steps = _serve_both(
            "moe", cfg, params, requests, {"K3": dispatch, "K4": flash_attention})
    L = cfg.num_layers
    _expect("moe", "K3", launches["K3"], (prefills + steps) * L,
            f"({prefills} prefills + {steps} decode steps) x {L} layers x 1 launch")
    _expect("moe", "K4", launches["K4"], prefills * L, f"{prefills} prefills x {L} layers")

    parent = _parent(K3_PARENT, k3.SOURCE)
    other = bench_dispatch.source_dispatch(Path(parent)) if parent else None
    served = {}
    for label, ((ids, h, P, C), kw) in ((f"layer 0 of the {prompt_len}-token prefill", seen[0]),
                                        ("layer 0 of a decode step, 4 slots", seen_decode[0])):
        served[label] = bench_dispatch.compare_case(ids, h, P, C, kw["group"], other)
    log(f"[moe] K3 at the served shapes equals dispatch_ref bit for bit (buffers, counts, dest) "
        f"on every route; {bench_dispatch.card()}:")
    for line in bench_dispatch.report({"other": K3_PARENT if other else None, "shapes": served}):
        log(f"[moe] {line}")
    pre = served[f"layer 0 of the {prompt_len}-token prefill"]
    ms, plain_ms = pre["ms"]["route: K3 reads h (group k)"], pre["plain_ms"]
    bound_ms = pre["bound_ms"]["fused"]
    log(f"[moe] the kernels line gives K3 at the prefill shape (T={pre['T']} P={pre['P']} "
        f"C={pre['C']} W={pre['W']}, {pre['T'] - pre['kept']} assignments dropped past capacity), "
        f"reading h: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms (bytes), "
        f"share of bound {bound_ms / ms:.4f}")
    del params, seen, seen_decode, ids, h
    _free()

    # f32 on a cut (full widths, fewer layers): qwen2-moe's f32 parameters
    # would not fit beside anything
    cfg32 = _cut(cfg, dtype=torch.float32, param_dtype=torch.float32)
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(1), "cuda")
    _f32_check("moe", cfg32, params32, requests[0])
    del params32
    _free()
    return {"launches": launches["K3"], "K4": launches["K4"], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


def _generate_cut(tag, arch, counters, prompt_len=200, steps=16) -> tuple[dict, object]:
    """One ``generate`` of ``arch`` at its widths with CUT_LAYERS layers
    (random bf16 weights, seed 0), counts set to 0 just before; returns
    (launches, cfg)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params

    full = get_config(arch)
    cfg = _cut(full)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _made(tag, cfg, t0, f" of {full.num_layers}")
    prompt = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, prompt_len))
    prompt = prompt[None].long().cuda()
    for fn in counters.values():
        fn.LAUNCHES = 0
    t0 = time.perf_counter()
    out = transformer.generate(cfg, params, prompt, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.LAUNCHES for name, fn in counters.items()}
    toks = out[0].cpu().numpy()
    if toks.shape != (steps + 1,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise RuntimeError(f"{tag}: {cfg.name} generated {toks.tolist()}")
    log(f"[{tag}] {cfg.name} ({cfg.num_heads} heads / {cfg.num_kv_heads} kv heads, head dim "
        f"{cfg.hd}): generate({prompt_len}-token prompt, {steps} steps) in {wall:.3f}s: "
        f"{toks.tolist()}")
    del params
    _free()
    return launches, cfg


def phase_phi() -> tuple[int, int]:
    """phi3.5-moe at its published widths, CUT_LAYERS of its 32 layers (its
    78 GiB of parameters do not fit beside a cache): one generate."""
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.dispatch.ops import dispatch

    steps = 16
    launches, cfg = _generate_cut("phi", PHI_ARCH, {"K3": dispatch, "K4": flash_attention},
                                  steps=steps)
    L = cfg.num_layers
    _expect("phi", "K3", launches["K3"], (1 + steps) * L,
            f"(1 prefill + {steps} decode steps) x {L} layers x 1 launch")
    _expect("phi", "K4", launches["K4"], L, f"1 prefill x {L} layers")
    return launches["K3"], launches["K4"]


def phase_ssm() -> dict:
    """mamba2-780m at full width through the engine: K5 on every mamba
    layer of every prefill; one layer's scan held to ``ssd_chunked`` within
    2e-4 and timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import parity
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd as k5
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.models import ssm, transformer
    from repro_torch.models.common import init_params

    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _made("ssm", cfg, t0)
    log(f"[ssm] d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    requests = _requests(cfg)
    _, launches, prefills, _ = _serve_both(
        "ssm", cfg, params, requests, {"K5": ssd_ops.ssd, "K4": flash_attention})
    L = cfg.num_layers
    _expect("ssm", "K5", launches["K5"], prefills * L * k5.LAUNCHES_PER_CALL,
            f"{prefills} prefills x {L} layers x {k5.LAUNCHES_PER_CALL}")
    _expect("ssm", "K4", launches["K4"], 0, "none (attention-free)")

    prompt = max((p for p, _ in requests), key=len)
    with _first_call(ssm, "ssd") as seen, torch.no_grad():
        transformer.prefill(cfg, params, torch.from_numpy(prompt)[None].long().cuda(),
                           max_len=1024)
    (x, dt, A, Bm, Cm), chunk = seen[0][0], cfg.ssm_chunk
    got = k5.ssd_fwd(x, dt, A, Bm, Cm, chunk)
    plain = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    ok, max_err = parity.ssd_close(got, plain, parity.SSD_TOL)
    log(f"[ssm] layer 0 of the {len(prompt)}-token prefill: K5 at B,L,H,P,N={tuple(x.shape)}"
        f"+({Bm.shape[-1]},) chunk {chunk} f32 against ssd_chunked: max|err| {max_err:.3g} "
        f"(tol {parity.SSD_TOL} + {parity.SSD_TOL} x |ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("K5 disagrees with ssd_chunked at mamba2-780m's layer 0")
    B, Lx, H, P = x.shape
    ms = graph_time_ms(lambda: k5.ssd_fwd(x, dt, A, Bm, Cm, chunk), iters=20)
    plain_ms = graph_time_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk), iters=10)
    bound_ms, bound_by = ssd_bound(B, Lx, H, P, Bm.shape[-1], chunk, 4, units="tensor")
    log(f"[ssm] device time (graph replay): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
        f"on the units it uses {bound_ms:.5f} ms ({bound_by}), share of bound "
        f"{bound_ms / ms:.4f}")
    del seen, x, dt, A, Bm, Cm, got, plain
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), params)
    del params
    _free()
    _f32_check("ssm", cfg32, params32, requests[0])
    del params32
    _free()
    return {"launches": launches["K5"], "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_dense() -> int:
    """The four other dense configs at their widths with CUT_LAYERS layers:
    one generate each, K4 on every layer of the prefill (GQA groups of 16
    and 12 among them, held to the plain version in phase 2)."""
    from repro_torch.kernels.attention.ops import flash_attention

    total = 0
    for arch in DENSE_ARCHS:
        launches, cfg = _generate_cut("dense", arch, {"K4": flash_attention})
        _expect("dense", f"K4 ({cfg.name})", launches["K4"], cfg.num_layers,
                f"1 prefill x {cfg.num_layers} layers")
        total += launches["K4"]
    return total


# ---------------------------------------------------------------- phases 13-14
JAMBA_ARCH, LLAMA_ARCH = "jamba-1.5-large-398b", "llama-3.2-vision-90b"
LLAMA_PERIODS = 4  # of llama-3.2-vision's 20 (163.3 GiB in bf16); 35.8 GiB
LLAMA_PROMPT, LLAMA_STEPS = 200, 16


def _k4_held(tag, where, q, k, v, causal, iters=100) -> dict:
    """K4 on the (q, k, v) of one call the model made, held to
    ``attention_ref`` at ``parity.FLASH_TOL`` and timed by graph replay
    beside the plain version and SDPA (on the kv heads repeated): the
    kernels line's keys."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention.ref import attention_ref

    q, k, v = (t.detach() for t in (q, k, v))
    got = flash.flash_fwd(q, k, v, causal)
    err = float((got.float() - attention_ref(q, k, v, causal).float()).abs().max())
    del got
    tol = parity.FLASH_TOL[q.dtype]
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    log(f"[{tag}] {where}: K4 at B,S,H,Hkv,Dh={(B, S, H, Hkv, Dh)} {str(q.dtype)[6:]} "
        f"{'causal' if causal else 'full'} against attention_ref: max|err| {err:.3g} (tol {tol}) "
        f"{'ok' if err <= tol else 'FAIL'}")
    if err > tol:
        raise RuntimeError(f"K4 disagrees with attention_ref at {tag}'s {where}")
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, plain_ms, lib_ms = (graph_time_ms(f, iters=iters) for f in (
        lambda: flash.flash_fwd(q, k, v, causal), lambda: attention_ref(q, k, v, causal),
        lambda: sdpa(qt, kt, vt, is_causal=causal)))
    bound_ms, by = attention_bound(B, S, H, Hkv, Dh, q.dtype, causal)
    log(f"[{tag}] K4 device time (graph replay): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"sdpa {lib_ms:.5f} ms (on the kv heads repeated), bound {bound_ms:.5f} ms ({by}), "
        f"share of bound {bound_ms / ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by}


def phase_jamba() -> dict:
    """jamba at its published widths but d_ff (one period of 8 layers;
    ``profile_serve.SERVED_CUTS``) through the engine: K3 on its four MoE
    layers in every prefill and decode step, K4 on its attention layer and
    K5 on its seven mamba layers in every prefill; the first MoE layer's
    dispatch at the prefill and decode shapes, the first scan and the
    attention of a 512-token prefill held to their plain versions and timed;
    then an f32 cut served against ``generate``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import parity
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.dispatch.ops import dispatch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd as k5
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.launch import bench_dispatch, bench_ssd
    from repro_torch.launch.profile_serve import SERVED_CUTS
    from repro_torch.models import attention, ffn, ssm, transformer
    from repro_torch.models.common import count_active_params, init_params

    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, **SERVED_CUTS[JAMBA_ARCH])
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _made("jamba", cfg, t0, f" of {full.num_layers}, d_ff = moe_d_ff {cfg.d_ff} of {full.d_ff}")
    kinds = [f"{m}+{f}" for m, f in cfg.pattern]
    log(f"[jamba] period {kinds}; {cfg.num_heads} heads / {cfg.num_kv_heads} kv heads of "
        f"{cfg.hd}; {cfg.num_experts} experts top-{cfg.top_k}; {cfg.ssm_heads} SSM heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}; "
        f"{count_active_params(cfg) / 1e9:.3f} B active params a token")
    requests = _requests(cfg)
    prompt_len = max(len(p) for p, _ in requests)

    def tuples(n):
        return lambda ids, *args, **kwargs: ids.numel() == n * cfg.top_k

    counters = {"K3": dispatch, "K4": flash_attention, "K5": ssd_ops.ssd}
    with _first_call(ffn, "dispatch", tuples(prompt_len)) as seen, \
            _first_call(ffn, "dispatch", tuples(4)) as seen_decode:
        _, launches, prefills, steps = _serve_both("jamba", cfg, params, requests, counters)
    n_moe = sum(f == "moe" for _, f in cfg.pattern)
    n_attn = sum(m == "attn" for m, _ in cfg.pattern)
    n_mamba = sum(m == "mamba" for m, _ in cfg.pattern)
    _expect("jamba", "K3", launches["K3"], (prefills + steps) * n_moe,
            f"({prefills} prefills + {steps} decode steps) x {n_moe} MoE layers x 1 launch")
    _expect("jamba", "K4", launches["K4"], prefills * n_attn,
            f"{prefills} prefills x {n_attn} attention layer")
    _expect("jamba", "K5", launches["K5"], prefills * n_mamba * k5.LAUNCHES_PER_CALL,
            f"{prefills} prefills x {n_mamba} mamba layers x {k5.LAUNCHES_PER_CALL}")

    served = {}
    for label, ((ids, h, P, C), kw) in ((f"layer 1 of the {prompt_len}-token prefill", seen[0]),
                                        ("layer 1 of a decode step, 4 slots", seen_decode[0])):
        served[label] = bench_dispatch.compare_case(ids, h, P, C, kw["group"])
    log(f"[jamba] K3 at the served shapes equals dispatch_ref bit for bit (buffers, counts, dest) "
        f"on every route; {bench_dispatch.card()}:")
    for line in bench_dispatch.report({"other": None, "shapes": served}):
        log(f"[jamba] {line}")
    pre = served[f"layer 1 of the {prompt_len}-token prefill"]
    k3_row = {"ms": pre["ms"]["route: K3 reads h (group k)"], "plain_ms": pre["plain_ms"],
              "bound_ms": pre["bound_ms"]["fused"]}
    del seen, seen_decode, ids, h

    # the first mamba layer's scan and the attention layer of the longest
    # prompt's prefill, as the model calls them
    prompt = torch.from_numpy(max((p for p, _ in requests), key=len))[None].long().cuda()
    with _first_call(ssm, "ssd") as scans, _first_call(attention, "flash_attention") as attns, \
            torch.no_grad():
        transformer.prefill(cfg, params, prompt, max_len=1024)
    (x, dt, A, Bm, Cm), chunk = scans[0][0], cfg.ssm_chunk
    got, plain = k5.ssd_fwd(x, dt, A, Bm, Cm, chunk), ssd_chunked(x, dt, A, Bm, Cm, chunk)
    ok, ssd_err = parity.ssd_close(got, plain, parity.SSD_TOL)
    log(f"[jamba] layer 0 of the {prompt.shape[1]}-token prefill: K5 at B,L,H,P,N="
        f"{tuple(x.shape)}+({Bm.shape[-1]},) chunk {chunk} f32 against ssd_chunked: max|err| "
        f"{ssd_err:.3g} (tol {parity.SSD_TOL} + {parity.SSD_TOL} x |ref|) {'ok' if ok else 'FAIL'}")
    _ssd_vs_f64("jamba", got, plain, (x, dt, A, Bm, Cm), chunk)
    del got, plain
    if not ok:
        raise RuntimeError("K5 disagrees with ssd_chunked at jamba's layer 0")
    B, L, H, P = x.shape
    ssd_ms = graph_time_ms(lambda: k5.ssd_fwd(x, dt, A, Bm, Cm, chunk), iters=20)
    ssd_plain_ms = graph_time_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk), iters=10)
    ssd_bound_ms, ssd_by = ssd_bound(B, L, H, P, Bm.shape[-1], chunk, 4, units="tensor")
    log(f"[jamba] K5 device time (graph replay): kernel {ssd_ms:.5f} ms, plain {ssd_plain_ms:.5f} "
        f"ms, bound on the units it uses {ssd_bound_ms:.5f} ms ({ssd_by}), share of bound "
        f"{ssd_bound_ms / ssd_ms:.4f}")
    k5_row = {"max_abs_err": ssd_err, "ms": ssd_ms, "plain_ms": ssd_plain_ms,
              "bound_ms": ssd_bound_ms, "bound_by": ssd_by}
    if _parent(K5_PARENT, k5.SOURCE):
        log(f"[jamba] against the parent's K5 ({os.path.relpath(K5_PARENT, ROOT)}), at this shape "
            "on the reference test's draw:")
        for line in bench_ssd.report(bench_ssd.compare(["package", K5_PARENT],
                                                       shape=(B, L, H, P, Bm.shape[-1], chunk))):
            log(f"[jamba] {line}")

    (q, k, v), kw = attns[0]
    k4_row = _k4_held("jamba", f"layer 4 of the {q.shape[1]}-token prefill", q, k, v,
                      kw.get("causal", True))
    del params, scans, attns, x, dt, A, Bm, Cm, q, k, v
    _free()

    # f32 on a narrower cut, after the bf16 copy is freed
    cfg32 = dataclasses.replace(cfg, d_ff=JAMBA_F32_D_FF, moe_d_ff=JAMBA_F32_D_FF,
                                dtype=torch.float32, param_dtype=torch.float32)
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(1), "cuda")
    _f32_check("jamba", cfg32, params32, requests[0])
    del params32
    _free()
    return {"launches": launches, "K3": k3_row, "K4": k4_row, "K5": k5_row}


def quantize_cache(cache: dict) -> dict:
    """A cache made int8 by the JAX package's test rule
    (``tests/test_serving_optimizations.py:26-43``): k and v scaled per
    (b, head, position) by absmax / 127 + 1e-9, rounded and clipped to
    [-127, 127], with the scales beside them as ``k_scale``/``v_scale``;
    every other leaf as it is."""
    out = {}
    for si, slot in cache.items():
        out[si] = {}
        for name, t in slot.items():
            if name in ("k", "v"):
                a = t.float()
                scale = a.abs().amax(-1) / 127.0 + 1e-9
                out[si][name] = torch.round(a / scale[..., None]).clamp(-127, 127).to(torch.int8)
                out[si][f"{name}_scale"] = scale
            else:
                out[si][name] = t
    return out


def phase_llama() -> int:
    """llama-3.2-vision at its published widths with LLAMA_PERIODS of its 20
    periods: one ``generate`` with seeded encoder states (K4 on every
    self-attention layer of the prefill, none on the cross-attention
    layers); decode against ``forward_train``; logits that move with the
    encoder states; one int8-cache decode step (``kv_quant``) against
    ``forward_train``.  Returns K4's launches in the ``generate``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params

    full = get_config(LLAMA_ARCH)
    cfg = dataclasses.replace(full, num_layers=LLAMA_PERIODS * len(full.pattern))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _made("llama", cfg, t0, f" of {full.num_layers}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    B, S, Se = 2, LLAMA_PROMPT, cfg.num_encoder_tokens
    enc = torch.randn(B, Se, cfg.d_model, generator=gen, device="cuda").to(cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    n_self = sum(m == "attn" for m, _ in cfg.pattern) * cfg.num_periods
    n_cross = sum(m == "xattn" for m, _ in cfg.pattern) * cfg.num_periods

    with torch.no_grad():
        flash_attention.LAUNCHES = 0
        t0 = time.perf_counter()
        out = transformer.generate(cfg, params, toks, LLAMA_STEPS, enc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.LAUNCHES
        got = out.cpu().numpy()
        if got.shape != (B, LLAMA_STEPS + 1) or got.min() < 0 or got.max() >= cfg.vocab_size:
            raise RuntimeError(f"llama: generate gave {got.tolist()}")
        log(f"[llama] generate(B={B}, {S}-token prompts, {Se} encoder states of {cfg.d_model}, "
            f"{LLAMA_STEPS} steps) in {wall:.3f}s: {got.tolist()}")
        _expect("llama", "K4", launches, n_self,
                f"1 prefill x {n_self} self-attention layers; the {n_cross} cross-attention "
                "layers none")

        full_logits, _ = transformer.forward_train(cfg, params, toks, enc)
        ref = full_logits[:, S - 1, : cfg.vocab_size]
        scale = float(ref.abs().max())
        pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
        _, cache = transformer.prefill(cfg, params, toks[:, : S - 1], enc, max_len=S + 4)
        lg_d, _ = transformer.decode_step(cfg, params, toks[:, S - 1], cache, pos)
        err = float((lg_d[:, : cfg.vocab_size] - ref).abs().max())
        tol = 3e-2 * max(scale, 1.0)
        log(f"[llama] decode at position {S - 1} against forward_train: max|diff| {err:.4g}, "
            f"tolerance 3e-2 x max(|logits|, 1) = {tol:.4g} {'ok' if err <= tol else 'FAIL'}")
        if not (err <= tol and bool(lg_d.isfinite().all())):
            raise RuntimeError("llama: decode disagrees with forward_train")

        other = transformer.prefill(cfg, params, toks[:, : S - 1], enc * 0.5, max_len=S + 4)[0]
        moved = float((other - transformer.prefill(cfg, params, toks[:, : S - 1], enc,
                                                   max_len=S + 4)[0]).abs().max())
        log(f"[llama] halving the encoder states moves the prefill logits by up to {moved:.4g}")
        if not moved > 0:
            raise RuntimeError("llama: the logits do not depend on the encoder states")
        del other

        cfg_q = dataclasses.replace(cfg, kv_quant=True)
        qcache = quantize_cache(cache)
        del cache
        lg_q, qcache = transformer.decode_step(cfg_q, params, toks[:, S - 1], qcache, pos)
        err_q = float((lg_q[:, : cfg.vocab_size] - ref).abs().max())
        kv = {t.dtype for slot in qcache.values() for n, t in slot.items() if n in ("k", "v")}
        ekv = {t.dtype for slot in qcache.values() for n, t in slot.items() if n in ("ek", "ev")}
        kept = kv == {torch.int8} and ekv == {cfg.dtype}
        log(f"[llama] kv_quant decode at position {S - 1} against forward_train: max|diff| "
            f"{err_q:.4g}, tolerance 0.08 x max|logits| = {0.08 * scale:.4g}; after it k/v are "
            f"{sorted(map(str, kv))}, ek/ev {sorted(map(str, ekv))}")
        if not (err_q < 0.08 * scale and kept):
            raise RuntimeError("llama: the int8 KV decode disagrees or its cache left int8")
    del params, full_logits, qcache, enc
    _free()
    return launches


# ---------------------------------------------------------------- phase 15
TPCXBB_TUPLES = 200_000
# Q2's viewed-together state grows with the square of a session's views
# (6,000 tuples: the reference test's size)
TPCXBB_CUTS = {"q2": 6_000}
TPCXBB_BATCH = 32
# tuples per exchange unit: at the default (the batch, 32) the process
# runtime can stall for good on Q1 when its host's cores are oversubscribed
# (ROADMAP Queue 3, R8; the JAX package's runtime alike)
TPCXBB_IO_BATCH = 8
MUX_SECONDS = 2.0  # of offered load at half the probed capacity
MUX_CHECK_VALUES = 64  # per session, in the interleaved ordering check
STREAM_WORKLOADS_TIMEOUT_S = 420
BENCH_CORE_TIMEOUT_S = 420


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sequential_oracle(specs, source) -> list:
    """The chain's egress computed apart from the runtime: a loop that
    applies each spec in turn to the whole stream (per-key state for a
    partitioned spec, one state for a stateful one)."""
    stream = list(source)
    for spec in specs:
        out = []
        if spec.kind == "stateless":
            for v in stream:
                out.extend(spec.fn(v))
        elif spec.kind == "stateful":
            state = spec.init_state()
            for v in stream:
                state, o = spec.fn(state, v)
                out.extend(o)
        else:
            states = {}
            for v in stream:
                k = spec.key_fn(v)
                state = states[k] if k in states else spec.init_state()
                states[k], o = spec.fn(state, k, v)
                out.extend(o)
        stream = out
    return stream


def _run_stream(graph, source):
    from repro_torch.core import Engine, EngineConfig, ProcessOptions

    eng = Engine(EngineConfig(collect_outputs=True, backend="process", num_workers="auto",
                              batch_size=TPCXBB_BATCH,
                              process=ProcessOptions(io_batch=TPCXBB_IO_BATCH)))
    t0 = time.perf_counter()
    res = eng.run(graph, source)
    return res, time.perf_counter() - t0


def _tpcxbb(card: str) -> list:
    """Every TPCx-BB query and DAG form on the process runtime, each held to
    :func:`sequential_oracle` over its linear form; one row per run."""
    from repro_torch.streams import tpcxbb

    runs = [(q, "linear") for q in tpcxbb.QUERIES] + [(q, "dag") for q in tpcxbb.DAG_QUERIES]
    rows, oracles = [], {}
    for q, form in runs:
        n = TPCXBB_CUTS.get(q, TPCXBB_TUPLES)
        if n != TPCXBB_TUPLES:
            log(f"[tpcxbb] cut: {q} runs {n} tuples, not {TPCXBB_TUPLES} (its viewed-together "
                "state grows with the square of a session's views)")
        specs, src = tpcxbb.QUERIES[q](n=n)
        source = list(src)
        if q not in oracles:  # a DAG form's egress is its linear form's
            oracles[q] = sequential_oracle(specs, source)
        want = oracles[q]
        if form == "linear":
            graph = tpcxbb.QUERIES[q](n=n)[0]
        else:
            nodes, edges, _ = tpcxbb.DAG_QUERIES[q](n=n)
            graph = (nodes, edges)
        res, wall = _run_stream(graph, source)
        if res.outputs != want:
            first = next((i for i, (a, b) in enumerate(zip(res.outputs, want)) if a != b),
                         min(len(res.outputs), len(want)))
            raise RuntimeError(f"tpcxbb {q} ({form}): egress differs from the sequential oracle "
                               f"({len(res.outputs)} vs {len(want)} tuples, first at {first})")
        rep = res.report
        row = {"query": q, "form": form, "tuples": n, "egress": len(want), "wall_s": wall,
               "throughput_per_s": rep.throughput, "p99_latency_ms": rep.p99_latency * 1e3,
               "card": card}
        log(f"[tpcxbb] {q} ({form}, {n} tuples, process, workers auto, batch {TPCXBB_BATCH}, "
            f"io_batch {TPCXBB_IO_BATCH}): "
            f"{rep.throughput:.1f} tuples/s, p99 {row['p99_latency_ms']:.3f} ms, wall "
            f"{wall:.3f} s; egress {len(want)} tuples in serial order = the sequential oracle "
            f"[{card}]")
        rows.append(row)
    return rows


def _mux_rows(card: str) -> dict:
    """The serving tier on the process backend: per-session ordering over
    interleaved sessions, then the open loop at half the probed capacity
    (``_run_serving``'s shape: the same chain, sessions and utilisation)."""
    import random

    from repro_torch.core import Engine, EngineConfig
    from repro_torch.launch.bench_core import SERVING_SESSIONS, SERVING_UTIL, SPIN, STAGES
    from repro_torch.serve import ArrivalConfig, MuxConfig, SessionMux, run_open_loop
    from repro_torch.streams.parametric import cpu_bound_chain

    def mux():
        eng = Engine(EngineConfig(backend="process", num_workers=2, batch_size=8))
        return SessionMux(eng, cpu_bound_chain(stages=STAGES, spin=SPIN),
                          config=MuxConfig(max_sessions=SERVING_SESSIONS))

    rng = random.Random(15)
    inputs = [[rng.randrange(10**6) for _ in range(MUX_CHECK_VALUES)]
              for _ in range(SERVING_SESSIONS)]
    with mux() as m:
        handles = [m.open() for _ in inputs]
        for lo in range(0, MUX_CHECK_VALUES, 8):
            for h, vals in zip(handles, inputs):
                h.push(vals[lo:lo + 8])
        for i, (h, vals) in enumerate(zip(handles, inputs)):
            want = sequential_oracle(cpu_bound_chain(stages=STAGES, spin=SPIN), vals)
            got = list(h.results(max_items=len(want), timeout=60))
            h.close()
            if got != want or h.poll():
                raise RuntimeError(f"mux: session {i} did not get exactly its own outputs in order")
    log(f"[mux] {SERVING_SESSIONS} interleaved sessions on the process backend: each got exactly "
        f"its own {MUX_CHECK_VALUES} outputs, in order")
    with mux() as m:
        probe = run_open_loop(m, sessions=SERVING_SESSIONS, requests=2000, warmup=400,
                              arrivals=ArrivalConfig(shape="poisson", rate=1e6, seed=3))
    capacity = max(probe.achieved_rate, 1.0)
    offered = capacity * SERVING_UTIL
    per_session = max(int(offered * MUX_SECONDS / SERVING_SESSIONS), 50)
    with mux() as m:
        rep = run_open_loop(m, sessions=SERVING_SESSIONS, requests=per_session,
                            arrivals=ArrivalConfig(shape="poisson",
                                                   rate=offered / SERVING_SESSIONS, seed=11))
    if rep.completed != SERVING_SESSIONS * per_session:
        raise RuntimeError(f"mux: {rep.completed} of {SERVING_SESSIONS * per_session} "
                           "requests completed")
    row = {"sessions": SERVING_SESSIONS, "requests": rep.requests, "capacity_per_s": capacity,
           "offered_rate_per_s": rep.offered_rate, "achieved_rate_per_s": rep.achieved_rate,
           "p50_latency_ms": rep.p50 * 1e3, "p99_latency_ms": rep.p99 * 1e3,
           "p999_latency_ms": rep.p999 * 1e3, "card": card}
    log(f"[mux] open loop, {SERVING_SESSIONS} sessions x {per_session} requests on the process "
        f"backend (2 workers, batch 8, {STAGES} x spin {SPIN}), Poisson at "
        f"{SERVING_UTIL:.0%} of the probed {capacity:.1f}/s: offered {rep.offered_rate:.1f}/s, "
        f"achieved {rep.achieved_rate:.1f}/s, p50 {row['p50_latency_ms']:.3f} ms, p99 "
        f"{row['p99_latency_ms']:.3f} ms, p999 {row['p999_latency_ms']:.3f} ms [{card}]")
    return row


def stream_workloads() -> None:
    """Phase 15 (a): run in a fresh process that never touches CUDA."""
    card = _card()
    result = {"tpcxbb": _tpcxbb(card), "mux": _mux_rows(card)}
    print(json.dumps({"stream_workloads": result}), flush=True)


def _subprocess(args: list, timeout: int, what: str) -> list:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{what} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return lines


def phase_stream_workloads() -> int:
    """Phase 15; returns K1's launches on its path (bench_core's
    device_offload row)."""
    t0 = time.perf_counter()
    lines = _subprocess([os.path.join(ROOT, "chip_smoke.py"), "--stream-workloads"],
                        STREAM_WORKLOADS_TIMEOUT_S, "the stream workloads")
    for line in lines[:-1]:
        log(line)
    r = json.loads(lines[-1])["stream_workloads"]
    if len(r["tpcxbb"]) != 8 or any(row["egress"] == 0 for row in r["tpcxbb"]):
        raise RuntimeError("tpcxbb: a query or DAG form did not run or gave no egress")
    card = _card()
    out = os.path.join("build", "BENCH_core_torch.json")
    lines = _subprocess(["-m", "repro_torch.launch.bench_core", "--smoke", "--out", out],
                        BENCH_CORE_TIMEOUT_S, "bench_core --smoke")
    with open(os.path.join(ROOT, out)) as f:
        doc = json.load(f)
    for row in doc["results"]:
        log(f"[bench_core] {json.dumps(row)} [{card}]")
    log(f"[bench_core] {lines[-1]} [{card}]")  # the ratios
    (off,) = [row for row in doc["results"] if row["workload"] == "device_offload"]
    if not (off["device_backend"] == "cuda" and off["egress_in_order"]
            and off["device_launches"] == off["device_dispatches"] > 0):
        raise RuntimeError(f"bench_core: the device_offload row did not run K1 once per dispatch "
                           f"on cuda with egress in order: {off}")
    log(f"[bench_core] device_offload: K1 launched {off['device_launches']} times = "
        f"{off['device_dispatches']} dispatches on cuda, egress in order")
    log(f"[stream workloads] phase 15 took {time.perf_counter() - t0:.1f} s [{card}]")
    return off["device_launches"]


# ---------------------------------------------------------------- phase 16
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 12
TRAIN_CUT = 2  # layers of the olmo-1b cuts (K4 against plain, resume) and of qwen2-moe
MOE_TRAIN_B, MOE_TRAIN_STEPS = 4, 4
RESUME_STEPS, RESUME_AT = 4, 2
# (b)'s limits on one 2-layer step through K4 against the plain version's,
# relative: on an H100, K4 moved the loss by 9.3e-7 and the grad norm by
# 1.4e-5, and the planted wrong forward (K4 with its causal mask dropped) by
# 1.1e-3 and 1.5; (b) fails unless the planted forward lands outside both
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-5, 1e-3
RESUME_LOSS_REL = 1e-3


def train_model_flops(cfg, B, S) -> float:
    """Model FLOPs of one train step: 6 x the non-embedding parameters (the
    unembedding counts) x the tokens, plus the attention's two products over
    the causal pairs, 4 B H Dh a pair a layer forward and twice that
    backward."""
    from repro_torch.models.common import count_params

    n = count_params(cfg) - cfg.vocab_size * cfg.d_model
    attn_layers = sum(m == "attn" for m, _ in cfg.pattern) * cfg.num_periods
    pairs = S * (S + 1) // 2
    return 6 * n * B * S + 3 * 4 * B * cfg.num_heads * cfg.hd * pairs * attn_layers


def _train_steps(cfg, params, opt, data, steps, ocfg) -> list[dict]:
    """``steps`` steps of the port's ``make_train_step`` on ``data``: each
    step's metrics as floats, its wall ms (ending in a synchronize) and its
    batch's serial."""
    from repro_torch.train import make_train_step

    step_fn = make_train_step(cfg, ocfg)
    rows = []
    for _ in range(steps):
        batch = next(data)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict({k: float(v) for k, v in m.items()}, ms=ms, serial=batch["serial"]))
    return rows


def _log_steps(tag, rows, first=0) -> None:
    for i, r in enumerate(rows, start=first):
        log(f"[{tag}] step {i}: loss {r['loss']:.6f} (nll {r['nll']:.6f}, aux {r['aux']:.6f}), "
            f"lr {r['lr']:.4e}, grad norm {r['grad_norm']:.6f}, {r['ms']:.3f} ms")


def _finite(tag, rows) -> list:
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite([r[k] for r in rows for k in ("loss", "aux", "grad_norm")])):
        raise RuntimeError(f"{tag}: a loss, aux or grad norm is not finite: {rows}")
    return losses


def _clone(tree):
    return tree_map(torch.clone, tree)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _data(cfg, B):
    from repro_torch.train import DataConfig, OrderedTokenPipeline

    return OrderedTokenPipeline(DataConfig(cfg.vocab_size, TRAIN_S, B, seed=0))


def _train_full(card) -> tuple[int, dict]:
    """Phase 16 (a): returns K4's launches and its row at the training shape."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.launch.profile_serve import _device_split
    from repro_torch.launch.train import opt_config
    from repro_torch.models import attention
    from repro_torch.models.common import count_params, init_params
    from repro_torch.train import apply_adamw, init_opt_state, make_train_step

    # (a) olmo-1b at its published widths and depth, as launch/train.py trains
    # it; layer 0's attention in the first step captured as the model calls K4
    cfg = get_config("olmo-1b")
    if cfg.remat != "full":
        raise RuntimeError(f"train: {cfg.name} remat is {cfg.remat!r}, expected 'full'")
    t0 = time.perf_counter()
    params = init_params(cfg, _gen(0), "cuda")
    _made("train", cfg, t0)
    ocfg = opt_config(cfg, TRAIN_STEPS)
    opt = init_opt_state(ocfg, params)
    stream = _data(cfg, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.LAUNCHES = 0
    with _first_call(attention, "flash_attention") as attns:
        rows = _train_steps(cfg, params, opt, stream, TRAIN_STEPS, ocfg)
    k4_a = flash_attention.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    _log_steps("train", rows, first=1)
    losses = _finite("train", rows)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    _expect("train", "K4", k4_a, 2 * cfg.num_layers * TRAIN_STEPS,
            f"{TRAIN_STEPS} steps x {cfg.num_layers} layers x 2 (the forward and the recompute)")
    step_ms = statistics.median(r["ms"] for r in rows[1:])
    tokens = TRAIN_B * TRAIN_S
    flops = train_model_flops(cfg, TRAIN_B, TRAIN_S)
    mfu = flops / (step_ms / 1e3) / PEAK_OPS_PER_S[torch.bfloat16]
    log(f"[train] {cfg.name}, remat {cfg.remat}, B {TRAIN_B} x S {TRAIN_S}, {TRAIN_STEPS} steps "
        f"from init_params(seed 0) on OrderedTokenPipeline(seed 0): loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; median step over steps 2-{TRAIN_STEPS} {step_ms:.3f} ms (step 1 "
        f"{rows[0]['ms']:.3f} ms), {tokens / (step_ms / 1e3):.1f} tokens/s, model FLOPs "
        f"{flops:.4e} a step ({count_params(cfg) - cfg.vocab_size * cfg.d_model:,} non-embedding "
        f"params), model-FLOPs share of the bf16 peak {mfu:.4f}; peak memory "
        f"{peak / 1e9:.3f} GB (max_memory_allocated) [{card}]")

    # where the step's time goes: one more step alone under the profiler, then
    # the AdamW update alone on gradients of the parameters' shapes and types
    step_fn = make_train_step(cfg, ocfg)
    batch = next(stream)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, runs, _ = _device_split(prof)
    busy = sum(groups.values())
    log(f"[train] one step under the profiler: wall {wall * 1e3:.3f} ms, device "
        f"{busy * 1e3:.3f} ms, busy share " + (f"{busy / wall:.4f}" if busy else
                                               "not measured (no device time recorded)")
        + "; " + ", ".join(f"{g} {sec * 1e3:.3f} ms in {runs[g]} kernels ({sec / busy:.4f})"
                           for g, sec in sorted(groups.items(), key=lambda kv: -kv[1])))
    del prof
    g_adamw = _gen(3)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g_adamw, device="cuda")
                     .mul_(1e-3).to(p.dtype), params)
    adamw_ms = []
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        apply_adamw(ocfg, params, grads, opt)
        end.record()
        torch.cuda.synchronize()
        adamw_ms.append(start.elapsed_time(end))
    log(f"[train] the AdamW update alone (CUDA events, calls 2-4): "
        + ", ".join(f"{t:.3f}" for t in adamw_ms[1:])
        + f" ms over {count_params(cfg):,} params (bf16, f32 master and moments) [{card}]")
    del params, opt, grads
    _free()
    (q, k, v), kw = attns[0]
    k4_train = _k4_held("train", f"layer 0 of step 1 (B {TRAIN_B} x S {TRAIN_S})", q, k, v,
                        kw.get("causal", True), iters=20)
    del attns, q, k, v
    _free()
    return k4_a, k4_train


def _train_cut():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("olmo-1b"), num_layers=TRAIN_CUT)


def _train_k4_vs_plain() -> None:
    """Phase 16 (b)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.launch.train import opt_config
    from repro_torch.models.common import init_params
    from repro_torch.train import init_opt_state

    # (b) K4 held to its plain version through one train step from the same
    # parameters and batch, with a planted wrong forward (K4 with its causal
    # mask dropped) that the limits must reject
    cut = _train_cut()
    params = init_params(cut, _gen(1), "cuda")
    ocfg_b = opt_config(cut, TRAIN_STEPS)
    kernel = flash_ops.FlashAttention.forward_fn
    held = {}
    for route, fwd in (("kernel", kernel), ("plain", attention_ref),
                       ("planted", lambda q, k, v, causal: kernel(q, k, v, False))):
        p = _clone(params)
        flash_ops.FlashAttention.forward_fn = staticmethod(fwd)
        try:
            (held[route],) = _train_steps(cut, p, init_opt_state(ocfg_b, p), _data(cut, TRAIN_B),
                                          1, ocfg_b)
        finally:
            flash_ops.FlashAttention.forward_fn = staticmethod(kernel)
        del p
    pl = held["plain"]
    rel = {route: (abs(r["loss"] - pl["loss"]) / abs(pl["loss"]),
                   abs(r["grad_norm"] - pl["grad_norm"]) / pl["grad_norm"])
           for route, r in held.items() if route != "plain"}
    log(f"[train] K4 against its plain version on one train step of {cut.name} with "
        f"{TRAIN_CUT} of {get_config(cut.name).num_layers} layers (B {TRAIN_B} x S {TRAIN_S}); "
        f"loss and grad norm, relative to the plain version's (limits {TRAIN_LOSS_REL}, "
        f"{TRAIN_GNORM_REL}): plain {pl['loss']:.6f}, {pl['grad_norm']:.6f}; "
        + "; ".join(f"{route} {held[route]['loss']:.6f} (rel {lo:.3e}), "
                    f"{held[route]['grad_norm']:.6f} (rel {gn:.3e})"
                    for route, (lo, gn) in rel.items())
        + f"; step {held['kernel']['ms']:.3f} / {pl['ms']:.3f} ms")
    if not (rel["kernel"][0] <= TRAIN_LOSS_REL and rel["kernel"][1] <= TRAIN_GNORM_REL):
        raise RuntimeError("train: the step through K4 disagrees with the plain version's")
    if rel["planted"][0] <= TRAIN_LOSS_REL or rel["planted"][1] <= TRAIN_GNORM_REL:
        raise RuntimeError("train: the limits pass a step whose K4 forward drops the causal mask")
    del params
    _free()


def _train_moe(card) -> tuple[int, int, dict]:
    """Phase 16 (c): returns K3's and K4's launches and K3's compare_case
    at the training shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.dispatch.ops import dispatch
    from repro_torch.launch import bench_dispatch
    from repro_torch.launch.train import opt_config
    from repro_torch.models import ffn
    from repro_torch.models.common import init_params
    from repro_torch.train import init_opt_state

    # (c) qwen2-moe at its widths with TRAIN_CUT of its layers: K3 in every MoE
    # layer's forward and recompute; layer 0's dispatch in the first step held
    # to dispatch_ref bit for bit
    full = get_config(MOE_ARCH)
    moe = dataclasses.replace(full, num_layers=TRAIN_CUT)
    t0 = time.perf_counter()
    params = init_params(moe, _gen(0), "cuda")
    _made("train", moe, t0, f" of {full.num_layers}")
    ocfg_c = opt_config(moe, MOE_TRAIN_STEPS)
    opt = init_opt_state(ocfg_c, params)
    dispatch.LAUNCHES = flash_attention.LAUNCHES = 0
    with _first_call(ffn, "dispatch") as seen:
        rows = _train_steps(moe, params, opt, _data(moe, MOE_TRAIN_B), MOE_TRAIN_STEPS, ocfg_c)
    k3_c, k4_c = dispatch.LAUNCHES, flash_attention.LAUNCHES
    _log_steps("train moe", rows, first=1)
    _finite("train moe", rows)
    n_moe = sum(f == "moe" for _, f in moe.pattern) * moe.num_periods
    n_attn = sum(m == "attn" for m, _ in moe.pattern) * moe.num_periods
    _expect("train moe", "K3", k3_c, 2 * n_moe * MOE_TRAIN_STEPS,
            f"{MOE_TRAIN_STEPS} steps x {n_moe} MoE layers x 2 (the forward and the recompute)")
    _expect("train moe", "K4", k4_c, 2 * n_attn * MOE_TRAIN_STEPS,
            f"{MOE_TRAIN_STEPS} steps x {n_attn} attention layers x 2")
    ms = statistics.median(r["ms"] for r in rows[1:])
    log(f"[train moe] {moe.name} with {TRAIN_CUT} of {full.num_layers} layers, B {MOE_TRAIN_B} x "
        f"S {TRAIN_S}: median step over steps 2-{MOE_TRAIN_STEPS} {ms:.3f} ms, "
        f"{MOE_TRAIN_B * TRAIN_S / (ms / 1e3):.1f} tokens/s [{card}]")
    del params, opt
    _free()
    (ids, h, P, C), kw = seen[0]
    label = f"layer 0 of step 1 (B {MOE_TRAIN_B} x S {TRAIN_S})"
    k3_train = bench_dispatch.compare_case(ids.detach(), h.detach(), P, C, kw["group"])
    log(f"[train moe] K3 in training equals dispatch_ref bit for bit (buffers, counts, dest) on "
        f"every route; {bench_dispatch.card()}:")
    for line in bench_dispatch.report({"other": None, "shapes": {label: k3_train}}):
        log(f"[train moe] {line}")
    del seen, ids, h
    _free()
    return k3_c, k4_c, k3_train


def _train_resume(card) -> int:
    """Phase 16 (d): returns K4's launches."""
    import shutil
    import tempfile

    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.launch.train import opt_config
    from repro_torch.models.common import init_params
    from repro_torch.train import CheckpointManager, init_opt_state

    # (d) checkpoint and resume on the card: RESUME_STEPS steps straight, saved
    # after step RESUME_AT; then restored into new tensors, the pipeline
    # seeked to the saved cursor, and the steps after RESUME_AT run again
    cut = _train_cut()
    params = init_params(cut, _gen(2), "cuda")
    ocfg_d = opt_config(cut, RESUME_STEPS)
    opt = init_opt_state(ocfg_d, params)
    stream = _data(cut, TRAIN_B)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        flash_attention.LAUNCHES = 0
        straight = _train_steps(cut, params, opt, stream, RESUME_AT, ocfg_d)
        state = {"params": params, "opt": opt}
        t0 = time.perf_counter()
        path = CheckpointManager(tmp).save(RESUME_AT, state,
                                           extra={"data_serial": stream.cursor()})
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        saved = _clone(state)
        straight += _train_steps(cut, params, opt, stream, RESUME_STEPS - RESUME_AT, ocfg_d)
        del params, opt, state
        t0 = time.perf_counter()
        step, restored, extra = CheckpointManager(tmp).restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved, restored_flat = flatten(saved), flatten(restored)
        names = list(saved)
        if step != RESUME_AT or list(restored_flat) != names:
            raise RuntimeError(f"train resume: restored step {step}, leaves differ from saved")
        differ = [n for n in names if not _same_bits(saved[n], restored_flat[n])]
        if differ:
            raise RuntimeError(f"train resume: restored leaves differ from saved: {differ[:5]}")
        del saved
        again = _data(cut, TRAIN_B)
        again.seek(extra["data_serial"])
        resumed = _train_steps(cut, restored["params"], restored["opt"], again,
                               RESUME_STEPS - RESUME_AT, ocfg_d)
        k4_d = flash_attention.LAUNCHES
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _finite("train resume", straight + resumed)
    want, got = straight[RESUME_AT:], resumed
    if [r["serial"] for r in got] != [r["serial"] for r in want]:
        raise RuntimeError("train resume: the resumed run read other batches")
    rels = [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got, want)]
    bitwise = all(g["loss"] == w["loss"] and g["grad_norm"] == w["grad_norm"]
                  for g, w in zip(got, want))
    log(f"[train resume] {cut.name} with {TRAIN_CUT} layers: saved at step {RESUME_AT} "
        f"({len(names)} leaves, {nbytes:,} bytes in {save_s:.3f} s, {nbytes / save_s / 1e9:.3f} "
        f"GB/s), restored onto the card in {restore_s:.3f} s, every leaf equal bit for bit; "
        f"steps {RESUME_AT + 1}-{RESUME_STEPS} resumed / straight: "
        + ", ".join(f"{g['loss']:.6f} / {w['loss']:.6f}" for g, w in zip(got, want))
        + f" (max rel {max(rels):.3e}, limit {RESUME_LOSS_REL}; losses and grad norms "
        f"{'equal bit for bit' if bitwise else 'not bit-equal'}) [{card}]")
    if max(rels) > RESUME_LOSS_REL:
        raise RuntimeError("train resume: the resumed losses differ from the straight run's")
    return k4_d


def phase_train() -> dict:
    """Phase 16: the port's trainer on the card.  Returns the launches of K3
    and (by run) K4 on the training paths (a), (c) and (d), each read just
    after its run with the counts set to 0 just before, and K4's and K3's
    rows at the training shapes."""
    t_phase = time.perf_counter()
    card = _card()
    _free()
    k4_a, k4_train = _train_full(card)
    _train_k4_vs_plain()
    k3_c, k4_c, k3_train = _train_moe(card)
    k4_d = _train_resume(card)
    _free()
    log(f"[train] phase 16 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"K3": k3_c, "K4_by_run": {"olmo-1b": k4_a, MOE_ARCH: k4_c,
                                      "olmo-1b cut resumed": k4_d},
            "K4 at olmo-1b's training shape": k4_train,
            "K3 at qwen2-moe's training shape": {
                "ms": k3_train["ms"]["route: K3 reads h (group k)"],
                "plain_ms": k3_train["plain_ms"], "bound_ms": k3_train["bound_ms"]["fused"]}}


def main() -> None:
    device_name = phase_device()
    phase_build()
    flash_entry = phase_kernels()
    k4_launches = {"olmo-1b": phase_serving()}
    affine_entry = phase_k1()
    affine_entry["launches"] = phase_stream()
    reorder_entry, dispatch_entry, ssd_entry = phase_k2(), phase_k3(), phase_k5()
    served = phase_moe()
    k4_launches[MOE_ARCH] = served.pop("K4")
    dispatch_entry.update(served)
    k3_phi, k4_launches[PHI_ARCH] = phase_phi()
    dispatch_entry["launches"] += k3_phi
    ssd_entry.update(phase_ssm())
    k4_launches["dense configs"] = phase_dense()
    jamba = phase_jamba()
    k4_launches[JAMBA_ARCH] = jamba["launches"]["K4"]
    k3_served = dispatch_entry["launches"]
    dispatch_entry["launches"] += jamba["launches"]["K3"]
    k5_served = ssd_entry["launches"]
    ssd_entry["launches"] += jamba["launches"]["K5"]
    k4_launches[LLAMA_ARCH] = phase_llama()
    flash_entry["launches"] = sum(k4_launches.values())
    k1_stream = affine_entry["launches"]
    affine_entry["launches"] += phase_stream_workloads()
    train = phase_train()
    for run, n in train["K4_by_run"].items():
        k4_launches[f"{run} trained"] = n
    flash_entry["launches"] = sum(k4_launches.values())
    dispatch_entry["launches"] += train["K3"]
    log(f"[main] launches on the main paths: K4 {k4_launches}; K3 {dispatch_entry['launches']} "
        f"({k3_served - k3_phi} {MOE_ARCH} served, {k3_phi} {PHI_ARCH}, "
        f"{jamba['launches']['K3']} {JAMBA_ARCH} served, {train['K3']} {MOE_ARCH} trained); "
        f"K5 {ssd_entry['launches']} "
        f"({k5_served} {SSM_ARCH} served, {jamba['launches']['K5']} {JAMBA_ARCH} served); the "
        "kernels line gives K3 and K5 at the served layer's shape of phases 9 and 11; K1 "
        f"{affine_entry['launches']} ({k1_stream} stream, "
        f"{affine_entry['launches'] - k1_stream} bench_core device_offload)")
    for kernel in ("K3", "K4", "K5"):
        log(f"[main] {kernel} at jamba's served shape: {json.dumps(jamba[kernel])}")
    for what in ("K4 at olmo-1b's training shape", "K3 at qwen2-moe's training shape"):
        log(f"[main] {what}: {json.dumps(train[what])}")
    entries = [flash_entry, affine_entry, reorder_entry, dispatch_entry, ssd_entry]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--stream-workloads"]:
        stream_workloads()
    else:
        main()
