#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. Device: the card's name and power limit (``nvidia-smi``).  Without CUDA
   the script stops here.
2. Kernels: builds K4 (``kernels/attention/csrc/flash_fwd.cu``) with nvcc for
   sm_90a, holds it to the plain ``attention_ref`` on the card (max error
   within 2e-2 in bf16, 2e-5 in f32, the tolerances of the kernel tests) at
   the olmo-1b attention shape (B=1, H=Hkv=16, Dh=128) for S in
   {13, 128, 200, 512}, bf16 and f32, causal and not, plus one GQA case
   (H=16, Hkv=4, Dh=64); then times the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) with CUDA events at every served prompt length.
3. Serving: olmo-1b at full width (16 layers, d_model 2048, vocab 50304) with
   random bf16 weights from a seeded generator, through
   ``OrderedServingEngine(max_slots=4, max_len=1024)``: eight requests, both
   schedules.  Egress must be in serial order, every token inside the vocab,
   and K4 launched exactly prefills x 16 times.  One request is then served
   again in f32 and checked token for token against ``generate``.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM data-sheet peaks (dense): device memory rate, and the operation
# rate for each input type (bf16 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
CHECK_SEQ_LENS = (13, 128, 200, 512)
SERVED_PROMPT_LENS = (17, 128, 200, 333, 512, 64, 45, 300)
REPLACES = "src/repro/kernels/attention/flash.py:22 (_flash_kernel; pallas_call at :112)"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


# ---------------------------------------------------------------- phase 2
def _qkv(B, S, H, Hkv, Dh, dtype, gen):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    return randn(B, S, H, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh)


def phase_kernels() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load(flash.SOURCE)
    log(f"[kernels] built {os.path.relpath(flash.SOURCE, ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for line in _build.BUILD_LOGS.get(str(flash.SOURCE), "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[kernels]   ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, S, 16, 16, 128) for S in CHECK_SEQ_LENS] + [(1, 200, 16, 4, 64)]
    max_err = 0.0
    for shape in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v = _qkv(*shape, dtype, gen)
                out = flash.flash_fwd(q, k, v, causal)
                torch.cuda.synchronize()
                ref = attention_ref(q, k, v, causal)
                diff = (out.float() - ref.float()).abs()
                err = float(diff.max())
                tol = TOL[dtype]
                ok = bool((diff <= tol + tol * ref.float().abs()).all()) and err <= tol
                extra = ""
                if dtype != torch.float32:  # both against the f32 computation
                    exact = attention_ref(q.float(), k.float(), v.float(), causal)
                    extra = (f"; vs f32: kernel {float((out.float() - exact).abs().max()):.3g}, "
                             f"plain {float((ref.float() - exact).abs().max()):.3g}")
                log(f"[kernels] K4 B,S,H,Hkv,Dh={shape} {str(dtype)[6:]} causal={causal}: "
                    f"max|err| {err:.3g} (tol {tol}) {'ok' if ok else 'FAIL'}{extra}")
                if not ok:
                    raise RuntimeError(f"K4 disagrees with attention_ref at {shape} {dtype} causal={causal}")
                max_err = max(max_err, err)

    # times at the served shapes: olmo-1b prefill, bf16, causal
    H, Dh, dtype = 16, 128, torch.bfloat16
    rows = {}
    for S in sorted(set(SERVED_PROMPT_LENS)):
        q, k, v = _qkv(1, S, H, H, Dh, dtype, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = time_ms(lambda: flash.flash_fwd(q, k, v, True))
        plain_ms = time_ms(lambda: attention_ref(q, k, v, True))
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        bound_ms, bound_by = attention_bound(1, S, H, H, Dh, dtype, True)
        rows[S] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernels] K4 time S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"share of bound {bound_ms / ms:.4f}")
    top = rows[max(rows)]
    log(f"[kernels] the kernels line reports K4 at B=1 S={max(rows)} H=Hkv=16 Dh=128 bf16 "
        "causal (the largest served prompt)")
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


def main() -> None:
    name = phase_device()
    entry = phase_kernels()
    entry["launches"] = phase_serving()
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
