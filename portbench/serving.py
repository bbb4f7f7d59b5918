"""A serving cell: the program's ordered engine drained by a source with
backpressure.

Set-up makes the weights from the seed, builds the engine (its cache
allocated), and runs one prefill at the mix's longest prompt and one decode
step of every slot, then clears the cache.  The window opens at the first
submit to the cold engine.  Before every engine step the source tops the
pending queue up to ``depth`` requests (no rate, no clock), and after every
step the completions that came out in order are timestamped as egressed.
The window closes at the end of the first step that ends past ``seconds``.

Then the ordered egress is checked (the serials in the order they were
submitted, each with the number of tokens its request asked for), the
engine is freed, and the reference scores a sample of the egressed requests
drawn from the seed, the longest among them: each served token's logit
against the best logit at its position of a float32 pass over the prompt
and the tokens served before it.  The cell's limits name the numbers
compared: the widest such gap, or the share of tokens off by more than
``OFF``.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import families, reference, weights
from .bench import (Run, end_to_end, judge, passed, pct, read_per_layer, setup_line,
                    window_line)
from .host import GcWatch
from .trace import Spans, Stretch, breakdown, kernel_line
from .traffic import RequestSource, block_lengths


# logits: a served token this far below the reference's best is off. Sound
# runs of qwen2-moe put 2-6% of their tokens there (bf16 flips near-tied
# expert choices), its float8 control 39-51%; olmo-1b none, its control 2-5%
# (PERF.md)
OFF = 0.5
# a request whose tokens are mostly off is one wrong answer, as of a slot
# gone bad: sound runs of qwen2-moe have none of 6 tokens or more, its
# float8 control 2-6 among 16 (PERF.md)
HALF_MIN = 6


def _warm(engine, longest: int, device) -> None:
    """One prefill at the cell's longest prompt and one decode step of every
    slot, then the cache and the slots' tokens cleared."""
    tokens = torch.zeros((1, longest), dtype=torch.long, device=device)
    logits, _ = engine._prefill1(engine.params, tokens)
    int(logits[0].argmax())
    position = torch.zeros((engine.max_slots,), dtype=torch.int32, device=device)
    out, _ = engine._decode(engine.params, engine.tokens, engine.cache, position)
    out.cpu()
    for slot in engine.cache.values():
        for leaf in slot.values():
            leaf.zero_()
    engine.tokens.zero_()


def window(run: Run, engine, spans: Spans) -> dict:
    """Drive the engine for ``run.seconds``; returns what the window saw."""
    model, mix, depth = run.model, run.mix, run.params["depth"]
    fam = families.of(run.config)
    source = RequestSource(mix, run.seed, model["vocab_size"], run.params["max_len"])
    stretch = Stretch(spans) if run.trace else None
    steps, egress, asked = [], [], {}
    seen = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    s_open, s_close = t0 + run.seconds * mix["stretch_at"], None
    while time.perf_counter() < deadline:
        if stretch is not None:
            now = time.perf_counter()
            if s_close is None and now >= s_open:
                stretch.start()
                s_close = time.perf_counter() + mix["stretch_s"]
            elif stretch.active and now >= s_close:
                stretch.stop()
        with spans.span("source"):
            while len(engine.pending) < depth:
                req = source.next()
                serial = engine.submit(req.prompt, req.max_new_tokens)
                req.submitted_at = engine.pending[-1].submitted_at
                asked[serial] = req
        head = engine.pending[0] if engine.pending else None
        active, position = engine.active.copy(), engine.position.copy()
        engine.step()
        kind, a, b, traced = spans.records[-1]
        if kind == "prefill":
            S = head.prompt.size
            step = {"tokens": S + 1, "flops": fam.prefill_flops(model, S),
                    **fam.prefill_bounds(model, S)}
        else:
            step = {"tokens": int(active.sum()),
                    "flops": fam.decode_flops(model, position[active].tolist()),
                    **fam.decode_bounds(model, engine.max_slots)}
        steps.append(dict(step, kind=kind, t0=a, t1=b, traced=traced))
        with spans.span("egress"):
            t = time.perf_counter()
            for c in engine.completions[seen:]:
                sub = asked[c.serial].submitted_at if c.serial in asked else float("nan")
                egress.append({"serial": c.serial, "tokens": c.tokens, "t": t,
                               "latency_s": t - sub, "hold_s": t - (sub + c.latency_s),
                               "traced": spans.in_stretch})
            seen = len(engine.completions)
    if stretch is not None and stretch.active:
        stretch.stop()
    t_end = time.perf_counter()
    if stretch is not None:
        stretch.finish()
    return {"window_s": t_end - t0, "steps": steps, "egress": egress, "asked": asked,
            "trace": stretch.summary if stretch is not None else None}


def rates(w: dict) -> dict:
    """Tokens prefilled and generated over the window's seconds, and the
    90th percentile of submit to in-order egress over every request egressed."""
    tokens = sum(s["tokens"] for s in w["steps"])
    lat = [e["latency_s"] * 1e3 for e in w["egress"]]
    return {"serve_tokens_per_s": tokens / w["window_s"],
            "egress_p90_ms": pct(lat, 90) if lat else None}


def sample(egress: list, seed: int, k: int) -> list:
    """k egressed requests drawn from the seed, the longest (most tokens
    served) always among them."""
    if not egress:
        return []
    longest = max(range(len(egress)), key=lambda i: (len(egress[i]["tokens"]), -i))
    rest = [i for i in range(len(egress)) if i != longest]
    rng = np.random.default_rng([seed, 3])
    pick = list(rng.choice(rest, size=min(k - 1, len(rest)), replace=False)) if rest else []
    return [egress[i] for i in [longest] + sorted(pick)]


def served_gaps(run: Run, params: dict, asked: dict, picked: list, control=False) -> list:
    """For each picked request, how far each served token's logit lies
    below the reference's best at its position (the family's float32
    pass).  With ``control`` ("fp8", or "bf16" for a witness) the tokens
    scored are that pass's own choices."""
    model, device, fam = run.model, run.device, families.of(run.config)
    seqs, wanted, served = [], [], []
    for e in picked:
        prompt = torch.from_numpy(asked[e["serial"]].prompt.astype(np.int64))
        toks = torch.from_numpy(np.asarray(e["tokens"], np.int64))
        seqs.append(torch.cat([prompt, toks[:-1]]).to(device))
        S = prompt.numel()
        wanted.append(torch.arange(S - 1, S - 1 + toks.numel(), device=device))
        served.append(toks.to(device))
    ref = fam.served_logits(model, params, seqs, wanted)
    if control:
        low = fam.served_logits(model, params, seqs, wanted, control=control)
        served = [lg.argmax(-1) for lg in low]
    return [reference.gaps(r, t) for r, t in zip(ref, served)]


def half_off(g: torch.Tensor) -> bool:
    """A request of ``HALF_MIN`` tokens or more with more than half of them off."""
    return g.numel() >= HALF_MIN and 2 * int((g > OFF).sum()) > g.numel()


def gap_numbers(gaps: list) -> dict:
    """The widest gap; the share (%) of served tokens whose logit lies more
    than ``OFF`` below the reference's best; and how many requests are
    mostly off; None without a token."""
    if not gaps:
        return {"served_logit_gap": None, "served_off_pct": None, "half_off_requests": None}
    flat = torch.cat(gaps)
    return {"served_logit_gap": float(flat.max()),
            "served_off_pct": 100.0 * float((flat > OFF).sum()) / flat.numel(),
            "half_off_requests": sum(half_off(g) for g in gaps)}


def order_checks(egress: list, asked: dict) -> dict:
    """Egress in submit order (``asked`` keeps it), each with the tokens asked."""
    order = sum(1 for e, s in zip(egress, asked) if e["serial"] != s)
    length = sum(1 for e in egress
                 if e["serial"] not in asked
                 or len(e["tokens"]) != asked[e["serial"]].max_new_tokens)
    return {"order_errors": order, "length_errors": length}


def make_engine(run: Run, params: dict):
    from repro_torch.serve.engine import OrderedServingEngine
    from .bench import program_config

    return OrderedServingEngine(program_config(run.model), params,
                                max_slots=run.params["slots"], max_len=run.params["max_len"],
                                device=run.device)


def setup(run: Run):
    """Weights, engine and warm-up; returns (params, engine, spans)."""
    marks = [("start", time.perf_counter())]
    params = weights.make(run.model, families.of(run.config).layout(run.model), run.seed,
                          run.device)
    marks.append(("weights", time.perf_counter()))
    engine = make_engine(run, params)
    marks.append(("engine", time.perf_counter()))
    spans = Spans(run.trace)
    engine._do_prefill = spans.wrap("prefill", engine._do_prefill)
    engine._do_decode = spans.wrap("decode", engine._do_decode)
    longest = int(block_lengths(run.mix, run.params["max_len"])[:, 0].max())
    _warm(engine, longest, run.device)
    marks.append(("warm-up", time.perf_counter()))
    setup_line(run, marks)
    if run.trace:  # the profiler's own start-up, outside the window
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=run.device).add_(1)
            torch.cuda.synchronize()
    spans.records.clear()
    return params, engine, spans


def run_cell(run: Run, memory_peak=lambda: 0) -> tuple:
    """Set-up, window and check; returns (result, checks)."""
    params, engine, spans = setup(run)
    setup_s = time.perf_counter() - run.t_start
    with GcWatch() as gcw:
        w = window(run, engine, spans)
    peak = memory_peak()
    print(gcw.line(), file=sys.stderr)
    print(window_line(w["steps"]), file=sys.stderr)
    egress, asked = w["egress"], w["asked"]
    del engine
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    values = order_checks(egress, asked)
    picked = sample(egress, run.seed, run.mix["sample"])
    gaps = served_gaps(run, params, asked, picked)
    values.update(gap_numbers(gaps))
    limits = run.params["limits"]
    checks = judge({k: v for k, v in values.items() if k in limits}, limits)
    widest = limits.get("served_logit_gap", float("inf"))
    failed = values["order_errors"] + values["length_errors"] + sum(
        float(g.max()) > widest or ("half_off_requests" in limits and half_off(g)) for g in gaps)
    result = {"correct": bool(egress) and passed(checks), "attempted": len(egress),
              "failed": failed, "metrics": {}, "device": {"memory_peak_bytes": peak}}
    kernels = families.of(run.config).KERNELS
    ctx = {"steps": w["steps"], "egress": egress, "window_s": w["window_s"], "trace": w["trace"],
           "kernels": {key: needle for needle, key in kernels}}
    if run.trace:
        result["metrics"] = read_per_layer(run, ctx)
        result["device"].update(busy_s=w["trace"]["busy_s"], window_s=w["trace"]["window_s"])
        result["breakdown"] = breakdown(w["trace"])
        print(kernel_line(w["trace"], [needle for needle, _ in kernels]), file=sys.stderr)
    else:
        result["metrics"] = end_to_end(run, dict(rates(w), setup_s=setup_s))
    return result, checks
