"""K2 against other builds of itself, on the card.

  PYTHONPATH=src python -m repro_torch.launch.bench_reorder \\
      [--source package] [--source OTHER/reorder.cu ...] [--json PATH]

Sets up the commit that ``chip_smoke.py`` phase 6 times (:func:`timing_commit`:
a 16,384-slot x 128 f32 ring in which a quarter of the window waits past a
gap, and a batch of 512 entries whose 480 serials fill the head, so that
each commit accepts and emits 480 rows), holds each source's K2 to
``commit_ref`` bit for bit on it, and times them by CUDA-graph replay in
turns (A B ... B A).  ``package`` is the package's ``reorder.cu``; another
source may be a one-launch K2 (``commit_launches_per_call()`` 1, the
package's C entry) or a three-launch one (3, the C entry without the ticket
argument, as before the one-launch design).  Each three-launch source's
launches (scatter, the one-block count, emit) are also timed alone, through
a generated file that includes the source and adds one entry per launch.
Prints the card's name and power limit, the times, and last a JSON line,
also written to ``--json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.parity import bits_equal
from repro_torch.kernels.reorder import reorder as k2
from repro_torch.kernels.reorder.ref import ReorderState, commit_ref, init_state
from repro_torch.launch.timing import graph_time_ms

RING, WIDTH, BATCH = 16384, 128, 512
# the three-launch entry: serials, K, payloads, buf, present, next, S,
# row_bytes, accepted, emitted, count, next_out
_OLD_ARGTYPES = k2._ARGTYPES[:-1]
_PARTS = ("scatter", "count", "emit")
_SPLIT = """// Generated: one entry per launch of the three-launch K2 in {source}.
#include "{source}"

namespace {{
template <typename V>
int part_launch(int part, const int* serials, int K, const void* payloads, void* buf,
                unsigned char* present, const int* next, int S, long long row_bytes,
                unsigned char* accepted, void* emitted, int* count, int* next_out,
                cudaStream_t s) {{
  const long long rv = row_bytes / (long long)sizeof(V);
  if (part == 0)
    scatter_kernel<V><<<rows::grid_for((long long)K * rv, kThreads), kThreads, 0, s>>>(
        serials, K, static_cast<const V*>(payloads), static_cast<V*>(buf), present, next, S,
        rv, accepted);
  else if (part == 1)
    count_kernel<<<1, kCountThreads, 0, s>>>(present, next, S, count, next_out);
  else
    emit_kernel<V><<<rows::grid_for((long long)S * rv, kThreads), kThreads, 0, s>>>(
        static_cast<const V*>(buf), present, next, count, S, rv, static_cast<V*>(emitted));
  return (int)cudaGetLastError();
}}
}}  // namespace

extern "C" int commit_part(int part, const void* serials, int K, const void* payloads,
                           void* buf, void* present, const void* next, int S,
                           long long row_bytes, void* accepted, void* emitted, void* count,
                           void* next_out, void* stream) {{
  const uintptr_t align =
      (uintptr_t)payloads | (uintptr_t)buf | (uintptr_t)emitted | (uintptr_t)row_bytes;
  return rows::with_vector(align, [&](auto v) {{
    return part_launch<decltype(v)>(
        part, static_cast<const int*>(serials), K, payloads, buf,
        static_cast<unsigned char*>(present), static_cast<const int*>(next), S, row_bytes,
        static_cast<unsigned char*>(accepted), emitted, static_cast<int*>(count),
        static_cast<int*>(next_out), static_cast<cudaStream_t>(stream));
  }});
}}
"""


def timing_commit(gen: torch.Generator):
    """(state, serials, payloads, per): ``per`` = 480 serials in a batch of
    512 fill the head of a ring whose window holds S/4 more serials past a
    gap.  A commit with these, on the same state, accepts and emits the
    ``per`` rows and clears their slots, so every repeat does the same work."""
    S, W, K = RING, WIDTH, BATCH
    per = K - K // 16
    start = 5 * S + 123
    state = init_state(S, W, device="cuda", start=start)
    gap = per + 1
    waiting = (start + gap + torch.randperm(S - gap, generator=gen, device="cuda")[: S // 4]) % S
    state.present[waiting] = True
    state.buf.copy_(torch.randn(S, W, generator=gen, device="cuda"))
    serials = torch.full((K,), -1, dtype=torch.int32, device="cuda")
    slots = torch.randperm(K, generator=gen, device="cuda")[:per]
    serials[slots] = start + torch.randperm(per, generator=gen, device="cuda").to(torch.int32)
    payloads = torch.randn(K, W, generator=gen, device="cuda")
    return state, serials, payloads, per


def _outputs(state, K):
    dev = state.buf.device
    return (torch.empty(K, dtype=torch.bool, device=dev), torch.empty_like(state.buf),
            torch.empty((), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.int32, device=dev))


def _args(state, serials, payloads, outs):
    buf, present, nxt = state
    accepted, emitted, count, next_out = outs
    return (serials.data_ptr(), serials.shape[0], payloads.data_ptr(), buf.data_ptr(),
            present.data_ptr(), nxt.data_ptr(), buf.shape[0], buf.shape[1] * buf.element_size(),
            accepted.data_ptr(), emitted.data_ptr(), count.data_ptr(), next_out.data_ptr())


def launches_per_call(source: Path) -> int:
    return _build.load(source).commit_launches_per_call()


def source_commit(source: Path):
    """A commit through ``source``'s C entry (one launch with the ticket, or
    three without), with the package's signature: (state, serials,
    payloads) -> (new_state, emitted, count, accepted)."""
    one = launches_per_call(source) == 1
    fn = _build.entry(source, "commit_launch", k2._ARGTYPES if one else _OLD_ARGTYPES)

    def call(state, serials, payloads):
        outs = _outputs(state, serials.shape[0])
        dev = state.buf.device
        ticket = (k2._ticket(dev).data_ptr(),) if one else ()
        _build.launch(fn, dev, *_args(state, serials, payloads, outs), *ticket)
        accepted, emitted, count, next_out = outs
        return ReorderState(state.buf, state.present, next_out), emitted, count, accepted
    return call


def launch_split(source: Path, state, serials, payloads) -> dict:
    """Each launch of ``source``'s three-launch commit alone, by graph
    replay, on this commit: scatter, then the count (on the scattered
    ring), then emit (which clears the run; repeats redo the same copies)."""
    out_dir = _build.BUILD_DIR / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    split = out_dir / "reorder_split.cu"
    split.write_text(_SPLIT.format(source=source.resolve()))
    fn = _build.entry(split, "commit_part", (ctypes.c_int,) + _OLD_ARGTYPES)
    outs = _outputs(state, serials.shape[0])
    args = _args(state, serials, payloads, outs)
    dev = state.buf.device
    times = {}
    for i, part in enumerate(_PARTS):
        _build.launch(fn, dev, i, *args)  # the state the next part finds
        times[part] = graph_time_ms(lambda: _build.launch(fn, dev, i, *args))  # noqa: B023
    return times


def compare(sources, gen: torch.Generator | None = None) -> dict:
    """Each of ``sources`` (``package`` or a path) on :func:`timing_commit`:
    equal to ``commit_ref`` bit for bit, graph replay times in turns (A B
    ... B A), and each three-launch source's launches alone."""
    gen = gen or torch.Generator(device="cuda").manual_seed(7)
    paths = {str(n): (k2.SOURCE if str(n) == "package" else Path(n).resolve()) for n in sources}
    kernels = {n: (k2.commit_fwd if n == "package" else source_commit(p)) for n, p in paths.items()}
    state, serials, payloads, per = timing_commit(gen)
    for name, call in kernels.items():
        st = ReorderState(*(t.clone() for t in state))
        call(st, serials, payloads)  # accept the head
        ref = commit_ref(ReorderState(*(t.clone() for t in st)), serials, payloads)
        _, em, cnt, acc = call(st, serials, payloads)
        if not (bits_equal(em, ref[1]) and int(cnt) == int(ref[2]) == per
                and torch.equal(acc, ref[3]) and torch.equal(st.present, ref[0].present)
                and bits_equal(st.buf, ref[0].buf)):
            raise RuntimeError(f"{name} K2 disagrees with commit_ref on the timing commit")
    names = list(kernels)
    turns = {n: [] for n in names}
    rings = {n: ReorderState(*(t.clone() for t in state)) for n in names}
    for n in names + names[::-1]:
        turns[n].append(graph_time_ms(lambda: kernels[n](rings[n], serials, payloads)))  # noqa: B023
    split = {n: launch_split(p, ReorderState(*(t.clone() for t in state)), serials, payloads)
             for n, p in paths.items() if launches_per_call(p) == 3}
    return {"ms": {n: sum(t) / len(t) for n, t in turns.items()}, "turns_ms": turns,
            "launches_per_call": {n: launches_per_call(p) for n, p in paths.items()},
            "three_launch_split_ms": split, "accepted_and_emitted": per}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=None,
                    help="a K2 source to time; 'package' is the package's (default)")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_reorder: needs an NVIDIA GPU")
    print(card(), flush=True)
    r = compare(args.source or ["package"])
    for line in report(r):
        print(f"[bench_reorder] {line}", flush=True)
    result = {"bench_reorder": {"card": card(), **r}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return result


def report(r: dict) -> list[str]:
    """Readable lines of a :func:`compare` result."""
    lines = [f"one commit at S={RING} W={WIDTH} f32, K={BATCH} ({r['accepted_and_emitted']} "
             "accepted and emitted), graph replay, turns A B ... B A:"]
    for n, ms in r["ms"].items():
        turns = " / ".join(f"{t:.5f}" for t in r["turns_ms"][n])
        lines.append(f"  {n} ({r['launches_per_call'][n]} launch(es) a commit): {ms:.5f} ms "
                     f"(turns {turns})")
    for n, split in r["three_launch_split_ms"].items():
        parts = ", ".join(f"{p} {t:.5f} ms" for p, t in split.items())
        lines.append(f"  {n}, its launches alone: {parts}; sum {sum(split.values()):.5f} ms, "
                     f"the rest of its commit {r['ms'][n] - sum(split.values()):.5f} ms")
    return lines


if __name__ == "__main__":
    main()
