"""K5 against other builds of itself, on the card.

  PYTHONPATH=src python -m repro_torch.launch.bench_ssd \\
      [--source package] [--source OTHER/ssd.cu ...] [--json PATH]

At mamba2-780m's widths (:data:`MAIN`: B=1, L=2,048, H=48, P=64, N=128,
chunk 256, f32 ``x``; inputs drawn on the card from a seed as the reference
test draws them), holds each source's K5 to ``ssd_scan_ref`` within
``parity.SSD_TOL`` (``parity.ssd_close``), then times them in turns (A B
... B A), by CUDA-graph replay and eagerly (back-to-back calls, the
wrapper's host work included).  ``package`` is the package's ``ssd.cu``;
another source may be a chunk-parallel K5 (``ssd_launches_per_call()`` in
its library, the package's C entry) or the one-launch kernel from before it
(no such function; its C entry takes no scratch).  Each launch of a
chunk-parallel source (chunk states, state passing, chunk outputs) is also
timed alone by graph replay, through its ``ssd_launch_step`` entry.  Prints
the card's name and power limit, the times, and last a JSON line, also
written to ``--json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.parity import SSD_TOL, ssd_close
from repro_torch.kernels.ssd import ssd as k5
from repro_torch.kernels.ssd.ref import ssd_scan_ref
from repro_torch.launch.timing import card, graph_time_ms, time_ms

MAIN = (1, 2048, 48, 64, 128, 256)  # mamba2-780m: B, L, H, P, N, chunk
STEPS = ("chunk states", "state passing", "chunk outputs")
# the one-launch entry: x, dt, A, Bm, Cm, y, hT; B, L, H, P, N, chunk, x_bf16
_ONE_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7


def inputs(B, L, H, P, N, gen: torch.Generator):
    """The reference test's draw on the card: x, softplus dt, negative A, B
    and C x 0.3, all float32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (randn(B, L, H, P), torch.nn.functional.softplus(randn(B, L, H)),
            -torch.exp(randn(H) * 0.3), randn(B, L, N) * 0.3, randn(B, L, N) * 0.3)


def launches_per_call(source: Path) -> int:
    lib = _build.load(source)
    return lib.ssd_launches_per_call() if hasattr(lib, "ssd_launches_per_call") else 1


def source_scan(source: Path):
    """A scan through ``source``'s C entry with the package's signature:
    (x, dt, A, Bm, Cm, chunk) -> (y, hT)."""
    if launches_per_call(source) > 1:
        fn = _build.entry(source, "ssd_launch", k5._ARGTYPES)

        def call(x, dt, A, Bm, Cm, chunk):
            y, hT, (args, _keep) = k5.launch_args(x, dt, A, Bm, Cm, chunk)
            _build.launch(fn, x.device, *args)
            return y, hT
        return call
    fn = _build.entry(source, "ssd_launch", _ONE_ARGTYPES)

    def call_one(x, dt, A, Bm, Cm, chunk):
        k5.check_inputs(x, dt, A, Bm, Cm, chunk)
        B, L, H, P = x.shape
        N = Bm.shape[-1]
        y = torch.empty_like(x)
        hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        _build.launch(fn, x.device, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                      Cm.data_ptr(), y.data_ptr(), hT.data_ptr(), B, L, H, P, N, chunk,
                      k5._X_DTYPES[x.dtype])
        return y, hT
    return call_one


def steps_alone(source: Path, args, chunk: int) -> dict:
    """Each launch of a chunk-parallel ``source`` alone, by graph replay, on
    scratch that a whole scan has filled first."""
    fn = _build.entry(source, "ssd_launch_step", (ctypes.c_int,) + k5._ARGTYPES)
    y, hT, (cargs, keep) = k5.launch_args(*args, chunk)
    dev = args[0].device
    for step in range(len(STEPS)):
        _build.launch(fn, dev, step, *cargs)
    return {name: graph_time_ms(lambda: _build.launch(fn, dev, step, *cargs), iters=50)  # noqa: B023
            for step, name in enumerate(STEPS)}


def compare(sources, gen: torch.Generator | None = None, shape=MAIN) -> dict:
    """Each of ``sources`` (``package`` or a path) at ``shape``: within
    SSD_TOL of ``ssd_scan_ref``, then graph-replay and eager times in turns
    (A B ... B A), and each chunk-parallel source's launches alone."""
    gen = gen or torch.Generator(device="cuda").manual_seed(17)
    B, L, H, P, N, chunk = shape
    args = inputs(B, L, H, P, N, gen)
    paths = {str(n): (k5.SOURCE if str(n) == "package" else Path(n).resolve()) for n in sources}
    scans = {n: (k5.ssd_fwd if n == "package" else source_scan(p)) for n, p in paths.items()}
    want = ssd_scan_ref(*args, chunk)
    errs = {}
    for name, scan in scans.items():
        ok, errs[name] = ssd_close(scan(*args, chunk), want, SSD_TOL)
        if not ok:
            raise RuntimeError(f"{name} K5 disagrees with ssd_scan_ref at {shape}: "
                               f"max|err| {errs[name]:.3g}")
    names = list(scans)
    graph = {n: [] for n in names}
    eager = {n: [] for n in names}
    for n in names + names[::-1]:
        graph[n].append(graph_time_ms(lambda: scans[n](*args, chunk), iters=20))  # noqa: B023
        eager[n].append(time_ms(lambda: scans[n](*args, chunk), iters=20, warmup=2))  # noqa: B023
    alone = {n: steps_alone(p, args, chunk) for n, p in paths.items() if launches_per_call(p) > 1}
    return {"shape": list(shape), "max_abs_err": errs,
            "graph_ms": {n: sum(t) / len(t) for n, t in graph.items()}, "graph_turns_ms": graph,
            "eager_ms": {n: sum(t) / len(t) for n, t in eager.items()}, "eager_turns_ms": eager,
            "launches_per_call": {n: launches_per_call(p) for n, p in paths.items()},
            "steps_alone_ms": alone}


def report(r: dict) -> list[str]:
    """Readable lines of a :func:`compare` result."""
    lines = [f"one scan at B,L,H,P,N,chunk={tuple(r['shape'])} f32, turns A B ... B A:"]
    for n in r["graph_ms"]:
        g = " / ".join(f"{t:.5f}" for t in r["graph_turns_ms"][n])
        e = " / ".join(f"{t:.5f}" for t in r["eager_turns_ms"][n])
        lines.append(f"  {n} ({r['launches_per_call'][n]} launch(es) a scan, max|err| "
                     f"{r['max_abs_err'][n]:.3g}): graph replay {r['graph_ms'][n]:.5f} ms "
                     f"(turns {g}); eager {r['eager_ms'][n]:.5f} ms (turns {e})")
    for n, steps in r["steps_alone_ms"].items():
        parts = ", ".join(f"{s} {t:.5f} ms" for s, t in steps.items())
        lines.append(f"  {n}, its launches alone (graph replay): {parts}; sum "
                     f"{sum(steps.values()):.5f} ms")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=None,
                    help="a K5 source to time; 'package' is the package's (default)")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssd: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    r = compare(args.source or ["package"])
    for line in report(r):
        print(f"[bench_ssd] {line}", flush=True)
    result = {"bench_ssd": {"card": card(), **r}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
