"""K1's routes through the device stage, on the card.

  PYTHONPATH=src python -m repro_torch.launch.bench_affine \\
      [--parent build/parent/src/repro_torch/kernels/affine/csrc/affine.cu] \\
      [--source OTHER/affine.cu ...] [--json PATH]

At the stream's device batch (:data:`ROWS` rows x :data:`WIDTH` ``i8``
columns, dev0's ``a=3, b=-1``; values from a seed), holds every route's
result to the plain version bit for bit, then times each by CUDA-graph
replay and eagerly (back-to-back calls, host work included).  In turns
(A B C C B A):

- ``parent`` (where ``--parent`` names the earlier K1 source, whose C entry
  takes the columns' arrays on every call, built beside the package's):
  the earlier route of a batch, the copy of the pinned
  staging buffer to the card, that K1 on the card's memory, a copy back;
- ``stage``: the device stage's route, the copy in, then the package's K1
  writing the pinned output buffer over PCIe;
- ``pinned``: the package's K1 reading the pinned staging buffer and
  writing the pinned output buffer, in one launch (measured, not shipped:
  the SMs read host memory slower than the copy engine).

Then once each: ``kernel`` (K1 from the card's memory into the pinned
output, as the main path launches it), ``read_pinned`` (K1 from the pinned
buffer into the card's memory), ``device`` (K1 on the card's memory), the
copy in alone, the two copies one after the other and at once on two
streams, and the plain version and ``torch.add(b, x, alpha=a)`` on each
column (a yardstick only; the port never calls it) from the card's memory
into the pinned output.  Each ``--source`` (another build of the package's
K1) is timed pinned to pinned in the turns, and as ``kernel`` after them.

Bounds: a route that crosses the link, the bytes of one direction over the
per-direction PCIe rate of the link's generation and width
(``nvidia-smi --query-gpu=pcie.link.gen.max,pcie.link.width.max``; else
sysfs; else the H100 SXM's Gen5 x16); ``device``, 2 x bytes over the HBM
rate.  Prints the card's name and power limit, the times, and last a JSON
line, also written to ``--json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.affine import affine as k1
from repro_torch.kernels.affine.ref import Layout, Scalars, affine_staged_ref, on_device
from repro_torch.kernels.parity import affine_column, bits_equal, staging_buffer
from repro_torch.launch.timing import graph_time_ms, time_ms

ROWS, WIDTH, A, B = 16384, 12, 3, -1  # the stream's batch, dev0's parameters
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# PCIe transfer rate per lane (GT/s) and line code, by generation
_PCIE = {1: (2.5, 8 / 10), 2: (5.0, 8 / 10), 3: (8.0, 128 / 130), 4: (16.0, 128 / 130),
         5: (32.0, 128 / 130)}
# the earlier K1's C entry: src, dst, ncols, offsets, rows, codes, ai, bi,
# af, bf, af32, bf32, a_float, b_float
_PARENT_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ctypes.POINTER(ctypes.c_int),
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
)


def smi(query: str) -> list[str]:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [f.strip() for f in out.strip().splitlines()[0].split(",")]


def card() -> str:
    return ", ".join(smi("name,power.limit"))


def _sysfs_link() -> tuple[int, int] | None:
    """Generation and width of the card's link from the PCI device's
    ``max_link_speed`` and ``max_link_width`` in sysfs, where readable."""
    bus = smi("pci.bus_id")[0].lower()  # 00000000:19:00.0
    dev = Path("/sys/bus/pci/devices") / f"{bus[-12:]}"
    try:
        speed = float((dev / "max_link_speed").read_text().split()[0])
        width = int((dev / "max_link_width").read_text())
    except (OSError, ValueError, IndexError):
        return None
    gen = next((g for g, (gts, _) in _PCIE.items() if abs(gts - speed) < 0.1), None)
    return (gen, width) if gen else None


def link() -> dict:
    """The card's PCIe link at its best (generation and width) and its rate
    each way, in bytes per second.  ``source`` says where the generation and
    width came from: ``nvidia-smi``; else sysfs; else, where neither reports
    them (as on a machine that hides the link), the H100 SXM data sheet's
    PCIe Gen5 x16."""
    fields = smi("pcie.link.gen.max,pcie.link.width.max")
    if all(f.isdigit() for f in fields):
        (gen, width), source = (int(f) for f in fields), "nvidia-smi"
    elif (found := _sysfs_link()) is not None:
        (gen, width), source = found, "sysfs"
    else:
        (gen, width), source = (5, 16), "data sheet (nvidia-smi: " + ", ".join(fields) + ")"
    gts, code = _PCIE[gen]
    return {"gen": gen, "width": width, "bytes_per_s": gts * 1e9 * code * width / 8,
            "source": source}


def parent_kernel(source: Path, layout: Layout, a, b):
    """``fn(src, dst)``: the earlier K1 built from ``source`` on the card's
    memory, its arguments prepared once."""
    fn = _build.entry(source, "affine_launch", _PARENT_ARGTYPES)
    if any(off % 16 for off in layout.offsets):
        raise ValueError("the earlier K1 takes columns at 16-byte offsets")
    n = layout.width
    s = Scalars.of(a, b)
    args = (n, (ctypes.c_longlong * n)(*layout.offsets),
            (ctypes.c_longlong * n)(*([layout.rows] * n)), (ctypes.c_int * n)(*layout.codes),
            k1._as_int64(s.a), k1._as_int64(s.b), s.af, s.bf, s.af32, s.bf32,
            int(s.a_float), int(s.b_float))
    dev = torch.device("cuda", torch.cuda.current_device())

    def call(src, dst):
        _build.launch(fn, dev, src.data_ptr(), dst.data_ptr(), *args)
    return call


def source_kernel(source: Path, layout: Layout, a, b):
    """``fn(src, dst)``: another build of the package's K1 (its C entry),
    launched with no checks."""
    fn = _build.entry(source, "affine_launch", k1._ARGTYPES, k1._CONSTANTS)
    desc = ctypes.byref(k1.descriptor(layout.codes, a, b))
    dev = torch.device("cuda", torch.cuda.current_device())

    def call(src, dst):
        _build.launch(fn, dev, src.data_ptr(), dst.data_ptr(), layout.rows, layout.nbytes, desc,
                      None, None)
    return call


def compare(parent: Path | None = None, sources=(), seed: int = 0) -> dict:
    """Every route at the stream's batch: checked against the plain version,
    then timed (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    cols = [torch.from_numpy(affine_column(torch.int64, ROWS, rng, False)) for _ in range(WIDTH)]
    layout = Layout.of([c.dtype for c in cols], ROWS)
    n = layout.nbytes
    staged = layout.stage(cols)
    cuda = torch.device("cuda", torch.cuda.current_device())
    # the device stage's buffers: pinned in and out, the card's copy of the
    # input; and the card's output buffer and a pinned one of the parent's
    host_in, host_out = staging_buffer(n, "pinned"), staging_buffer(n, "pinned")
    dev_in, dev_out = staging_buffer(n, "device"), staging_buffer(n, "device")
    copy_out = staging_buffer(n, "pinned")
    host_in.copy_(staged)
    dev_in.copy_(staged)
    want = affine_staged_ref(dev_in, layout, A, B, torch.empty_like(dev_in))
    mapped_out = on_device(host_out, cuda)
    side = torch.cuda.Stream()

    def copy_in():
        dev_in.copy_(host_in, non_blocking=True)

    def plain():  # the plain version of the kernel on the main path
        affine_staged_ref(dev_in, layout, A, B, mapped_out)

    def library():
        for j in range(layout.width):
            torch.add(B, layout.column(dev_in, j), alpha=A, out=layout.column(mapped_out, j))

    def both_copies():  # the copy in and a copy out at once, on two streams
        cur = torch.cuda.current_stream()
        side.wait_stream(cur)
        copy_in()
        with torch.cuda.stream(side):
            copy_out.copy_(dev_out, non_blocking=True)
        cur.wait_stream(side)

    routes = {
        "stage": lambda: (copy_in(), k1.affine_fwd(dev_in, layout, A, B, host_out)),
        "pinned": lambda: k1.affine_fwd(host_in, layout, A, B, host_out),
        "kernel": lambda: k1.affine_fwd(dev_in, layout, A, B, host_out),
        "read_pinned": lambda: k1.affine_fwd(host_in, layout, A, B, dev_out),
        "device": lambda: k1.affine_fwd(dev_in, layout, A, B, dev_out),
        "copy_in": copy_in,
        "copies": lambda: (copy_in(), copy_out.copy_(dev_out, non_blocking=True)),
        "copies_concurrent": both_copies,
        "plain": plain,
        "library": library,
    }
    # where each route writes its result, where not into host_out
    outputs = {"read_pinned": dev_out, "device": dev_out, "parent": copy_out}
    if parent is not None:
        old = parent_kernel(parent, layout, A, B)
        routes["parent"] = lambda: (copy_in(), old(dev_in, dev_out),
                                    copy_out.copy_(dev_out, non_blocking=True))
    for path in sources:
        other = source_kernel(path, layout, A, B)
        routes[f"pinned {path.name}"] = functools.partial(other, host_in, host_out)
        routes[f"kernel {path.name}"] = functools.partial(other, dev_in, host_out)
    errs = {}
    for name, fn in routes.items():
        if name.startswith("cop"):
            continue
        for buf in (host_out, dev_out, copy_out):
            buf.zero_()
        fn()
        torch.cuda.synchronize()
        got = outputs.get(name, host_out).cuda()
        same = bits_equal(got, want)
        errs[name] = 0.0 if same else max(float(
            (got.view(torch.int64).double() - want.view(torch.int64).double()).abs().max()), 1.0)
        if not same and name != "library":  # torch.add is a yardstick, held to nothing
            raise RuntimeError(f"K1's {name} route differs from the plain version")
    turns = (["parent"] if parent is not None else []) + ["stage", "pinned"] + [
        f"pinned {path.name}" for path in sources]
    graph = {r: [] for r in routes}
    eager = {r: [] for r in routes}
    for r in turns + turns[::-1] + [r for r in routes if r not in turns]:  # A B B A, then the rest
        graph[r].append(graph_time_ms(routes[r]))
        eager[r].append(time_ms(routes[r], iters=200))
    ln = link()
    bounds = {"pcie": n / ln["bytes_per_s"] * 1e3, "hbm": 2 * n / HBM_BYTES_PER_S * 1e3}
    return {"rows": ROWS, "width": WIDTH, "nbytes": n, "a": A, "b": B, "link": ln,
            "bound_ms": bounds, "max_abs_err": errs,
            "graph_ms": {r: sum(t) / len(t) for r, t in graph.items()}, "graph_turns_ms": graph,
            "eager_ms": {r: sum(t) / len(t) for r, t in eager.items()}, "eager_turns_ms": eager}


def report(r: dict) -> list[str]:
    """Readable lines of a :func:`compare` result."""
    ln, bd = r["link"], r["bound_ms"]
    lines = [f"one batch: {r['rows']} rows x {r['width']} i8 ({r['nbytes']} B each way), "
             f"a={r['a']} b={r['b']}; PCIe gen {ln['gen']} x{ln['width']} ({ln['source']}), "
             f"{ln['bytes_per_s'] / 1e9:.2f} GB/s each way: bound {bd['pcie']:.5f} ms (every "
             f"route that crosses the link); HBM bound (device) {bd['hbm']:.5f} ms"]
    for name in r["graph_ms"]:
        g = " / ".join(f"{t:.5f}" for t in r["graph_turns_ms"][name])
        e = " / ".join(f"{t:.5f}" for t in r["eager_turns_ms"][name])
        bound = bd["hbm"] if name == "device" else bd["pcie"]
        share = (f", {bound / r['graph_ms'][name]:.4f} of its bound"
                 if not name.startswith("cop") else "")
        lines.append(f"  {name}: graph replay {r['graph_ms'][name]:.5f} ms (turns {g}){share}; "
                     f"eager {r['eager_ms'][name]:.5f} ms (turns {e}); max|err| "
                     f"{r['max_abs_err'].get(name, 0.0)}")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="an earlier K1 source (its C entry takes the columns' arrays) to time "
                         "its route (copy in, K1, copy out) beside")
    ap.add_argument("--source", action="append", default=[],
                    help="another build of the package's K1 (its C entry) to time beside it")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_affine: needs an NVIDIA GPU")
    print(card(), flush=True)
    r = compare(Path(args.parent).resolve() if args.parent else None,
                [Path(p).resolve() for p in args.source])
    for line in report(r):
        print(f"[bench_affine] {line}", flush=True)
    result = {"bench_affine": {"card": card(), **r}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
