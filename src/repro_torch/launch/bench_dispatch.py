"""K3 on the card: the package's build beside another (the parent commit's),
and the MoE layer's two routes to its expert buffers.

  PYTHONPATH=src python -m repro_torch.launch.bench_dispatch \\
      [--parent build/parent/src/repro_torch/kernels/dispatch/csrc/dispatch.cu] [--json PATH]

Shapes (:data:`SHAPES`), inputs drawn on the card from seed 7:

- ``decode``: a qwen2-moe-a2.7b decode step with four slots: 4 tokens, top-4
  of 60 experts (T = 16), C = 4, d_model 2,048 bf16;
- ``prefill``: a 512-token qwen2-moe prefill (T = 2,048), C = 43;
- ``phi3.5 synthetic``: 4,096 tokens, top-2 of 16 experts (T = 8,192),
  C = 640, 4,096 bf16;
- ``skewed keyed``: a Zipf(1.1) keyed batch, T = 16,384, P = 64, C = 512,
  32 f32 (numpy seed 3), with -1s; hot partitions overflow.

MoE ids are the top-k of random router gates, token-major and choice minor,
as ``ffn.moe`` makes them; C is ``ffn.moe_capacity`` at factor 1.25.  For
each shape every build is held to ``dispatch_ref`` bit for bit, then timed
by CUDA-graph replay in turns (A B ... B A):

- K3 on the gathered payloads (group 1): the package's and the other
  source's;
- at the MoE shapes, the routes from the token rows ``h``: the other
  source's (``h[token_of]``, then its K3), the gather then the package's K3
  with group 1, and the package's K3 reading ``h`` itself (group k).

The plain ``dispatch_ref`` is timed once, and so is a kernel node with no
work to speak of (``zero_()`` of one element), the floor under any one
launch.  Each time is printed beside its
bound (:func:`dispatch_bound`): the fused route reads each kept token's row
once, a gathered one each kept assignment's.  Prints the card's name and
power limit, and last a JSON line, also written to ``--json``.  The other
source is a K3 with this package's C entry or the four-launch K3 from
before the one-launch design (:func:`source_dispatch`).  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import dispatch as k3
from repro_torch.kernels.dispatch.ref import dispatch_ref
from repro_torch.kernels.parity import bits_equal, zipf_ids
from repro_torch.launch.timing import card, graph_time_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
CAPACITY_FACTOR = 1.25  # ModelConfig's default, qwen2-moe's and phi3.5-moe's
# name -> (tokens, experts, top_k, width, dtype) of the MoE shapes
MOE_SHAPES = {
    "decode": (4, 60, 4, 2048, torch.bfloat16),
    "prefill": (512, 60, 4, 2048, torch.bfloat16),
    "phi3.5 synthetic": (4096, 16, 2, 4096, torch.bfloat16),
}
KEYED = {"skewed keyed": (16384, 64, 512, 32)}  # T, P, C, W f32
SHAPES = (*MOE_SHAPES, *KEYED)

# ids, T, payloads, row_bytes, P, C, buffers, counts, dest, local_rank,
# tile_hist, inv: the four-launch C entry from before the one-launch design
_FOUR_LAUNCH_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
)


def dispatch_bound(T, P, C, W, itemsize, rows_read) -> float:
    """Least time of one dispatch, in ms: the ids and the ``rows_read``
    payload rows that kept tuples need read once, the whole zero-filled
    buffers, counts and dest written once.  Bytes bound it."""
    nbytes = T * 4 + rows_read * W * itemsize + P * C * W * itemsize + P * 4 + T * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def rows_read(dest: torch.Tensor, group: int) -> int:
    """Distinct payload rows that the kept tuples (dest >= 0) read."""
    kept = torch.nonzero(dest >= 0).flatten()
    return int(torch.unique(kept // group).numel())


def moe_inputs(tokens, experts, top_k, width, dtype, gen):
    """(ids (tokens*k,) int32, h (tokens, width), C): the top-k of random
    router gates, token-major and choice minor."""
    gates = torch.randn(tokens, experts, generator=gen, device="cuda")
    ids = gates.topk(top_k, dim=1).indices.to(torch.int32).reshape(-1)
    h = torch.randn(tokens, width, generator=gen, device="cuda").to(dtype)
    cap = max(int(math.ceil(tokens * top_k / experts * CAPACITY_FACTOR)), 4)
    return ids, h, cap


def keyed_inputs(gen, name="skewed keyed"):
    T, P, C, W = KEYED[name]
    ids = torch.from_numpy(zipf_ids(np.random.RandomState(3), T, P)).cuda()
    return ids, torch.randn(T, W, generator=gen, device="cuda"), P, C


def source_dispatch(source: Path):
    """``(ids, payloads, P, C) -> (buffers, counts, dest)`` (group 1)
    through ``source``'s C entry, and its launches a call.  The entry is
    told by ``dispatch_launches_per_call()``: 4 is the four-launch K3 (no
    ``group``, scratch from the caller), anything else this package's
    entry."""
    launches = _build.load(source).dispatch_launches_per_call()
    four = launches == 4
    fn = _build.entry(source, "dispatch_launch", _FOUR_LAUNCH_ARGTYPES if four else k3._ARGTYPES)

    def call(ids, pay, P, C):
        T, W = pay.shape
        dev = pay.device
        i32 = dict(dtype=torch.int32, device=dev)
        outs = (torch.empty((P, C, W), dtype=pay.dtype, device=dev), torch.empty(P, **i32),
                torch.empty(T, **i32))
        ptrs = [t.data_ptr() for t in outs]
        if four:
            scratch = (torch.empty(T, **i32), torch.empty(-(-T // 256) * P, **i32),
                       torch.empty(P * C, **i32))
            args = (pay.data_ptr(), W * pay.element_size(), P, C, *ptrs,
                    *(t.data_ptr() for t in scratch))
        else:
            args = (pay.data_ptr(), 1, W * pay.element_size(), P, C, *ptrs)
        _build.launch(fn, dev, ids.data_ptr(), T, *args)
        return outs
    return call, launches


def compare_case(ids, h, P, C, group, other=None) -> dict:
    """One dispatch of ``ids`` over the rows ``h`` (tuple t takes row
    t // group), every build and route held to ``dispatch_ref`` bit for bit
    and timed in turns; ``other`` is a :func:`source_dispatch` pair."""
    T, W = ids.numel(), h.shape[1]
    pay = h.repeat_interleave(group, dim=0) if group > 1 else h  # the gathered rows
    token_of = torch.arange(T, device=h.device) // group
    want = dispatch_ref(ids, pay, P, C)
    kernels = {"K3": lambda: k3.dispatch_fwd(ids, pay, P, C)}
    launches = {"K3": k3.LAUNCHES_PER_CALL}
    if other is not None:
        kernels["other K3"] = lambda: other[0](ids, pay, P, C)
        launches["other K3"] = other[1]
    if group > 1:
        if other is not None:
            kernels["route: gather + other K3"] = lambda: other[0](ids, h[token_of], P, C)
            launches["route: gather + other K3"] = other[1]
        kernels["route: gather + K3"] = lambda: k3.dispatch_fwd(ids, h[token_of], P, C)
        kernels["route: K3 reads h (group k)"] = lambda: k3.dispatch_fwd(ids, h, P, C, group)
        launches["route: gather + K3"] = launches["route: K3 reads h (group k)"] = (
            k3.LAUNCHES_PER_CALL)
        if not all(bits_equal(a, b) for a, b in zip(dispatch_ref(ids, h, P, C, group), want)):
            raise RuntimeError("dispatch_ref with group differs from it on the gathered rows")
    for name, fn in kernels.items():
        if not all(bits_equal(a, b) for a, b in zip(fn(), want)):
            raise RuntimeError(f"{name} disagrees with dispatch_ref at T,P,C,W={T, P, C, W}")
    iters = 100 if T <= 2048 else 20
    names = list(kernels)
    turns = {n: [] for n in names}
    for n in names + names[::-1]:
        turns[n].append(graph_time_ms(kernels[n], iters=iters))
    plain_ms = graph_time_ms(lambda: dispatch_ref(ids, h, P, C, group), iters=iters)
    dest = want[2]
    size = h.element_size()
    return {
        "T": T, "P": P, "C": C, "W": W, "dtype": str(h.dtype)[6:], "group": group,
        "kept": int((dest >= 0).sum()), "max_count": int(want[1].max()),
        "ms": {n: sum(t) / len(t) for n, t in turns.items()}, "turns_ms": turns,
        "launches": launches, "plain_ms": plain_ms,
        "bound_ms": {"gathered": dispatch_bound(T, P, C, W, size, rows_read(dest, 1)),
                     "fused": dispatch_bound(T, P, C, W, size, rows_read(dest, group))},
    }


def compare(other: Path | None = None, shapes=SHAPES) -> dict:
    """:func:`compare_case` at each of ``shapes`` (:data:`SHAPES`), beside
    ``other``'s K3 where given."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    pair = source_dispatch(Path(other).resolve()) if other is not None else None
    one = torch.zeros(1, device="cuda")
    node_ms = graph_time_ms(one.zero_)
    out = {}
    for name in shapes:
        if name in MOE_SHAPES:
            tokens, experts, top_k, width, dtype = MOE_SHAPES[name]
            ids, h, C = moe_inputs(tokens, experts, top_k, width, dtype, gen)
            out[name] = compare_case(ids, h, experts, C, top_k, pair)
        else:
            ids, pay, P, C = keyed_inputs(gen, name)
            out[name] = compare_case(ids, pay, P, C, 1, pair)
    return {"other": str(other) if other is not None else None, "node_ms": node_ms,
            "shapes": out}


def report(r: dict) -> list[str]:
    """Readable lines of a :func:`compare` result."""
    lines = [f"graph replay, turns A B ... B A; other source: {r['other']}"]
    if "node_ms" in r:
        lines.append(f"a kernel node with no work (one-element zero_()): {r['node_ms']:.5f} ms")
    for name, c in r["shapes"].items():
        lines.append(f"{name}: T={c['T']} P={c['P']} C={c['C']} W={c['W']} {c['dtype']} "
                     f"group {c['group']}, {c['kept']} kept, largest count {c['max_count']}; "
                     f"bound {c['bound_ms']['gathered']:.5f} ms on the gathered rows, "
                     f"{c['bound_ms']['fused']:.5f} ms reading h; plain {c['plain_ms']:.5f} ms")
        for n, ms in c["ms"].items():
            bound = c["bound_ms"]["fused" if n.startswith("route") else "gathered"]
            turns = " / ".join(f"{t:.5f}" for t in c["turns_ms"][n])
            lines.append(f"  {n} ({c['launches'][n]} launch(es)): {ms:.5f} ms, share of "
                         f"bound {bound / ms:.4f} (turns {turns})")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="another K3 source to time beside the package's")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_dispatch: needs an NVIDIA GPU")
    print(card(), flush=True)
    r = compare(args.parent)
    for line in report(r):
        print(f"[bench_dispatch] {line}", flush=True)
    result = {"bench_dispatch": {"card": card(), **r}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
