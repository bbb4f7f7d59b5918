"""K4 against other builds of itself, the plain version and SDPA, on the card.

  PYTHONPATH=src python -m repro_torch.launch.bench_flash \\
      [--source package] [--source OTHER/flash_fwd.cu ...] [--json PATH]

Builds each ``--source`` (``package``, the default, is the package's
``kernels/attention/csrc/flash_fwd.cu``; any other path is another K4 source
with the same C entry ``flash_fwd``, for example an earlier commit's), holds
each to ``attention_ref`` at olmo-1b's served prefill shapes (B=1,
H=Hkv=16, Dh=128, bf16, causal; 2e-2), then times each by CUDA-graph replay
at every served prompt length, the sources in turns (A B B A), beside the
plain version and ``scaled_dot_product_attention`` (a yardstick the port
never calls), with each source's eager call time.  Prints the card's name
and power limit, a line per length, and last a JSON line, also written to
``--json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.launch.profile_serve import PROMPT_LENS
from repro_torch.launch.timing import graph_time_ms, time_ms

H, DH, DTYPE = 16, 128, torch.bfloat16
TOL = 2e-2


def _kernel(source: Path):
    """A call of ``source``'s C entry: (q, k, v) -> o, causal."""
    fn = _build.entry(source, "flash_fwd", flash._ARGTYPES)

    def call(q, k, v):
        o = torch.empty_like(q)
        _build.launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                      flash._DTYPE_CODES[q.dtype], 1)
        return o
    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=None,
                    help="a K4 source to time; 'package' is the package's (default)")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.source or ["package"]
    sources = {n: (flash.SOURCE if n == "package" else Path(n).resolve()) for n in names}
    kernels, failed = {}, []
    for n, src in sources.items():
        try:
            kernels[n] = _kernel(src)
        except RuntimeError as e:  # a source that does not build is reported, the rest timed
            print(f"[bench_flash] {n} does not build:\n{e}", flush=True)
            failed.append(n)
    names = [n for n in names if n in kernels]
    for n in names:
        for line in _build.ptxas_report(sources[n]):
            print(f"[build] {n}: {line}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turns = names + names[::-1]  # A B B A
    rows = []
    for S in sorted(set(PROMPT_LENS)):
        q, k, v = (torch.randn(1, S, H, DH, generator=gen, device="cuda").to(DTYPE)
                   for _ in range(3))
        ref = attention_ref(q, k, v, True)
        for n, call in kernels.items():
            err = float((call(q, k, v).float() - ref.float()).abs().max())
            if err > TOL:
                raise RuntimeError(f"{n} disagrees with attention_ref at S={S}: {err:.3g}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        graph = {n: [] for n in names}
        for n in turns:
            graph[n].append(graph_time_ms(lambda: kernels[n](q, k, v)))  # noqa: B023
        row = {
            "S": S,
            "kernel_ms": {n: sum(t) / len(t) for n, t in graph.items()},
            "kernel_turns_ms": graph,
            "eager_call_ms": {n: time_ms(lambda: kernels[n](q, k, v), iters=200)  # noqa: B023
                              for n in names},
            "plain_ms": graph_time_ms(lambda: attention_ref(q, k, v, True)),
            "sdpa_ms": graph_time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "sdpa_eager_call_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=200),
        }
        rows.append(row)
        mine = ", ".join(f"{n} {row['kernel_ms'][n]:.5f} ms (turns "
                         + " / ".join(f"{t:.5f}" for t in graph[n])
                         + f"; eager call {row['eager_call_ms'][n]:.5f})" for n in names)
        print(f"[bench_flash] S={S} graph replay: {mine}; plain {row['plain_ms']:.5f} ms; sdpa "
              f"{row['sdpa_ms']:.5f} ms (eager call {row['sdpa_eager_call_ms']:.5f})", flush=True)
    result = {"bench_flash": {"card": card, "shape": f"B=1 H=Hkv={H} Dh={DH} bf16 causal",
                              "sources": {n: str(s) for n, s in sources.items()}, "rows": rows}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    if failed:
        raise SystemExit(f"bench_flash: {', '.join(failed)} did not build")
    return result


if __name__ == "__main__":
    main()
