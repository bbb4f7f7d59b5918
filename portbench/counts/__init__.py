"""Operations and bytes from shapes, and the card's peaks (``peaks.json``).

A kernel's bound is the larger of its operations over the bf16 peak and its
bytes over the memory's peak, each input byte read once and each output byte
written once.  A family's module (``families/``) counts its model's FLOPs
and puts its kernels' calls together from these.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def k4(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int, itemsize: int = 2):
    """(flops, bytes) of one causal K4 forward: q, k, v read, o written; the
    product q k^T and the weighted sum of v over the keys at or before each
    query (S (S + 1) / 2 pairs a head)."""
    pairs = batch * heads * seq * (seq + 1) / 2
    flops = 4 * pairs * head_dim
    nbytes = itemsize * batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    return flops, nbytes


def k3(tokens: int, top_k: int, experts: int, width: int, itemsize: int = 2):
    """(0, bytes) of one K3 dispatch of ``tokens`` rows, ``top_k`` assignments
    each, none dropped: the ids read, each token's row read once, each
    assignment's row written once (the buffers' empty rows are not counted),
    the counts and the destinations written."""
    T = tokens * top_k
    nbytes = T * 4 + tokens * width * itemsize + T * width * itemsize + experts * 4 + T * 4
    return 0.0, nbytes
