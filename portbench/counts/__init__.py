"""Operations and bytes from shapes, and the card's peaks (``peaks.json``).

A kernel's bound is the larger of its operations over the bf16 peak and its
bytes over the memory's peak, each input byte read once and each output byte
written once.  Model FLOPs count the products a token needs (2 per weight of
every linear layer it passes through, the output head included, the
embedding lookup not) and attention over the positions it really attends.
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


def linear_weights(model: dict) -> int:
    """Weights of the linear layers one token passes through (routed
    experts: top_k of them; the router and the output head included)."""
    D, H, n = model["d_model"], model["num_heads"], model["num_layers"]
    Dh = D // H
    attn = D * Dh * (2 * H + 2 * model["num_kv_heads"])
    if model.get("num_experts"):
        F = model["moe_d_ff"]
        ffn = 3 * D * F * (model["top_k"] + model["num_shared_experts"]) + D * model["num_experts"]
    else:
        ffn = 3 * D * model["d_ff"]
    return n * (attn + ffn) + D * model["vocab_size"]


def attention_flops(model: dict, positions: float) -> float:
    """Forward FLOPs of attention for query-key pairs summed over a token's
    positions: 4 x head width x heads a pair, in every layer."""
    return 4.0 * positions * model["d_model"] * model["num_layers"]


def prefill_flops(model: dict, seq: int) -> float:
    """A prompt of ``seq`` tokens through the model; the head at the last position."""
    body = linear_weights(model) - model["d_model"] * model["vocab_size"]
    return 2.0 * seq * body + 2.0 * model["d_model"] * model["vocab_size"] \
        + attention_flops(model, seq * (seq + 1) / 2)


def decode_flops(model: dict, positions) -> float:
    """One decode step of the active slots; ``positions`` their write indices."""
    return sum(2.0 * linear_weights(model) + attention_flops(model, p + 1) for p in positions)


def train_flops(model: dict, batch: int, seq: int) -> float:
    """One training step: 3 x the forward (no recomputation counted)."""
    return 3.0 * batch * (2.0 * seq * linear_weights(model)
                          + attention_flops(model, seq * (seq + 1) / 2))
