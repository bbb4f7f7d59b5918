"""The one generator of the benchmark's traffic, driven by a mix's data file
(``traffic/<mix>.json``).

A serving mix gives lognormal prompt and output lengths (median, sigma,
clipped to [min, max]) and a block size.  The lengths do not depend on the
seed: one block holds the ``block`` quantiles (i + 0.5) / block of each
distribution, prompts and outputs paired by a fixed shuffle, each prompt
cut to the cell's context less the output it asks for (as a deployment
truncates what does not fit its model's context), and every block
of the stream holds that same set in an order of its own, drawn from a fixed
seed.  The seed draws the prompts' tokens.  So every seed asks for the same
work in the same order, and runs of different seeds differ by the data and
the clock alone.

A training mix gives the batch (rows, sequence length); its rows follow the
repository's synthetic ordered token stream (a copy of its generator: each
row a random start and steps of 1-16 through the vocabulary, labels the next
token), keyed by the seed and the batch's serial.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 0.5) / n of a clipped lognormal, as whole numbers."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def block_lengths(mix: dict, max_len: int) -> np.ndarray:
    """(block, 2) prompt and output lengths of one block, seed-free; each
    prompt at most ``max_len`` less its output."""
    n = mix["block"]
    prompt = quantile_lengths(mix["prompt"], n)
    output = quantile_lengths(mix["output"], n)[np.random.default_rng(0).permutation(n)]
    return np.stack([np.minimum(prompt, max_len - output), output], axis=1)


@dataclass
class Request:
    index: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    submitted_at: float = 0.0  # the engine's clock at submit


class RequestSource:
    """Requests in a fixed order drawn from the seed: ``next()`` gives the
    next one.  Two sources of one mix and seed give the same sequence."""

    def __init__(self, mix: dict, seed: int, vocab_size: int, max_len: int):
        self.lengths = block_lengths(mix, max_len)
        self.shuffle = np.random.default_rng([0, 1])  # the blocks' orders: seed-free
        self.rng = np.random.default_rng([seed, 1])
        self.vocab = vocab_size
        self.order: list = []
        self.count = 0

    def next(self) -> Request:
        if not self.order:
            self.order = list(self.shuffle.permutation(len(self.lengths)))
        s, out = self.lengths[self.order.pop(0)]
        prompt = self.rng.integers(0, self.vocab, size=int(s), dtype=np.int32)
        req = Request(self.count, prompt, int(out))
        self.count += 1
        return req


def train_batch(mix: dict, vocab_size: int, seed: int, serial: int) -> dict:
    """Batch ``serial`` of the synthetic stream: {"tokens", "labels"} (B, S) int32."""
    rng = np.random.default_rng([seed, 2, serial])
    B, S, V = mix["batch"], mix["seq_len"], vocab_size
    base = rng.integers(0, V, size=(B, 1))
    steps = rng.integers(1, 17, size=(B, S))
    tokens = ((np.cumsum(steps, axis=1) + base) % V).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = tokens[:, 0]
    return {"tokens": tokens, "labels": labels}
