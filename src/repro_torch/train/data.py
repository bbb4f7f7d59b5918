# Port copy of src/repro/train/data.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Ordered training data pipeline (paper §3 serial numbers as replay cursor).

Batches carry a monotone global serial; the checkpoint stores the cursor so a
restart (possibly on a different mesh size — elastic) resumes exactly-once.
The pipeline itself is a linear ordered stream: generate -> pack -> batch,
deterministic given (seed, serial).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class OrderedTokenPipeline:
    """Synthetic LM stream: per-batch deterministic generation keyed by the
    batch serial, so any worker on any topology produces identical batches in
    identical order — ordered processing for the input pipeline."""

    def __init__(self, cfg: DataConfig, start_serial: int = 0):
        self.cfg = cfg
        self.serial = start_serial

    def _batch_for(self, serial: int) -> dict:
        rng = np.random.RandomState((self.cfg.seed * 1_000_003 + serial) % (2**31))
        B, S, V = self.cfg.global_batch, self.cfg.seq_len, self.cfg.vocab_size
        # Markov-ish synthetic text: mixture of a few token bigram chains
        base = rng.randint(0, V, size=(B, 1))
        steps = rng.randint(1, 17, size=(B, S))
        toks = (np.cumsum(steps, axis=1) + base) % V
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = tokens[:, 0]
        return {"tokens": tokens, "labels": labels, "serial": serial}

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self._batch_for(self.serial)
        self.serial += 1
        return batch

    def cursor(self) -> int:
        return self.serial

    def seek(self, serial: int) -> None:
        self.serial = serial
