"""Ordered serving engine: continuous batching + ordered egress (port of
``repro.serve.engine``).

Requests arrive with serial numbers; decode completes out of order (variable
generation lengths); egress preserves arrival order through the paper's
non-blocking reorder ring.  Each iteration the engine chooses between a
prefill and a decode step, under the ``interleave`` or ``prefill_first``
schedule.

Where the port differs from the JAX engine: the cache (k/v for attention
layers, the ssm and conv states for mamba layers) and the slot token vector
live on ``device`` and are updated in place (prefill installs each leaf with
``copy_``, decode writes into the cache), instead of being replaced by new
arrays every step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..core.reorder import NonBlockingReorderBuffer, ParkingReorderBuffer
from ..core.serial import SerialAssigner
from ..models import transformer
from ..models.common import ModelConfig


@dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    serial: int = 0
    submitted_at: float = 0.0


@dataclass
class Completion:
    serial: int
    tokens: np.ndarray
    latency_s: float = 0.0


class OrderedServingEngine:
    """Continuous-batching model server with ordered completions.

    Requests share ``max_slots`` decode slots (admitted in serial order);
    completions egress through a serial-number reorder ring, so callers see
    results in submission order regardless of per-request decode length.
    Runs on ``device`` (default ``cuda``; raises without a card unless the
    caller passes ``device="cpu"``), where ``params`` must already lie."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_slots: int = 4,
        max_len: int = 96,
        schedule: str = "interleave",  # or "prefill_first" (micro-batch style)
        eos_token: int = -1,
        reorder_size: int = 256,
        device=None,
    ):
        self.device = default_device(device)
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.schedule = schedule
        self.eos = eos_token

        self._serials = SerialAssigner()
        self.pending: list[Request] = []
        self.completions: list[Completion] = []
        # Parking wrapper: a slow head-of-line request can hold ``next`` back
        # while more than reorder_size later requests complete. The engine is
        # single threaded, so spinning in send_blocking would livelock —
        # out-of-window completions park host-side and drain as the ring
        # window advances.
        self._reorder = ParkingReorderBuffer(
            NonBlockingReorderBuffer(self._emit, size=reorder_size)
        )

        # slot state (host-side bookkeeping; device-side cache batch = slots)
        self.slot_serial = [-1] * max_slots
        self.slot_generated: list[list[int]] = [[] for _ in range(max_slots)]
        self.slot_budget = [0] * max_slots
        self.slot_t0 = [0.0] * max_slots
        self.position = np.zeros((max_slots,), np.int32)
        self.cache = transformer.init_cache(cfg, max_slots, max_len, self.device)
        self.tokens = torch.zeros((max_slots,), dtype=torch.long, device=self.device)
        self.active = np.zeros((max_slots,), bool)
        self.stats = {"prefills": 0, "decode_steps": 0, "emitted": 0}

    # ------------------------------------------------------------ model calls
    def _prefill1(self, params, tokens: torch.Tensor):
        return transformer.prefill(self.cfg, params, tokens, max_len=self.max_len)

    def _decode(self, params, tokens: torch.Tensor, cache, position: torch.Tensor):
        logits, cache = transformer.decode_step(self.cfg, params, tokens, cache, position)
        return logits.argmax(-1), cache

    # ------------------------------------------------------------------ api
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        """Enqueue a prompt; returns its serial (completion order)."""
        serial = self._serials.next()
        self.pending.append(
            Request(np.asarray(prompt, np.int32), max_new_tokens, serial, time.perf_counter())
        )
        return serial

    def _emit(self, completion: Completion) -> None:
        self.completions.append(completion)
        self.stats["emitted"] += 1

    # ------------------------------------------------------------- internals
    def _free_slot(self) -> Optional[int]:
        for b in range(self.max_slots):
            if not self.active[b]:
                return b
        return None

    @torch.no_grad()
    def _do_prefill(self) -> None:
        req = self.pending.pop(0)
        b = self._free_slot()
        assert b is not None
        prompt = torch.from_numpy(req.prompt[None, :]).to(self.device, torch.long)
        logits, cache1 = self._prefill1(self.params, prompt)
        first = int(logits[0].argmax())
        # install the request's cache into slot b (prefill->decode hand-off):
        # every leaf, k/v or the ssm and conv states, is (nP, batch, ...)
        for si, slot in self.cache.items():
            for name, c in slot.items():
                c[:, b].copy_(cache1[si][name][:, 0])
        self.tokens[b] = first
        self.position[b] = len(req.prompt)
        self.slot_serial[b] = req.serial
        self.slot_generated[b] = [first]
        self.slot_budget[b] = req.max_new_tokens - 1
        self.slot_t0[b] = req.submitted_at
        self.active[b] = True
        self.stats["prefills"] += 1

    @torch.no_grad()
    def _do_decode(self) -> None:
        # ``self.position`` is a host buffer mutated in place below (and by
        # ``_do_prefill``).  ``torch.from_numpy`` aliases it, and a host->device
        # copy from it may still be in flight when the host mutates it, so the
        # decode would read a *later* position.  A fresh copy per call is
        # never mutated.
        position = torch.from_numpy(self.position.copy()).to(self.device)
        next_tok, self.cache = self._decode(self.params, self.tokens, self.cache, position)
        self.tokens = next_tok
        self.position += self.active.astype(np.int32)
        self.stats["decode_steps"] += 1
        toks = next_tok.cpu().numpy().reshape(-1)
        for b in range(self.max_slots):
            if not self.active[b]:
                continue
            self.slot_generated[b].append(int(toks[b]))
            self.slot_budget[b] -= 1
            done = (
                self.slot_budget[b] <= 0
                or int(toks[b]) == self.eos
                or self.position[b] >= self.max_len - 1
            )
            if done:
                comp = Completion(
                    self.slot_serial[b],
                    np.asarray(self.slot_generated[b], np.int32),
                    time.perf_counter() - self.slot_t0[b],
                )
                # ordered egress: the reorder buffer holds it until all
                # earlier-arrived requests have been emitted; out-of-window
                # completions park (never spin) and drain on later sends
                self._reorder.send(comp.serial, comp)
                self.active[b] = False
                self.slot_serial[b] = -1

    # ------------------------------------------------------------------ run
    def step(self) -> bool:
        """One scheduler decision. Returns False when fully idle."""
        can_prefill = self.pending and self._free_slot() is not None
        can_decode = self.active.any()
        if not can_prefill and not can_decode:
            return False
        if self.schedule == "prefill_first":
            if can_prefill:
                self._do_prefill()
            else:
                self._do_decode()
        else:  # interleave: keep the decode pipeline flowing (CT-style)
            if can_decode and (self.stats["decode_steps"] == 0 or not can_prefill):
                self._do_decode()
            elif can_prefill and self.active.sum() < self.max_slots:
                self._do_prefill()
            else:
                self._do_decode()
        return True

    def run_to_completion(self, max_steps: int = 100_000) -> list[Completion]:
        """Step until every submitted request completed; returns the
        completions drained so far, in serial order."""
        steps = 0
        while self.step():
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine did not converge")
        return self.completions
