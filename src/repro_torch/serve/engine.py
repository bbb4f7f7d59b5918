"""Ordered serving engine: continuous batching + ordered egress (port of
``repro.serve.engine``).

Requests arrive with serial numbers; decode completes out of order (variable
generation lengths); egress preserves arrival order through the paper's
non-blocking reorder ring.  Each iteration the engine chooses between a
prefill and a decode step, under the ``interleave`` or ``prefill_first``
schedule.

Where the port differs from the JAX engine: the cache (k/v for attention
layers, the ssm and conv states for mamba layers, both in a hybrid such as
jamba) and the slot token vector
live on ``device`` and are updated in place (prefill installs each leaf with
``copy_``, decode writes into the cache), instead of being replaced by new
arrays every step.

On the card and with no mesh in scope, the decode step is one CUDA graph: its
shapes are fixed for the engine's life (``max_slots`` tokens, a cache
``max_len`` long, updated in place), and nothing in it waits for the host.
The engine's first decode runs the step eagerly on a side stream (its
results are that step's) and captures it; each later decode refills the
positions and replays the graph, which reads the slots' tokens from the
``tokens`` the engine was built with and writes the next ones there, so a
prefill's install writes into what the next replay reads.  ``decode_replays`` counts the replays, and
the kernels' ``LAUNCHES`` counters advance on each by what the capture
launched.  On the CPU, under a mesh, or for a call with other params or
another cache than the engine's own, the step runs eagerly.  The graph and
its memory pool are the engine's, and go with it.

With the port's tracer on (``repro_torch.trace``) the engine records, each
decision, an ``engine.step`` span with an ``engine.prefill`` (the serial) or
``engine.decode`` child, and inside those ``engine.upload`` (prompt or
positions to the device), ``model.prefill``/``model.decode`` (the forward's
enqueue, or the graph's replay), ``engine.readback`` (waiting for the tokens
on the host), ``engine.install`` (the prefill's cache copies) and
``engine.bookkeep`` (the slots and the reorder ring's sends); the decode
step's capture as ``engine.capture``; each prefilled request's wait from its
submit as ``engine.queued``; and at each send the samples ``ring.held``, the
completions handed to the ring (``completed``, beside ``stats``, the JAX
engine's counters) and not yet emitted, and ``ring.parked``, those of them
parked past the ring's window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import default_device, trace
from ..core.reorder import NonBlockingReorderBuffer, ParkingReorderBuffer
from ..core.serial import SerialAssigner
from ..kernels.attention.ops import flash_attention
from ..kernels.dispatch.ops import dispatch
from ..kernels.ssd.ops import ssd
from ..models import transformer
from ..models.common import ModelConfig
from ..sharding.context import get_mesh

# the kernel wrappers whose ``LAUNCHES`` count a replay advances by what the
# graph's capture launched, as the eager step would have
_COUNTERS = (dispatch, ssd, flash_attention)


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
    caller passes ``device="cpu"``), where ``params`` must already lie.

    Raises ``ValueError`` for a config with a cross-attention (``xattn``)
    layer or ``kv_quant``: the JAX engine cannot serve either (its prefill
    passes no encoder states, ``repro/serve/engine.py:38-40``, and its
    prefill cache has no scale leaves for the int8 cache it allocates,
    ``:105-108`` against ``:145-147``), so there is nothing to hold a port
    of it to."""

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
        if cfg.has("xattn") or cfg.kv_quant:
            raise ValueError(
                f"{cfg.name}: the serving engine serves no cross-attention (xattn) or "
                "kv_quant config: its prefill passes no encoder states, and its prefill "
                "cache holds no scales for an int8 cache (as in the JAX engine)"
            )
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
        self.completed = 0  # completions handed to the reorder ring
        self.decode_replays = 0  # decode steps run as a replay of the captured graph
        self._graph = None  # the decode step as a CUDA graph, from the first decode
        self._launched = ()  # the counts of _COUNTERS the capture launched
        if self.device.type == "cuda":
            # what the graph reads its tokens and positions from (it writes
            # the next tokens over its input), and the pinned host buffer the
            # positions are copied from asynchronously
            self._graph_tokens = self.tokens
            self._position = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
            self._staging = torch.zeros((max_slots,), dtype=torch.int32, pin_memory=True)
            self._staged = torch.cuda.Event()  # recorded after each copy out of _staging

    # ------------------------------------------------------------ model calls
    def _prefill1(self, params, tokens: torch.Tensor):
        with trace.span("model.prefill"):
            return transformer.prefill(self.cfg, params, tokens, max_len=self.max_len)

    def _decode(self, params, tokens: torch.Tensor, cache, position: torch.Tensor):
        """The next token of every slot, and the cache (updated in place).
        Replays the engine's graph where ``_graphed`` holds (capturing it at
        the first call), and then returns the graph's token buffer, which
        now holds the next tokens."""
        with trace.span("model.decode"):
            if not self._graphed(params, cache):
                logits, cache = transformer.decode_step(self.cfg, params, tokens, cache, position)
                return logits.argmax(-1), cache
            if tokens is not self._graph_tokens:
                self._graph_tokens.copy_(tokens)
            if position is not self._position:
                self._position.copy_(position)
            if self._graph is None:
                self._capture()
            else:
                self._graph.replay()
                self.decode_replays += 1
                for fn, n in zip(_COUNTERS, self._launched):
                    fn.LAUNCHES += n
            return self._graph_tokens, cache

    def _graphed(self, params, cache) -> bool:
        """Whether a decode of ``params`` over ``cache`` runs as the graph:
        on the card, with no mesh in scope, on the engine's own params and
        cache (whose storage the graph reads and writes)."""
        return (self.device.type == "cuda" and get_mesh() is None
                and params is self.params and cache is self.cache)

    @torch.no_grad()
    def _capture(self) -> None:
        """One eager decode step on a side stream, which leaves the cache
        and the token buffer as this call's step must (cuBLAS sets up its
        handle and workspace for that stream there), then the same step
        captured on that stream as the engine's graph.  The capture runs
        nothing, so the counts its wrappers added are taken back."""
        def step():
            logits, _ = transformer.decode_step(self.cfg, self.params, self._graph_tokens,
                                                self.cache, self._position)
            self._graph_tokens.copy_(logits.argmax(-1))

        with trace.span("engine.capture"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            before = [fn.LAUNCHES for fn in _COUNTERS]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                step()
            self._launched = tuple(fn.LAUNCHES - n for fn, n in zip(_COUNTERS, before))
            for fn, n in zip(_COUNTERS, before):
                fn.LAUNCHES = n
            self._graph = graph

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
        trace.since("engine.queued", req.submitted_at, req.serial)
        with trace.span("engine.prefill", req.serial):
            b = self._free_slot()
            assert b is not None
            with trace.span("engine.upload"):
                prompt = torch.from_numpy(req.prompt[None, :]).to(self.device, torch.long)
            logits, cache1 = self._prefill1(self.params, prompt)
            with trace.span("engine.readback"):
                first = int(logits[0].argmax())
            # install the request's cache into slot b (prefill->decode hand-off):
            # every leaf, k/v or the ssm and conv states, is (nP, batch, ...)
            with trace.span("engine.install"):
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
        with trace.span("engine.decode"):
            with trace.span("engine.upload"):
                position = self._upload_position()
            next_tok, self.cache = self._decode(self.params, self.tokens, self.cache, position)
            self.tokens = next_tok
            self.position += self.active.astype(np.int32)
            self.stats["decode_steps"] += 1
            with trace.span("engine.readback"):
                toks = next_tok.cpu().numpy().reshape(-1)
            with trace.span("engine.bookkeep"):
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
                        self._send(comp)
                        self.active[b] = False
                        self.slot_serial[b] = -1

    def _upload_position(self) -> torch.Tensor:
        """The slots' positions on the device, as ``self.position`` holds
        them now.  ``self.position`` is a host buffer mutated in place after
        each decode (and by ``_do_prefill``); a host->device copy from it may
        still be in flight when the host mutates it, so the decode would read
        a *later* position.  The graph's positions come from the pinned
        ``_staging``, written only once its last copy has landed; an eager
        step gets a fresh copy per call, which is never mutated."""
        if not self._graphed(self.params, self.cache):
            return torch.from_numpy(self.position.copy()).to(self.device)
        self._staged.synchronize()
        self._staging.numpy()[:] = self.position
        self._position.copy_(self._staging, non_blocking=True)
        self._staged.record(torch.cuda.current_stream(self.device))
        return self._position

    def _send(self, comp: Completion) -> None:
        self._reorder.send(comp.serial, comp)
        self.completed += 1
        if trace.on():
            trace.sample("ring.held", self.completed - self.stats["emitted"], comp.serial)
            # the engine is single threaded: between two sends nothing else
            # parks or drains, so a rise from one sample to the next is a park
            trace.sample("ring.parked", self._reorder.parked_count(), comp.serial)

    # ------------------------------------------------------------------ run
    def step(self) -> bool:
        """One scheduler decision. Returns False when fully idle."""
        with trace.span("engine.step"):
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
