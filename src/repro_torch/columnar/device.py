"""Device-offload execution for ``DEVICE`` operator stages (the port's
counterpart of ``repro.columnar.device``, rewritten for PyTorch and CUDA).

A device stage accumulates columnar micro-batches until it holds a
device-sized batch and dispatches the batch *asynchronously*: it stages the
batch's columns into a pinned host buffer and, on a side CUDA stream, copies
it to the card and launches the kernel, which writes the result straight into
a pinned output buffer over PCIe (two stream operations a batch: no copy
back), then returns; events before the copy and around the launch time
the batch on the side stream.  It synchronises (``event.synchronize()``) only when a result must
cross the ordered-egress boundary.  With ``device_inflight >= 2`` batches in
flight, host-side ingest/encode overlaps the copy and the kernel
(double-buffering).  See ``docs/columnar.md`` for the protocol.

Backends (no silent fallback between them):

- ``cuda`` (the default): the hand-written kernels and torch on the card;
  raises when there is no card.
- ``cpu``: the same staging and the same code on CPU tensors, through the
  kernels' plain versions.  The work of a batch runs when its result is
  waited for, the latest point the card could run it, so a staging buffer
  reused too early shows here as well.
- ``numpy``: the reference's per-column NumPy maps.

Kernels are elementwise column maps registered in :data:`KERNELS` under a
name; each entry supplies a NumPy factory and a torch factory.  The torch
factory returns a *staged* map ``fn(src, layout, dst, device, events=None)``
over whole staging buffers (:class:`~repro_torch.kernels.affine.ref.Layout`)
that runs on ``device`` whatever the buffers' placement (on the card, pinned
host buffers are read and written in place) and records the two
``events``, where given, right before and after its work on the current
stream.  ``affine_pallas`` is K1, the
hand-written CUDA kernel (one launch per batch); ``affine`` and ``square``
are plain torch elementwise code, as they are plain jnp in the reference.  Every backend equals the NumPy reference
bit for bit, for every column type.  Batch boundaries never change results
precisely *because* kernels are elementwise; that is what lets the runtime
flush partial batches on barriers, EOF, or upstream stalls.

Fork safety: device workers are forked, and a CUDA context does not survive
a fork.  Nothing here touches CUDA at import; :func:`have_cuda` asks NVML,
which does not initialise CUDA; :func:`cuda_fork_hazard` lets the runtime
refuse to fork ``cuda`` workers from a parent that has initialised CUDA.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional, Tuple

import numpy as np
import torch

from .. import have_cuda
from ..core.api import ConfigError
from ..core.operators import DEVICE, OpSpec
from ..kernels import _build
from ..kernels.affine import affine as k1
from ..kernels.affine.ops import affine_staged
from ..kernels.affine.ref import ALIGN, Layout, affine_staged_ref, on_device
from .block import ColumnBlock, Schema

Params = Tuple[Tuple[str, Any], ...]

#: the device backends, in order of preference
BACKENDS = ("cuda", "cpu", "numpy")


def cuda_fork_hazard() -> bool:
    """True when THIS process has initialised CUDA.  A forked child of such a
    process cannot use the card (the context does not survive a fork), so
    the process runtime checks this before forking ``cuda`` device workers
    and fails fast with guidance instead of failing in every worker."""
    return torch.cuda.is_initialized()


def resolve_backend(name: Optional[str] = "cuda") -> str:
    """Check a backend request: ``cuda`` | ``cpu`` | ``numpy``.

    ``cuda`` without a card raises ``RuntimeError``; anything else (``auto``
    included) raises :class:`~repro_torch.core.api.ConfigError`."""
    if name not in BACKENDS:
        raise ConfigError(
            f"unknown device backend {name!r}: pick one of cuda|cpu|numpy "
            "(cuda: the kernels on the card; cpu: torch on the CPU; numpy: "
            "the reference)",
            key="device_backend",
        )
    if name == "cuda" and not have_cuda():
        raise RuntimeError(
            "device backend 'cuda' requested but CUDA is not available; pin "
            "device_backend='cpu' or 'numpy' to run the device stage on the host"
        )
    return name


# --------------------------------------------------------------- kernels
def _np_affine(params: Params) -> Callable[..., tuple]:
    kw = dict(params)
    a, b = kw.get("a", 1), kw.get("b", 0)

    def fn(*cols):
        return tuple(np.asarray(c * a + b, dtype=c.dtype) for c in cols)

    return fn


def _np_square(params: Params) -> Callable[..., tuple]:
    def fn(*cols):
        return tuple(np.asarray(c * c, dtype=c.dtype) for c in cols)

    return fn


def _torch_affine(params: Params) -> Callable[..., None]:
    kw = dict(params)
    a, b = kw.get("a", 1), kw.get("b", 0)

    def fn(src, layout, dst, device, events=None):
        src, dst = on_device(src, device), on_device(dst, device)
        _record(events, 0)
        affine_staged_ref(src, layout, a, b, dst)
        _record(events, 1)

    return fn


def _torch_square(params: Params) -> Callable[..., None]:
    def fn(src, layout, dst, device, events=None):
        src, dst = on_device(src, device), on_device(dst, device)
        _record(events, 0)
        for j in range(layout.width):
            x = layout.column(src, j)
            torch.mul(x, x, out=layout.column(dst, j))
        _record(events, 1)

    return fn


def _torch_affine_pallas(params: Params) -> Callable[..., None]:
    kw = dict(params)
    a, b = kw.get("a", 1), kw.get("b", 0)

    def fn(src, layout, dst, device, events=None):
        # K1 on the card; its C entry records the events around the launch
        affine_staged(src, layout, a, b, dst, device=device, events=events)

    return fn


def _record(events, i: int) -> None:
    if events is not None:
        events[i].record()


#: kernel name -> (numpy factory, torch factory); factories take the frozen
#: params tuple.  The NumPy one returns an elementwise column map
#: ``fn(*cols) -> cols``, the torch one a staged map
#: ``fn(src, layout, dst, device, events=None)``.
KERNELS = {
    "affine": (_np_affine, _torch_affine),
    "square": (_np_square, _torch_square),
    "affine_pallas": (_np_affine, _torch_affine_pallas),
}

#: kernel name -> CUDA source it launches on the card
_CUDA_SOURCES = {"affine_pallas": k1.SOURCE}


def _factories(kernel: str):
    try:
        return KERNELS[kernel]
    except KeyError:
        raise ValueError(
            f"unknown device kernel {kernel!r} (registered: {sorted(KERNELS)})"
        ) from None


def make_kernel(
    kernel: str, backend: str, params: Params = ()
) -> Callable[..., tuple]:
    """Instantiate a registered kernel as a column map ``fn(*cols) -> cols``:
    NumPy arrays for ``numpy``, torch tensors (on one device) otherwise,
    worked on by the backend's device."""
    np_factory, torch_factory = _factories(kernel)
    if resolve_backend(backend) == "numpy":
        return np_factory(params)
    staged = torch_factory(params)
    device = torch.device(backend)

    def fn(*cols):
        layout = Layout.of([c.dtype for c in cols], len(cols[0]))
        src = layout.stage(cols)
        dst = torch.empty_like(src)
        staged(src, layout, dst, device)
        return tuple(layout.column(dst, j) for j in range(layout.width))

    return fn


def prepare_backend(spec: OpSpec, backend: str) -> None:
    """Parent-side preparation before forking a device worker: compile the
    CUDA kernel the op launches (``nvcc`` only, CUDA stays uninitialised),
    so workers load a built library instead of each compiling it."""
    source = _CUDA_SOURCES.get(spec.device_kernel[0])
    if backend == "cuda" and source is not None:
        _build.build(source)


@functools.lru_cache(maxsize=None)
def _ref_kernel(kernel: str, params: Params) -> Callable[..., tuple]:
    return make_kernel(kernel, "numpy", params)


def ref_apply(value, kernel: str, params: Params, schema: Schema) -> list:
    """Per-value NumPy reference apply — the ``OpSpec.fn`` of a device op.

    This is what the thread backend, cost calibration, and correctness
    tests run; the batched device path must match it bit for bit."""
    block = ColumnBlock.from_values([value], schema=schema)
    if block is None:
        raise TypeError(
            f"device-op input {value!r} does not fit schema {schema}"
        )
    outs = _ref_kernel(kernel, params)(*block.columns)
    return ColumnBlock.from_columns(schema, list(outs)).to_values()


def device_op(
    name: str,
    kernel: str,
    schema: Schema,
    *,
    params: Optional[dict] = None,
    device_batch: int = 0,
    backend: str = "cuda",
    cost_us: float = 1.0,
) -> OpSpec:
    """Build a ``DEVICE``-kind :class:`OpSpec`.

    ``device_batch=0`` defers to the runtime's ``device_batch`` knob.
    ``backend`` is ``cuda`` | ``cpu`` | ``numpy`` and is checked here (a card
    is looked for only when a worker starts).  The spec's ``fn`` is the
    NumPy reference (:func:`ref_apply`), so the same spec runs unchanged on
    the thread backend."""
    _factories(kernel)
    if backend not in BACKENDS:
        resolve_backend(backend)  # raises ConfigError naming the three
    frozen: Params = tuple(sorted((params or {}).items()))
    return OpSpec(
        name=name,
        kind=DEVICE,
        fn=functools.partial(
            ref_apply, kernel=kernel, params=frozen, schema=schema
        ),
        cost_us=cost_us,
        schema=schema,
        device_kernel=(kernel, frozen),
        device_batch=int(device_batch),
        device_backend=backend,
    )


class _Slot:
    """One staging set of the ring: host buffers in and out (pinned on the
    card's backend), and on the card the buffer the batch is copied into and
    three events: before the copy in, and around the launch.  The kernel writes ``host_out`` in
    place: over PCIe on the card, directly on the CPU."""

    def __init__(self, nbytes: int, device: torch.device):
        cuda = device.type == "cuda"
        self.capacity = nbytes
        self.host_in = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.host_out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.host_in_np = self.host_in.numpy()
        self.host_out_np = self.host_out.numpy()
        self.dev_in = self.events = None
        if cuda:
            self.dev_in = torch.empty(nbytes, dtype=torch.uint8, device=device)
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            for ev in self.events:
                ev.record()  # torch creates the CUDA event at its first record


class DeviceExecutor:
    """Double-buffered batch executor behind a device-stage worker.

    ``submit`` absorbs per-unit :class:`ColumnBlock`\\ s; once accumulated
    rows reach ``batch`` the pending blocks are staged and dispatched.  Up
    to ``inflight`` dispatched batches ride concurrently; submitting past
    the window synchronises on the *oldest* batch only, so the newest
    dispatch overlaps both host ingest and the older batches still on the
    card.  Completed batches are split back into the original per-unit
    blocks — serials and marks untouched — so the caller publishes each
    unit exactly as it arrived (the replay-identity requirement).

    Buffers: a ring of ``inflight + 1`` staging slots.  A dispatch writes
    slot ``dispatches % (inflight + 1)``, whose previous batch has been
    popped (at most ``inflight`` batches are in flight when a dispatch
    starts), so no buffer is rewritten while its copy or kernel may still
    use it.  The
    blocks a pop returns own their columns (copied out of the slot), so a
    caller may hold them across later dispatches."""

    def __init__(
        self,
        spec: OpSpec,
        batch: int = 256,
        inflight: int = 2,
        backend: str = "cuda",
    ):
        if spec.kind != DEVICE or spec.device_kernel is None:
            raise ValueError(f"op {spec.name!r} is not a device op")
        kernel, params = spec.device_kernel
        self.schema: Schema = spec.schema
        self.batch = max(int(spec.device_batch or batch), 1)
        self.inflight_limit = max(int(inflight), 1)
        self.backend = resolve_backend(spec.device_backend or backend)
        np_factory, torch_factory = _factories(kernel)
        self._pending: List[ColumnBlock] = []
        self._pending_rows = 0
        self._inflight: Deque[tuple] = deque()
        #: dispatched batch count (observability)
        self.dispatches = 0
        #: kernel launches counted by the kernels' wrappers for this executor
        self.launches = 0
        self.rows = 0
        # seconds: host staging and copy-out; waiting on the oldest batch;
        # on the card, from the side stream's events, the copy in (to the
        # launch) and the kernel (its writes over PCIe inside); on the cpu
        # and numpy backends, the map's host time as the kernel's
        self._secs = dict(host=0.0, wait=0.0, kernel=0.0)
        if self.backend == "numpy":
            self._fn = np_factory(params)
            return
        self._fn = torch_factory(params)
        self._device = torch.device(self.backend)
        if self.backend == "cuda":
            self._secs.update(copy_in=0.0, enqueue=0.0)
        self._dtypes = [torch.from_numpy(np.empty(0, dt)).dtype for dt in self.schema.dtypes]
        self._slots: List[Optional[_Slot]] = [None] * (self.inflight_limit + 1)
        self._stream = torch.cuda.Stream() if self.backend == "cuda" else None

    @property
    def pending_rows(self) -> int:
        """Rows accumulated but not yet dispatched."""
        return self._pending_rows

    @property
    def inflight(self) -> int:
        """Dispatched batches not yet synchronised."""
        return len(self._inflight)

    def stats(self) -> dict:
        """Counters and the time split of this executor (milliseconds):
        ``host_ms`` (staging, enqueueing, copying results out of the slot),
        ``wait_ms`` (waiting on the oldest batch), ``kernel_ms`` (on the card,
        the side stream's interval around each launch, recorded by K1's C
        entry with no host work between: the kernel with its writes over
        PCIe; on the cpu and numpy backends, the map's host time) and, on
        the card only, ``copy_in_ms`` (from before each batch's copy to the
        card to its launch: the copy, and any wait for the host to enqueue
        the launch) and ``enqueue_ms`` (the host's time from that first event
        to the launch's return, a part of ``host_ms``)."""
        out = {"backend": self.backend, "dispatches": self.dispatches,
               "launches": self.launches, "rows": self.rows}
        out.update({f"{k}_ms": v * 1e3 for k, v in self._secs.items()})
        return out

    def submit(self, block: ColumnBlock) -> List[ColumnBlock]:
        """Absorb one unit's block; returns any units whose batches
        completed (possibly none, never blocks unless the window is full)."""
        self._pending.append(block)
        self._pending_rows += len(block)
        if self._pending_rows < self.batch:
            return []
        self._dispatch()
        ready: List[ColumnBlock] = []
        while len(self._inflight) > self.inflight_limit:
            ready.extend(self._pop())
        return ready

    def flush(self) -> List[ColumnBlock]:
        """Dispatch any partial batch and synchronise everything in
        flight (barrier / EOF / upstream-stall path)."""
        if self._pending:
            self._dispatch()
        out: List[ColumnBlock] = []
        while self._inflight:
            out.extend(self._pop())
        return out

    # ------------------------------------------------------------ dispatch
    def _dispatch(self) -> None:
        units = [(b.serials, b.marks) for b in self._pending]
        rows = self._pending_rows
        self.rows += rows
        if self.backend == "numpy":
            t0 = time.perf_counter()
            big = ColumnBlock.concat(self._pending)
            t1 = time.perf_counter()
            work = self._fn(*big.columns)
            self._secs["host"] += t1 - t0
            self._secs["kernel"] += time.perf_counter() - t1
        else:
            work = self._stage_and_launch(self._pending, rows)
        self._pending = []
        self._pending_rows = 0
        self.dispatches += 1
        self._inflight.append((work, units))

    def _slot(self, nbytes: int) -> _Slot:
        i = self.dispatches % len(self._slots)
        slot = self._slots[i]
        if slot is None or slot.capacity < nbytes:
            # not in flight (see the class docstring), so it may be replaced
            size = max(nbytes, self.batch * self.schema.row_bytes + ALIGN * self.schema.width)
            if self._stream is not None:  # the card's buffer belongs to the side stream
                with torch.cuda.stream(self._stream):
                    slot = _Slot(size, self._device)
            else:
                slot = _Slot(size, self._device)
            self._slots[i] = slot
        return slot

    def _stage_and_launch(self, blocks: List[ColumnBlock], rows: int) -> tuple:
        t0 = time.perf_counter()
        layout = Layout.of(self._dtypes, rows)
        slot = self._slot(layout.nbytes)
        host = slot.host_in_np
        for j, dt in enumerate(self.schema.dtypes):
            # straight from the units' columns into the staging buffer
            off = layout.offsets[j]
            np.concatenate([b.columns[j] for b in blocks],
                           out=host[off : off + rows * dt.itemsize].view(dt))
        if self._stream is not None:
            # two stream operations: the copy engine brings the batch in,
            # and the kernel writes host_out over PCIe; K1's wrapper records
            # the other two events around its launch
            n = layout.nbytes
            with torch.cuda.stream(self._stream):
                t1 = time.perf_counter()
                slot.events[0].record()
                slot.dev_in[:n].copy_(slot.host_in[:n], non_blocking=True)
                self._launch(slot, layout, slot.events[1:])
                self._secs["enqueue"] += time.perf_counter() - t1
        self._secs["host"] += time.perf_counter() - t0
        return slot, layout

    def _launch(self, slot: _Slot, layout: Layout, events=None) -> None:
        before = affine_staged.LAUNCHES
        src = slot.host_in if slot.dev_in is None else slot.dev_in
        self._fn(src, layout, slot.host_out, self._device, events)
        self.launches += affine_staged.LAUNCHES - before

    # ----------------------------------------------------------------- pop
    def _pop(self) -> List[ColumnBlock]:
        work, units = self._inflight.popleft()
        if self.backend == "numpy":
            cols = [
                np.asarray(o).astype(dt, copy=False)
                for o, dt in zip(work, self.schema.dtypes)
            ]
        else:
            cols = self._finish(*work)
        blocks: List[ColumnBlock] = []
        off = 0
        for serials, marks in units:
            n = len(serials)
            blocks.append(
                ColumnBlock(
                    self.schema,
                    [c[off : off + n] for c in cols],
                    serials,
                    list(marks),
                )
            )
            off += n
        return blocks

    def _finish(self, slot: _Slot, layout: Layout) -> List[np.ndarray]:
        t0 = time.perf_counter()
        if slot.events is not None:
            ev = slot.events
            ev[2].synchronize()  # the ordered-egress boundary
            t1 = time.perf_counter()
            self._secs["wait"] += t1 - t0
            self._secs["copy_in"] += ev[0].elapsed_time(ev[1]) / 1e3
            self._secs["kernel"] += ev[1].elapsed_time(ev[2]) / 1e3
        else:  # cpu: the batch's work runs now, when its result is needed
            self._launch(slot, layout)
            t1 = time.perf_counter()
            self._secs["kernel"] += t1 - t0
        host = slot.host_out_np
        cols = [
            host[off : off + layout.rows * dt.itemsize].view(dt).copy()
            for off, dt in zip(layout.offsets, self.schema.dtypes)
        ]
        self._secs["host"] += time.perf_counter() - t1
        return cols
