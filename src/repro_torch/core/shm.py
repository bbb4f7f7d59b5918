# Port copy of src/repro/core/shm.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Shared-memory transport for the process-parallel backend (paper §3, across
address spaces).

Three lock-free structures layered on ``multiprocessing.shared_memory``, plus
the value codec they share.  Together they carry the staged process pipeline
(:mod:`.procrun`): every stage owns one :class:`ExchangeRing` — N per-worker
ingress rings in, one serial-number reorder ring out.

Ring wire format
----------------

- :class:`ShmSpscRing` — bounded single-producer/single-consumer ring of
  fixed-width slots.  A record's first slot is ``[total_len:4][tag:1]
  [serial:8][payload...]``; large payloads span consecutive slots
  (continuation slots are raw payload bytes) and the producer publishes the
  whole span with one tail store, so the consumer never observes a partial
  record.  The head (consumer cursor, offset 8) and tail (producer cursor,
  offset 0) are each written by exactly one process, so no cross-process
  atomic RMW is needed — the only primitive required is an aligned 8-byte
  store.  Offset 16 is the producer-owned ``closed`` flag (EOF: drain what is
  left, then stop); offset 24 is the supervisor-owned ``handoff`` flag
  (elastic resize: the exiting consumer first sends its worker-local state
  back over its pipe).  Consumption is split into :meth:`ShmSpscRing.peek` /
  :meth:`ShmSpscRing.advance` so a consumer can *read* a record, act on it,
  and only then commit the head — the basis of crash replay (below).

- :class:`ShmReorderRing` — the cross-process mirror of
  :class:`~.reorder.NonBlockingReorderBuffer` (paper fig. 4): a bounded ring
  indexed by ``serial mod size`` with a shared ``next`` counter (header
  offset 0, drainer-owned; offset 8 is a supervisor-owned ``stop`` flag that
  tells publishers/drainers to abandon ship at teardown).  Slot layout is
  ``[seq:8][len:4][span:4][tag:1][payload...]``.  Any worker
  process may publish a slot (each serial is owned by exactly one worker);
  the single drainer consumes the contiguous ready prefix and is the only
  writer of ``next``.

Serial-number protocol
----------------------

Serials are assigned by the stage's *feeder* (the parent for stage 0, an
exchange router for interior stages) in stream order, one per tuple, starting
at 1.  A micro-batch dispatched as one unit covers either a *contiguous* run
of serials (round-robin routing: the SPSC record's serial field is the span
head) or an *explicit* serial list (keyed routing interleaves serials across
workers — the per-tuple serials ride inside the payload, which is what lets
``batch_size`` and keyed stages compose).  Workers publish results back under
those same serials: one ``span``-sized slot for a contiguous unit, one
single-serial slot per tuple for a keyed unit, so the drainer's contiguous
sweep restores the exact cross-worker interleave order.  A slot is published
by storing its sequence number *last*; the publish entry condition is
``next <= t < next + size`` (``t < next`` reports ``STALE``, beyond the
window reports ``FULL`` and the worker retries).  ``TAG_EOF`` is published by
the feeder itself at ``last_serial + 1`` once every unit is dispatched — the
ring's contiguity guarantee means the drainer sees it only after every real
result, which is the staged pipeline's end-of-stream marker.

Crash / replay invariants
-------------------------

A worker *peeks* its next unit, processes it, publishes the result, and only
then advances the ring head.  Both cursor stores are single aligned 8-byte
writes and the sequence field is stored last, so a worker killed at any point
leaves every shared structure consistent: a replacement process forked onto
the same rings (after :meth:`ShmSpscRing.sync_consumer`) re-reads at most one
uncommitted unit and re-publishes it.  Duplicate publishes are safe because
segment functions are required to be deterministic — a republish either
overwrites the identical payload (serial still in window) or fails the entry
condition with ``STALE`` (already drained) and is dropped.

Payload codec: dispatch units and multi-tuple result bundles travel as
pickle; single-int/float result bundles take a raw 8-byte fast path
(``TAG_ONE_INT``/``TAG_ONE_FLOAT``) and bundles of homogeneous small
int/float tuples take a raw struct path (``TAG_TUPS`` — a 4-byte header,
per-column type codes, then 8 bytes per cell).  Columnar micro-batches
(:mod:`repro.columnar`) ride whole blocks through ``TAG_COLBLOCK`` span
slots — NumPy column vectors written directly into the ring via the same
span-publish path, with pickle reserved for the ragged marker sidecar.
Reorder-ring bundles whose encoding exceeds the slot payload are diverted
to a pipe side channel and the slot carries only a spill tag, keeping the
ring itself fixed-width.
"""
from __future__ import annotations

import pickle
import struct
from multiprocessing import shared_memory
from typing import Optional, Tuple

# ---------------------------------------------------------------- value codec
TAG_PICKLE = 2  # pickle bytes (slow path)
TAG_EMPTY = 3  # empty output bundle (hole-punch: serial completed, 0 tuples)
TAG_ONE_INT = 4  # bundle of exactly one int
TAG_ONE_FLOAT = 5  # bundle of exactly one float
TAG_SPILL = 6  # bundle too large for the slot; body travels via pipe
TAG_MBUNDLE = 7  # single-serial bundle + latency marker: pickle((outs, marker))
TAG_BUNDLES = 8  # span result: pickle((bundles, out_marks, dropped_marks))
TAG_EOF = 9  # end-of-stream marker published by the feeder at last_serial+1
TAG_UNIT = 10  # contiguous dispatch unit: pickle((values, marks)); serial=head
TAG_KUNIT = 11  # keyed dispatch unit: pickle((serials, values, marks))
TAG_KBUNDLES = 12  # batched keyed results: pickle([(serial, tag, data), ...])
# published as ONE slot at the unit's first serial; the drainer scatters the
# non-head serials into a local stash (see ShmReorderRing.poll), which is
# what keeps a keyed stage's reorder traffic per-unit instead of per-tuple
TAG_BARRIER = 13  # epoch checkpoint barrier riding an ingress ring: the
# serial field is the epoch's boundary serial B (state after every serial
# < B), the payload is the 8-byte epoch number.  Workers snapshot and ack
# over their pipe; nothing is published to the reorder ring for a barrier.
TAG_COLBLOCK = 14  # columnar micro-batch (repro.columnar wire format): a
# whole fixed-width ColumnBlock in one span slot — as a dispatch unit it
# replaces TAG_UNIT (serial = block head, span rides the record), as a
# result it replaces TAG_BUNDLES (span = block rows, one serial per row).
# The payload is decoded by repro.columnar.codec; core.shm only moves it.
TAG_TUPS = 15  # bundle of homogeneous fixed-width numeric tuples:
# [n:2][k:1][col type codes: k bytes] then n*k raw 8-byte cells row-major
# (code 0 = int64, 1 = float64) — the widened raw fast path for results
# that are small tuples of ints/floats instead of bare scalars.

_I8 = struct.Struct("<q")
_F8 = struct.Struct("<d")
_TUP_HDR = struct.Struct("<HB")  # rows:2, cols:1 (then `cols` code bytes)
_TUP_MAX_COLS = 16
_TUP_MAX_ROWS = 0xFFFF
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _try_encode_tuples(outs: list) -> Optional[bytes]:
    """Raw struct encoding for a bundle of homogeneous numeric tuples, or
    None when any row breaks the shape/type contract (pickle fallback).
    Column types are fixed by the first row; bools are excluded (a bool is
    an int subclass but must round-trip as bool)."""
    first = outs[0]
    k = len(first)
    if not 1 <= k <= _TUP_MAX_COLS or len(outs) > _TUP_MAX_ROWS:
        return None
    codes = bytearray()
    for v in first:
        if type(v) is int:
            codes.append(0)
        elif type(v) is float:
            codes.append(1)
        else:
            return None
    buf = bytearray(_TUP_HDR.pack(len(outs), k))
    buf += codes
    pack_i, pack_f = _I8.pack, _F8.pack
    for row in outs:
        if type(row) is not tuple or len(row) != k:
            return None
        for code, v in zip(codes, row):
            if code == 0:
                if type(v) is not int or not _I64_MIN <= v <= _I64_MAX:
                    return None
                buf += pack_i(v)
            else:
                if type(v) is not float:
                    return None
                buf += pack_f(v)
    return bytes(buf)


def _decode_tuples(data: bytes) -> list:
    n, k = _TUP_HDR.unpack_from(data, 0)
    codes = data[_TUP_HDR.size:_TUP_HDR.size + k]
    off = _TUP_HDR.size + k
    unpack_i, unpack_f = _I8.unpack_from, _F8.unpack_from
    out = []
    for _ in range(n):
        row = []
        for code in codes:
            row.append(
                unpack_i(data, off)[0] if code == 0 else unpack_f(data, off)[0]
            )
            off += 8
        out.append(tuple(row))
    return out


def encode_bundle(outs: list) -> Tuple[int, bytes]:
    """Encode a flat-map result bundle (list of outputs) for a reorder slot."""
    if not outs:
        return TAG_EMPTY, b""
    if len(outs) == 1:
        v = outs[0]
        if type(v) is int and -(1 << 63) <= v < (1 << 63):
            return TAG_ONE_INT, _I8.pack(v)
        if type(v) is float:
            return TAG_ONE_FLOAT, _F8.pack(v)
    if type(outs[0]) is tuple:
        raw = _try_encode_tuples(outs)
        if raw is not None:
            return TAG_TUPS, raw
    return TAG_PICKLE, pickle.dumps(outs, protocol=pickle.HIGHEST_PROTOCOL)


def decode_bundle(tag: int, data: bytes) -> list:
    if tag == TAG_EMPTY:
        return []
    if tag == TAG_ONE_INT:
        return [_I8.unpack(data)[0]]
    if tag == TAG_ONE_FLOAT:
        return [_F8.unpack(data)[0]]
    if tag == TAG_TUPS:
        return _decode_tuples(data)
    return pickle.loads(data)


def _align(n: int, a: int = 64) -> int:
    return (n + a - 1) // a * a


# ------------------------------------------------------------------ SPSC ring
class ShmSpscRing:
    """Bounded SPSC ring of fixed-width slots over a shared-memory segment.

    Record layout (first slot of a span):
      [total_len:4][tag:1][serial:8][payload...]
    continuation slots carry raw payload bytes.  ``tail``/``head`` count
    *slots*; a record occupies ``ceil((13+len)/slot_bytes)`` slots and is
    published by a single tail store after every byte is written.

    Consumption is two-phase: :meth:`peek` reads the record at the head
    without committing, :meth:`advance` commits it.  A consumer that dies
    between the two leaves the record in place for its replacement (see the
    module docstring's crash/replay invariants); :meth:`get` is the
    peek+advance convenience for consumers that do not need replay.
    """

    _HDR = 64  # tail:8 @0 (producer-owned), head:8 @8 (consumer-owned),
    # closed:8 @16 (producer-owned), handoff:8 @24 (supervisor-owned),
    # heartbeat:8 @32 (consumer-owned monotone liveness counter)
    _REC = struct.Struct("<IBq")  # total_len, tag, serial

    def __init__(self, name_prefix: str, slots: int = 4096, slot_bytes: int = 512):
        if slots < 4:
            raise ValueError("ring needs >= 4 slots")
        self.slots = slots
        self.slot_bytes = _align(slot_bytes)
        size = self._HDR + self.slots * self.slot_bytes
        self._shm = shared_memory.SharedMemory(
            create=True, size=size, name=f"{name_prefix}_spsc"
        )
        self._buf = self._shm.buf
        self._buf[: self._HDR] = bytes(self._HDR)
        self._tail = 0  # producer-side mirror
        self._head = 0  # consumer-side mirror
        self._beat = 0  # consumer-side heartbeat mirror
        self.name = self._shm.name

    @property
    def capacity_bytes(self) -> int:
        """Max payload bytes a single record can carry (span limit)."""
        return (self.slots - 1) * self.slot_bytes - self._REC.size

    # -- counters (aligned 8-byte single-writer stores) ---------------------
    def _load(self, off: int) -> int:
        return _I8.unpack_from(self._buf, off)[0]

    def _store(self, off: int, v: int) -> None:
        _I8.pack_into(self._buf, off, v)

    # -- producer -----------------------------------------------------------
    def sync_producer(self) -> None:
        """Reload the producer cursor from shared memory.

        A replacement producer process (router crash re-fork) inherits the
        supervisor's stale tail mirror — usually 0, since the parent never
        puts into interior rings; writing with it would rewind the shared
        tail and orphan every queued record.  Re-read the authoritative
        value before the first :meth:`put`."""
        self._tail = self._load(0)

    def put(self, serial: int, tag: int, data: bytes) -> bool:
        """Append one record; returns False if the ring lacks space."""
        total = self._REC.size + len(data)
        nslots = max(1, -(-total // self.slot_bytes))
        if nslots >= self.slots:
            raise ValueError(
                f"record of {len(data)}B exceeds ring capacity "
                f"({self.capacity_bytes}B); raise slot_bytes/slots"
            )
        head = self._load(8)
        if self._tail - head + nslots > self.slots:
            return False
        first = (self._tail % self.slots) * self.slot_bytes + self._HDR
        self._REC.pack_into(self._buf, first, len(data), tag, serial)
        wrote = min(len(data), self.slot_bytes - self._REC.size)
        self._buf[first + self._REC.size : first + self._REC.size + wrote] = (
            data[:wrote]
        )
        pos = wrote
        for k in range(1, nslots):
            off = ((self._tail + k) % self.slots) * self.slot_bytes + self._HDR
            chunk = data[pos : pos + self.slot_bytes]
            self._buf[off : off + len(chunk)] = chunk
            pos += len(chunk)
        self._tail += nslots
        self._store(0, self._tail)  # publish the whole span
        return True

    def close_ring(self) -> None:
        """Producer-side EOF: consumers drain whatever is left, then stop."""
        self._store(16, 1)

    # -- supervisor (elastic replanning) ------------------------------------
    def request_handoff(self) -> None:
        """Ask the consumer to send its worker-local state back over its pipe
        before exiting (elastic resize: the group is re-forked at a new width
        and keyed state must migrate).  Set BEFORE :meth:`close_ring` so the
        exiting worker observes it."""
        self._store(24, 1)

    def handoff_requested(self) -> bool:
        """Whether the supervisor flagged an elastic state handoff."""
        return self._load(24) != 0

    def reopen_ring(self) -> None:
        """Clear the EOF/handoff flags so a quiesced ring (head == tail) can
        serve a freshly forked replacement group after an elastic resize."""
        self._store(16, 0)
        self._store(24, 0)

    def reset_to_tail(self) -> None:
        """Supervisor-side group-restore reset: discard every queued record
        by moving the consumer cursor to the producer cursor.  Only legal
        once the consumer process is dead (the supervisor briefly becomes the
        sole writer of the head); the feeder then re-pumps the discarded
        window from its replay log and a freshly forked consumer resumes via
        :meth:`sync_consumer`."""
        self._store(8, self._load(0))

    # -- progress counters (any process) ------------------------------------
    def consumed_slots(self) -> int:
        """Slots the consumer has committed — a monotone per-worker progress
        counter the supervisor samples for the cost model."""
        return self._load(8)

    def queued_slots(self) -> int:
        """Slots currently queued (produced − consumed): the stage-occupancy
        signal behind elastic replanning."""
        return max(self._load(0) - self._load(8), 0)

    # -- liveness heartbeat (consumer writes, supervisor reads) -------------
    def beat(self) -> None:
        """Consumer-side liveness tick.  Monotone and written on every main
        loop pass (including idle naps and FULL publish spins), so a frozen
        counter means the consumer is hung or dead — the supervisor's stall
        detector SIGKILLs it and lets the crash path recover."""
        self._beat += 1
        self._store(32, self._beat)

    def heartbeat(self) -> int:
        """Current consumer heartbeat value (supervisor-side sample)."""
        return self._load(32)

    # -- consumer -----------------------------------------------------------
    def sync_consumer(self) -> None:
        """Reload the consumer cursor from shared memory.

        A replacement consumer process (crash re-fork) inherits the parent's
        stale head mirror; this re-reads the authoritative shared value so it
        resumes exactly at the first uncommitted record."""
        self._head = self._load(8)

    def peek(self) -> Optional[Tuple[int, int, bytes, int]]:
        """Read the head record WITHOUT committing it.

        Returns ``(serial, tag, payload, nslots)`` or None when empty; pass
        ``nslots`` to :meth:`advance` to commit after acting on the record.
        """
        tail = self._load(0)
        if self._head >= tail:
            return None
        first = (self._head % self.slots) * self.slot_bytes + self._HDR
        total, tag, serial = self._REC.unpack_from(self._buf, first)
        nslots = max(1, -(-(self._REC.size + total) // self.slot_bytes))
        take = min(total, self.slot_bytes - self._REC.size)
        data = bytes(self._buf[first + self._REC.size : first + self._REC.size + take])
        if nslots > 1:
            parts = [data]
            pos = take
            for k in range(1, nslots):
                off = ((self._head + k) % self.slots) * self.slot_bytes + self._HDR
                chunk_len = min(total - pos, self.slot_bytes)
                parts.append(bytes(self._buf[off : off + chunk_len]))
                pos += chunk_len
            data = b"".join(parts)
        return serial, tag, data, nslots

    def advance(self, nslots: int) -> None:
        """Commit the record last returned by :meth:`peek`."""
        self._head += nslots
        self._store(8, self._head)

    def get(self) -> Optional[Tuple[int, int, bytes]]:
        """Pop one record -> (serial, tag, payload), or None when empty."""
        rec = self.peek()
        if rec is None:
            return None
        serial, tag, data, nslots = rec
        self.advance(nslots)
        return serial, tag, data

    def closed(self) -> bool:
        """Producer-side EOF flag: drain what is left, then stop."""
        return self._load(16) != 0

    def __len__(self) -> int:  # records are >=1 slot; used as emptiness hint
        return max(self._load(0) - self._load(8), 0)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Detach this process's mapping (does not free the segment)."""
        self._buf = None
        self._shm.close()

    def unlink(self) -> None:
        """Free the shared-memory segment (idempotent)."""
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


# --------------------------------------------------------------- reorder ring
class ShmReorderRing:
    """Cross-process serial-number reorder ring (fig. 4 semantics, MPSC).

    Slot layout: [seq:8][len:4][span:4][tag:1][payload...].  Workers publish
    serial ``t`` into slot ``t % size`` under the entry condition
    ``next <= t < next + size`` (``next`` read from the shared
    header); the sequence field is stored last, which is the publish.  A
    ``span > 1`` slot carries the results of the contiguous serial run
    ``[t, t + span)`` in one publish (round-robin micro-batches); the drainer
    advances ``next`` past the whole run.  The drainer consumes the
    contiguous prefix and is the sole writer of ``next``.  Header offset 8 is
    a supervisor-owned ``stop`` flag: publishers spinning on a FULL window
    and idle drainers check it so teardown never strands a process.

    Drains come in two flavours.  :meth:`poll` is read-and-commit in one
    step (the parent's final-ring drain).  A *restartable* drainer (an
    exchange router) instead uses :meth:`read_ahead` — which moves only a
    local cursor, leaving the shared ``next`` (and therefore the publish
    window, whose slots double as the replay source) behind — and
    :meth:`commit`, which widens the window only after everything read has
    been durably handed downstream.  ``commit`` also double-buffers a
    *commit record* ``(read_pos, downstream_next_serial)`` in the header:
    two slots plus an index written last, so a drainer SIGKILLed mid-commit
    always leaves one complete pair for its replacement
    (:meth:`sync_drainer` / :meth:`commit_record`).
    """

    _HDR = 128  # next:8 @0 (drainer-owned), stop:8 @8 (supervisor-owned),
    # active group width:8 @16 (supervisor-owned metadata),
    # drainer heartbeat:8 @24, commit record slots A/B:16 @32/@48
    # (read_pos, downstream serial), active record index:8 @64 (0 = none)
    _SLOT_HDR = struct.Struct("<qIIB")  # seq, len, span, tag

    PUBLISHED = 0
    FULL = 1
    STALE = 2  # serial already drained (replay after crash) — drop

    def __init__(self, name_prefix: str, size: int = 4096, payload_bytes: int = 512):
        self.size = size
        self.payload_bytes = payload_bytes
        self.slot_bytes = _align(self._SLOT_HDR.size + payload_bytes)
        self._shm = shared_memory.SharedMemory(
            create=True,
            size=self._HDR + size * self.slot_bytes,
            name=f"{name_prefix}_reorder",
        )
        self._buf = self._shm.buf
        self._buf[: self._HDR] = bytes(self._HDR)
        # seq fields must start != any valid serial (serials start at 1)
        for j in range(size):
            _I8.pack_into(self._buf, self._HDR + j * self.slot_bytes, 0)
        _I8.pack_into(self._buf, 0, 1)  # next = 1
        self._next = 1  # drainer-side mirror (read cursor; see read_ahead)
        self._beat = 0  # drainer-side heartbeat mirror
        # drainer-local scatter stash for TAG_KBUNDLES slots: a keyed worker
        # publishes a whole unit's results (interleaved serials) as one slot
        # at the unit's first serial; the remaining (serial -> (tag, data))
        # entries wait here until the contiguous sweep reaches them.  Bounded
        # by the ring window (every stashed serial is < next + size).
        self._stash: dict = {}
        self.name = self._shm.name

    # -- worker side --------------------------------------------------------
    def shared_next(self) -> int:
        """The drainer's published ``next`` — readable from any process.

        Feeders use it to bound in-flight serials (dispatched − drained), the
        staged backend's per-stage backpressure."""
        return _I8.unpack_from(self._buf, 0)[0]

    def try_publish(self, t: int, tag: int, data: bytes, span: int = 1) -> int:
        """Publish serial ``t``'s result slot (covering ``span`` serials).
        Returns ``PUBLISHED``, ``FULL`` (window not there yet — retry), or
        ``STALE`` (already drained: crash replay — drop)."""
        n = self.shared_next()
        if t < n:
            return self.STALE
        if t >= n + self.size:
            return self.FULL
        if len(data) > self.payload_bytes:
            raise ValueError("bundle exceeds slot payload; caller must spill")
        off = self._HDR + (t % self.size) * self.slot_bytes
        body = off + self._SLOT_HDR.size
        self._buf[body : body + len(data)] = data
        # header written in two steps so seq (the publish) is stored last
        struct.pack_into("<IIB", self._buf, off + 8, len(data), span, tag)
        _I8.pack_into(self._buf, off, t)
        return self.PUBLISHED

    # -- drainer side -------------------------------------------------------
    def read_ahead(self) -> Optional[Tuple[int, int, bytes, int]]:
        """Consume the next in-order slot -> (serial, tag, payload, span)
        advancing only the drainer-LOCAL cursor — the shared ``next`` (and
        with it the publish window) moves at :meth:`commit` time.  A
        ``TAG_KBUNDLES`` slot is unpacked transparently: the head serial's
        entry is returned now, the rest scatter into the drainer-local stash
        and are returned when the sweep reaches their serials."""
        t = self._next
        hit = self._stash.pop(t, None)
        if hit is None:
            off = self._HDR + (t % self.size) * self.slot_bytes
            seq, length, span, tag = self._SLOT_HDR.unpack_from(self._buf, off)
            if seq != t:
                return None
            body = off + self._SLOT_HDR.size
            data = bytes(self._buf[body : body + length])
            if tag == TAG_KBUNDLES:
                head = None
                for s, etag, edata in pickle.loads(data):
                    if s == t:
                        head = (etag, edata)
                    else:
                        self._stash[s] = (etag, edata)
                tag, data = head
                span = 1
        else:
            tag, data = hit
            span = 1
        self._next += max(span, 1)
        return t, tag, data, span

    def poll(self) -> Optional[Tuple[int, int, bytes, int]]:
        """Read-and-commit drain (the parent's final ring): every
        :meth:`read_ahead` is immediately committed, so the publish window
        tracks the read cursor exactly — the pre-recovery semantics."""
        got = self.read_ahead()
        if got is not None:
            _I8.pack_into(self._buf, 0, self._next)  # widen the window
        return got

    def commit(self, downstream_serial: int) -> None:
        """Publish drain progress: widen the shared window to the local read
        cursor and record ``(read_pos, downstream_serial)`` — the pair a
        replacement drainer resumes from.  The caller guarantees everything
        read so far is durably pumped downstream (its out-queues, partial
        accumulators, and scatter stash are all empty), so slots below the
        cursor may be recycled.  The record is double-buffered with the
        index stored last: a SIGKILL mid-commit leaves the previous complete
        pair active."""
        idx = _I8.unpack_from(self._buf, 64)[0]
        new = 2 if idx == 1 else 1
        base = 32 if new == 1 else 48
        _I8.pack_into(self._buf, base, self._next)
        _I8.pack_into(self._buf, base + 8, downstream_serial)
        _I8.pack_into(self._buf, 64, new)
        _I8.pack_into(self._buf, 0, self._next)  # widen the window last

    def commit_record(self) -> Optional[Tuple[int, int]]:
        """The active ``(read_pos, downstream_serial)`` commit pair, or None
        if this ring's drainer has never committed."""
        idx = _I8.unpack_from(self._buf, 64)[0]
        if idx == 0:
            return None
        base = 32 if idx == 1 else 48
        return (
            _I8.unpack_from(self._buf, base)[0],
            _I8.unpack_from(self._buf, base + 8)[0],
        )

    def sync_drainer(self) -> int:
        """Restarted-drainer resume: reload the read cursor from the commit
        record (falling back to the shared ``next``), clear the local stash,
        and return the downstream serial to resume dispatch at.  Also
        re-publishes the window at the committed position — a predecessor
        killed between writing the record and widening the window left the
        two an index apart, and the record is the later, authoritative one."""
        rec = self.commit_record()
        if rec is None:
            self._next = _I8.unpack_from(self._buf, 0)[0]
            serial = 1
        else:
            self._next, serial = rec
            _I8.pack_into(self._buf, 0, self._next)
        self._stash = {}
        return serial

    def has_stashed(self) -> bool:
        """Whether KBUNDLES scatter entries are still awaiting their serials
        (a commit while stashed would let their source slot be recycled)."""
        return bool(self._stash)

    def read_pos(self) -> int:
        """Drainer-local read cursor (may run ahead of the shared window)."""
        return self._next

    # -- drainer heartbeat (drainer writes, supervisor reads) ---------------
    def beat_drainer(self) -> None:
        """Drainer-side liveness tick (see :meth:`ShmSpscRing.beat`)."""
        self._beat += 1
        _I8.pack_into(self._buf, 24, self._beat)

    def drainer_heartbeat(self) -> int:
        """Current drainer heartbeat value (supervisor-side sample)."""
        return _I8.unpack_from(self._buf, 24)[0]

    @property
    def next_serial(self) -> int:
        """Drainer-side mirror of the next serial to consume."""
        return self._next

    def published(self, t: int) -> bool:
        """Any-process-side: is serial ``t`` already drained or sitting
        published in its slot?  A crash-replacement worker checks this before
        re-publishing its replayed unit — a serial whose result survived the
        dead worker must have exactly one publisher, or the duplicate could
        clobber the slot concurrently with its reuse by ``t + size`` once the
        drain sweeps past ``t``.  (If the slot is *unpublished*, republish is
        race-free: the drain cannot pass ``t``, so ``t + size`` fails the
        entry condition until the republish lands.)"""
        if t < self.shared_next():
            return True
        off = self._HDR + (t % self.size) * self.slot_bytes
        return _I8.unpack_from(self._buf, off)[0] == t

    # -- teardown flag ------------------------------------------------------
    def request_stop(self) -> None:
        """Supervisor-side: tell publishers/drainers to abandon the stream."""
        _I8.pack_into(self._buf, 8, 1)

    def stopped(self) -> bool:
        """Teardown flag: publishers/drainers must abandon the stream."""
        return _I8.unpack_from(self._buf, 8)[0] != 0

    # -- group-width metadata (supervisor-owned, any process may read) ------
    def set_active_width(self, w: int) -> None:
        """Publish the stage's live worker-group width (elastic resizes
        rewrite it; routers/monitors read it for introspection)."""
        _I8.pack_into(self._buf, 16, w)

    def active_width(self) -> int:
        """The stage's live worker-group width (supervisor-published)."""
        return _I8.unpack_from(self._buf, 16)[0]

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Detach this process's mapping (does not free the segment)."""
        self._buf = None
        self._shm.close()

    def unlink(self) -> None:
        """Free the shared-memory segment (idempotent)."""
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


# -------------------------------------------------------------- exchange edge
class ExchangeRing:
    """M-producer → N-consumer hand-off backing one process stage.

    The stage's *feeder* (parent or exchange router — the single upstream
    drainer, so M producers are already serialized by the upstream reorder
    ring) seals stream-ordered tuples into dispatch units and puts them into
    the N per-worker ingress SPSC rings (keyed routing for partitioned
    stages; round-robin otherwise).  The stage's N workers publish per-serial
    results into the single ``reorder`` ring, whose contiguous drain restores
    stream order for the next hop.  Pure structure: routing/sealing policy
    lives in :mod:`.procrun`.

    ``consumers`` is the *maximum* group width: elastic replanning
    (:mod:`.costmodel`) may run fewer live workers than rings.  The live
    width rides the reorder-ring header (:meth:`set_active_width`) and the
    per-ring cursors double as the cost model's progress/occupancy counters
    (:meth:`progress`, :meth:`backlog_slots`).
    """

    def __init__(
        self,
        name_prefix: str,
        consumers: int,
        *,
        ring_slots: int = 2048,
        slot_bytes: int = 1024,
        reorder_size: int = 1024,
        reorder_payload: int = 4096,
    ):
        if consumers < 1:
            raise ValueError("exchange needs at least one consumer")
        self.consumers = consumers
        self.rings = [
            ShmSpscRing(f"{name_prefix}_c{j}", slots=ring_slots, slot_bytes=slot_bytes)
            for j in range(consumers)
        ]
        self.reorder = ShmReorderRing(
            name_prefix, size=reorder_size, payload_bytes=reorder_payload
        )
        self.reorder.set_active_width(consumers)

    # -- group-width metadata ----------------------------------------------
    def set_active_width(self, w: int) -> None:
        self.reorder.set_active_width(w)

    def active_width(self) -> int:
        return self.reorder.active_width()

    # -- sampling counters (supervisor-side cost model) ---------------------
    def progress(self) -> Tuple[int, list]:
        """(drained serials, per-worker consumed-slot counters) — the publish
        counters :class:`~.costmodel.OccupancyMonitor` samples."""
        return (
            max(self.reorder.shared_next() - 1, 0),
            [r.consumed_slots() for r in self.rings],
        )

    def backlog_slots(self) -> int:
        """Queued ingress slots across the group (stage occupancy proxy)."""
        return sum(r.queued_slots() for r in self.rings)

    def close_ingress(self) -> None:
        """Producer-side EOF on every ingress ring (workers drain, then exit)."""
        for r in self.rings:
            r.close_ring()

    def request_handoff(self) -> None:
        """Elastic resize: flag every ring so exiting workers send state."""
        for r in self.rings:
            r.request_handoff()

    def reopen_ingress(self) -> None:
        """Clear EOF/handoff flags after a quiesced resize (see
        :meth:`ShmSpscRing.reopen_ring`)."""
        for r in self.rings:
            r.reopen_ring()

    def reset_ingress(self) -> None:
        """Group-restore: discard every queued ingress record (the feeder
        re-pumps them from its replay log).  Only legal with the consumer
        group dead — see :meth:`ShmSpscRing.reset_to_tail`."""
        for r in self.rings:
            r.reset_to_tail()

    def sync_feeder(self) -> None:
        """Restarted-feeder resume: reload every ingress ring's producer
        cursor (see :meth:`ShmSpscRing.sync_producer`)."""
        for r in self.rings:
            r.sync_producer()

    def heartbeats(self) -> list:
        """Per-worker consumer heartbeat samples (stall detection)."""
        return [r.heartbeat() for r in self.rings]

    def request_stop(self) -> None:
        self.reorder.request_stop()

    def close(self) -> None:
        for r in self.rings:
            r.close()
        self.reorder.close()

    def unlink(self) -> None:
        for r in self.rings:
            r.unlink()
        self.reorder.unlink()
