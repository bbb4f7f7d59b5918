# Port copy of src/repro/columnar/block.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Typed fixed-width columnar micro-batches: :class:`Schema` / :class:`ColumnBlock`.

The streaming runtime moves tuples between stages in micro-batches; this
module gives those batches a *columnar* in-memory form — one NumPy vector
per field plus a per-row serial vector and a ragged marker sidecar — so a
numeric batch can cross a shared-memory ring as a handful of contiguous
buffer writes instead of a per-tuple pickle (see :mod:`.codec` for the wire
format and ``docs/columnar.md`` for the subsystem overview).

Schema rules
------------

A schema is an ordered list of fixed-width numeric fields.  Supported field
codes: ``i8``/``f8`` (the Python-exact widths — ``int``/``float`` round-trip
bitwise) and ``i4``/``f4`` (device-friendly narrow widths, used by
:class:`~.device.DeviceExecutor` schemas; narrowing casts are the declared
operator semantics, not an encoding artifact).  ``scalar=True`` marks a
one-field schema whose rows are bare scalars rather than 1-tuples — the two
decode differently and must not be conflated.

:meth:`Schema.infer` only ever infers ``i8``/``f8`` (from ``int``/``float``
cells), so inference never narrows a value.  Bools, ragged tuples, and any
non-int/float cell make a batch non-columnar: builders return ``None`` and
callers fall back to pickle.
"""
from __future__ import annotations

from array import array
from dataclasses import dataclass, field
from itertools import chain
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

#: field code -> numpy dtype string (little-endian, fixed width)
DTYPES = {"i8": "<i8", "f8": "<f8", "i4": "<i4", "f4": "<f4"}
#: field code -> encoded byte (wire stability: codes are append-only)
_CODE_BYTE = {"i8": 0, "f8": 1, "i4": 2, "f4": 3}
_BYTE_CODE = {b: c for c, b in _CODE_BYTE.items()}


def code_to_byte(code: str) -> int:
    """Wire byte for a field code (:mod:`.codec` helper)."""
    return _CODE_BYTE[code]


def byte_to_code(b: int) -> str:
    """Field code for a wire byte; raises ``ValueError`` on unknown bytes."""
    try:
        return _BYTE_CODE[b]
    except KeyError:
        raise ValueError(f"unknown columnar field-code byte {b}") from None


@dataclass(frozen=True)
class Schema:
    """Ordered fixed-width field layout of a :class:`ColumnBlock`.

    ``fields`` is a tuple of ``(name, code)`` pairs with codes from
    :data:`DTYPES`; ``scalar`` marks the bare-scalar single-field form.
    Frozen (hashable, fork-picklable) so operator specs can carry one.
    """

    fields: Tuple[Tuple[str, str], ...]
    scalar: bool = False

    def __post_init__(self):
        if not self.fields:
            raise ValueError("schema needs at least one field")
        names = [n for n, _c in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate schema field names: {names}")
        for name, code in self.fields:
            if code not in DTYPES:
                raise ValueError(
                    f"field {name!r}: unknown code {code!r} "
                    f"(pick from {sorted(DTYPES)})"
                )
        if self.scalar and len(self.fields) != 1:
            raise ValueError("scalar schemas have exactly one field")

    # ------------------------------------------------------------ factories
    @classmethod
    def of(cls, *codes: str, scalar: bool = False) -> "Schema":
        """Positional shorthand: ``Schema.of("i8", "f8")`` names fields
        ``c0..ck``."""
        return cls(
            tuple((f"c{i}", code) for i, code in enumerate(codes)),
            scalar=scalar,
        )

    @classmethod
    def infer(cls, value: Any) -> Optional["Schema"]:
        """Schema for one sample value, or ``None`` when it is not a
        fixed-width numeric scalar/tuple (bools excluded on purpose)."""
        if type(value) is int:
            return cls((("c0", "i8"),), scalar=True)
        if type(value) is float:
            return cls((("c0", "f8"),), scalar=True)
        if type(value) is not tuple or not value:
            return None
        codes = []
        for cell in value:
            if type(cell) is int:
                codes.append("i8")
            elif type(cell) is float:
                codes.append("f8")
            else:
                return None
        return cls.of(*codes)

    # ---------------------------------------------------------- properties
    @property
    def width(self) -> int:
        """Number of columns."""
        return len(self.fields)

    @property
    def names(self) -> Tuple[str, ...]:
        """Field names, in column order."""
        return tuple(n for n, _c in self.fields)

    @property
    def codes(self) -> Tuple[str, ...]:
        """Field codes, in column order."""
        return tuple(c for _n, c in self.fields)

    @property
    def dtypes(self) -> Tuple[np.dtype, ...]:
        """NumPy dtypes, in column order (computed once per instance — the
        builder hot path reads this per block)."""
        dts = self.__dict__.get("_dtypes")
        if dts is None:
            dts = tuple(np.dtype(DTYPES[c]) for _n, c in self.fields)
            object.__setattr__(self, "_dtypes", dts)
        return dts

    @property
    def row_bytes(self) -> int:
        """Fixed bytes per row (the planner's transfer-cost input)."""
        return sum(dt.itemsize for dt in self.dtypes)


_I64 = np.dtype("<i8")

#: the only cell type each Python-exact code admits (bools, numpy scalars,
#: Decimals, … must fall back to pickle so egress types are untouched)
_EXACT_KIND = {"i8": int, "f8": float}


def _pack_column(col: Sequence[Any], code: str, dt: np.dtype):
    """One column of Python cells -> typed vector, or ``None`` on any cell
    that breaks the column's declared type.

    The hot path of :meth:`ColumnBlock.from_values`.  ``i8``/``f8`` columns
    pack through :mod:`array` (a single C loop) and gate on an exact type
    scan — ``set(map(type, col))`` is C-speed, unlike a per-cell genexpr.
    ``i4``/``f4`` columns are declared-cast device schemas, so they take the
    plain NumPy conversion (which raises on junk; the caller catches).
    May raise ``TypeError``/``ValueError``/``OverflowError`` — the caller's
    fallback signal alongside ``None``.
    """
    kind = _EXACT_KIND.get(code)
    if kind is None:  # i4/f4: casting is the declared semantics
        return np.asarray(col, dtype=dt)
    if set(map(type, col)) != {kind}:
        return None
    packed = array("q" if code == "i8" else "d", col)
    return np.frombuffer(packed, dtype=dt)


@dataclass
class ColumnBlock:
    """One columnar micro-batch: per-field NumPy vectors, per-row serials,
    and a ragged ``(row_offset, marker)`` sidecar.

    Invariants: every column (and ``serials``) has the same length;
    column ``i`` has ``schema.dtypes[i]``; ``marks`` offsets are in
    ``[0, len(block))`` and strictly increasing (dispatch order).
    Slicing returns NumPy *views* — blocks are treated as immutable once
    built (the zero-copy contract: decode and slice never copy cell data).
    """

    schema: Schema
    columns: List[np.ndarray]
    serials: np.ndarray
    marks: List[Tuple[int, Any]] = field(default_factory=list)

    # ----------------------------------------------------------- builders
    @classmethod
    def from_values(
        cls,
        values: Sequence[Any],
        head_serial: int = 1,
        marks: Optional[Sequence[Tuple[int, Any]]] = None,
        schema: Optional[Schema] = None,
    ) -> Optional["ColumnBlock"]:
        """Build a block from Python row values, or ``None`` when any row
        breaks the (inferred or given) schema — the pickle-fallback signal.

        Rows are scalars (``scalar`` schema) or equal-width tuples; serials
        are contiguous from ``head_serial`` (the dispatch-unit shape)."""
        if not values:
            return None
        if schema is None:
            schema = Schema.infer(values[0])
            if schema is None:
                return None
        try:
            if schema.scalar:
                col = _pack_column(values, schema.codes[0], schema.dtypes[0])
                if col is None:
                    return None
                cols = [col]
            else:
                k = schema.width
                for v in values:
                    if type(v) is not tuple or len(v) != k:
                        return None
                codes = schema.codes
                kind = _EXACT_KIND.get(codes[0])
                if kind is not None and codes.count(codes[0]) == k:
                    # homogeneous Python-exact schema (the common numeric
                    # unit): pack every cell row-major in ONE C pass, type-
                    # gate in one more, and view columns out of the matrix
                    packed = array(
                        "q" if codes[0] == "i8" else "d",
                        chain.from_iterable(values),
                    )
                    if set(map(type, chain.from_iterable(values))) != {kind}:
                        return None
                    mat2 = np.frombuffer(
                        packed, dtype=schema.dtypes[0]
                    ).reshape(len(values), k)
                    cols = list(mat2.T)
                else:
                    # mixed/narrow schema: per-column pack via transpose
                    cols_py = list(zip(*values))
                    mat: List[np.ndarray] = []
                    for i, dt in enumerate(schema.dtypes):
                        col = _pack_column(cols_py[i], codes[i], dt)
                        if col is None:
                            return None
                        mat.append(col)
                    cols = mat
        except (TypeError, ValueError, OverflowError):
            return None
        n = len(values)
        serials = np.arange(head_serial, head_serial + n, dtype=_I64)
        return cls(schema, cols, serials, list(marks or ()))

    @classmethod
    def from_columns(
        cls,
        schema: Schema,
        columns: Sequence[np.ndarray],
        head_serial: int = 1,
        serials: Optional[np.ndarray] = None,
        marks: Optional[Sequence[Tuple[int, Any]]] = None,
    ) -> "ColumnBlock":
        """Wrap ready-made column vectors (device-result path); casts each
        column to its schema dtype (no-op when already exact)."""
        cols = [
            np.ascontiguousarray(c, dtype=dt)
            for c, dt in zip(columns, schema.dtypes)
        ]
        if len(cols) != schema.width:
            raise ValueError(
                f"{len(cols)} columns for a {schema.width}-field schema"
            )
        n = len(cols[0]) if cols else 0
        if any(len(c) != n for c in cols):
            raise ValueError("ragged columns")
        if serials is None:
            serials = np.arange(head_serial, head_serial + n, dtype=_I64)
        else:
            serials = np.ascontiguousarray(serials, dtype=_I64)
            if len(serials) != n:
                raise ValueError("serials length != column length")
        return cls(schema, cols, serials, list(marks or ()))

    @classmethod
    def concat(cls, blocks: Sequence["ColumnBlock"]) -> "ColumnBlock":
        """Stack same-schema blocks (device batch accumulation)."""
        if not blocks:
            raise ValueError("concat of zero blocks")
        schema = blocks[0].schema
        if any(b.schema != schema for b in blocks):
            raise ValueError("concat of mixed-schema blocks")
        cols = [
            np.concatenate([b.columns[i] for b in blocks])
            for i in range(schema.width)
        ]
        serials = np.concatenate([b.serials for b in blocks])
        marks: List[Tuple[int, Any]] = []
        off = 0
        for b in blocks:
            marks.extend((off + i, m) for i, m in b.marks)
            off += len(b)
        return cls(schema, cols, serials, marks)

    # ------------------------------------------------------------- access
    def __len__(self) -> int:
        return len(self.serials)

    @property
    def nrows(self) -> int:
        """Row count (``len`` alias for readability at call sites)."""
        return len(self.serials)

    @property
    def head_serial(self) -> int:
        """Serial of row 0 (the span head for contiguous blocks)."""
        return int(self.serials[0]) if len(self.serials) else 0

    def contiguous_serials(self) -> bool:
        """Whether serials are ``head, head+1, ...`` (span-slot shape)."""
        n = len(self.serials)
        if n == 0:
            return True
        head = int(self.serials[0])
        return bool(
            (self.serials == np.arange(head, head + n, dtype=_I64)).all()
        )

    def slice(self, start: int, stop: int) -> "ColumnBlock":
        """Row-range view (zero-copy columns/serials; marks re-offset)."""
        marks = [
            (i - start, m) for i, m in self.marks if start <= i < stop
        ]
        return ColumnBlock(
            self.schema,
            [c[start:stop] for c in self.columns],
            self.serials[start:stop],
            marks,
        )

    def with_serials(self, head_serial: int) -> "ColumnBlock":
        """Copy of this block re-stamped with contiguous serials from
        ``head_serial`` (exchange routers re-assign serials per stage)."""
        n = len(self)
        return ColumnBlock(
            self.schema,
            self.columns,
            np.arange(head_serial, head_serial + n, dtype=_I64),
            self.marks,
        )

    def to_values(self) -> list:
        """Back to Python row values — ``int``/``float`` cells are exact for
        ``i8``/``f8`` columns (NumPy ``tolist`` round-trips them bitwise)."""
        if self.schema.scalar:
            return self.columns[0].tolist()
        return list(zip(*[c.tolist() for c in self.columns]))
