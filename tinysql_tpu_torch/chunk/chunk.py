"""Chunk: a batch of columns with an optional selection vector.

Capability parity with reference util/chunk/chunk.go:31 (Chunk = []Column +
sel) and chunk.go:573-588 (Sel semantics: operators read only selected rows
without materializing).  `required_rows` early-stop mirrors chunk.go:151-165.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..mytypes import FieldType, Datum
from .column import Column

INIT_CHUNK_SIZE = 32      # reference: sessionctx tidb_vars.go:241
MAX_CHUNK_SIZE = 1024     # reference: sessionctx tidb_vars.go:242


class Chunk:
    __slots__ = ("columns", "sel", "required_rows", "virtual_rows")

    def __init__(self, fields: Sequence[FieldType], cap: int = INIT_CHUNK_SIZE):
        self.columns: List[Column] = [Column(ft, cap) for ft in fields]
        self.sel: Optional[np.ndarray] = None
        self.required_rows: int = MAX_CHUNK_SIZE
        # row count for zero-column chunks (TableDual / `SELECT 1`)
        self.virtual_rows: int = 0

    @classmethod
    def from_columns(cls, cols: List[Column], virtual_rows: int = 0) -> "Chunk":
        c = cls([], 1)
        c.columns = cols
        c.virtual_rows = virtual_rows
        return c

    # ---- size ---------------------------------------------------------
    def num_rows(self) -> int:
        if self.sel is not None:
            return len(self.sel)
        if not self.columns:
            return self.virtual_rows
        return len(self.columns[0])

    def full_rows(self) -> int:
        """Physical row count ignoring the selection vector."""
        return len(self.columns[0]) if self.columns else self.virtual_rows

    def num_cols(self) -> int:
        return len(self.columns)

    def is_full(self) -> bool:
        return self.num_rows() >= self.required_rows

    def reset(self) -> None:
        for c in self.columns:
            c.truncate(0)
        self.sel = None
        self.virtual_rows = 0

    # ---- selection vector ---------------------------------------------
    def set_sel(self, sel: Optional[np.ndarray]) -> None:
        self.sel = None if sel is None else np.asarray(sel, dtype=np.int64)

    def compact(self) -> "Chunk":
        """Materialize the selection vector (marshalling boundary only —
        reference keeps Sel lazy, chunk.go:573)."""
        if self.sel is None:
            return self
        if not self.columns:
            # zero-column chunk: the sel vector's length IS the row count
            return Chunk.from_columns([], virtual_rows=len(self.sel))
        return Chunk.from_columns([c.take(self.sel) for c in self.columns])

    # ---- row append ----------------------------------------------------
    def append_row(self, values: Sequence[Datum]) -> None:
        assert self.sel is None
        for c, v in zip(self.columns, values):
            c.append(v)

    def append_chunk_row(self, other: "Chunk", i: int) -> None:
        if not self.columns:
            self.virtual_rows += 1
            return
        phys = other.sel[i] if other.sel is not None else i
        for dst, src in zip(self.columns, other.columns):
            dst.extend(src, phys, phys + 1)

    def append_chunk(self, other: "Chunk") -> None:
        o = other.compact()
        if not self.columns:
            self.virtual_rows += o.num_rows()
            return
        for dst, src in zip(self.columns, o.columns):
            dst.extend(src)

    # ---- row access ----------------------------------------------------
    def get_row(self, i: int) -> List[Datum]:
        phys = self.sel[i] if self.sel is not None else i
        return [c.get(phys) for c in self.columns]

    def rows(self) -> Iterable[List[Datum]]:
        for i in range(self.num_rows()):
            yield self.get_row(i)

    def to_rows(self) -> List[List[Datum]]:
        return [self.get_row(i) for i in range(self.num_rows())]

    def field_types(self) -> List[FieldType]:
        return [c.ft for c in self.columns]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Chunk({self.num_rows()}x{self.num_cols()})"


def new_chunk_like(chk: Chunk, cap: int = INIT_CHUNK_SIZE) -> Chunk:
    return Chunk(chk.field_types(), cap)


def chunk_from_rows(fields: Sequence[FieldType],
                    rows: Iterable[Sequence[Datum]]) -> Chunk:
    c = Chunk(fields)
    for r in rows:
        c.append_row(r)
    return c
