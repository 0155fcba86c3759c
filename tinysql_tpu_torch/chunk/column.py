"""Columnar vector: fixed-width numpy buffer + null bitmap.

Capability parity with reference util/chunk/column.go:28 (data buffer +
null bitmap + elem buf), redesigned TPU-first: the numeric families are
contiguous numpy int64/float64 arrays that marshal zero-copy-ish to
`jax.Array`; the null bitmap is a boolean mask (True = NULL) that becomes the
device-side validity mask.  Strings stay host-side (object array) — the
planner's device enforcer (planner/core/task.py) keeps them off TPU, mirroring
the north-star numeric-only gate.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..mytypes import EvalType, FieldType, Datum
from ..utils import memory as _memory

_INIT_CAP = 32


def _np_dtype(et: EvalType):
    if et is EvalType.INT:
        return np.int64
    if et is EvalType.REAL:
        return np.float64
    return object


class Column:
    """A growable typed vector with a null mask.

    Memory accounting is PAIRED: every buffer charge remembers the
    tracker it hit (utils/memory.py), and the charge is released when
    the buffers are freed (``__del__`` / :meth:`free` / ``truncate(0)``)
    — so a statement's tracker reports its LIVE working set, long-lived
    sessions don't monotonically over-report, and spill reloads net out
    instead of double-counting."""

    __slots__ = ("ft", "_data", "_null", "_len", "_tracker", "_charged")

    def __init__(self, ft: FieldType, cap: int = _INIT_CAP):
        self.ft = ft
        dt = _np_dtype(ft.eval_type)
        self._data = np.zeros(max(cap, 1), dtype=dt)
        self._null = np.zeros(max(cap, 1), dtype=bool)
        self._len = 0
        # per-query memory quota (utils/memory.py): charge the buffer
        # capacity; no-op without an active tracker
        self._tracker = None
        self._charged = 0
        self._charge(self._data.nbytes + self._null.nbytes)

    # ---- quota pairing ------------------------------------------------
    def _charge(self, n: int) -> None:
        if n <= 0:
            return
        if self._tracker is None:
            self._tracker = _memory.consume_tracked(n)
            if self._tracker is not None:
                self._charged = n
        else:
            # later growth charges the column's OWN tracker (the one it
            # was born under), keeping the charge/release pair balanced
            # even if the column outlives its statement
            self._tracker.consume(n)
            self._charged += n

    def _release_all(self) -> None:
        if self._tracker is not None and self._charged > 0:
            self._tracker.release(self._charged)
        self._charged = 0

    def _adopt_charge(self, other: "Column") -> None:
        """Take over ``other``'s charge (its buffers became ours): the
        lazily-materializing subclasses steal the freshly built column's
        arrays, so the release must move with them."""
        self._release_all()
        self._tracker = other._tracker
        self._charged = other._charged
        other._tracker = None
        other._charged = 0

    def free(self) -> None:
        """Drop the buffers and release their charge now (spill paths
        call this the moment a partition is written out, instead of
        waiting for GC)."""
        self._release_all()
        self._data = np.zeros(1, dtype=_np_dtype(self.ft.eval_type))
        self._null = np.zeros(1, dtype=bool)
        self._len = 0

    def __del__(self):
        try:
            self._release_all()
        except Exception:  # interpreter teardown: modules half-gone
            pass

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_numpy(cls, ft: FieldType, data: np.ndarray,
                   null: Optional[np.ndarray] = None) -> "Column":
        c = cls(ft, cap=1)
        n = len(data)
        dt = _np_dtype(ft.eval_type)
        c._data = np.ascontiguousarray(data, dtype=dt)
        c._null = (np.zeros(n, dtype=bool) if null is None
                   else np.asarray(null, dtype=bool).copy())
        c._len = n
        # the cap-1 seed buffers were just replaced: re-pair the charge
        # against the real materialization
        c._release_all()
        c._tracker = None
        c._charge(c._data.nbytes + c._null.nbytes)
        return c

    @classmethod
    def wrap_raw(cls, ft: FieldType, data: np.ndarray,
                 null: Optional[np.ndarray] = None) -> "Column":
        """Zero-copy wrap: `data` is used as-is (any dtype, incl. <U string
        arrays) — the columnar-replica fast path's view constructor."""
        c = cls(ft, cap=1)
        c._data = data
        c._null = (null if null is not None
                   else np.zeros(len(data), dtype=bool))
        c._len = len(data)
        return c

    @classmethod
    def from_datums(cls, ft: FieldType, values: Iterable[Datum]) -> "Column":
        c = cls(ft)
        for v in values:
            c.append(v)
        return c

    # ---- size ---------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def _ensure_host(self) -> None:
        """Hook for lazily-materialized subclasses (DeviceColumn): a
        no-op here.  Every accessor that touches the host buffers calls
        it first, so device-resident columns stay on device until a host
        consumer actually reads them."""

    def _grow(self, need: int) -> None:
        self._ensure_host()
        cap = len(self._data)
        if self._len + need <= cap:
            return
        new_cap = max(cap * 2, self._len + need)
        self._charge((new_cap - cap)
                     * (self._data.itemsize + self._null.itemsize))
        self._data = np.resize(self._data, new_cap)
        self._null = np.resize(self._null, new_cap)

    # ---- append -------------------------------------------------------
    def append(self, v: Datum) -> None:
        self._grow(1)
        i = self._len
        if v is None:
            self._null[i] = True
            self._data[i] = 0 if self.ft.eval_type is not EvalType.STRING else ""
        else:
            self._null[i] = False
            if isinstance(v, int) and not (-(1 << 63) <= v < (1 << 63)):
                # unsigned values live in the int64 buffer two's-complement
                # wrapped (reference: column.go stores uint64 in the same buf)
                v = (v & ((1 << 64) - 1)) - (1 << 64) if v & (1 << 63) else v & ((1 << 64) - 1)
            self._data[i] = v
        self._len = i + 1

    def append_null(self) -> None:
        self.append(None)

    def extend(self, other: "Column", start: int = 0,
               end: Optional[int] = None) -> None:
        other._ensure_host()
        end = other._len if end is None else end
        n = end - start
        if n <= 0:
            return
        self._grow(n)
        self._data[self._len:self._len + n] = other._data[start:end]
        self._null[self._len:self._len + n] = other._null[start:end]
        self._len += n

    def extend_take(self, other: "Column", idx: np.ndarray) -> None:
        other._ensure_host()
        n = len(idx)
        if n == 0:
            return
        self._grow(n)
        self._data[self._len:self._len + n] = other._data[:other._len][idx]
        self._null[self._len:self._len + n] = other._null[:other._len][idx]
        self._len += n

    # ---- access -------------------------------------------------------
    def get(self, i: int) -> Datum:
        self._ensure_host()
        if self._null[i]:
            return None
        v = self._data[i]
        et = self.ft.eval_type
        if et is EvalType.INT:
            iv = int(v)
            if self.ft.is_unsigned and iv < 0:
                iv += 1 << 64
            return iv
        if et is EvalType.REAL:
            return float(v)
        return str(v)  # normalize np.str_ -> str

    def is_null(self, i: int) -> bool:
        self._ensure_host()
        return bool(self._null[i])

    def values(self) -> np.ndarray:
        """Raw buffer view, length-trimmed (reference: column.go Int64s())."""
        self._ensure_host()
        return self._data[:self._len]

    def null_mask(self) -> np.ndarray:
        self._ensure_host()
        return self._null[:self._len]

    def datums(self) -> List[Datum]:
        return [self.get(i) for i in range(self._len)]

    # ---- transforms ---------------------------------------------------
    def take(self, idx: np.ndarray) -> "Column":
        c = Column(self.ft, cap=max(len(idx), 1))
        c.extend_take(self, np.asarray(idx, dtype=np.int64))
        return c

    def slice(self, start: int, end: int) -> "Column":
        c = Column(self.ft, cap=max(end - start, 1))
        c.extend(self, start, end)
        return c

    def copy(self) -> "Column":
        return self.slice(0, self._len)

    def truncate(self, n: int) -> None:
        self._len = min(self._len, n)
        if n == 0 and self._data is not None and len(self._data) > _INIT_CAP:
            # a full reset frees the (possibly large) buffers and returns
            # their charge — a truncated-then-idle column must not pin a
            # statement-sized allocation on the session's books
            self.free()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Column({self.ft.type_name()}, {self.datums()[:8]}{'...' if self._len > 8 else ''})"


class DeviceColumn(Column):
    """Device-resident column: values/null live as torch tensors padded to
    a power-of-two bucket; host buffers materialize lazily on first host
    access, through counted pulls only (kernels.d2h_many).  The per-op TPU tier's late-materialization carrier — an
    aggregate output consumed by the join above it never round-trips
    through host memory (the reference's chunk always lives in Go heap,
    column.go:28; on TPU the chunk's natural home is HBM).

    Rows [0:_len) are live; padding rows carry null=True so device
    consumers (join match) treat them as no-match."""

    __slots__ = ("_dev_v", "_dev_n")

    def __init__(self, ft: FieldType, dev_v, dev_n, n: int):
        self.ft = ft
        self._data = None         # host buffers: absent until demanded
        self._null = None
        self._len = n
        self._tracker = None
        self._charged = 0
        self._dev_v = dev_v
        self._dev_n = dev_n

    def device_pair(self):
        """(values, null) tensors, bucket-padded (padding null=True)."""
        return self._dev_v, self._dev_n

    def device_bucket(self) -> int:
        return int(self._dev_v.shape[0])

    def _ensure_host(self) -> None:
        if self._data is None:
            # one COUNTED pull for both streams (values + null mask) —
            # raw np.asarray here was a hidden uncounted d2h (DF801)
            from ..ops import kernels
            v, m = kernels.d2h_many([self._dev_v, self._dev_n])
            v = v[:self._len]
            m = m[:self._len]
            dt = _np_dtype(self.ft.eval_type)
            self._data = np.ascontiguousarray(v, dtype=dt)
            self._null = np.asarray(m, dtype=bool).copy()
            self._charge(self._data.nbytes + self._null.nbytes)

    def take(self, idx: np.ndarray) -> "Column":
        """Gather on device, land only the gathered rows on host — the
        late-materialization payoff: a join keeping k of n rows downloads
        k values, not n."""
        if self._data is not None:
            return super().take(idx)
        from ..ops import kernels
        di = kernels.h2d(np.asarray(idx, dtype=np.int64))
        v, m = kernels.d2h_many([self._dev_v[di], self._dev_n[di]])
        dt = _np_dtype(self.ft.eval_type)
        return Column.from_numpy(
            self.ft, np.ascontiguousarray(v, dtype=dt),
            np.asarray(m, dtype=bool))


class LazyTakeColumn(Column):
    """Deferred gather: (source column, row indices) materialized only on
    first host access.  Joins emit their output columns as lazy takes, so
    a chain join -> join -> TopN gathers each payload column ONCE at the
    final (smallest) cardinality instead of at every operator — the
    late-materialization analogue of the reference's chunk.Row indirection
    (util/chunk/chunk.go:573 Sel semantics), generalized across operators.

    take() composes index arrays without touching the data, and the source
    may itself be a DeviceColumn (the final gather then runs on device)."""

    __slots__ = ("_src", "_idx")

    def __init__(self, src: Column, idx: np.ndarray):
        self.ft = src.ft
        self._data = None
        self._null = None
        self._tracker = None
        self._charged = 0
        self._idx = np.asarray(idx, dtype=np.int64)
        self._len = len(self._idx)
        self._src = src

    def _ensure_host(self) -> None:
        if self._data is None:
            mat = self._src.take(self._idx)
            mat._ensure_host()
            self._data = mat._data
            self._null = mat._null
            # the materialized column's buffers are now OURS: move its
            # charge here so `mat`'s __del__ doesn't release live bytes
            self._adopt_charge(mat)

    def take(self, idx: np.ndarray) -> "Column":
        if self._data is not None:
            return super().take(idx)
        return LazyTakeColumn(self._src,
                              self._idx[np.asarray(idx, dtype=np.int64)])
