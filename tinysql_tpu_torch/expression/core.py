"""Expression trees: Column / Constant / ScalarFunction.

Capability parity with reference expression/expression.go:44-58 (Expression
iface: scalar Eval* + vectorized VecEval* + Vectorized flag), column.go,
constant.go, scalar_function.go.  TPU-first redesign: the vectorized path
operates on (numpy values, numpy null-mask) pairs — exactly the layout that
marshals onto device arrays; ops/exprjit.py lowers the same tree to a jitted
JAX function for the TPU executors.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..chunk import Chunk, Column as ChunkColumn
from ..mytypes import (Datum, EvalType, FieldType, new_int_type)

_uid = itertools.count(1)


class Expression:
    ret_type: FieldType

    @property
    def eval_type(self) -> EvalType:
        return self.ret_type.eval_type

    # ---- scalar path ---------------------------------------------------
    def eval(self, row: Sequence[Datum]) -> Datum:
        raise NotImplementedError

    # ---- vectorized path -----------------------------------------------
    def vec_eval(self, chk: Chunk) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (values, null_mask) over the chunk's physical rows."""
        raise NotImplementedError

    def vectorized(self) -> bool:
        return True

    # ---- analysis ------------------------------------------------------
    def collect_columns(self, out: Optional[list] = None) -> List["Column"]:
        if out is None:
            out = []
        if isinstance(self, Column):
            out.append(self)
        for a in self.children():
            a.collect_columns(out)
        return out

    def children(self) -> List["Expression"]:
        return []

    def is_constant(self) -> bool:
        return isinstance(self, Constant)

    def key(self) -> str:
        """Canonical string for dedup / memoization (reference:
        Expression.HashCode)."""
        raise NotImplementedError

    def resolve_indices(self, schema: "Schema") -> "Expression":
        """Rebind Column refs to offsets in `schema` (reference:
        planner/core/resolve_indices.go)."""
        raise NotImplementedError


class Column(Expression):
    """A resolved column reference — evaluates by offset into the input row
    or chunk (reference: expression/column.go)."""

    def __init__(self, ret_type: FieldType, index: int = -1,
                 unique_id: Optional[int] = None, name: str = "",
                 table: str = "", db: str = "",
                 stats_col_id: Optional[int] = None):
        self.ret_type = ret_type
        self.index = index
        self.unique_id = unique_id if unique_id is not None else next(_uid)
        self.name = name
        self.table = table
        self.db = db
        # source ColumnInfo.id for histogram/CMS selectivity lookups
        self.stats_col_id = stats_col_id

    def eval(self, row):
        return row[self.index]

    def vec_eval(self, chk: Chunk):
        col = chk.columns[self.index]
        return col.values(), col.null_mask()

    def children(self):
        return []

    def key(self) -> str:
        return f"col#{self.unique_id}"

    def resolve_indices(self, schema: "Schema") -> "Column":
        idx = schema.column_index(self)
        if idx < 0:
            raise ValueError(f"column {self.name or self.unique_id} not in schema")
        return self.clone_with_index(idx)

    def clone_with_index(self, index: int) -> "Column":
        return Column(self.ret_type, index, self.unique_id, self.name,
                      self.table, self.db, self.stats_col_id)

    def renamed(self, name: str = None, table: str = None) -> "Column":
        """Same unique id, new qualifiers (derived-table aliasing)."""
        return Column(self.ret_type, self.index, self.unique_id,
                      name if name is not None else self.name,
                      table if table is not None else self.table, self.db,
                      self.stats_col_id)

    def __repr__(self):  # pragma: no cover
        return f"{self.name or 'col'}#{self.unique_id}@{self.index}"


class Constant(Expression):
    def __init__(self, value: Datum, ret_type: FieldType):
        self.value = value
        self.ret_type = ret_type

    def eval(self, row):
        return self.value

    def vec_eval(self, chk: Chunk):
        n = chk.full_rows()
        if self.value is None:
            et = self.eval_type
            z = np.zeros(n, dtype=np.int64 if et is EvalType.INT
                         else (np.float64 if et is EvalType.REAL else object))
            return z, np.ones(n, dtype=bool)
        if self.eval_type is EvalType.STRING:
            v = np.full(n, self.value)  # fixed-width <U dtype: vectorizes
        elif self.eval_type is EvalType.INT:
            from ..mytypes import wrap_i64
            v = np.full(n, wrap_i64(int(self.value)), dtype=np.int64)
        else:
            v = np.full(n, self.value, dtype=np.float64)
        return v, np.zeros(n, dtype=bool)

    def key(self) -> str:
        return f"const({self.value!r})"

    def resolve_indices(self, schema):
        return self

    def __repr__(self):  # pragma: no cover
        return f"Const({self.value!r})"


class ScalarFunction(Expression):
    """reference: expression/scalar_function.go; impl dispatch lives in
    builtins.py's registry."""

    def __init__(self, name: str, args: List[Expression], ret_type: FieldType,
                 scalar_fn, vec_fn=None):
        self.name = name
        self.args = args
        self.ret_type = ret_type
        self._scalar_fn = scalar_fn
        self._vec_fn = vec_fn

    def eval(self, row):
        return self._scalar_fn([a.eval(row) for a in self.args])

    def vec_eval(self, chk: Chunk):
        if self._vec_fn is not None:
            return self._vec_fn([a.vec_eval(chk) for a in self.args], chk)
        # row-at-a-time fallback (reference: chunk_executor.go)
        n = chk.full_rows()
        et = self.eval_type
        vals = np.zeros(n, dtype=np.int64 if et is EvalType.INT
                        else (np.float64 if et is EvalType.REAL else object))
        null = np.zeros(n, dtype=bool)
        rows = [[c.get(i) for c in chk.columns] for i in range(n)]
        for i, r in enumerate(rows):
            v = self.eval(r)
            if v is None:
                null[i] = True
            else:
                vals[i] = v
        return vals, null

    def vectorized(self) -> bool:
        return self._vec_fn is not None and all(a.vectorized() for a in self.args)

    def children(self):
        return self.args

    def key(self) -> str:
        return f"{self.name}({','.join(a.key() for a in self.args)})"

    def resolve_indices(self, schema):
        return ScalarFunction(self.name, [a.resolve_indices(schema) for a in self.args],
                              self.ret_type, self._scalar_fn, self._vec_fn)

    def __repr__(self):  # pragma: no cover
        return f"{self.name}({', '.join(map(repr, self.args))})"


class Schema:
    """Ordered column list with unique-key info (reference:
    expression/schema.go)."""

    def __init__(self, columns: List[Column]):
        self.columns = columns
        self.keys: List[List[Column]] = []  # unique keys
        self._by_uid = {c.unique_id: i for i, c in enumerate(columns)}

    def column_index(self, col: Column) -> int:
        return self._by_uid.get(col.unique_id, -1)

    def contains(self, col: Column) -> bool:
        return col.unique_id in self._by_uid

    def field_types(self) -> List[FieldType]:
        return [c.ret_type for c in self.columns]

    def __len__(self):
        return len(self.columns)

    def clone(self) -> "Schema":
        s = Schema(list(self.columns))
        s.keys = [list(k) for k in self.keys]
        return s

    def merge(self, other: "Schema") -> "Schema":
        return Schema(self.columns + other.columns)

    def __repr__(self):  # pragma: no cover
        return f"Schema({self.columns})"


def columns_to_chunk_fields(schema: Schema) -> List[FieldType]:
    return schema.field_types()
