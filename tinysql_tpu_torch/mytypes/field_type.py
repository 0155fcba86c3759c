"""Field types and eval types.

Mirrors the *capability* of the reference's types/field_type.go +
types/eval_type.go: the engine supports exactly three eval families —
int (signed/unsigned int64), real (float64), string — as documented in
SURVEY §0.2 and enforced by reference util/chunk/column.go:64-76.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

# MySQL-ish type codes (subset actually reachable in the reference grammar).
TYPE_NULL = 0x06
TYPE_LONG = 0x03        # INT
TYPE_LONGLONG = 0x08    # BIGINT
TYPE_FLOAT = 0x04
TYPE_DOUBLE = 0x05
TYPE_VARCHAR = 0x0F
TYPE_STRING = 0xFE      # CHAR

_INT_TYPES = {TYPE_LONG, TYPE_LONGLONG}
_REAL_TYPES = {TYPE_FLOAT, TYPE_DOUBLE}
_STRING_TYPES = {TYPE_VARCHAR, TYPE_STRING}

# Column flags (subset of parser/mysql/type.go flags used by the engine).
FLAG_NOT_NULL = 1
FLAG_PRI_KEY = 2
FLAG_UNIQUE_KEY = 4
FLAG_UNSIGNED = 32
FLAG_AUTO_INCREMENT = 512


class EvalType(enum.Enum):
    """The three vectorized evaluation families (reference: types/eval_type.go)."""
    INT = "int"
    REAL = "real"
    STRING = "string"

    @property
    def fixed_width(self) -> bool:
        return self is not EvalType.STRING


@dataclass
class FieldType:
    tp: int = TYPE_LONGLONG
    flag: int = 0
    flen: int = -1
    decimal: int = -1
    charset: str = "utf8mb4"
    collate: str = "utf8mb4_bin"

    @property
    def eval_type(self) -> EvalType:
        if self.tp in _INT_TYPES:
            return EvalType.INT
        if self.tp in _REAL_TYPES:
            return EvalType.REAL
        if self.tp in _STRING_TYPES or self.tp == TYPE_NULL:
            return EvalType.STRING if self.tp != TYPE_NULL else EvalType.INT
        raise ValueError(f"unsupported field type {self.tp}")

    @property
    def is_unsigned(self) -> bool:
        return bool(self.flag & FLAG_UNSIGNED)

    @property
    def not_null(self) -> bool:
        return bool(self.flag & FLAG_NOT_NULL)

    def clone(self) -> "FieldType":
        return FieldType(self.tp, self.flag, self.flen, self.decimal,
                         self.charset, self.collate)

    def type_name(self) -> str:
        return {
            TYPE_LONG: "int", TYPE_LONGLONG: "bigint",
            TYPE_FLOAT: "float", TYPE_DOUBLE: "double",
            TYPE_VARCHAR: "varchar", TYPE_STRING: "char",
            TYPE_NULL: "null",
        }[self.tp]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        u = " unsigned" if self.is_unsigned else ""
        return f"FieldType({self.type_name()}{u})"


def new_int_type(unsigned: bool = False, not_null: bool = False) -> FieldType:
    flag = (FLAG_UNSIGNED if unsigned else 0) | (FLAG_NOT_NULL if not_null else 0)
    return FieldType(TYPE_LONGLONG, flag=flag, flen=20)


def new_real_type(not_null: bool = False) -> FieldType:
    return FieldType(TYPE_DOUBLE, flag=(FLAG_NOT_NULL if not_null else 0), flen=22)


def new_string_type(flen: int = -1, not_null: bool = False) -> FieldType:
    return FieldType(TYPE_VARCHAR, flag=(FLAG_NOT_NULL if not_null else 0), flen=flen)


def agg_field_type(fts: list[FieldType]) -> FieldType:
    """Merge field types (reference: types/field_type.go AggFieldType semantics,
    reduced to the 3-family lattice: string > real > int)."""
    best = EvalType.INT
    unsigned = True
    for ft in fts:
        et = ft.eval_type
        if et is EvalType.STRING:
            best = EvalType.STRING
        elif et is EvalType.REAL and best is EvalType.INT:
            best = EvalType.REAL
        unsigned = unsigned and ft.is_unsigned
    if best is EvalType.STRING:
        return new_string_type()
    if best is EvalType.REAL:
        return new_real_type()
    return new_int_type(unsigned=unsigned)
