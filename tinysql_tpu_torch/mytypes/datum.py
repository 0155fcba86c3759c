"""Scalar values ("datums") and MySQL-compatible coercion/comparison.

Capability parity with reference types/datum.go + types/compare.go +
types/convert.go, reduced to the int/real/string families the reference
supports (SURVEY §2.9).  Host-side scalar path only; the vectorized/TPU path
lives in chunk/ and ops/.
"""
from __future__ import annotations

from typing import Any, Optional

from .field_type import EvalType, FieldType

# A Datum is simply: None (NULL), int, float, or str.
Datum = Optional[object]

_U64_MASK = (1 << 64) - 1
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def wrap_i64(v: int) -> int:
    """Wrap python int into signed-int64 two's-complement range (Go overflow
    semantics differ — reference types/overflow.go errors; we clamp errors at
    the conversion layer and wrap in arithmetic like the columnar path does)."""
    v &= _U64_MASK
    return v - (1 << 64) if v > _I64_MAX else v


def to_int(v: Datum, truncate_ok: bool = True) -> Optional[int]:
    """Convert datum to int64 (reference: types/convert.go ToInt64)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return wrap_i64(v)
    if isinstance(v, float):
        # MySQL rounds half away from zero when casting real->int.
        r = int(v + 0.5) if v >= 0 else -int(-v + 0.5)
        return max(_I64_MIN, min(_I64_MAX, r))
    if isinstance(v, (str, bytes)):
        s = v.decode() if isinstance(v, bytes) else v
        s = s.strip()
        # MySQL parses the leading numeric prefix.
        num = _leading_number(s)
        if num is None:
            if not truncate_ok:
                raise ValueError(f"cannot convert {s!r} to int")
            return 0
        # integer-shaped strings must not round-trip through float (loses
        # precision above 2^53)
        if num.lstrip("+-").isdigit():
            return max(_I64_MIN, min(_I64_MAX, int(num)))
        return to_int(float(num))
    raise TypeError(f"bad datum {v!r}")


def to_uint(v: Datum, truncate_ok: bool = True) -> Optional[int]:
    """Convert datum to uint64 range [0, 2^64) (reference: types/convert.go
    ToUint64)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        if not 0 <= v < (1 << 64):
            raise ValueError(f"constant {v} overflows unsigned bigint")
        return v
    if isinstance(v, float):
        r = int(v + 0.5) if v >= 0 else -int(-v + 0.5)
        if not 0 <= r < (1 << 64):
            raise ValueError(f"constant {v} overflows unsigned bigint")
        return r
    if isinstance(v, (str, bytes)):
        s = (v.decode() if isinstance(v, bytes) else v).strip()
        num = _leading_number(s)
        if num is None:
            if not truncate_ok:
                raise ValueError(f"cannot convert {s!r} to uint")
            return 0
        if num.lstrip("+-").isdigit():
            return to_uint(int(num))
        return to_uint(float(num))
    raise TypeError(f"bad datum {v!r}")


def to_real(v: Datum) -> Optional[float]:
    if v is None:
        return None
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, (str, bytes)):
        s = v.decode() if isinstance(v, bytes) else v
        num = _leading_number(s.strip())
        return float(num) if num is not None else 0.0
    raise TypeError(f"bad datum {v!r}")


def to_string(v: Datum) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, float):
        return format_real(v)
    return str(v)


def format_real(f: float) -> str:
    """MySQL-style float formatting: no trailing .0 for integral values."""
    if f != f or f in (float("inf"), float("-inf")):
        return str(f)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_bool(v: Datum) -> Optional[int]:
    """SQL truthiness: nonzero numeric prefix = true (reference:
    expression/expression.go:205 VecEvalBool semantics)."""
    if v is None:
        return None
    return 1 if to_real(v) != 0.0 else 0


def _leading_number(s: str) -> Optional[str]:
    i, n = 0, len(s)
    if i < n and s[i] in "+-":
        i += 1
    start_digits = i
    while i < n and s[i].isdigit():
        i += 1
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i].isdigit():
            i += 1
    if i < n and s[i] in "eE":
        j = i + 1
        if j < n and s[j] in "+-":
            j += 1
        if j < n and s[j].isdigit():
            i = j
            while i < n and s[i].isdigit():
                i += 1
    text = s[:i]
    if text in ("", "+", "-") or i == start_digits == len(text):
        return None
    try:
        float(text)
        return text
    except ValueError:
        return None


def coerce_for_compare(a: Datum, b: Datum) -> tuple:
    """Coerce two datums to a comparable pair per MySQL comparison rules
    (reference: types/compare.go CompareDatum): NULL handled by caller;
    numeric vs string compares numerically; string vs string binary collate."""
    if isinstance(a, str) and isinstance(b, str):
        return a, b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        # python compares int/float pairs exactly — do NOT lift big ints
        # to float64 (2^63+3 and 2^63+9 both round to the same double)
        return a, b
    if isinstance(a, (int, float)) or isinstance(b, (int, float)):
        return to_real(a), to_real(b)
    return to_string(a), to_string(b)


def datum_compare(a: Datum, b: Datum) -> Optional[int]:
    """3-valued compare: returns -1/0/1, or None if either side is NULL."""
    if a is None or b is None:
        return None
    x, y = coerce_for_compare(a, b)
    if x < y:
        return -1
    if x > y:
        return 1
    return 0


def sort_key(v: Datum):
    """Total-order key for host sorts: NULL first (MySQL ORDER BY semantics)."""
    if v is None:
        return (0, 0)
    if isinstance(v, (int, float)):
        return (1, float(v))
    return (2, v)


def cast_datum(v: Datum, ft: FieldType) -> Datum:
    """Cast a datum to a column's field type on the write path
    (reference: table/column.go CastValue)."""
    if v is None:
        return None
    et = ft.eval_type
    if et is EvalType.INT:
        return to_uint(v) if ft.is_unsigned else to_int(v)
    if et is EvalType.REAL:
        return to_real(v)
    s = to_string(v)
    if ft.flen >= 0 and s is not None and len(s) > ft.flen:
        raise ValueError(f"data too long (len {len(s)} > {ft.flen})")
    return s
