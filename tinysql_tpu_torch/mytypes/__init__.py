"""Typed values for the engine.

Capability parity with the reference's three eval families
(reference: util/chunk/column.go:64-76 — ETInt / ETReal / ETString;
types/eval_type.go): int64, float64, string.  No DECIMAL/TIME exists in the
reference (SURVEY §2.9), so none here.
"""
from .field_type import (
    EvalType,
    FieldType,
    TYPE_LONG,
    TYPE_LONGLONG,
    TYPE_FLOAT,
    TYPE_DOUBLE,
    TYPE_VARCHAR,
    TYPE_STRING,
    TYPE_NULL,
    FLAG_NOT_NULL,
    FLAG_PRI_KEY,
    FLAG_UNIQUE_KEY,
    FLAG_UNSIGNED,
    FLAG_AUTO_INCREMENT,
    new_int_type,
    new_real_type,
    new_string_type,
    agg_field_type,
)
from .datum import (
    Datum,
    datum_compare,
    coerce_for_compare,
    cast_datum,
    sort_key,
    format_real,
    to_int,
    to_uint,
    to_real,
    to_string,
    to_bool,
    wrap_i64,
)

__all__ = [
    "EvalType", "FieldType",
    "TYPE_LONG", "TYPE_LONGLONG", "TYPE_FLOAT", "TYPE_DOUBLE",
    "TYPE_VARCHAR", "TYPE_STRING", "TYPE_NULL",
    "FLAG_NOT_NULL", "FLAG_PRI_KEY", "FLAG_UNIQUE_KEY", "FLAG_UNSIGNED",
    "FLAG_AUTO_INCREMENT",
    "new_int_type", "new_real_type", "new_string_type", "agg_field_type",
    "Datum", "datum_compare", "coerce_for_compare", "cast_datum", "sort_key",
    "format_real", "to_int", "to_uint", "to_real", "to_string", "to_bool",
    "wrap_i64",
]
