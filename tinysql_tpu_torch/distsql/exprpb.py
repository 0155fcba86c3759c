"""Expression <-> wire-form codec for coprocessor pushdown.

Capability parity with reference expression/expr_to_pb.go (expression ->
tipb.Expr with pushdown eligibility checks) and distsql_builtin.go (the
reverse decode on the storage side).  The wire form is a plain dict tree —
the in-process analogue of the protobuf — and the decode path rebuilds
through `new_function`, so the storage side executes the SAME typed builtin
implementations the root executor would.
"""
from __future__ import annotations

from typing import List, Optional

from ..expression import Column, Constant, Expression, ScalarFunction
from ..expression.builtins import new_function
from ..mytypes import FieldType

# functions the coprocessor can evaluate (reference expr_to_pb.go canFuncBePushed)
PUSHABLE_FUNCS = {
    "+", "-", "*", "/", "div", "%", "unaryminus",
    "=", "!=", "<", "<=", ">", ">=", "<=>",
    "and", "or", "xor", "not", "isnull", "istrue", "isfalse",
    "if", "ifnull", "case", "in", "like",
}


def _ft_to_pb(ft: FieldType) -> dict:
    return {"tp": ft.tp, "flag": ft.flag, "flen": ft.flen}


def _ft_from_pb(d: dict) -> FieldType:
    return FieldType(tp=d["tp"], flag=d["flag"], flen=d["flen"])


def can_push(e: Expression) -> bool:
    if isinstance(e, (Column, Constant)):
        return True
    if isinstance(e, ScalarFunction):
        if e.name not in PUSHABLE_FUNCS:
            return False
        return all(can_push(a) for a in e.args)
    return False


def expr_to_pb(e: Expression) -> dict:
    """Offset-bound expression -> wire dict.  Raises ValueError on
    non-pushable trees (caller gates with can_push)."""
    if isinstance(e, Column):
        if e.index < 0:
            raise ValueError(f"unbound column {e!r}")
        return {"t": "col", "i": e.index, "ft": _ft_to_pb(e.ret_type)}
    if isinstance(e, Constant):
        return {"t": "const", "v": e.value, "ft": _ft_to_pb(e.ret_type)}
    if isinstance(e, ScalarFunction):
        if e.name not in PUSHABLE_FUNCS:
            raise ValueError(f"not pushable: {e.name}")
        return {"t": "func", "name": e.name,
                "args": [expr_to_pb(a) for a in e.args]}
    raise ValueError(f"cannot encode {type(e).__name__}")


def pb_to_expr(d: dict) -> Expression:
    """Wire dict -> executable expression (reference: distsql_builtin.go
    PBToExpr).  Columns come back offset-bound to the scan output."""
    t = d["t"]
    if t == "col":
        return Column(_ft_from_pb(d["ft"]), index=d["i"])
    if t == "const":
        return Constant(d["v"], _ft_from_pb(d["ft"]))
    if t == "func":
        return new_function(d["name"], [pb_to_expr(a) for a in d["args"]])
    raise ValueError(f"bad expr pb {d!r}")


def exprs_to_pb(exprs: List[Expression]) -> Optional[List[dict]]:
    """All-or-nothing encode (reference: ExpressionsToPBList)."""
    if not all(can_push(e) for e in exprs):
        return None
    return [expr_to_pb(e) for e in exprs]
