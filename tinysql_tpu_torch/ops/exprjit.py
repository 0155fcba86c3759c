"""Expression tree -> torch: the device-side vectorized evaluator.

The port of tinysql_tpu/ops/exprjit.py (ROADMAP K13).  Each numeric
expression tree lowers to a closure over (values, null-mask) tensor pairs
with MySQL 3-valued NULL semantics and the unsigned two's-complement
contract (unsigned BIGINT lives wrapped in int64).  The closures run as
plain torch tensor operations on whatever device the columns live on; in
this slice they are the elementwise prologue that feeds the hand kernels
(HK1/HK2 take the mask and argument lanes they produce).  A generated
Triton prologue per ``stable_shape_key`` is queued in ROADMAP.md.

Only INT/REAL expressions lower; the planner's device enforcer
(planner/device.py) keeps strings on the CPU tier.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..expression import Column, Constant, Expression, ScalarFunction
from ..mytypes import EvalType

I64 = torch.int64
F64 = torch.float64
_SIGN = -(1 << 63)

JITTABLE_FUNCS = {
    "+", "-", "*", "/", "div", "%", "unaryminus", "abs",
    "=", "!=", "<", "<=", ">", ">=", "<=>",
    "and", "or", "xor", "not", "isnull", "istrue", "isfalse",
    "if", "ifnull", "case", "in", "cast_int", "cast_real",
}


def is_jittable(e: Expression) -> bool:
    """Can this tree run on device?  (numeric-only, known functions)"""
    if e.eval_type is EvalType.STRING:
        return False
    if isinstance(e, Column):
        return e.eval_type is not EvalType.STRING
    if isinstance(e, Constant):
        return not isinstance(e.value, str)
    if isinstance(e, ScalarFunction):
        if e.name not in JITTABLE_FUNCS:
            return False
        if (e.name in ("div", "%") and len(e.args) == 2
                and all(a.eval_type is EvalType.INT for a in e.args)):
            u = [getattr(a.ret_type, "is_unsigned", False) for a in e.args]
            if u[0] != u[1]:  # mixed-signedness int div/mod: CPU tier only
                return False
        return all(is_jittable(a) for a in e.args)
    return False


VV = Tuple[torch.Tensor, torch.Tensor]  # (values, bool null-mask)


def _truthy(a: VV):
    v, nl = a
    return v != 0, nl


def _full(n: int, value, dtype, like: torch.Tensor):
    """A broadcast constant of length n as a stride-0 view (no n-sized
    allocation; elementwise ops materialize only their results)."""
    return torch.tensor(value, dtype=dtype, device=like.device).expand(n)


def _to_real_u(v, unsigned: bool):
    """int64 -> float64 honoring the wrapped-uint64 representation."""
    r = v.to(F64)
    if unsigned and v.dtype == I64:
        r = torch.where(v < 0, r + 2.0 ** 64, r)
    return r


def _udivmod(a, b):
    """Unsigned 64-bit division of wrapped int64 tensors (b != 0) using
    signed arithmetic only: the divisor's top bit decides between a 0/1
    quotient and a halved dividend whose quotient is corrected by one."""
    big = b < 0  # divisor >= 2^63 unsigned
    ua_ge = (a ^ _SIGN) >= (b ^ _SIGN)
    q_big = ua_ge.to(I64)
    bs = torch.where(big, torch.ones_like(b), b)
    half = torch.bitwise_right_shift(a, 1) & ((1 << 63) - 1)  # logical >> 1
    q = torch.div(half, bs, rounding_mode="floor") * 2
    r = a - q * bs
    q = torch.where((r ^ _SIGN) >= (bs ^ _SIGN), q + 1, q)
    q = torch.where(big, q_big, q)
    return q, a - q * b


def _int_div_j(a, safe_b, uns):
    """Truncating int64 div/mod.  Both-unsigned runs as unsigned 64-bit
    division; mixed signedness is rejected by is_jittable (CPU tier)."""
    if uns[0] and uns[1]:
        return _udivmod(a, safe_b)
    q = torch.div(torch.abs(a), torch.abs(safe_b), rounding_mode="floor")
    q = torch.where((a < 0) != (safe_b < 0), -q, q)
    return q, a - safe_b * q


def _int_lt_eq_j(a, ua: bool, b, ub: bool):
    """(lt, eq) for int64 tensors with per-side unsignedness — mirrors
    expression/builtins._int_lt_eq."""
    if ua == ub:
        if ua:
            a = a ^ _SIGN
            b = b ^ _SIGN
        return a < b, a == b
    if ua:
        ok = (a >= 0) & (b >= 0)
        return ok & (a < b), ok & (a == b)
    ok = (a >= 0) & (b >= 0)
    return (a < 0) | (b < 0) | (a < b), ok & (a == b)


def _cast_int(v):
    """float64 -> int64 rounding half away from zero, saturating at the
    int64 range, NaN -> 0 (the reference's XLA conversion)."""
    r = torch.where(v >= 0, torch.floor(v + 0.5), -torch.floor(-v + 0.5))
    hi = r >= 2.0 ** 63
    lo = r <= -2.0 ** 63
    nan = torch.isnan(r)
    safe = torch.where(hi | lo | nan, torch.zeros_like(r), r)
    out = safe.to(I64)
    out = torch.where(hi, torch.full_like(out, (1 << 63) - 1), out)
    return torch.where(lo, torch.full_like(out, _SIGN), out)


def _apply(name: str, vals: List[VV], arg_types, ret_int: bool,
           arg_uns=None) -> VV:
    arg_uns = arg_uns or [False] * len(vals)
    if name in ("+", "-", "*", "/", "div", "%"):
        (a, na), (b, nb) = vals
        null = na | nb
        int_math = (arg_types[0] is EvalType.INT
                    and arg_types[1] is EvalType.INT and name != "/")
        if not int_math:
            a = _to_real_u(a, arg_uns[0])
            b = _to_real_u(b, arg_uns[1])
        if name == "+":
            return a + b, null  # int: wrap-correct mod 2^64 any signedness
        if name == "-":
            return a - b, null
        if name == "*":
            return a * b, null
        zero = b == 0
        safe_b = torch.where(zero, torch.ones_like(b), b)
        null = null | zero
        if name == "/":
            return a / safe_b, null
        if name == "div":
            if int_math:
                q = _int_div_j(a, safe_b, arg_uns)[0]
            else:
                q = _cast_trunc(a / safe_b)
            return q, null
        # %
        if int_math:
            return _int_div_j(a, safe_b, arg_uns)[1], null
        m = torch.remainder(torch.abs(a), torch.abs(safe_b))
        return torch.where(zero, torch.zeros_like(a),
                           torch.where(torch.sign(a) >= 0, m, -m)), null
    if name == "unaryminus":
        v, nl = vals[0]
        return -v, nl
    if name == "abs":
        v, nl = vals[0]
        return torch.abs(v), nl
    if name in ("=", "!=", "<", "<=", ">", ">=", "<=>"):
        (a, na), (b, nb) = vals
        if arg_types[0] is not arg_types[1]:
            a = _to_real_u(a, arg_uns[0])
            b = _to_real_u(b, arg_uns[1])
            r = _cmp(name, a, b)
        elif (arg_types[0] is EvalType.INT
              and (arg_uns[0] or arg_uns[1])):
            lt, eq = _int_lt_eq_j(a, arg_uns[0], b, arg_uns[1])
            base = "=" if name == "<=>" else name
            r = {"=": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
                 ">": ~(lt | eq), ">=": ~lt}[base]
        else:
            r = _cmp(name, a, b)
        if name == "<=>":
            v = torch.where(na | nb, na & nb, r)
            return v.to(I64), torch.zeros_like(na)
        return r.to(I64), na | nb
    if name == "and":
        (a, na), (b, nb) = (_truthy(v) for v in vals)
        fa, fb = (~a) & ~na, (~b) & ~nb
        v = (a & b) & ~(na | nb)
        null = (na | nb) & ~(fa | fb)
        return v.to(I64), null
    if name == "or":
        (a, na), (b, nb) = (_truthy(v) for v in vals)
        ta, tb = a & ~na, b & ~nb
        v = ta | tb
        null = (na | nb) & ~v
        return v.to(I64), null
    if name == "xor":
        (a, na), (b, nb) = (_truthy(v) for v in vals)
        return (a != b).to(I64), na | nb
    if name == "not":
        a, na = _truthy(vals[0])
        return (~a).to(I64), na
    if name == "isnull":
        v, nl = vals[0]
        return nl.to(I64), torch.zeros_like(nl)
    if name in ("istrue", "isfalse"):
        a, na = _truthy(vals[0])
        want = name == "istrue"
        v = ~na & (a == want)
        return v.to(I64), torch.zeros_like(na)
    if name == "if":
        c, nc = _truthy(vals[0])
        take = c & ~nc
        (a, na), (b, nb) = _same_kind(vals[1], vals[2])
        return torch.where(take, a, b), torch.where(take, na, nb)
    if name == "ifnull":
        (a, na), (b, nb) = _same_kind(vals[0], vals[1])
        return torch.where(na, b, a), na & nb
    if name == "case":
        has_else = len(vals) % 2 == 1
        pairs = len(vals) // 2
        results = [vals[2 * p + 1] for p in range(pairs)]
        if has_else:
            results.append(vals[-1])
        dt = F64 if any(r[0].dtype == F64 for r in results) else I64
        proto = vals[1][0]
        v = torch.zeros(proto.shape, dtype=dt, device=proto.device)
        null = torch.ones(proto.shape, dtype=torch.bool, device=proto.device)
        decided = torch.zeros(proto.shape, dtype=torch.bool,
                              device=proto.device)
        for p in range(pairs):
            c, nc = _truthy(vals[2 * p])
            take = c & ~nc & ~decided
            rv, rn = vals[2 * p + 1]
            v = torch.where(take, rv.to(dt), v)
            null = torch.where(take, rn, null)
            decided = decided | take
        if has_else:
            rv, rn = vals[-1]
            v = torch.where(decided, v, rv.to(dt))
            null = torch.where(decided, null, rn)
        return v, null
    if name == "in":
        x, xn = vals[0]
        hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        saw_null = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for k, (item, inull) in enumerate(vals[1:], start=1):
            if x.dtype != item.dtype:
                eq = _to_real_u(x, arg_uns[0]) == _to_real_u(item,
                                                              arg_uns[k])
            elif x.dtype == I64 and (arg_uns[0] or arg_uns[k]):
                eq = _int_lt_eq_j(x, arg_uns[0], item, arg_uns[k])[1]
            else:
                eq = x == item
            hit = hit | (eq & ~inull & ~xn)
            saw_null = saw_null | inull
        return hit.to(I64), ~hit & (saw_null | xn)
    if name == "cast_int":
        v, nl = vals[0]
        if v.dtype == I64:
            return v, nl
        return _cast_int(v), nl
    if name == "cast_real":
        v, nl = vals[0]
        return _to_real_u(v, arg_uns[0]), nl
    raise ValueError(f"not jittable: {name}")


def _cmp(name, a, b):
    if name in ("=", "<=>"):
        return a == b
    return {"!=": a != b, "<": a < b, "<=": a <= b, ">": a > b,
            ">=": a >= b}[name]


def _cast_trunc(x):
    """float64 quotient -> int64 truncation toward zero (real DIV)."""
    t = torch.trunc(x)
    hi = t >= 2.0 ** 63
    lo = t < -2.0 ** 63
    nan = torch.isnan(t)
    out = torch.where(hi | lo | nan, torch.zeros_like(t), t).to(I64)
    out = torch.where(hi, torch.full_like(out, (1 << 63) - 1), out)
    return torch.where(lo, torch.full_like(out, _SIGN), out)


def _same_kind(x: VV, y: VV):
    """Branches of if/ifnull as one dtype (jnp.where promotes int64 with
    float64 to float64; torch.where refuses mixed dtypes)."""
    (a, na), (b, nb) = x, y
    if a.dtype != b.dtype:
        a, b = a.to(F64), b.to(F64)
    return (a, na), (b, nb)


class ParamTable:
    """Per-query runtime parameters for device programs.  Constants lower
    to slot reads instead of baked values, so queries that differ only in
    their constants share one registered program (the progcache key is
    the expression SHAPE).  compile_expr_params assigns slots in
    deterministic traversal order and fills the values as it walks."""

    def __init__(self):
        self.i64: list = []
        self.f64: list = []

    def add_int(self, v) -> int:
        from ..mytypes import wrap_i64
        self.i64.append(0 if v is None else wrap_i64(int(v)))
        return len(self.i64) - 1

    def add_real(self, v) -> int:
        self.f64.append(0.0 if v is None else float(v))
        return len(self.f64) - 1

    def arrays(self):
        return (np.asarray(self.i64, dtype=np.int64),
                np.asarray(self.f64, dtype=np.float64))


def compile_expr_params(e: Expression, pt: ParamTable) \
        -> Callable[[Sequence[VV], tuple], VV]:
    """Closure evaluating ``e`` over device (values, null) pairs: it takes
    (cols, (params_i64, params_f64)) and every Constant reads its value
    from a param slot of ``pt``, so queries that differ only in their
    constants share one registered program.  NULL-ness of a constant
    stays structural."""
    if isinstance(e, Column):
        idx = e.index

        def col_fn(cols, params):
            return cols[idx]
        return col_fn
    if isinstance(e, Constant):
        is_null = e.value is None
        if e.eval_type is EvalType.INT:
            slot = pt.add_int(e.value)
            which = 0
        else:
            slot = pt.add_real(e.value)
            which = 1

        def const_fn(cols, params, slot=slot, which=which,
                     is_null=is_null):
            n, like = _broadcast(cols)
            v = params[which][slot].expand(n)
            return v, _full(n, is_null, torch.bool, like)
        return const_fn
    assert isinstance(e, ScalarFunction), e
    args = [compile_expr_params(a, pt) for a in e.args]
    arg_types = [a.eval_type for a in e.args]
    arg_uns = [a.eval_type is EvalType.INT
               and getattr(a.ret_type, "is_unsigned", False) for a in e.args]
    name = e.name
    ret_int = e.eval_type is EvalType.INT

    def fn(cols, params):
        vals = [a(cols, params) for a in args]
        return _apply(name, vals, arg_types, ret_int, arg_uns)
    return fn


def _broadcast(cols):
    """(length, a tensor on the columns' device) from the first populated
    slot (sparse device-column lists hold None for untouched columns;
    string slots may carry only their null mask)."""
    for c in cols:
        if c is None:
            continue
        arr = c[0] if c[0] is not None else c[1]
        if arr is not None:
            return arr.shape[0], arr
    from . import kernels
    return 1, torch.empty(0, device=kernels.device())


def stable_shape_key(e: Expression) -> str:
    """Identity of an expression by schema OFFSETS, types and the
    unsigned flag, with constant VALUES erased — the program-cache key of
    the params-compiled closures (same shape + types = same program)."""
    if isinstance(e, Column):
        return f"@{e.index}:{e.ret_type.tp}:{e.ret_type.flag & 32}"
    if isinstance(e, Constant):
        return f"c?({'N' if e.value is None else 'v'}:{e.ret_type.tp})"
    if isinstance(e, ScalarFunction):
        return f"{e.name}({','.join(stable_shape_key(a) for a in e.args)})"
    return repr(e)
