"""Expression trees -> HK7 programs: the device-side vectorized evaluator.

The port of tinysql_tpu/ops/exprjit.py (ROADMAP K13).  The reference
traced each numeric expression tree into an XLA program; here
:func:`compile_program` lowers the filter conditions and output
expressions of one call site into ONE linear register program, which the
hand kernel HK7 (csrc/expr_eval.cu, ops/kernels.expr_eval) interprets per
row on the card.  Its plain version (kernels.expr_eval_plain, the CPU's
path) executes the same program instruction by instruction with
:func:`_apply`, which holds the semantics: MySQL 3-valued NULL logic and
the unsigned two's-complement contract (unsigned BIGINT lives wrapped in
int64) over (values, null-mask) tensor pairs.

Only INT/REAL expressions lower; the planner's device enforcer
(planner/device.py) keeps strings on the CPU tier.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
        v, null, decided = case_init(proto.shape[0], dt, proto.device)
        for p in range(pairs):
            v, null, decided = case_arm(v, null, decided, vals[2 * p],
                                        vals[2 * p + 1], dt)
        if has_else:
            v, null = case_else(v, null, decided, vals[-1], dt)
        return v, null
    if name == "in":
        x = vals[0]
        hit, saw_null = in_init(x[0].shape[0], x[0].device)
        for k, item in enumerate(vals[1:], start=1):
            hit, saw_null = in_item(hit, saw_null, x, item, arg_uns[0],
                                    arg_uns[k])
        return in_end(hit, saw_null, x[1])
    if name == "cast_int":
        v, nl = vals[0]
        if v.dtype == I64:
            return v, nl
        return _cast_int(v), nl
    if name == "cast_real":
        v, nl = vals[0]
        return _to_real_u(v, arg_uns[0]), nl
    raise ValueError(f"not jittable: {name}")


def case_init(n: int, dt, dev):
    """CASE's running state: value, NULL (set until an arm decides) and
    the decided flag."""
    return (torch.zeros(n, dtype=dt, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))


def case_arm(v, null, decided, cond: VV, res: VV, dt):
    """One WHEN cond THEN res arm: the first true condition decides."""
    c, nc = _truthy(cond)
    take = c & ~nc & ~decided
    rv, rn = res
    return (torch.where(take, rv.to(dt), v), torch.where(take, rn, null),
            decided | take)


def case_else(v, null, decided, res: VV, dt):
    rv, rn = res
    return torch.where(decided, v, rv.to(dt)), torch.where(decided, null, rn)


def in_init(n: int, dev):
    """IN's running state: a hit and a NULL item seen."""
    z = torch.zeros(n, dtype=torch.bool, device=dev)
    return z, z.clone()


def in_item(hit, saw_null, x: VV, item: VV, ux: bool, ui: bool):
    (xv, xn), (iv, inull) = x, item
    if xv.dtype != iv.dtype:
        eq = _to_real_u(xv, ux) == _to_real_u(iv, ui)
    elif xv.dtype == I64 and (ux or ui):
        eq = _int_lt_eq_j(xv, ux, iv, ui)[1]
    else:
        eq = xv == iv
    return hit | (eq & ~inull & ~xn), saw_null | inull


def in_end(hit, saw_null, xn):
    return hit.to(I64), ~hit & (saw_null | xn)


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

    @staticmethod
    def stack(tables, b: Optional[int] = None):
        """Stack N members' runtime-constant vectors on a LEADING batch
        axis: ``[(int64[Ni], float64[Nf]), ...] -> (int64[B, Ni],
        float64[B, Nf])`` — the parameter operand of a stacked round's
        batched program (ops/kernels.stacked_variant: HK7b reads member
        b's row), where the data columns stay shared and only the
        per-member constants carry the batch dimension.  ``tables`` holds
        ParamTables or their ``arrays()`` pairs; ``b`` pads the batch
        axis up to an occupancy bucket (rows past the member count repeat
        member 0 — inert: the dispatcher takes only real member rows).
        Raises ``ValueError`` on a slot-layout mismatch (members compiled
        from different expression shapes): the round then takes the
        legacy back-to-back leg."""
        pairs = [t.arrays() if isinstance(t, ParamTable) else t
                 for t in tables]
        if not pairs:
            raise ValueError("ParamTable.stack: no members")
        ni, nf = len(pairs[0][0]), len(pairs[0][1])
        for pi, pf in pairs[1:]:
            if len(pi) != ni or len(pf) != nf:
                raise ValueError(
                    f"ParamTable.stack: slot-layout mismatch "
                    f"({len(pi)}i/{len(pf)}f vs {ni}i/{nf}f)")
        b = len(pairs) if b is None else int(b)
        if b < len(pairs):
            raise ValueError(
                f"ParamTable.stack: bucket {b} < occupancy {len(pairs)}")
        idx = list(range(len(pairs))) + [0] * (b - len(pairs))
        return (np.stack([np.asarray(pairs[i][0], dtype=np.int64)
                          for i in idx]),
                np.stack([np.asarray(pairs[i][1], dtype=np.float64)
                          for i in idx]))


def stable_shape_key(e: Expression) -> str:
    """Identity of an expression by schema OFFSETS, types and the
    unsigned flag, with constant VALUES erased — the program-cache key of
    the HK7 programs (same shape + types = same program)."""
    if isinstance(e, Column):
        return f"@{e.index}:{e.ret_type.tp}:{e.ret_type.flag & 32}"
    if isinstance(e, Constant):
        return f"c?({'N' if e.value is None else 'v'}:{e.ret_type.tp})"
    if isinstance(e, ScalarFunction):
        return f"{e.name}({','.join(stable_shape_key(a) for a in e.args)})"
    return repr(e)


def code_cmp(op: str, code, lo, hi, card, null=None):
    """K14: a string compare as an int compare over order-preserving
    dictionary codes with [lo, hi) bounds (the constant's run of equal
    values) and the NULL code ``card`` — one implementation for numpy
    arrays (host filters) and torch tensors (device masks)."""
    live = code != card  # NULL code = card: comparisons exclude it
    if null is not None:
        live = live & ~null
    if op == "=":
        r = (code >= lo) & (code < hi)
    elif op == "!=":
        r = (code < lo) | (code >= hi)
    elif op == "<":
        r = code < lo
    elif op == "<=":
        r = code < hi
    elif op == ">":
        r = code >= hi
    else:  # >=
        r = code >= lo
    return r & live


# =========================================================================
# HK7 expr_eval: expression trees as one linear register program
# =========================================================================
# The compiler below lowers a list of filter conditions (their
# conjunction is the mask) and output expressions into ONE program of
# register instructions, which HK7 (csrc/expr_eval.cu) interprets per row
# and kernels.expr_eval_plain executes instruction by instruction with
# _apply.  Constants stay ParamTable slots, so one program serves every
# query of the same shape key.  Each register holds one 8-byte value
# (int64 or float64 bits) and a NULL bit; its dtype is static:
# "i" int64, "f" float64, "b" bool lane (0/1), "n" a NULL mask only.

#: kernel limits (csrc/expr_eval.cu): instructions and registers per
#: launch, input and output lanes per launch.  A longer program is split
#: into several launches with the live registers in global lanes.
MAX_PROG = 64
MAX_REGS = 16
MAX_IN = 32
MAX_OUT = 32
INS_WORDS = 8   # op, dst, a, b, c, flags, p0, p1 (int32 each)

# opcodes: the order of enum Op in csrc/expr_eval.cu
(OP_LD, OP_LDC, OP_ST, OP_MASK, OP_MOV, OP_CVT,
 OP_ADD, OP_SUB, OP_MUL, OP_FDIV, OP_DIV, OP_MOD,
 OP_NEG, OP_ABS, OP_CMP, OP_AND, OP_OR, OP_XOR, OP_NOT, OP_ISNULL,
 OP_ISTRUE, OP_ISFALSE, OP_IF, OP_IFNULL, OP_CASE_INIT, OP_CASE_ARM,
 OP_CASE_ELSE, OP_IN_INIT, OP_IN_ITEM, OP_IN_END, OP_CAST_INT,
 OP_CODECMP, OP_KEYDEC, OP_AVG) = range(34)

# int64 -> float64 conversions an operand takes before a float op:
# none, signed, or _to_real_u's unsigned (two roundings)
CV_NONE, CV_S2F, CV_U2F = 0, 1, 2
# lane kinds of csrc/expr_eval.cu: 8-byte values, bool values, no values
LANE_W8, LANE_BOOL, LANE_NULL = 0, 2, 3

_ARITH_OP = {"+": OP_ADD, "-": OP_SUB, "*": OP_MUL, "/": OP_FDIV,
             "div": OP_DIV, "%": OP_MOD}
_CMP_CODE = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5, "<=>": 6}
_CODECMP_CODE = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_SIMPLE_OP = {"unaryminus": OP_NEG, "abs": OP_ABS, "and": OP_AND,
              "or": OP_OR, "xor": OP_XOR, "not": OP_NOT,
              "isnull": OP_ISNULL, "istrue": OP_ISTRUE,
              "isfalse": OP_ISFALSE, "if": OP_IF, "ifnull": OP_IFNULL}


def _int_math(name: str, arg_types) -> bool:
    return (arg_types[0] is EvalType.INT and arg_types[1] is EvalType.INT
            and name != "/")


def _col_dt(e: Expression) -> str:
    return "f" if e.eval_type is EvalType.REAL else "i"


def _same_dt(a: str, b: str) -> str:
    return a if a == b else "f"


def _fn_dt(name: str, dts, arg_types) -> str:
    """The dtype _apply gives a function of args with these dtypes."""
    if name in ("+", "-", "*", "%"):
        return "i" if (_int_math(name, arg_types)
                       and dts[0] == dts[1] == "i") else "f"
    if name == "/":
        return "f"
    if name in ("unaryminus", "abs"):
        return dts[0]
    if name == "if":
        return _same_dt(dts[1], dts[2])
    if name == "ifnull":
        return _same_dt(dts[0], dts[1])
    if name == "cast_real":
        return "f"
    return "i"  # div, compares, logic, in, cast_int


def _expr_dt(e: Expression) -> str:
    """Static dtype of a jittable tree (the dtype _apply gives it)."""
    if isinstance(e, Column):
        return _col_dt(e)
    if isinstance(e, Constant):
        return "i" if e.eval_type is EvalType.INT else "f"
    if e.name == "case":
        res = [e.args[i] for i in range(1, len(e.args), 2)]
        if len(e.args) % 2 == 1:
            res.append(e.args[-1])
        return "f" if any(_expr_dt(r) == "f" for r in res) else "i"
    return _fn_dt(e.name, [_expr_dt(a) for a in e.args],
                  [a.eval_type for a in e.args])


def _uns(a: Expression) -> bool:
    return a.eval_type is EvalType.INT \
        and getattr(a.ret_type, "is_unsigned", False)


def _cv(dt: str, uns: bool) -> int:
    """_to_real_u's conversion of an operand of dtype ``dt``."""
    if dt != "i":
        return CV_NONE
    return CV_U2F if uns else CV_S2F


class ExprProgram:
    """A compiled expression program (HK7's input).

    Built by walking items in order: filter conditions (AND-ed into the
    mask) and outputs.  ``inputs`` lists the (schema slot, lane kind)
    pairs it reads; ``outputs`` the dtype of each output lane ("n": a
    NULL mask only).  Constants become slots of the ParamTable passed
    in, in walk order, so two programs of the same shape key are
    identical and the first one built serves both (ops/progcache.py).
    :meth:`segments` lowers it once for the kernel's limits."""

    def __init__(self):
        self.ins: List[tuple] = []     # (kind, defs, uses, meta)
        self.dt: List[str] = []        # virtual register -> dtype
        self.inputs: List[tuple] = []  # (slot, "i" | "f" | "b" | "n")
        self._in_index: dict = {}
        self.outputs: List[str] = []
        self.has_mask = False
        self._segs = None
        self._dev: dict = {}

    # ---- building ---------------------------------------------------------
    def _new(self, dt: str) -> int:
        self.dt.append(dt)
        return len(self.dt) - 1

    def _emit(self, kind, defs, uses, meta=()):
        self.ins.append((kind, tuple(defs), tuple(uses), tuple(meta)))

    def load(self, slot: int, kind: str) -> int:
        """Register holding schema slot ``slot`` read as ``kind``."""
        key = (slot, kind)
        j = self._in_index.get(key)
        if j is None:
            j = self._in_index[key] = len(self.inputs)
            self.inputs.append(key)
        v = self._new(kind)
        self._emit("ld", [v], [], [j])
        return v

    def const(self, value, is_int: bool, pt: ParamTable) -> int:
        slot = pt.add_int(value) if is_int else pt.add_real(value)
        v = self._new("i" if is_int else "f")
        self._emit("ldc", [v], [], [0 if is_int else 1, slot,
                                    value is None])
        return v

    def expr(self, e: Expression, pt: ParamTable) -> int:
        """Lower a jittable tree; returns its result register."""
        if isinstance(e, Column):
            return self.load(e.index, _col_dt(e))
        if isinstance(e, Constant):
            return self.const(e.value, e.eval_type is EvalType.INT, pt)
        assert isinstance(e, ScalarFunction), e
        name = e.name
        if name == "case":
            return self._case(e, pt)
        if name == "in":
            x = self.expr(e.args[0], pt)
            r = self._new("i")
            self._emit("in_init", [r], [])
            ux = _uns(e.args[0])
            for a in e.args[1:]:
                it = self.expr(a, pt)
                self._emit("in_item", [r], [r, x, it], [ux, _uns(a)])
            self._emit("in_end", [r], [r, x])
            return r
        if name not in JITTABLE_FUNCS:
            raise ValueError(f"not jittable: {name}")
        args = [self.expr(a, pt) for a in e.args]
        arg_types = tuple(a.eval_type for a in e.args)
        arg_uns = tuple(_uns(a) for a in e.args)
        dt = _fn_dt(name, [self.dt[a] for a in args], arg_types)
        r = self._new(dt)
        self._emit("fn", [r], args, [name, arg_types, arg_uns,
                                     e.eval_type is EvalType.INT])
        return r

    def _case(self, e, pt) -> int:
        a = e.args
        dt = _expr_dt(e)
        r, dec = self._new(dt), self._new("i")
        self._emit("case_init", [r, dec], [], [dt])
        for p in range(len(a) // 2):
            c = self.expr(a[2 * p], pt)
            v = self.expr(a[2 * p + 1], pt)
            self._emit("case_arm", [r, dec], [r, dec, c, v], [dt])
        if len(a) % 2 == 1:
            v = self.expr(a[-1], pt)
            self._emit("case_else", [r], [r, dec, v], [dt])
        return r

    def code_cmp(self, slot: int, op: str, lo: int, hi: int, card: int,
                 pt: ParamTable) -> int:
        """K14: compare of a string column's dictionary codes."""
        c = self.load(slot, "i")
        r = self._new("i")
        self._emit("codecmp", [r], [c], [op, pt.add_int(lo), pt.add_int(hi),
                                         pt.add_int(card)])
        return r

    def key_decode(self, ids: int, live: int, stride: int, card: int,
                   base: int, pt: ParamTable) -> int:
        """K15: a group key from the mixed-radix group id,
        (ids // stride) % (card + 1) + base; NULL when the code is
        ``card`` or the row is not live."""
        r = self._new("i")
        self._emit("keydec", [r], [ids, live], [pt.add_int(stride),
                                                pt.add_int(card),
                                                pt.add_int(base)])
        return r

    def avg(self, s: int, c: int) -> int:
        """K15: AVG as sum / max(count, 1), NULL when the count is 0."""
        r = self._new("f")
        self._emit("avg", [r], [s, c])
        return r

    def to_real(self, v: int) -> int:
        """float64 of a register (signed conversion, as Tensor.to)."""
        if self.dt[v] == "f":
            return v
        r = self._new("f")
        self._emit("cvt", [r], [v], [CV_S2F])
        return r

    def cond(self, v: int) -> None:
        """AND truthy(v) and not NULL into the mask."""
        self.has_mask = True
        self._emit("mask", [], [v])

    def store(self, v: int, null_only: bool = False) -> int:
        """Make register ``v`` the next output lane; returns its index."""
        k = len(self.outputs)
        self.outputs.append("n" if null_only else self.dt[v])
        self._emit("st", [], [v], [k, null_only])
        return k

    # ---- lowering ---------------------------------------------------------
    def segments(self) -> list:
        """The program cut for the kernel's limits (memoized): each
        segment is one launch whose registers that live past it are
        stored to temporary lanes and loaded again by the next."""
        if self._segs is None:
            self._segs = _lower(self)
        return self._segs

    def n_tmp(self) -> int:
        segs = self.segments()
        return max([t + 1 for s in segs for r in s.in_refs + s.out_refs
                    if r[0] == "tmp" for t in (r[1],)] + [0])

    def device_code(self, dev):
        """The segments' instruction words on ``dev`` (one upload per
        program and device) and each segment's word offset."""
        key = str(dev)
        got = self._dev.get(key)
        if got is None:
            segs = self.segments()
            flat = np.concatenate([s.code.reshape(-1) for s in segs]
                                  + [np.zeros(INS_WORDS, np.int32)])
            t = torch.from_numpy(flat).to(dev)
            offs, o = [], 0
            for s in segs:
                offs.append(o)
                o += s.code.size
            got = self._dev[key] = (t, offs)
        return got


class _Seg:
    """One launch: ``plain`` instructions with physical registers,
    ``code`` their int32 words, and the lanes behind its LD / ST lane
    indexes: ("in", program input) | ("tmp", temp lane) and ("out",
    program output) | ("tmp", temp lane)."""
    __slots__ = ("plain", "code", "in_refs", "out_refs")

    def __init__(self, plain, code, in_refs, out_refs):
        self.plain = plain
        self.code = code
        self.in_refs = in_refs
        self.out_refs = out_refs


def _lower(prog: ExprProgram) -> list:
    ins = prog.ins
    n = len(ins)
    last = {}
    first = {}
    for i, (_k, defs, uses, _m) in enumerate(ins):
        for v in uses + defs:
            last[v] = i
        for v in defs:
            first.setdefault(v, i)
    segs = []
    tmp_of: dict = {}
    s = 0
    while s < n:
        best = None
        e = s + 1
        while e <= n and e - s <= MAX_PROG:
            plan = _plan(prog, s, e, first, last)
            if plan is None:
                break
            best = plan
            e += 1
        if best is None:
            raise ValueError("an instruction exceeds HK7's limits")
        segs.append(_emit_seg(prog, best, tmp_of))
        s = best["e"]
    if not segs:  # no instruction: one launch still writes the mask
        segs.append(_Seg([], np.zeros((0, INS_WORDS), np.int32), [], []))
    return segs


def _plan(prog, s, e, first, last):
    """Register plan of instructions [s, e) as one launch, or None when
    it breaks a limit."""
    ins = prog.ins[s:e]
    live_in = []
    seen = set()
    written = set()
    for _k, defs, uses, _m in ins:
        for v in uses:
            if v not in seen and first[v] < s and v not in written:
                live_in.append(v)
            seen.add(v)
        for v in defs:
            written.add(v)
            seen.add(v)
    live_out = sorted(v for v in written if last[v] >= e)
    n_in = len(live_in) + len({m[0] for k, _d, _u, m in ins if k == "ld"})
    n_out = len(live_out) + sum(1 for k, *_ in ins if k == "st")
    if (len(ins) + len(live_in) + len(live_out) > MAX_PROG
            or n_in > MAX_IN or n_out > MAX_OUT):
        return None
    keep = set(live_out)
    end = {}
    for i, (_k, defs, uses, _m) in enumerate(ins):
        for v in uses + defs:
            end[v] = i
    free = list(range(MAX_REGS - 1, -1, -1))
    phys = {}
    for v in live_in:
        phys[v] = free.pop()
    assign = []
    for i, (_k, defs, uses, _m) in enumerate(ins):
        for v in set(uses):
            if end[v] == i and v not in keep and v not in defs:
                free.append(phys[v])
        for v in defs:
            if v not in phys:
                if not free:
                    return None
                phys[v] = free.pop()
        assign.append(dict(phys))
        for v in defs:
            if end[v] == i and v not in keep:
                free.append(phys[v])
    return {"s": s, "e": e, "live_in": live_in, "live_out": live_out,
            "assign": assign, "phys": phys}


def _emit_seg(prog, plan, tmp_of) -> _Seg:
    s, e = plan["s"], plan["e"]
    in_refs, out_refs = [], []
    in_lane = {}
    plain = []
    words = []

    def lane_in(ref):
        j = in_lane.get(ref)
        if j is None:
            j = in_lane[ref] = len(in_refs)
            in_refs.append(ref)
        return j

    phys0 = plan["phys"]
    for v in plan["live_in"]:
        t = tmp_of[v]
        j = lane_in(("tmp", t))
        plain.append(("ld", (phys0[v],), (), (j,), prog.dt[v]))
        words.append([OP_LD, phys0[v], j, 0, 0, LANE_W8, 0, 0])
    for i, (kind, defs, uses, meta) in enumerate(prog.ins[s:e]):
        ph = plan["assign"][i]
        d = tuple(ph[v] for v in defs)
        u = tuple(ph[v] for v in uses)
        udt = tuple(prog.dt[v] for v in uses)
        if kind == "ld":
            slot_kind = prog.inputs[meta[0]][1]
            j = lane_in(("in", meta[0]))
            meta = (j,)
            lk = {"b": LANE_BOOL, "n": LANE_NULL}.get(slot_kind, LANE_W8)
            words.append([OP_LD, d[0], j, 0, 0, lk, 0, 0])
        elif kind == "st":
            k, null_only = meta
            j = len(out_refs)
            out_refs.append(("out", k))
            meta = (j, null_only)
            words.append([OP_ST, 0, u[0], j, 0, int(bool(null_only)), 0, 0])
        else:
            words.append(_encode(kind, d, u, udt, meta,
                                 prog.dt[defs[0]] if defs else None))
        plain.append((kind, d, u, meta, prog.dt[defs[0]] if defs else None))
    phys_end = plan["assign"][-1] if plan["assign"] else phys0
    for v in plan["live_out"]:
        t = tmp_of.setdefault(v, len(tmp_of))
        j = len(out_refs)
        out_refs.append(("tmp", t))
        plain.append(("st", (), (phys_end[v],), (j, False), None))
        words.append([OP_ST, 0, phys_end[v], j, 0, 0, 0, 0])
    code = np.asarray(words, dtype=np.int32).reshape(-1, INS_WORDS)
    return _Seg(plain, code, in_refs, out_refs)


def _encode(kind, d, u, udt, meta, ddt) -> list:
    """The kernel's instruction words for one typed instruction."""
    dst = d[0] if d else 0
    if kind == "ldc":
        which, slot, is_null = meta
        return [OP_LDC, dst, 0, 0, 0, which | (int(bool(is_null)) << 1),
                slot, 0]
    if kind == "mask":
        return [OP_MASK, 0, u[0], 0, 0, int(udt[0] == "f"), 0, 0]
    if kind == "cvt":
        return [OP_CVT, dst, u[0], 0, 0, meta[0], 0, 0]
    if kind == "case_init":
        return [OP_CASE_INIT, d[0], 0, 0, d[1], 0, 0, 0]
    if kind == "case_arm":
        _r, dec, c, v = u
        cv = CV_S2F if (meta[0] == "f" and udt[3] == "i") else CV_NONE
        return [OP_CASE_ARM, dst, c, v, dec, int(udt[2] == "f") | cv << 2,
                0, 0]
    if kind == "case_else":
        _r, dec, v = u
        cv = CV_S2F if (meta[0] == "f" and udt[2] == "i") else CV_NONE
        return [OP_CASE_ELSE, dst, v, 0, dec, cv << 2, 0, 0]
    if kind == "in_init":
        return [OP_IN_INIT, dst, 0, 0, 0, 0, 0, 0]
    if kind == "in_item":
        ux, ui = meta
        _r, x, it = u
        dx, di = udt[1], udt[2]
        if dx != di:
            mode, ca, cb = 1, _cv(dx, ux), _cv(di, ui)
        elif dx == "i" and (ux or ui):
            mode, ca, cb = 2, CV_NONE, CV_NONE
        else:
            mode, ca, cb = (1 if dx == "f" else 0), CV_NONE, CV_NONE
        return [OP_IN_ITEM, dst, x, it, 0,
                mode | ca << 2 | cb << 4 | int(ux) << 6 | int(ui) << 7, 0, 0]
    if kind == "in_end":
        return [OP_IN_END, dst, u[1], 0, 0, 0, 0, 0]
    if kind == "codecmp":
        op, lo, hi, card = meta
        return [OP_CODECMP, dst, u[0], card, _CODECMP_CODE[op], 0, lo, hi]
    if kind == "keydec":
        stride, card, base = meta
        return [OP_KEYDEC, dst, u[0], u[1], base, 0, stride, card]
    if kind == "avg":
        return [OP_AVG, dst, u[0], u[1], 0, int(udt[0] == "f"), 0, 0]
    assert kind == "fn", kind
    name, arg_types, arg_uns, _ret_int = meta
    if name in _ARITH_OP:
        if _int_math(name, arg_types):
            if not (udt[0] == udt[1] == "i"):
                raise ValueError(f"{name}: integer math over float lanes")
            ca = cb = CV_NONE
            is_f = False
        else:
            ca, cb = _cv(udt[0], arg_uns[0]), _cv(udt[1], arg_uns[1])
            is_f = True
        uns = int(bool(arg_uns[0] and arg_uns[1]))
        return [_ARITH_OP[name], dst, u[0], u[1], 0,
                ca | cb << 2 | int(is_f) << 4 | uns << 5, 0, 0]
    if name in _CMP_CODE:
        ua, ub = arg_uns
        if arg_types[0] is not arg_types[1]:
            mode, ca, cb = 1, _cv(udt[0], ua), _cv(udt[1], ub)
        elif arg_types[0] is EvalType.INT and (ua or ub):
            if not (udt[0] == udt[1] == "i"):
                raise ValueError(f"{name}: unsigned compare of float lanes")
            mode, ca, cb = 2, CV_NONE, CV_NONE
        elif udt[0] != udt[1]:  # torch promotes the int64 side
            mode = 1
            ca = CV_S2F if udt[0] == "i" else CV_NONE
            cb = CV_S2F if udt[1] == "i" else CV_NONE
        else:
            mode, ca, cb = (1 if udt[0] == "f" else 0), CV_NONE, CV_NONE
        return [OP_CMP, dst, u[0], u[1], _CMP_CODE[name],
                ca | cb << 2 | mode << 4 | int(ua) << 6 | int(ub) << 7, 0, 0]
    if name == "cast_int":
        if udt[0] == "i":
            return [OP_MOV, dst, u[0], 0, 0, 0, 0, 0]
        return [OP_CAST_INT, dst, u[0], 0, 0, 0, 0, 0]
    if name == "cast_real":
        cv = _cv(udt[0], arg_uns[0])
        if cv == CV_NONE:
            return [OP_MOV, dst, u[0], 0, 0, 0, 0, 0]
        return [OP_CVT, dst, u[0], 0, 0, cv, 0, 0]
    op = _SIMPLE_OP[name]
    if name == "if":
        cx = CV_S2F if (ddt == "f" and udt[1] == "i") else CV_NONE
        cy = CV_S2F if (ddt == "f" and udt[2] == "i") else CV_NONE
        return [op, dst, u[0], u[1], u[2],
                int(udt[0] == "f") | cx << 2 | cy << 4, 0, 0]
    if name == "ifnull":
        cx = CV_S2F if (ddt == "f" and udt[0] == "i") else CV_NONE
        cy = CV_S2F if (ddt == "f" and udt[1] == "i") else CV_NONE
        return [op, dst, u[0], u[1], 0, cx << 2 | cy << 4, 0, 0]
    fl = int(udt[0] == "f") | (int(len(udt) > 1 and udt[1] == "f") << 1)
    return [op, dst, u[0], u[1] if len(u) > 1 else 0, 0, fl, 0, 0]


def compile_program(conds: Sequence = (), outs: Sequence = (),
                    pt: Optional[ParamTable] = None,
                    mask: bool = False) -> ExprProgram:
    """Lower filter conditions and output expressions into one program.

    ``conds`` items: a jittable Expression, or ("codecmp", slot, op, lo,
    hi, card) (K14).  ``outs`` items: an Expression (values and NULL),
    ("null", Expression) (its NULL mask only: COUNT's argument) or
    ("nullof", slot) (a column's NULL mask).  ``mask``: produce the mask
    even without a condition (the incoming mask AND the row guard)."""
    prog = ExprProgram()
    prog.has_mask = bool(mask)
    pt = pt if pt is not None else ParamTable()
    for c in conds:
        if isinstance(c, tuple):
            _, slot, op, lo, hi, card = c
            prog.cond(prog.code_cmp(slot, op, lo, hi, card, pt))
        else:
            prog.cond(prog.expr(c, pt))
    for o in outs:
        if isinstance(o, tuple):
            if o[0] == "nullof":
                prog.store(prog.load(o[1], "n"), null_only=True)
            else:
                prog.store(prog.expr(o[1], pt), null_only=True)
        else:
            prog.store(prog.expr(o, pt))
    return prog
