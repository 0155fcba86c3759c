"""The expression battery: seeded columns and trees for every SQL function
the device evaluates (ops/exprjit.JITTABLE_FUNCS), for holding HK7
(csrc/expr_eval.cu) against its plain version and both against the JAX
package.

Columns (slots): 0 int, 1 int, 2 real, 3 real, 4 unsigned int, 5
unsigned int — each with NULLs, int64 min and max, zeros, signed zeros,
huge reals and unsigned words past 2^63.  A tree is a nested tuple:
("col", slot) | ("const", "int" | "real" | "uint", value) | (function
name, *args); :func:`build` turns it into an expression of a package's
expression module (the port's by default).
"""
from __future__ import annotations

import numpy as np

N = 257
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
SLOT_TYPES = ["int", "int", "real", "real", "uint", "uint"]


def columns(seed: int, n: int = N):
    """(values, NULL masks) per slot, numpy, made from ``seed``."""
    rng = np.random.default_rng(seed)
    ints = [rng.integers(-50, 50, n) for _ in range(2)]
    for a in ints:
        a[:6] = [I64_MIN, I64_MAX, 0, -1, 1, I64_MIN]
        a[6:12] = rng.integers(I64_MIN, I64_MAX, 6, endpoint=True)
    reals = [np.round(rng.normal(size=n) * 40, 3) for _ in range(2)]
    for a in reals:
        a[:6] = [0.0, -0.0, 1e300, -1e300, 2.5, -2.5]
        a[6] = 9.3e18
    uns = [rng.integers(I64_MIN, I64_MAX, n, endpoint=True)
           for _ in range(2)]
    for a in uns:
        a[:4] = [0, -1, I64_MIN, 1]
    vals = [ints[0].astype(np.int64), ints[1].astype(np.int64),
            reals[0], reals[1], uns[0].astype(np.int64),
            uns[1].astype(np.int64)]
    nulls = [rng.random(n) < 0.15 for _ in vals]
    return vals, nulls


def build(spec, pkg=None, types=None):
    """The expression of a tree, built with ``pkg`` (an expression
    module) and ``types`` (its mytypes module)."""
    if pkg is None:
        from .. import expression as pkg
    if types is None:
        from .. import mytypes as types

    def ft(kind):
        if kind == "int":
            return types.new_int_type()
        if kind == "uint":
            return types.new_int_type(unsigned=True)
        return types.new_real_type()

    def go(s):
        if s[0] == "col":
            return pkg.Column(ft(SLOT_TYPES[s[1]]), index=s[1])
        if s[0] == "const":
            return pkg.Constant(s[2], ft(s[1]))
        return pkg.new_function(s[0], [go(a) for a in s[1:]])
    return go(spec)


def C(i):
    return ("col", i)


def K(kind, v):
    return ("const", kind, v)


CASES = {
    "+": [("+", C(0), C(1)), ("+", C(0), C(2)), ("+", C(4), C(5))],
    "-": [("-", C(0), C(1)), ("-", C(2), C(3))],
    "*": [("*", C(0), C(1)), ("*", C(2), K("int", 3))],
    "/": [("/", C(0), C(1)), ("/", C(2), C(3)), ("/", C(4), C(0))],
    "div": [("div", C(0), C(1)), ("div", C(2), C(3)), ("div", C(4), C(5)),
            ("div", C(0), K("int", -1))],
    "%": [("%", C(0), C(1)), ("%", C(2), C(3)), ("%", C(4), C(5)),
          ("%", C(2), K("real", 0.0))],
    "unaryminus": [("unaryminus", C(0)), ("unaryminus", C(2))],
    "abs": [("abs", C(0)), ("abs", C(3))],
    "=": [("=", C(0), C(1)), ("=", C(4), C(0)), ("=", C(2), C(0))],
    "!=": [("!=", C(4), C(5)), ("!=", C(2), C(3))],
    "<": [("<", C(0), C(1)), ("<", C(4), C(5)), ("<", C(0), C(4)),
          ("<", C(2), C(1))],
    "<=": [("<=", C(4), C(0)), ("<=", C(2), C(3))],
    ">": [(">", C(0), C(4)), (">", C(2), K("real", 1.5))],
    ">=": [(">=", C(4), C(5)), (">=", C(1), K("int", 3))],
    "<=>": [("<=>", C(0), C(1)), ("<=>", C(4), C(0)),
            ("<=>", C(2), K("real", None))],
    "and": [("and", C(0), C(1)), ("and", C(2), C(4))],
    "or": [("or", C(0), C(1)), ("or", C(3), K("int", None))],
    "xor": [("xor", C(0), C(2))],
    "not": [("not", C(0)), ("not", C(3))],
    "isnull": [("isnull", C(1)), ("isnull", C(2))],
    "istrue": [("istrue", C(0)), ("istrue", C(3))],
    "isfalse": [("isfalse", C(0)), ("isfalse", C(2))],
    "if": [("if", C(0), C(1), C(2)), ("if", C(2), C(0), C(1))],
    "ifnull": [("ifnull", C(0), C(1)), ("ifnull", C(2), C(0))],
    "case": [("case", ("<", C(0), K("int", 0)), C(1), C(2)),
             ("case", ("<", C(0), K("int", 0)), C(1),
              (">", C(2), K("real", 1.0)), C(0))],
    "in": [("in", C(0), K("int", 3), K("int", -7), C(1)),
           ("in", C(2), K("real", 2.5), K("int", None)),
           ("in", C(4), K("int", 0), C(0))],
    "cast_int": [("cast_int", C(2)), ("cast_int", C(0))],
    "cast_real": [("cast_real", C(0)), ("cast_real", C(4))],
}


def nested_sum(depth: int, slots=(0, 1)):
    """c0 + (c1 + (c0 + ...)): ``depth`` + 1 additions, right-nested, so
    every left operand stays live while the right one is computed (one
    register more per level)."""
    t = ("+", C(slots[0]), C(slots[1]))
    for k in range(depth):
        t = ("+", C(slots[k % 2]), t)
    return t


#: HK7's limits in one launch: 16 live registers and 64 instructions
LIMIT_CASES = {"regs16": nested_sum(14)}

#: programs past HK7's limits (exprjit.MAX_PROG instructions): the
#: compiler splits each into several launches
SPLIT_CASES = {
    "in64": ("in", C(0)) + tuple(K("int", v) for v in range(-32, 31))
    + (K("int", None),),
    "in64_real": ("in", C(2)) + tuple(K("real", v * 0.5)
                                      for v in range(-30, 30))
    + (K("int", None), C(3), C(0), C(4)),
    "case20": ("case",) + sum(((("<", C(0), K("int", 5 * k - 50)),
                                C(k % 2)) for k in range(20)), ())
    + (C(1),),
    "case20_real": ("case",) + sum(((("<", C(2), K("real", 4.0 * k - 40)),
                                     C(2 + k % 2) if k % 3 else C(k % 2))
                                    for k in range(20)), ()),
    # 16 live registers in every launch but the last; nest30 has more
    # live values across a cut than registers
    "nest20": nested_sum(20),
    "nest30_real": nested_sum(30, (2, 3)),
}

#: K14: each dictionary-code compare, over slot 0 read as codes in
#: [0, 40) with the NULL code 40, against the run [lo, hi) = [12, 15)
CODE_CMP_OPS = ("=", "!=", "<", "<=", ">", ">=")
CODE_CARD, CODE_LO, CODE_HI = 40, 12, 15


def code_column(seed: int, n: int = N):
    """Dictionary codes in [0, CODE_CARD] (CODE_CARD = NULL) and a NULL
    mask that also marks some rows whose code is live."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, CODE_CARD + 1, n).astype(np.int64)
    null = (codes == CODE_CARD) | (rng.random(n) < 0.05)
    return codes, null


def member_params(pi: np.ndarray, pf: np.ndarray, b: int):
    """Member ``b``'s parameters for a stacked round over one program:
    member 0 keeps (pi, pf); member b adds b to each positive int slot
    below 2^62 (a divisor stays nonzero, a sign stays) and scales each
    finite real slot by 1 + b / 64."""
    pi = np.asarray(pi, dtype=np.int64).copy()
    pf = np.asarray(pf, dtype=np.float64).copy()
    grow = (pi > 0) & (pi < (1 << 62))
    pi[grow] += b
    fin = np.isfinite(pf)
    pf[fin] = pf[fin] * (1.0 + b / 64.0)
    return pi, pf


def stacked_params(pi: np.ndarray, pf: np.ndarray, nmem: int):
    """(int64 [nmem, Ni], float64 [nmem, Nf]) of members 0 .. nmem - 1."""
    rows = [member_params(pi, pf, b) for b in range(nmem)]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))
