"""The port's expression lowering (tinysql_tpu_torch/ops/exprjit.py) against
the reference's (tinysql_tpu/ops/exprjit.py): every name in JITTABLE_FUNCS,
on the same seeded random columns with NULLs, int64 min and max, unsigned
values and division by zero.  The same expression tree is built twice, once
from each package's expression module, and both are evaluated through
compile_expr_params with the same ParamTable constants.

Tolerance: NULL masks and integer results exactly; float results to 1e-12
relative (both sides evaluate the same IEEE-754 float64 operations
elementwise; only the float remainder's library routine may differ in the
last ulp).  Values under a NULL are not compared."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tinysql_tpu.expression as ref_expr
import tinysql_tpu.mytypes as ref_types
from tinysql_tpu.ops import exprjit as ref_jit
import tinysql_tpu_torch.expression as port_expr
import tinysql_tpu_torch.mytypes as port_types
from tinysql_tpu_torch.ops import exprjit as port_jit

jax.config.update("jax_enable_x64", True)

N = 257
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _columns(seed: int):
    """Slots: 0 int, 1 int, 2 real, 3 real, 4 unsigned int, 5 unsigned
    int — each with NULLs, extremes and zeros."""
    rng = np.random.default_rng(seed)
    ints = [rng.integers(-50, 50, N) for _ in range(2)]
    for a in ints:
        a[:6] = [I64_MIN, I64_MAX, 0, -1, 1, I64_MIN]
        a[6:12] = rng.integers(I64_MIN, I64_MAX, 6, endpoint=True)
    reals = [np.round(rng.normal(size=N) * 40, 3) for _ in range(2)]
    for a in reals:
        a[:6] = [0.0, -0.0, 1e300, -1e300, 2.5, -2.5]
        a[6] = 9.3e18
    uns = [rng.integers(I64_MIN, I64_MAX, N, endpoint=True)
           for _ in range(2)]
    for a in uns:
        a[:4] = [0, -1, I64_MIN, 1]
    vals = [ints[0].astype(np.int64), ints[1].astype(np.int64),
            reals[0], reals[1], uns[0].astype(np.int64),
            uns[1].astype(np.int64)]
    nulls = [rng.random(N) < 0.15 for _ in vals]
    return vals, nulls


SLOT_TYPES = ["int", "int", "real", "real", "uint", "uint"]


def _build(pkg, types, spec):
    """spec: nested tuples — ("col", slot) | ("const", kind, value) |
    (func name, *args)."""
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


C = lambda i: ("col", i)  # noqa: E731
K = lambda kind, v: ("const", kind, v)  # noqa: E731

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


def test_every_jittable_name_has_a_case():
    assert set(CASES) == set(ref_jit.JITTABLE_FUNCS) \
        == set(port_jit.JITTABLE_FUNCS)


def _eval_ref(spec, vals, nulls):
    e = _build(ref_expr, ref_types, spec)
    assert ref_jit.is_jittable(e)
    pt = ref_jit.ParamTable()
    fn = ref_jit.compile_expr_params(e, pt)
    pi, pf = pt.arrays()
    cols = [(jnp.asarray(v), jnp.asarray(m)) for v, m in zip(vals, nulls)]
    v, m = fn(cols, (jnp.asarray(pi), jnp.asarray(pf)))
    return np.asarray(v), np.asarray(m)


def _eval_port(spec, vals, nulls):
    e = _build(port_expr, port_types, spec)
    assert port_jit.is_jittable(e)
    pt = port_jit.ParamTable()
    fn = port_jit.compile_expr_params(e, pt)
    pi, pf = pt.arrays()
    cols = [(torch.from_numpy(v.copy()), torch.from_numpy(m.copy()))
            for v, m in zip(vals, nulls)]
    v, m = fn(cols, (torch.from_numpy(pi), torch.from_numpy(pf)))
    return v.expand(N).numpy(), m.expand(N).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_exprjit_matches_reference(name, seed):
    vals, nulls = _columns(seed)
    for spec in CASES[name]:
        rv, rm = _eval_ref(spec, vals, nulls)
        pv, pm = _eval_port(spec, vals, nulls)
        np.testing.assert_array_equal(pm, rm, err_msg=f"{spec} null mask")
        live = ~rm
        assert pv.dtype == rv.dtype, (spec, pv.dtype, rv.dtype)
        if rv.dtype == np.float64:
            np.testing.assert_allclose(pv[live], rv[live], rtol=1e-12,
                                       atol=0, equal_nan=True,
                                       err_msg=str(spec))
        else:
            np.testing.assert_array_equal(pv[live], rv[live],
                                          err_msg=str(spec))


def test_stable_keys_and_jittability_match_reference():
    for specs in CASES.values():
        for spec in specs:
            r = _build(ref_expr, ref_types, spec)
            p = _build(port_expr, port_types, spec)
            assert port_jit.stable_shape_key(p) == \
                ref_jit.stable_shape_key(r)
    mixed = ("div", C(0), C(4))  # mixed-signedness int div: CPU tier only
    assert not port_jit.is_jittable(_build(port_expr, port_types, mixed))
    assert not ref_jit.is_jittable(_build(ref_expr, ref_types, mixed))


def test_param_table_matches_reference():
    a, ra = port_jit.ParamTable(), ref_jit.ParamTable()
    for pt in (a, ra):
        pt.add_int(I64_MAX)
        pt.add_int(1 << 64)  # wraps into the int64 lane
        pt.add_real(0.5)
        pt.add_int(None)
    for g, w in zip(a.arrays(), ra.arrays()):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
