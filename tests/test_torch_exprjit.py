"""The port's expression lowering (tinysql_tpu_torch/ops/exprjit.py) against
the reference's (tinysql_tpu/ops/exprjit.py): every name in JITTABLE_FUNCS,
on the same seeded random columns with NULLs, int64 min and max, unsigned
values and division by zero.  The same expression tree is built twice, once
from each package's expression module: the reference's evaluates through
its compile_expr_params closure, the port's through the HK7 program
compiler (exprjit.compile_program) and its plain interpreter
(kernels.expr_eval_plain), with the same ParamTable constants.

The same trees also go through the HK7 program compiler
(exprjit.compile_program) and its plain interpreter
(kernels.expr_eval_plain, what the CPU runs), held to the same
reference: every JITTABLE_FUNCS name, K14's dictionary-code compares
against the reference's _code_cmp, K15's two output-layout programs
(group key decode, AVG) against the reference's formulas, and programs
past HK7's limits, which the compiler splits into several launches.
The battery lives in tinysql_tpu_torch/bench/exprcases.py, shared with
tests/test_torch_cuda.py and chip_smoke.py, which hold the kernel to the
plain interpreter on the card.

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
from tinysql_tpu.executor import tpu_executors as ref_tpu_exec
from tinysql_tpu.ops import exprjit as ref_jit
import tinysql_tpu_torch.expression as port_expr
import tinysql_tpu_torch.mytypes as port_types
from tinysql_tpu_torch.bench import exprcases
from tinysql_tpu_torch.ops import exprjit as port_jit
from tinysql_tpu_torch.ops import kernels as port_kernels

jax.config.update("jax_enable_x64", True)

N = exprcases.N
I64_MIN, I64_MAX = exprcases.I64_MIN, exprcases.I64_MAX
_columns = exprcases.columns
SLOT_TYPES = exprcases.SLOT_TYPES


def _build(pkg, types, spec):
    """spec: nested tuples — ("col", slot) | ("const", kind, value) |
    (func name, *args)."""
    return exprcases.build(spec, pkg, types)


C, K = exprcases.C, exprcases.K
CASES = exprcases.CASES


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
    """The tree as a condition (the mask) and as two output lanes (values
    and NULL; the NULL mask alone) of ONE program, run by the plain
    interpreter: (values, NULL, mask, NULL-only lane)."""
    e = _build(port_expr, port_types, spec)
    assert port_jit.is_jittable(e)
    pt = port_jit.ParamTable()
    prog = port_jit.compile_program([e], [e, ("null", e)], pt)
    assert prog.outputs == [port_jit._expr_dt(e), "n"]
    pi, pf = pt.arrays()
    cols = [(torch.from_numpy(v.copy()), torch.from_numpy(m.copy()))
            for v, m in zip(vals, nulls)]
    mask, outs = port_kernels.expr_eval_plain(
        prog, cols, (torch.from_numpy(pi), torch.from_numpy(pf)), N)
    (v, m), (nv, nm) = outs
    assert nv is None
    return v.numpy(), m.numpy(), mask.numpy(), nm.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_exprjit_matches_reference(name, seed):
    vals, nulls = _columns(seed)
    for spec in CASES[name]:
        rv, rm = _eval_ref(spec, vals, nulls)
        pv, pm, mask, null_lane = _eval_port(spec, vals, nulls)
        np.testing.assert_array_equal(pm, rm, err_msg=f"{spec} null mask")
        np.testing.assert_array_equal(null_lane, rm, err_msg=f"{spec} lane")
        np.testing.assert_array_equal(mask, (rv != 0) & ~rm,
                                      err_msg=f"{spec} mask")
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


# ---- HK7: the program compiler and its plain interpreter -------------------

def _run_program(prog, pt, cols, n, **kw):
    pi, pf = pt.arrays()
    return port_kernels.expr_eval(
        prog, cols, (torch.from_numpy(pi), torch.from_numpy(pf)), n, **kw)


def _torch_cols(vals, nulls):
    return [(torch.from_numpy(v.copy()), torch.from_numpy(m.copy()))
            for v, m in zip(vals, nulls)]


def _assert_like_ref(got, want, what):
    (pv, pm), (rv, rm) = got, want
    pv = pv.numpy() if pv is not None else None
    pm = pm.numpy()
    np.testing.assert_array_equal(pm, rm, err_msg=f"{what} null mask")
    if pv is None:
        return
    live = ~rm
    assert pv.dtype == rv.dtype, (what, pv.dtype, rv.dtype)
    if rv.dtype == np.float64:
        np.testing.assert_allclose(pv[live], rv[live], rtol=1e-12, atol=0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(pv[live], rv[live], err_msg=what)


@pytest.mark.parametrize("op", exprcases.CODE_CMP_OPS)
def test_code_compare_program_matches_reference(op):
    """K14: a string compare on dictionary codes, with the reference's
    _code_cmp as the truth; rows past n_rows are cut and mask_in ANDs."""
    codes, null = exprcases.code_column(5)
    card, lo, hi = exprcases.CODE_CARD, exprcases.CODE_LO, exprcases.CODE_HI
    want = np.asarray(ref_tpu_exec._code_cmp(
        jnp, op, jnp.asarray(codes), lo, hi, card, null=jnp.asarray(null)))
    pt = port_jit.ParamTable()
    prog = port_jit.ExprProgram()
    r = prog.code_cmp(0, op, lo, hi, card, pt)
    prog.cond(r)
    prog.store(r)
    cols = [(torch.from_numpy(codes), torch.from_numpy(null))]
    mask, outs = _run_program(prog, pt, cols, N)
    np.testing.assert_array_equal(outs[0][0].numpy(), want.astype(np.int64))
    assert not outs[0][1].any()
    np.testing.assert_array_equal(mask.numpy(), want)
    keep = np.random.default_rng(6).random(N) < 0.7
    mask, outs = _run_program(prog, pt, cols, N, n_rows=200,
                              mask_in=torch.from_numpy(keep))
    cut = np.arange(N) < 200
    np.testing.assert_array_equal(mask.numpy(), want & keep & cut)
    np.testing.assert_array_equal(outs[0][0].numpy(),
                                  np.where(cut, want, 0).astype(np.int64))
    np.testing.assert_array_equal(outs[0][1].numpy(), ~cut)


@pytest.mark.parametrize("real", [False, True])
def test_layout_programs_match_reference(real):
    """K15: the HashAgg device output layout — a group key decoded from
    the mixed-radix id, AVG as sum / max(count, 1) and an integer SUM cast
    to REAL — against the reference's formulas
    (tpu_executors.py:1431-1448) in jnp."""
    rng = np.random.default_rng(8)
    n = N
    cards, bases = (6, 13), (-3, 1 << 40)
    strides = (cards[1] + 1, 1)
    ids = rng.integers(0, (cards[0] + 1) * (cards[1] + 1), n)
    ids[-20:] = (cards[0] + 1) * (cards[1] + 1)  # padding: id = ns
    live = ids < (cards[0] + 1) * (cards[1] + 1)
    sv = np.round(rng.normal(size=n) * 1e3, 2) if real else \
        rng.integers(-1 << 40, 1 << 40, n)
    sm = rng.random(n) < 0.1
    cv = rng.integers(0, 4, n)
    iv = rng.integers(-(1 << 62), 1 << 62, n)
    im = rng.random(n) < 0.2
    pt = port_jit.ParamTable()
    prog = port_jit.ExprProgram()
    for j in range(2):
        prog.store(prog.key_decode(prog.load(0, "i"), prog.load(1, "b"),
                                   strides[j], cards[j], bases[j], pt))
    prog.store(prog.avg(prog.load(2, "f" if real else "i"),
                        prog.load(3, "i")))
    prog.store(prog.to_real(prog.load(4, "i")))
    cols = [(torch.from_numpy(ids), None), (torch.from_numpy(live), None),
            (torch.from_numpy(sv), torch.from_numpy(sm)),
            (torch.from_numpy(cv), None),
            (torch.from_numpy(iv), torch.from_numpy(im))]
    _, outs = _run_program(prog, pt, cols, n)
    jids, jlive = jnp.asarray(ids), jnp.asarray(live)
    for j in range(2):
        code = (jids // strides[j]) % (cards[j] + 1)
        nullk = (code == cards[j]) | ~jlive
        want = (np.asarray(jnp.where(nullk, 0, code + bases[j])),
                np.asarray(nullk))
        _assert_like_ref(outs[j], want, f"key {j}")
        np.testing.assert_array_equal(outs[j][0].numpy(), want[0])
    jsv, jcv = jnp.asarray(sv), jnp.asarray(cv)
    want = (np.asarray(jsv / jnp.maximum(jcv, 1)),
            np.asarray(jnp.asarray(sm) | (jcv == 0)))
    _assert_like_ref(outs[2], want, "avg")
    _assert_like_ref(outs[3], (np.asarray(jnp.asarray(iv).astype(
        jnp.float64)), im), "real")


@pytest.mark.parametrize("name", sorted(exprcases.SPLIT_CASES))
def test_programs_past_the_limits_split(name):
    """A 64-item IN and a 20-arm CASE pass HK7's program length: the
    compiler cuts them into several launches whose live registers travel
    through temporary lanes, and the result still equals the
    reference's."""
    spec = exprcases.SPLIT_CASES[name]
    vals, nulls = _columns(3)
    e = _build(port_expr, port_types, spec)
    pt = port_jit.ParamTable()
    prog = port_jit.compile_program([e], [e], pt)
    segs = prog.segments()
    assert len(segs) > 1 and prog.n_tmp() > 0, name
    for sg in segs:
        assert sg.code.shape[0] <= port_jit.MAX_PROG
        assert len(sg.in_refs) <= port_jit.MAX_IN
        assert max([max(d + u, default=0) for _k, d, u, _m, _t in sg.plain],
                   default=0) < port_jit.MAX_REGS
    rv, rm = _eval_ref(spec, vals, nulls)
    mask, outs = _run_program(prog, pt, _torch_cols(vals, nulls), N)
    _assert_like_ref(outs[0], (rv, rm), name)
    np.testing.assert_array_equal(mask.numpy(), (rv != 0) & ~rm)


def test_constants_ride_the_param_table():
    """Two queries that differ only in their constants compile to the same
    instruction words (one registered program serves both)."""
    a = _build(port_expr, port_types, ("<", C(2), K("real", 1.5)))
    b = _build(port_expr, port_types, ("<", C(2), K("real", -7.25)))
    pa, pb = port_jit.ParamTable(), port_jit.ParamTable()
    ga = port_jit.compile_program([a], [a], pa)
    gb = port_jit.compile_program([b], [b], pb)
    assert [s.code.tolist() for s in ga.segments()] == \
        [s.code.tolist() for s in gb.segments()]
    assert pa.f64 == [1.5] * 2 and pb.f64 == [-7.25] * 2
