"""The port's operator families (tinysql_tpu_torch/ops/kernels.py) against
the reference's (tinysql_tpu/ops/kernels.py) on identical seeded numpy
inputs, modelled on the direct-kernel tests of tests/test_tpu_ops.py.

On the CPU each hand kernel's wrapper runs its plain torch version (the
tensors lie on the CPU), so these tests hold the plain versions of HK1-HK4
and HK7 to the reference: fused_scalar_aggregate (HK7 + HK1),
fused_segment_aggregate and its device-resident variant (HK7 + HK2), unique_join_match and join_match
(HK3), sort_permutation and top_k (HK4).  The reference's join kernels run
as its device programs (TINYSQL_DEVICE_JOIN_ONLY=1), not its numpy twins.

Tolerance: integers, counts, NULL masks and row order exactly; float sums
to 1e-9 relative (the two sides add in different orders; the reference's
own bound is 1e-6).  tests/test_torch_cuda.py holds each kernel against
its plain version on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import HealthCheck, given, settings, strategies as st

from tinysql_tpu.ops import kernels as ref
from tinysql_tpu_torch.ops import kernels as port

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
SPECS = [("count_star", False), ("count", True), ("sum", True),
         ("sum0", True), ("min", True), ("max", True)]


@pytest.fixture(autouse=True)
def _cpu_device():
    with port.use_device("cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def _reference_registry_unchanged():
    """The reference programs these tests build (under test-only program
    keys) leave its process-global registry when the module ends, so
    later modules see the registry they would see without this one."""
    from tinysql_tpu.ops import progcache as ref_progcache
    before = set(ref_progcache.keys())
    yield
    with ref_progcache._mu:
        for k in [k for k in ref_progcache._REG if k not in before]:
            ref_progcache._REG.pop(k, None)
            ref_progcache._CATALOG.pop(k, None)


def _assert_aggs(got, want, what):
    assert len(got) == len(want), what
    for i, ((gv, gm), (wv, wm)) in enumerate(zip(got, want)):
        gv, gm, wv, wm = (np.asarray(x) for x in (gv, gm, wv, wm))
        np.testing.assert_array_equal(gm, wm, err_msg=f"{what} null {i}")
        live = ~wm.astype(bool)
        assert gv.dtype == wv.dtype, (what, i, gv.dtype, wv.dtype)
        if wv.dtype == np.float64:
            np.testing.assert_allclose(gv[live], wv[live], rtol=1e-9,
                                       err_msg=f"{what} value {i}")
        else:
            np.testing.assert_array_equal(gv[live], wv[live],
                                          err_msg=f"{what} value {i}")


def _data(n, seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int":
        v = rng.integers(-1000, 1000, n).astype(np.int64)
        v[:3] = [I64_MAX, I64_MIN, 0][:len(v[:3])]
    else:
        v = np.round(rng.normal(size=n) * 100, 3)
    m = rng.random(n) < 0.2
    return v, m


def _pair(dev, v, m, nb, lib):
    if lib == "ref":
        return (ref.h2d_pad(v, nb), ref.h2d_pad(m, nb, True))
    return (port.h2d_pad(v, nb), port.h2d_pad(m, nb, True))


def _args(nspecs):
    """Every aggregate reads slot 0 (a (values, null) device pair)."""
    return [None] + [(lambda cols, pr: cols[0])] * (nspecs - 1)


def _port_program(specs, dtype):
    """The port's fused paths take ONE HK7 expression program: every
    aggregate reads slot 0.  Returns (program, lane_of, params)."""
    from tinysql_tpu_torch.executor.gpu_executors import _agg_program
    from tinysql_tpu_torch.expression import Column
    from tinysql_tpu_torch.mytypes import new_int_type, new_real_type
    from tinysql_tpu_torch.ops.exprjit import ParamTable
    col = Column(new_int_type() if dtype == "int" else new_real_type(),
                 index=0)
    pt = ParamTable()
    prog, lane_of, _ = _agg_program(
        specs, [col if has else None for _, has in specs], [], pt)
    return prog, lane_of, pt.arrays()


@pytest.mark.parametrize("dtype", ["int", "float"])
@pytest.mark.parametrize("n,sel", [(1000, 0.7), (37, 0.0), (5, 1.0)])
def test_fused_scalar_aggregate_matches_reference(dtype, n, sel):
    v, m = _data(n, 11, dtype)
    if n == 5:
        m[:] = True  # all-NULL argument column
    nb = ref.bucket(max(n, 1))
    mask = np.zeros(nb, dtype=bool)
    mask[:n] = np.random.default_rng(2).random(n) < sel
    want = ref.fused_scalar_aggregate(
        [_pair(None, v, m, nb, "ref")], SPECS, _args(len(SPECS)), n, nb,
        ("host", jnp.asarray(mask)), program_key=("t", dtype))
    prog, lane_of, params = _port_program(SPECS, dtype)
    got = port.fused_scalar_aggregate(
        [_pair(None, v, m, nb, "port")], SPECS, prog, lane_of, n, nb,
        ("host", port.h2d(mask)), program_key=("t", dtype), params=params)
    _assert_aggs(got[0], want[0], "scalar")
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["int", "float"])
@pytest.mark.parametrize("n_segments", [6, 64, 700, 70000])
def test_fused_segment_aggregate_matches_reference(dtype, n_segments):
    n = 2000
    v, m = _data(n, 5, dtype)
    rng = np.random.default_rng(9)
    gid = rng.integers(0, n_segments, n).astype(np.int64)
    gid[gid == 3] = 4  # segment 3 empty
    m[gid == 5] = True  # segment 5 all-NULL
    nb = ref.bucket(n)
    mask = np.zeros(nb, dtype=bool)
    mask[:n] = rng.random(n) < 0.8
    gid_pad = np.concatenate([gid, np.full(nb - n, n_segments, np.int64)])
    want = ref.fused_segment_aggregate(
        [_pair(None, v, m, nb, "ref")], jnp.asarray(gid_pad), n_segments,
        SPECS, _args(len(SPECS)), n, ("host", jnp.asarray(mask)),
        program_key=("t", dtype))
    prog, lane_of, params = _port_program(SPECS, dtype)
    got = port.fused_segment_aggregate(
        [_pair(None, v, m, nb, "port")], port.h2d(gid_pad), n_segments,
        SPECS, prog, lane_of, n, ("host", port.h2d(mask)),
        program_key=("t", dtype), params=params)
    np.testing.assert_array_equal(got[0], want[0])
    _assert_aggs(got[1], want[1], "segment")
    np.testing.assert_array_equal(got[2], want[2])

    # device-resident (late materialization) variant
    rk = ref.fused_segment_aggregate_keep(
        [_pair(None, v, m, nb, "ref")], jnp.asarray(gid_pad), n_segments,
        SPECS[1:], _args(len(SPECS))[1:], ("host", jnp.asarray(mask)),
        program_key=("k", dtype))
    prog, lane_of, params = _port_program(SPECS[1:], dtype)
    pk = port.fused_segment_aggregate_keep(
        [_pair(None, v, m, nb, "port")], port.h2d(gid_pad), n_segments,
        SPECS[1:], prog, lane_of, n, ("host", port.h2d(mask)),
        program_key=("k", dtype), params=params)
    assert pk[3:] == rk[3:]
    np.testing.assert_array_equal(pk[0].numpy(), np.asarray(rk[0]))
    np.testing.assert_array_equal(pk[1].numpy(), np.asarray(rk[1]))
    _assert_aggs([(a.numpy(), b.numpy()) for a, b in pk[2]],
                 [(np.asarray(a), np.asarray(b)) for a, b in rk[2]],
                 "keep")


def test_group_and_segment_aggregate_over_host_columns():
    n = 900
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 10, n).astype(np.int64)
    knull = rng.random(n) < 0.1
    v, m = _data(n, 6, "float")
    specs = [("count_star", False), ("sum", True), ("min", True)]
    cols = [(v, m), (v, m)]
    want = ref.group_aggregate([(keys, knull)], specs, cols, n)
    got = port.group_aggregate([(keys, knull)], specs, cols, n)
    np.testing.assert_array_equal(got[0][0][0], want[0][0][0])
    np.testing.assert_array_equal(got[0][0][1], want[0][0][1])
    _assert_aggs(got[1], want[1], "group")
    np.testing.assert_array_equal(got[2], want[2])
    gid = np.where(knull, 10, keys)
    want = ref.segment_group_aggregate(gid, 11, specs, cols, n)
    got = port.segment_group_aggregate(gid, 11, specs, cols, n)
    np.testing.assert_array_equal(got[0], want[0])
    _assert_aggs(got[1], want[1], "segment host")
    want = ref.scalar_aggregate(specs, cols, n, filter_mask=keys > 4)
    got = port.scalar_aggregate(specs, cols, n, filter_mask=keys > 4)
    _assert_aggs(got[0], want[0], "scalar host")


@pytest.fixture
def device_joins(monkeypatch):
    """The reference's DEVICE join programs, not its numpy twins."""
    monkeypatch.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")


def _join_inputs(seed, nl, nr, lo, hi):
    rng = np.random.default_rng(seed)
    lk = rng.integers(lo, hi, nl, endpoint=True).astype(np.int64)
    rk = rng.integers(lo, hi, nr, endpoint=True).astype(np.int64)
    return (lk, rng.random(nl) < 0.1, rng.random(nl) < 0.9,
            rk, rng.random(nr) < 0.1, rng.random(nr) < 0.9)


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("keys", ["dense", "sparse", "extremes"])
def test_join_match_matches_reference(device_joins, outer, keys):
    lo, hi = {"dense": (0, 40), "sparse": (0, 1 << 40),
              "extremes": (I64_MAX - 30, I64_MAX)}[keys]
    lk, ln, lv, rk, rn, rv = _join_inputs(3, 700, 300, lo, hi)
    if keys == "sparse":
        rk[::3] = lk[:100]  # some matches in a wide range
    want = ref.join_match((lk, ln), 700, (rk, rn), 300, outer=outer,
                          lvalid=lv, rvalid=rv)
    got = port.join_match((lk, ln), 700, (rk, rn), 300, outer=outer,
                          lvalid=lv, rvalid=rv)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("keys", ["dense", "sparse", "float"])
def test_unique_join_match_matches_reference(device_joins, outer, keys):
    rng = np.random.default_rng(7)
    if keys == "float":
        rk = np.unique(np.round(rng.random(300) * 50, 1))
        lk = np.round(rng.random(800) * 50, 1)
        lk[:2] = [-0.0, 0.0]
        rk[0] = 0.0
    else:
        span = 1 if keys == "dense" else (1 << 45)
        rk = (rng.permutation(300) * span).astype(np.int64)
        lk = (rng.integers(-5, 305, 800) * span).astype(np.int64)
    ln, lv = rng.random(len(lk)) < 0.1, rng.random(len(lk)) < 0.9
    rn, rv = rng.random(len(rk)) < 0.1, rng.random(len(rk)) < 0.9
    want = ref.unique_join_match((lk, ln), len(lk), (rk, rn), len(rk),
                                 outer=outer, lvalid=lv, rvalid=rv)
    got = port.unique_join_match((lk, ln), len(lk), (rk, rn), len(rk),
                                 outer=outer, lvalid=lv, rvalid=rv)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_join_sentinel_collision_int64_max(device_joins):
    """A LIVE build key equal to int64 max matches; a dead row holding it
    never does (tests/test_tpu_ops.py:384)."""
    lk = np.array([I64_MAX, 5], dtype=np.int64)
    ln = np.zeros(2, dtype=bool)
    rk = np.array([7, I64_MAX, 5], dtype=np.int64)
    rn = np.array([True, False, False])
    for fn in (port.join_match, port.unique_join_match):
        li, ri = fn((lk, ln), 2, (rk, rn), 3)
        assert sorted(zip(li.tolist(), ri.tolist())) == [(0, 1), (1, 2)]
    rv = np.array([True, False, True])  # the max-key row is filtered out
    for fn in (port.join_match, port.unique_join_match):
        li, ri = fn((lk, ln), 2, (rk, rn), 3, rvalid=rv)
        assert sorted(zip(li.tolist(), ri.tolist())) == [(1, 2)]
        want = (ref.join_match if fn is port.join_match
                else ref.unique_join_match)((lk, ln), 2, (rk, rn), 3,
                                            rvalid=rv)
        np.testing.assert_array_equal(li, np.asarray(want[0]))


def test_r4_dense_range_at_int64_max(device_joins):
    """R4: the reference's host join twin computes ``lk - kmin`` and
    ``kmin + card`` before its range check, which wraps when the build's
    largest key is int64 max.  The port indexes only in-range keys: it
    agrees with the reference's device program and with brute force."""
    rk = np.array([I64_MAX - 2, I64_MAX - 1, I64_MAX, I64_MAX],
                  dtype=np.int64)
    lk = np.array([I64_MAX, I64_MIN, I64_MAX - 1, 0, -1], dtype=np.int64)
    z_l, z_r = np.zeros(5, bool), np.zeros(4, bool)
    want = sorted((i, j) for i in range(5) for j in range(4)
                  if lk[i] == rk[j])
    li, ri = port.join_match((lk, z_l), 5, (rk, z_r), 4)
    assert list(zip(li.tolist(), ri.tolist())) == want
    dev = ref.join_match((lk, z_l), 5, (rk, z_r), 4)
    np.testing.assert_array_equal(li, np.asarray(dev[0]))
    np.testing.assert_array_equal(ri, np.asarray(dev[1]))
    u = port.unique_join_match((lk, z_l), 5, (rk[:3], z_r[:3]), 3)
    assert list(zip(u[0].tolist(), u[1].tolist())) == [(0, 2), (2, 1)]


def test_r3_build_sorted_with_mask_holes():
    """R3: the reference's ``build_sorted`` claim is only valid when no
    validity mask punches holes mid-array.  The port has no such claim
    (its key table needs no sorted build side): with holes in an
    ascending build side it still matches every live key — the
    reference's host twin is the oracle here; its device program given
    the claim would miss matches."""
    rk = np.arange(10, dtype=np.int64)
    rv = np.ones(10, dtype=bool)
    rv[[2, 5]] = False  # holes in the middle of an ascending build side
    lk = np.arange(-1, 12, dtype=np.int64)
    z_l, z_r = np.zeros(13, bool), np.zeros(10, bool)
    got = port.unique_join_match((lk, z_l), 13, (rk, z_r), 10, rvalid=rv)
    want = ref._np_unique_join(lk, z_l, np.ones(13, bool), rk, z_r, rv,
                               False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("anti,null_aware", [(False, False), (True, False),
                                             (True, True)])
def test_semi_join_match_matches_reference(device_joins, anti, null_aware):
    lk, ln, lv, rk, rn, rv = _join_inputs(8, 500, 120, 0, 60)
    for rn_case in (rn, np.zeros_like(rn)):
        want = ref.semi_join_match((lk, ln), 500, (rk, rn_case), 120,
                                   anti=anti, null_aware=null_aware,
                                   lvalid=lv, rvalid=rv)
        got = port.semi_join_match((lk, ln), 500, (rk, rn_case), 120,
                                   anti=anti, null_aware=null_aware,
                                   lvalid=lv, rvalid=rv)
        np.testing.assert_array_equal(got, np.asarray(want))


# ---- K8: HK3's membership + HK10's ladder and compaction ------------------

def _port_semi_plain(lk, ln, lv, rk, rn, rv, anti, null_aware):
    """The port's K8 on the CPU, piece by piece: HK3's plain membership,
    then semi_pick_plain, then the pull of the kept rows."""
    nl, nr = len(lk), len(rk)
    t = port._join_inputs((lk, ln), nl, (rk, rn), nr, lv, rv)
    match = port.unique_match(*t)
    out = port.semi_pick_plain(match, t[1], t[2], t[4], t[5], anti,
                               null_aware)
    return port._pull_kept(out)


MODES = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("anti,null_aware", MODES)
@pytest.mark.parametrize("case", ["nulls", "one_null_build_key",
                                  "empty_build", "dead_build", "no_nulls",
                                  "one_probe_row"])
def test_semi_pick_plain_matches_reference(device_joins, anti, null_aware,
                                           case):
    """semi_pick_plain over HK3's plain membership against the reference's
    semi_join_match run as its device program (TINYSQL_DEVICE_JOIN_ONLY)
    and against its host twin _np_semi_match: the NOT IN ladder's every
    rung (empty and all-dead build sides, one NULL build key, NULL probe
    keys, a single probe row)."""
    lk, ln, lv, rk, rn, rv = _join_inputs(9, 400, 150, 0, 90)
    if case == "one_null_build_key":
        rn = np.zeros_like(rn)
        rn[37] = rv[37] = True
    elif case == "empty_build":
        rk, rn, rv = rk[:0], rn[:0], rv[:0]
    elif case == "dead_build":
        rv = np.zeros_like(rv)
    elif case == "no_nulls":
        ln, rn = np.zeros_like(ln), np.zeros_like(rn)
    elif case == "one_probe_row":
        lk, ln, lv = lk[:1], np.zeros(1, bool), np.ones(1, bool)
    nl, nr = len(lk), len(rk)
    got = _port_semi_plain(lk, ln, lv, rk, rn, rv, anti, null_aware)
    dev = ref.semi_join_match((lk, ln), nl, (rk, rn), nr, anti=anti,
                              null_aware=null_aware, lvalid=lv, rvalid=rv)
    twin = ref._np_semi_match(lk, ln, lv, rk, rn, rv, anti, null_aware)
    np.testing.assert_array_equal(got, np.asarray(dev))
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(
        port.semi_join_match((lk, ln), nl, (rk, rn), nr, anti=anti,
                             null_aware=null_aware, lvalid=lv, rvalid=rv),
        twin)
    if case in ("empty_build", "dead_build") and anti:
        assert list(got) == list(np.nonzero(lv)[0])  # NOT IN () is TRUE
    if case == "one_null_build_key" and anti and null_aware:
        assert got.size == 0


def test_semi_join_match_pulls_once_per_call(device_joins):
    """A null-aware anti join pulls the count and the kept rows in one
    transfer when they fit PRESENT_HEAD, with no pull of the build NULL
    mask; a larger result takes exactly one more.  HK3's membership makes
    no pull (its build statistics stay on the card), so on the card too
    these are every host sync of the call."""
    lk, ln, lv, rk, rn, rv = _join_inputs(12, 9000, 300, 0, 600)
    for n_kept_large in (False, True):
        lk2 = lk if n_kept_large else lk[:500]
        args = ((lk2, ln[:len(lk2)]), len(lk2), (rk, np.zeros_like(rn)), 300)
        kw = dict(anti=True, null_aware=True, lvalid=lv[:len(lk2)],
                  rvalid=rv)
        snap = port.stats_snapshot()
        got = port.semi_join_match(*args, **kw)
        d = port.stats_delta(snap)
        assert d["d2h_transfers"] == (2 if got.size > port.PRESENT_HEAD
                                      else 1), (got.size, d)
        assert got.size > port.PRESENT_HEAD if n_kept_large else True
        np.testing.assert_array_equal(
            got, ref._np_semi_match(lk2, ln[:len(lk2)], lv[:len(lk2)], rk,
                                    np.zeros_like(rn), rv, True, True))


_KEYS = {
    "small": st.integers(-3, 12),
    "extremes": st.sampled_from([I64_MIN, I64_MIN + 1, -1, 0, 1,
                                 I64_MAX - 1, I64_MAX]),
    # no NaN: MySQL stores none, and the port folds NaN into NULL
    "float": st.sampled_from([-2.5, -0.0, 0.0, 0.5, 1.0, 1e300, -np.inf,
                              np.inf]),
}


@st.composite
def _semi_case(draw):
    kind = draw(st.sampled_from(sorted(_KEYS)))
    keys = _KEYS[kind]
    nl = draw(st.integers(1, 40))
    nr = draw(st.integers(0, 30))
    lk = draw(st.lists(keys, min_size=nl, max_size=nl))
    # duplicate build keys: draw from the probe keys and the strategy
    rk = draw(st.lists(st.one_of(keys, st.sampled_from(lk)), min_size=nr,
                       max_size=nr))
    bools = lambda n, p: draw(st.lists(  # noqa: E731
        st.sampled_from([True] * p + [False] * (10 - p)), min_size=n,
        max_size=n))
    build_valid = draw(st.sampled_from(["some", "all", "dead"]))
    rv = {"some": bools(nr, 8), "all": [True] * nr,
          "dead": [False] * nr}[build_valid]
    dt = np.float64 if kind == "float" else np.int64
    return (np.array(lk, dtype=dt), np.array(bools(nl, 2), dtype=bool),
            np.array(bools(nl, 9), dtype=bool), np.array(rk, dtype=dt),
            np.array(bools(nr, draw(st.sampled_from([0, 1, 3]))),
                     dtype=bool), np.array(rv, dtype=bool))


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(case=_semi_case(), mode=st.sampled_from(MODES))
def test_semi_pick_plain_sweep(device_joins, case, mode):
    """Hypothesis over NULL probe and build keys, empty and all-dead build
    sides, duplicate build keys, int64 extremes and float keys (-0.0 and
    +0.0 equal, infinities), in all three modes: the kept indices equal
    the reference's device program and host twin exactly."""
    lk, ln, lv, rk, rn, rv = case
    anti, null_aware = mode
    got = _port_semi_plain(lk, ln, lv, rk, rn, rv, anti, null_aware)
    twin = ref._np_semi_match(lk, ln, lv, rk, rn, rv, anti, null_aware)
    dev = ref.semi_join_match((lk, ln), len(lk), (rk, rn), len(rk),
                              anti=anti, null_aware=null_aware, lvalid=lv,
                              rvalid=rv)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, np.asarray(dev))


_NOT_IN_SQL = {
    "not_in": "select a from p where a not in (select x from q) order by a",
    "not_exists": "select a from p where not exists "
                  "(select * from q where q.x = p.a) order by a",
    "in": "select a from p where a in (select x from q) order by a",
}


@pytest.fixture(scope="module")
def not_in_sessions():
    from tinysql_tpu.session import new_session as ref_new
    from tinysql_tpu_torch.session import new_session as port_new
    out = []
    for s in (ref_new(), port_new(device="cpu")):
        s.execute("create database k8")
        s.execute("use k8")
        s.execute("create table p (a bigint)")
        s.execute("create table q (x bigint)")
        s.execute("insert into p values " + ", ".join(
            f"({v})" for v in [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]) + ", (null)")
        s.execute("insert into q values (2), (4), (4), (6), (12)")
        s.execute("set @@tidb_tpu_min_rows = 0")
        s.execute("set @@tidb_devpipe = 0")
        out.append(s)
    return out


@pytest.mark.parametrize("null_in_build", [False, True])
def test_not_in_and_not_exists_through_both_sessions(device_joins,
                                                     not_in_sessions,
                                                     null_in_build):
    """NOT IN (null-aware anti), NOT EXISTS (plain anti) and IN (semi)
    statements through both packages' sessions on their device tiers:
    equal rows; with a NULL key in the subquery NOT IN returns no rows
    while NOT EXISTS still does; the port ran K8 through HK3's membership
    and HK10's plain version."""
    ref_s, port_s = not_in_sessions
    for s in not_in_sessions:
        s.execute("delete from q where x is null")
        if null_in_build:
            s.execute("insert into q values (null)")
    plan = [r[3] for r in port_s.query(
        "explain " + _NOT_IN_SQL["not_in"]).rows if "Join" in r[0]]
    assert plan and "anti" in plan[0] and "null-aware" in plan[0], plan
    got = {}
    for name, sql in _NOT_IN_SQL.items():
        port.reset_kernel_counts()
        got[name] = port_s.query(sql).rows
        counts = port.kernel_counts()["plain_calls"]
        assert counts["semi_pick"] >= 1 and counts["equi_join"] >= 1, counts
        assert got[name] == ref_s.query(sql).rows, name
    want_exists = [[v] for v in [1, 3, 5, 7, 8, 9, 10, None]]
    assert sorted(got["not_exists"], key=lambda r: (r[0] is not None,
                                                    r[0] or 0)) == \
        sorted(want_exists, key=lambda r: (r[0] is not None, r[0] or 0))
    if null_in_build:
        assert got["not_in"] == []
    else:
        assert got["not_in"] == [[v] for v in [1, 3, 5, 7, 8, 9, 10]]
    assert got["in"] == [[2], [4], [6]]


def _sort_keys(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.integers(-5, 5, n).astype(np.int64)
    a[:4] = [I64_MAX, I64_MIN, I64_MAX, I64_MIN]
    b = np.round(rng.random(n), 2)
    b[:4] = [np.nan, -0.0, 0.0, -np.inf]
    return [(a, rng.random(n) < 0.15), (b, rng.random(n) < 0.15)]


@pytest.mark.parametrize("descs", [[False, False], [True, False],
                                   [False, True], [True, True]])
def test_sort_permutation_matches_reference(descs):
    keys = _sort_keys(5, 600)
    want = ref.sort_permutation(keys, descs, 600)
    got = port.sort_permutation(keys, descs, 600)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("descs,k", [([True], 17), ([False], 1),
                                     ([True, False], 10),
                                     ([False, True], 37), ([True], 900)])
def test_top_k_matches_reference(descs, k):
    keys = _sort_keys(6, 800)[:len(descs)]
    if len(descs) == 1:
        keys = [(np.round(keys[0][0].astype(np.float64) % 97, 0),
                 keys[0][1])]  # one finite key: the reference's fast path
    want = ref.top_k(keys, descs, 800, k)
    got = port.top_k(keys, descs, 800, k)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_padding_and_packing_match_reference():
    rng = np.random.default_rng(12)
    for n in (0, 1, 15, 16, 17, 1000):
        assert port.bucket(n) == ref.bucket(n)
    v = rng.integers(-9, 9, 21).astype(np.int64)
    np.testing.assert_array_equal(port.pad1(v, 32, 7), ref.pad1(v, 32, 7))
    b = rng.random(21) < 0.5
    np.testing.assert_array_equal(port.h2d_pad(b, 32, True).numpy(),
                                  np.asarray(ref.h2d_pad(b, 32, True)))
    arrays = [v, rng.random(9), b, np.arange(4, dtype=np.int32)]
    ps, rs = [], []
    pi, pf = port.pack_arrays(ps, [torch.from_numpy(a) for a in arrays])
    ri, rf = ref.pack_arrays(rs, [jnp.asarray(a) for a in arrays])
    assert ps == rs
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))
    for got, want in zip(port.unpack_flat((pi, pf), ps),
                         ref.unpack_host((np.asarray(ri), np.asarray(rf)),
                                         rs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    before = port.STATS["d2h_transfers"]
    port.unpack_host((pi.numpy(), pf.numpy()), ps)
    port.unpack_flat((pi, pf), ps)
    assert port.STATS["d2h_transfers"] == before + 1  # one pull, both


def test_empty_inputs():
    z = np.zeros(0, dtype=np.int64)
    zb = np.zeros(0, dtype=bool)
    assert port.top_k([(z, zb)], [True], 0, 5).size == 0
    assert port.sort_permutation([(z, zb)], [False], 0).size == 0
    li, ri = port.unique_join_match((z, zb), 0, (z, zb), 0)
    assert li.size == 0 and ri.size == 0
    li, ri = port.join_match((z, zb), 0, (z, zb), 0, outer=True)
    assert li.size == 0 and ri.size == 0
    aggs, first = port.scalar_aggregate([("count_star", False)], [], 0)
    assert first.size == 0 and aggs[0][0].size == 0


def test_cpu_tensors_take_the_plain_versions():
    port.reset_kernel_counts()
    v, m = _data(300, 1, "float")
    port.scalar_aggregate([("sum", True)], [(v, m)], 300)
    port.sort_permutation([(v, m)], [False], 300)
    port.unique_join_match((np.arange(5), np.zeros(5, bool)), 5,
                           (np.arange(5), np.zeros(5, bool)), 5)
    c = port.kernel_counts()
    assert all(x == 0 for x in c["launches"].values())
    assert c["plain_calls"]["masked_reduce"] == 1
    assert c["plain_calls"]["lex_order"] == 1
    assert c["plain_calls"]["equi_join"] == 1
    with pytest.raises(RuntimeError):
        port._on_card(torch.zeros(1, device="meta"), "x")


# ---- K18's multiplicity join (HK8) and K19's boundary scan (HK9) ---------
# Each plain version against the reference's jnp formulation, copied line
# for line from tinysql_tpu/executor/devpipe.py (_JoinNode._prepare_mult's
# kernel, :1595-1656; _SortGroupNode's boundary scan, :1829-1851).

def _ref_mult(order, ends, ng, n_rows, lo, hi, tbl, keys, spec, pvalid,
              bvalid, outer, ob, plns, blns):
    from jax import lax
    jn = jnp
    order, ends, tbl = jn.asarray(order), jn.asarray(ends), jn.asarray(tbl)
    pvalid, bvalid = jn.asarray(pvalid), jn.asarray(bvalid)
    nbb, ngb, nb, tbl_len = len(order), len(ends), len(pvalid), len(tbl)
    in_table = jn.arange(nbb) < n_rows
    vs = bvalid[order] & in_table
    c = jn.cumsum(vs.astype(jn.int64))
    gmask = jn.arange(ngb) < ng
    prev = jn.concatenate([jn.full((1,), -1, dtype=jn.int64), ends[:-1]])
    prev_safe = jn.maximum(prev, 0)
    start_c = jn.where(prev >= 0, c[prev_safe], 0)
    vcnt = jn.where(gmask, c[ends] - start_c, 0)
    vidx = jn.nonzero(vs, size=nbb, fill_value=0)[0]
    comp = order[vidx]
    if spec is not None:
        ok = pvalid
        kp = jn.zeros(nb, dtype=jn.int64)
        for (kvj, knj), (klo, khi, kst) in zip(keys, spec):
            kvj, knj = jn.asarray(kvj), jn.asarray(knj)
            ok = ok & (kvj >= klo) & (kvj <= khi) & ~knj
            kp = kp + (kvj - klo) * kst
        inr = ok & (kp >= lo) & (kp <= hi)
        kp = jn.clip(kp, lo, hi)
    else:
        kp, knull = (jn.asarray(x) for x in keys[0])
        inr = (kp >= lo) & (kp <= hi) & ~knull & pvalid
    pos0 = jn.clip(kp - lo, 0, tbl_len - 1)
    g = jn.where(inr, tbl[pos0].astype(jn.int64), -1)
    gsafe = jn.clip(g, 0, ngb - 1)
    m = jn.where(g >= 0, vcnt[gsafe], 0)
    cnt = jn.where(pvalid, jn.maximum(m, 1), 0) if outer else m
    offs = jn.cumsum(cnt) - cnt
    total = offs[-1] + cnt[-1]
    tgt = jn.where(cnt > 0, offs, ob)
    base = jn.zeros(ob, dtype=jn.int64).at[tgt].set(
        jn.arange(nb) + 1, mode="drop")
    pidx = lax.cummax(base, axis=0) - 1
    valid_out = (pidx >= 0) & (jn.arange(ob) < total)
    ps = jn.clip(pidx, 0, nb - 1)
    k = jn.arange(ob) - offs[ps]
    gj = g[ps]
    gjs = jn.clip(gj, 0, ngb - 1)
    matched = (gj >= 0) & (k < m[ps]) & valid_out
    brow = comp[jn.clip(start_c[gjs] + k, 0, nbb - 1)]
    pcols = [(jn.asarray(pv)[ps], jn.asarray(pn)[ps]) for pv, pn in plns]
    bcols = [(jn.asarray(bv)[brow], jn.asarray(bn)[brow] | ~matched)
             for bv, bn in blns]
    return valid_out, pcols, bcols


def _mult_case(rng, nk, skew):
    from tinysql_tpu_torch.executor import devpipe
    nbuild, nprobe = 900, 700
    nbb, nb = port.bucket(nbuild), port.bucket(nprobe)
    if nk == 1:
        bk = rng.integers(1, 60, nbuild).astype(np.int64)
        if skew:
            bk[:400] = 9
        gi = devpipe.GroupIndex([(bk, rng.random(nbuild) < 0.05)])
        keys = [(port.pad1(rng.integers(-3, 66, nprobe).astype(np.int64),
                           nb), port.pad1(rng.random(nprobe) < 0.05, nb,
                                          True))]
        spec = None
    else:
        cols = [(rng.integers(1, 7, nbuild).astype(np.int64),
                 rng.random(nbuild) < 0.03) for _ in range(nk)]
        los, his, strides, comp, null_any, _ = devpipe._composite_spec(cols)
        gi = devpipe.GroupIndex([(comp, null_any)])
        spec = list(zip(los, his, strides))
        keys = [(port.pad1(rng.integers(0, 9, nprobe).astype(np.int64), nb),
                 port.pad1(rng.random(nprobe) < 0.03, nb, True))
                for _ in range(nk)]
    ngb = port.bucket(max(gi.n_groups, 1))
    ob = port.bucket(int(gi.raw_counts().max()) * nprobe + nprobe)
    common = (port.pad1(gi.order, nbb),
              port.pad1(gi.ends, ngb, fill=nbuild - 1), gi.n_groups, nbuild,
              gi.lo, gi.hi, gi.pos_table(), keys, spec,
              port.pad1(rng.random(nprobe) < 0.9, nb),
              rng.random(nbb) < 0.8)
    plns = [(rng.integers(0, 99, nb), rng.random(nb) < 0.1), keys[0]]
    blns = [(rng.normal(size=nbb), rng.random(nbb) < 0.1),
            (rng.integers(0, 99, nbb), np.zeros(nbb, bool))]
    return common, ob, plns, blns


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("nk,skew", [(1, False), (1, True), (2, False),
                                     (3, False)])
def test_csr_expand_plain_matches_reference_mult_kernel(nk, skew, outer):
    """HK8's plain version against the reference's _prepare_mult kernel
    on the same group index and inputs: the valid slots, and at every
    valid slot the probe lanes and the build lanes (values where not
    NULL); slots past the total are the reference's padding."""
    rng = np.random.default_rng(40 + nk + skew)
    (order, ends, ng, n_rows, lo, hi, tbl, keys, spec, pvalid,
     bvalid), ob, plns, blns = _mult_case(rng, nk, skew)
    want = _ref_mult(order, ends, ng, n_rows, lo, hi, tbl, keys, spec,
                     pvalid, bvalid, outer, ob, plns, blns)
    t = torch.from_numpy
    got = port.csr_expand(
        t(order), t(ends), ng, n_rows, t(bvalid), t(tbl), lo, hi,
        [(t(k), t(m)) for k, m in keys], spec, t(pvalid), outer, ob,
        [(t(v), t(m)) for v, m in plns], [(t(v), t(m)) for v, m in blns])
    live = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), live)
    assert live.sum() > 0
    for (gv, gm), (wv, wm) in zip(got[1] + got[2], want[1] + want[2]):
        gv, gm, wv, wm = gv.numpy(), gm.numpy(), np.asarray(wv), \
            np.asarray(wm)
        np.testing.assert_array_equal(gm[live], wm[live])
        keep = live & ~wm
        np.testing.assert_array_equal(gv[keep], wv[keep])


def _ref_bounds(perm, valid, keys):
    from jax import lax
    jn = jnp
    perm, valid = jn.asarray(perm), jn.asarray(valid)
    nb = len(perm)
    valid_s = valid[perm]
    skeys = [(jn.asarray(v)[perm], jn.asarray(m)[perm]) for v, m in keys]
    idx = jn.arange(nb)
    diff = jn.zeros(nb, dtype=bool).at[0].set(True)
    for sv, sn in skeys:
        d = ((sv[1:] != sv[:-1]) & ~(sn[1:] & sn[:-1])) \
            | (sn[1:] != sn[:-1])
        diff = diff.at[1:].set(diff[1:] | d)
    prev_invalid = jn.concatenate([jn.ones(1, dtype=bool), ~valid_s[:-1]])
    lead = valid_s & (diff | prev_invalid)
    gnum = jn.cumsum(lead.astype(jn.int64))
    ng = gnum[-1]
    sgid = jn.where(valid_s, gnum - 1, nb)
    lp = jn.where(lead, idx, nb)
    nxt = lax.cummin(lp[::-1])[::-1]
    nxt_after = jn.concatenate([nxt[1:], jn.full((1,), nb, dtype=nxt.dtype)])
    end = jn.clip(nxt_after - 1, 0, nb - 1)
    lead_pos = jn.nonzero(lead, size=nb, fill_value=0)[0]
    return int(ng), np.asarray(lead_pos), np.asarray(end[lead_pos]), \
        np.asarray(sgid)


@pytest.mark.parametrize("frac", [0.85, 0.0, 1.0])
@pytest.mark.parametrize("keys", ["int", "float", "int_float"])
def test_run_bounds_plain_matches_reference_boundary_scan(keys, frac):
    """HK9's plain version against the reference's sortgroup boundary
    scan over the same sorted order: the group count, the leaders, each
    group's end (the reference's last window runs to the bucket's end,
    over the invalid tail whose contributions it masks; HK9 ends it at
    the last valid row) and the group numbers."""
    rng = np.random.default_rng(len(keys) + int(frac * 10))
    n = 2048
    iv = rng.integers(0, 30, n).astype(np.int64)
    fv = rng.integers(-3, 3, n).astype(np.float64)
    fv[:8] = [np.nan, -0.0, 0.0, np.nan, -0.0, 1.5, 0.0, np.nan]
    lanes = {"int": [(iv, rng.random(n) < 0.1)],
             "float": [(fv, rng.random(n) < 0.1)],
             "int_float": [(iv, rng.random(n) < 0.1),
                           (fv, np.zeros(n, bool))]}[keys]
    valid = rng.random(n) < frac
    t = torch.from_numpy
    tl = [(t(v), t(m)) for v, m in lanes]
    perm = port.lex_order_plain(port.sort_lanes(tl, [False] * len(tl),
                                                t(valid)), n)
    count, lead, ends, gid = port.run_bounds(perm, t(valid), tl,
                                             want_gid=True)
    ng, lead_pos, end, sgid = _ref_bounds(perm.numpy(), valid, lanes)
    assert int(count[0]) == ng
    np.testing.assert_array_equal(lead.numpy()[:ng], lead_pos[:ng])
    head = max(ng - 1, 0)
    np.testing.assert_array_equal(ends.numpy()[:head], end[:head])
    if ng:
        assert int(ends[ng - 1]) == int(valid.sum()) - 1
    assert (ends.numpy()[ng:] == (int(ends[ng - 1]) if ng else -1)).all()
    np.testing.assert_array_equal(gid.numpy()[perm.numpy()], sgid)


# ---- K12: the batched entry points' plain versions ----------------------

def _b_lanes(rng, nmem, n):
    t = torch.as_tensor
    return [(t(rng.normal(size=(nmem, n))), t(rng.random((nmem, n)) < 0.2),
             "sum"),
            (t(rng.normal(size=n)), None, "min"),
            (t(rng.integers(-9, 9, (nmem, n))), t(rng.random(n) < 0.1),
             "max"),
            (None, t(rng.random((nmem, n)) < 0.3), "count")]


@pytest.mark.parametrize("nmem", [1, 3, 8])
def test_batched_reductions_equal_solo_per_member(nmem):
    """HK1b's and HK2b's plain versions: member b's row / table equals the
    solo plain version over member b's mask and lanes, byte for byte."""
    rng = np.random.default_rng(40 + nmem)
    n = 700
    valid = torch.as_tensor(rng.random((nmem, n)) < 0.6)
    lanes = _b_lanes(rng, nmem, n)
    port.reset_kernel_counts()
    got = port.masked_reduce_batched(valid, lanes)
    assert got.shape == (nmem, 2 + 2 * len(lanes))
    for b in range(nmem):
        assert torch.equal(got[b], port.masked_reduce(
            valid[b], port._member_lanes(lanes, b))), b
    for ns in (16, 4096):
        gid = torch.as_tensor(rng.integers(-1, ns + 1, n))
        got = port.segment_reduce_batched(gid, valid, ns, lanes)
        assert got.shape == (nmem, 2 + 2 * len(lanes), ns)
        for b in range(nmem):
            assert torch.equal(got[b], port.segment_reduce(
                gid, valid[b], ns, port._member_lanes(lanes, b))), (ns, b)
    calls = port.kernel_counts()["plain_calls"]
    assert calls["masked_reduce_batched"] == 1
    assert calls["segment_reduce_batched"] == 2


@pytest.mark.parametrize("nmem", [1, 3, 8])
def test_batched_expr_eval_equals_solo_per_member(nmem):
    """HK7b's plain version over the expression battery and the split
    programs: member b's mask and lanes equal the solo plain version with
    member b's parameters, byte for byte, with and without a row cut and
    an incoming mask (shared or per member)."""
    from tinysql_tpu_torch.bench import exprcases as EC
    from tinysql_tpu_torch.ops import exprjit as X
    rng = np.random.default_rng(50 + nmem)
    vals, nulls = EC.columns(3)
    n = len(vals[0])
    cols = [(torch.as_tensor(v), torch.as_tensor(m))
            for v, m in zip(vals, nulls)]
    keeps = [torch.as_tensor(rng.random(n) < 0.8),
             torch.as_tensor(rng.random((nmem, n)) < 0.8)]
    specs = [ss[0] for ss in EC.CASES.values()]
    specs += list(EC.SPLIT_CASES.values())
    for spec in specs:
        e = EC.build(spec)
        pt = X.ParamTable()
        prog = X.compile_program([e], [e, ("null", e)], pt)
        prs = port._params_dev(EC.stacked_params(*pt.arrays(), nmem))
        assert prs[0].shape[0] == nmem and prs[1].shape[0] == nmem
        for kw in ({}, {"n_rows": n - 9, "mask_in": keeps[0]},
                   {"mask_in": keeps[1]}):
            mask, outs = port.expr_eval_batched(prog, cols, prs, n, **kw)
            for b in range(nmem):
                kb = dict(kw)
                if "mask_in" in kb and kb["mask_in"].dim() == 2:
                    kb["mask_in"] = kb["mask_in"][b]
                sm, so = port.expr_eval(prog, cols,
                                        (prs[0][b], prs[1][b]), n, **kb)
                assert (mask is None) == (sm is None)
                if sm is not None:
                    assert torch.equal(mask[b], sm), (spec, b)
                for (v, m), (sv, snl) in zip(outs, so):
                    assert torch.equal(m[b], snl), (spec, b)
                    if sv is not None:
                        assert torch.equal(v[b].view(torch.int64)
                                           if v.dtype == torch.float64
                                           else v[b],
                                           sv.view(torch.int64)
                                           if sv.dtype == torch.float64
                                           else sv), (spec, b)
