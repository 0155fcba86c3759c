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
