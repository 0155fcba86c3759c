"""The port on the card: each hand kernel against its plain torch version
on CUDA tensors, and TPC-H through SQL on cuda against the port's own CPU
tier.  Every test is marked ``cuda`` and skips without a CUDA device.

This file imports neither JAX nor the reference package, so it runs on a
machine without them; there, skip tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tinysql_tpu_torch.bench import compactcases as CC
from tinysql_tpu_torch.bench import rankcases as RC
from tinysql_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = torch.device("cuda", torch.cuda.current_device())
    with K.use_device(d):
        yield d


def _t(a, d, dtype=None):
    return torch.as_tensor(a, dtype=dtype).to(d)


def test_masked_and_segment_reduce_match_plain(dev):
    rng = np.random.default_rng(0)
    n = 5000
    valid = _t(rng.random(n) < 0.7, dev)
    v = _t(rng.normal(size=n), dev)
    iv = _t(rng.integers(-9, 9, n), dev, torch.int64)
    m = _t(rng.random(n) < 0.2, dev)
    lanes = [(v, m, "sum"), (v, None, "min"), (iv, m, "max"),
             (None, m, "count")]
    a = K.masked_reduce(valid, lanes)
    b = K.masked_reduce_plain(valid, lanes)
    assert torch.equal(a[:2], b[:2]) and torch.equal(a[3:], b[3:])
    torch.testing.assert_close(a[2:3].view(torch.float64),
                               b[2:3].view(torch.float64), rtol=1e-9,
                               atol=0)
    assert torch.equal(a, K.masked_reduce(valid, lanes))  # deterministic
    for ns in (16, 4096):
        gid = _t(rng.integers(0, ns, n), dev, torch.int64)
        a = K.segment_reduce(gid, valid, ns, lanes)
        b = K.segment_reduce_plain(gid, valid, ns, lanes)
        assert torch.equal(a[:2], b[:2]) and torch.equal(a[3:], b[3:])
        torch.testing.assert_close(a[2].view(torch.float64),
                                   b[2].view(torch.float64), rtol=1e-9,
                                   atol=1e-12)
        assert torch.equal(a, K.segment_reduce(gid, valid, ns, lanes))
        ka, pa = K.present_compact(a, ns)
        kb, pb = K.present_compact_plain(a, ns)
        assert ka == kb and torch.equal(pa, pb)


def test_segment_reduce_long_runs_match_plain(dev):
    """Runs longer than one thread's share (a group holding most rows, and
    runs just around the threshold) reduce on a block of their own."""
    rng = np.random.default_rng(2)
    n, ns = 1 << 16, 1 << 12
    gid = np.where(rng.random(n) < 0.8, 5, rng.integers(0, ns, n))
    gid[:1025] = 7
    gid[1025:2049] = 9
    gid = _t(rng.permutation(gid), dev, torch.int64)
    valid = _t(rng.random(n) < 0.97, dev)
    v = _t(rng.normal(size=n), dev)
    iv = _t(rng.integers(-9, 9, n), dev, torch.int64)
    m = _t(rng.random(n) < 0.1, dev)
    lanes = [(v, m, "sum"), (v, None, "min"), (v, m, "max"),
             (iv, m, "sum"), (iv, None, "min"), (None, m, "count")]
    a = K.segment_reduce(gid, valid, ns, lanes)
    b = K.segment_reduce_plain(gid, valid, ns, lanes)
    assert torch.equal(a[:2], b[:2]) and torch.equal(a[3:], b[3:])
    torch.testing.assert_close(a[2].view(torch.float64),
                               b[2].view(torch.float64), rtol=1e-9,
                               atol=1e-12)
    assert torch.equal(a, K.segment_reduce(gid, valid, ns, lanes))


def _same_table(a, b, float_sums, float_minmax=()):
    """Integers, counts and first rows exactly; float sums to 1e-9
    relative; float MIN/MAX as floats (the plain HK2 ties -0.0 with
    +0.0, the kernels order them)."""
    for r in range(a.shape[0]):
        x, y = a[r].view(torch.float64), b[r].view(torch.float64)
        if r in float_sums:
            torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12,
                                       equal_nan=True)
        elif r in float_minmax:
            assert bool(((x == y) | (torch.isnan(x) & torch.isnan(y)))
                        .all()), r
        else:
            assert torch.equal(a[r], b[r]), r


def test_few_segment_regime_matches_plain(dev):
    """The few-segment body HK2, HK2b and HK5 share (csrc/few_reduce.cuh):
    ns on both sides of kSmallSeg (64) over a row count that is not a
    multiple of the 4,096-row tile, HK2b members past the 16 a block
    keeps equal to solo launches, and an HK5 index whose order leaves
    rows out (they belong to no group)."""
    rng = np.random.default_rng(11)
    n = 3 * 4096 + 5
    valid = _t(rng.random(n) < 0.9, dev)
    v = _t(rng.normal(size=n), dev)
    v[:4] = torch.tensor([0.0, -0.0, float("nan"), float("inf")])
    iv = _t(rng.integers(-9, 9, n), dev, torch.int64)
    m = _t(rng.random(n) < 0.2, dev)
    lanes = [(v, m, "sum"), (v, None, "min"), (v, m, "max"), (iv, m, "sum"),
             (iv, None, "max"), (None, m, "count"), (None, None, "count")]
    for ns in (1, 64, 65):
        gid = _t(rng.integers(-1, ns + 1, n), dev, torch.int64)
        a = K.segment_reduce(gid, valid, ns, lanes)
        _same_table(a, K.segment_reduce_plain(gid, valid, ns, lanes), {2},
                    {4, 6})
        assert torch.equal(a, K.segment_reduce(gid, valid, ns, lanes))
    nmem = 17
    gid = _t(rng.integers(0, 6, n), dev, torch.int64)
    vb = _t(rng.random((nmem, n)) < 0.9, dev)
    bl = [(_t(rng.normal(size=(nmem, n)), dev), m, "sum"), (v, None, "sum"),
          (None, m, "count")]
    t = K.segment_reduce_batched(gid, vb, 16, bl)
    for b in range(nmem):
        assert torch.equal(t[b], K.segment_reduce(gid, vb[b], 16,
                                                  K._member_lanes(bl, b)))
    keys = rng.integers(0, 4, n)
    order = np.argsort(keys, kind="stable")
    order = order[rng.random(n)[order] < 0.9]
    sk = keys[order]
    ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0]
    o = _t(K.pad1(order.astype(np.int64), n), dev)
    e = _t(K.pad1(ends.astype(np.int64), 16, fill=len(order) - 1), dev)
    a = K.csr_reduce(o, e, valid, lanes, n, len(ends))
    _same_table(a, K.csr_reduce_plain(o, e, valid, lanes, n, len(ends)),
                {2})
    assert torch.equal(a, K.csr_reduce(o, e, valid, lanes, n, len(ends)))


def test_equi_join_and_lex_order_match_plain(dev):
    rng = np.random.default_rng(1)
    n = 5000
    lk = _t(rng.integers(0, 300, n), dev, torch.int64)
    ln = _t(rng.random(n) < 0.1, dev)
    lv = _t(rng.random(n) < 0.9, dev)
    for rk in (_t(np.arange(256), dev, torch.int64),
               _t(rng.integers(-(1 << 62), 1 << 62, 256), dev,
                  torch.int64)):
        rn = _t(rng.random(256) < 0.1, dev)
        rv = _t(rng.random(256) < 0.9, dev)
        for outer in (False, True):
            a = K.equi_join_unique(lk, ln, lv, rk, rn, rv, outer=outer)
            b = K.equi_join_unique_plain(lk, ln, lv, rk, rn, rv, outer)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            a = K.equi_join_mult(lk, ln, lv, rk % 50, rn, rv, outer=outer)
            b = K.equi_join_mult_plain(lk, ln, lv, rk % 50, rn, rv, outer)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    f = _t(rng.integers(-3, 3, n).astype(np.float64), dev)
    lanes = K.sort_lanes([(lk, ln), (f, lv)], [True, False],
                         _t(rng.random(n) < 0.95, dev))
    for k in (None, 10, 700):
        want = K.lex_order_plain(lanes, n)
        got = K.lex_order(lanes, n, k)
        assert torch.equal(got, want[:got.shape[0]])


def _kept(out):
    return out[:1 + int(out[0])]


def test_semi_pick_matches_plain(dev):
    """HK10 (K8's ladder and compaction) against its plain version byte
    for byte in every mode: over 2^12 rows past one scan block, with an
    empty build side, a NULL build key, NULL probe keys and no NULLs."""
    rng = np.random.default_rng(4)
    nl, nr = 5000, 3000
    lk = _t(rng.integers(0, 4000, nl), dev, torch.int64)
    rk = _t(rng.integers(0, 4000, nr), dev, torch.int64)
    ln0 = _t(rng.random(nl) < 0.1, dev)
    lv = _t(rng.random(nl) < 0.9, dev)
    rv0 = _t(rng.random(nr) < 0.9, dev)
    cases = {"nulls both sides": (ln0, _t(rng.random(nr) < 0.01, dev), rv0),
             "no nulls": (torch.zeros_like(ln0), torch.zeros_like(rv0), rv0),
             "empty build": (ln0, torch.zeros_like(rv0),
                             torch.zeros_like(rv0))}
    one = torch.zeros_like(rv0)
    one[17] = True
    cases["one null build key"] = (ln0, one, rv0 | one)
    for what, (ln, rn, rv) in cases.items():
        match = K.unique_match(lk, ln, lv, rk, rn, rv)
        for anti, na in ((False, False), (True, False), (True, True)):
            a = K.semi_pick(match, ln, lv, rn, rv, anti, na)
            b = K.semi_pick_plain(match, ln, lv, rn, rv, anti, na)
            assert torch.equal(_kept(a), _kept(b)), (what, anti, na)
            assert torch.equal(_kept(a), _kept(K.semi_pick(
                match, ln, lv, rn, rv, anti, na)))
        if what == "one null build key":
            assert int(K.semi_pick(match, ln, lv, rn, rv, True, True)[0]) \
                == 0


def test_block_pipeline_stages_on_a_side_stream(dev):
    """devpipe.BlockPipeline at depth 2 uploads each block on its side
    stream while the consumer reduces the previous one on the current
    stream: the sums equal the inline (depth 0) run's."""
    from tinysql_tpu_torch.executor.devpipe import BlockPipeline
    rng = np.random.default_rng(5)
    host = [rng.integers(-1000, 1000, 1 << 16) for _ in range(8)]

    def stage(i):
        return i, K.h2d(host[i])

    got = {}
    for depth in (0, 2):
        pipe = BlockPipeline(stage, range(len(host)), depth=depth)
        assert (pipe._side is not None) == (depth > 0)
        got[depth] = [int(x.sum()) for _, x in pipe]
    assert got[0] == got[2] == [int(h.sum()) for h in host]


def test_csr_reduce_matches_plain(dev):
    """HK5 over a group index: short groups on a thread each, long ones
    (past the 1024-row threshold) through the chunk queue, NULL lanes,
    invalid and padding rows, padding groups; bit-identical run to run."""
    rng = np.random.default_rng(3)
    n, nb = 60000, 1 << 16
    key = rng.integers(0, 500, n)
    key[:3000] = 7
    key[3000:4025] = 9
    order = np.argsort(key, kind="stable")
    sk = key[order]
    ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0]
    ng, ngb = len(ends), 1024
    o = _t(K.pad1(order.astype(np.int64), nb), dev)
    e = _t(K.pad1(ends.astype(np.int64), ngb, fill=n - 1), dev)
    valid = _t(rng.random(nb) < 0.8, dev)
    v = _t(rng.normal(size=nb), dev)
    iv = _t(rng.integers(-9, 9, nb), dev, torch.int64)
    m = _t(rng.random(nb) < 0.1, dev)
    lanes = [(v, m, "sum"), (v, None, "min"), (v, m, "max"),
             (iv, m, "sum"), (iv, None, "min"), (None, m, "count")]
    a = K.csr_reduce(o, e, valid, lanes, n, ng)
    b = K.csr_reduce_plain(o, e, valid, lanes, n, ng)
    assert torch.equal(a[:2], b[:2]) and torch.equal(a[3:], b[3:])
    torch.testing.assert_close(a[2].view(torch.float64),
                               b[2].view(torch.float64), rtol=1e-9,
                               atol=1e-12)
    assert torch.equal(a, K.csr_reduce(o, e, valid, lanes, n, ng))


def test_dense_probe_matches_plain(dev):
    rng = np.random.default_rng(4)
    n, m = 5000, 256
    for lo in (-100, (1 << 63) - 300, -(1 << 63)):
        hi = lo + 299
        tbl = np.full(300, -1, np.int32)
        tbl[rng.choice(300, 200, replace=False)] = np.arange(200)
        off = rng.integers(-20, 320, n)
        kp = np.array([min(max(lo + int(x), -(1 << 63)), (1 << 63) - 1)
                       for x in off], dtype=np.int64)
        args = (_t(kp, dev), _t(rng.random(n) < 0.1, dev),
                _t(rng.random(n) < 0.9, dev), lo, hi, _t(tbl, dev),
                _t(rng.random(m) < 0.8, dev),
                [(_t(rng.normal(size=m), dev), _t(rng.random(m) < 0.2, dev)),
                 (_t(rng.integers(0, 9, m), dev, torch.int64), None),
                 (_t(rng.random(m) < 0.5, dev), None)])
        for mode in ("inner", "left", "semi", "anti"):
            va, la = K.dense_probe(*args, mode)
            vb, lb = K.dense_probe_plain(*args, mode)
            assert torch.equal(va, vb) and len(la) == len(lb), mode
            for (x, xn), (y, yn) in zip(la, lb):
                assert torch.equal(xn, yn), mode
                assert torch.equal(x.view(torch.uint8),
                                   y.view(torch.uint8)), mode


def _same_pairs(a, b, what):
    """Lists of (values, NULL mask) pairs byte for byte."""
    assert len(a) == len(b), what
    for (x, xn), (y, yn) in zip(a, b):
        assert torch.equal(xn, yn), what
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), what


def test_dense_probe_multi_matches_plain(dev):
    """HK6's composite mode: two and three keys, NULL and out-of-range
    parts, dead build rows, left and inner."""
    rng = np.random.default_rng(5)
    n, m = 6000, 512
    for spans in ((20, 15), (7, 5, 9)):
        los = [int(x) for x in rng.integers(-50, 50, len(spans))]
        spec, st = [], 1
        for lo, sp in reversed(list(zip(los, spans))):
            spec.append((lo, lo + sp - 1, st))
            st *= sp
        spec.reverse()
        total = st
        tbl = np.full(total, -1, np.int32)
        tbl[rng.choice(total, min(total, m), replace=False)] = \
            np.arange(min(total, m))
        keys = [(_t(rng.integers(lo - 3, hi + 4, n), dev, torch.int64),
                 _t(rng.random(n) < 0.05, dev)) for lo, hi, _ in spec]
        keys[0] = (keys[0][0], None)
        args = (keys, spec, _t(rng.random(n) < 0.9, dev), _t(tbl, dev),
                _t(rng.random(m) < 0.8, dev),
                [(_t(rng.normal(size=m), dev), _t(rng.random(m) < 0.2, dev)),
                 (_t(rng.integers(0, 9, m), dev, torch.int64), None)])
        for mode in ("inner", "left"):
            va, la = K.dense_probe_multi(*args, mode)
            vb, lb = K.dense_probe_multi_plain(*args, mode)
            assert torch.equal(va, vb), mode
            _same_pairs(la, lb, mode)


def _csr_case(rng, dev, n_build, n_probe, nk, skew=False):
    """A build side with duplicate (and NULL) keys, its group index over
    the key (or the composite lane), and a probe side."""
    from tinysql_tpu_torch.executor import devpipe
    nbb, nb = K.bucket(n_build), K.bucket(n_probe)
    if nk == 1:
        bk = rng.integers(1, 300, n_build).astype(np.int64)
        if skew:
            bk[: n_build // 2] = 7
        bkn = rng.random(n_build) < 0.05
        gi = devpipe.GroupIndex([(bk, bkn)])
        keys = [(_t(K.pad1(rng.integers(-5, 320, n_probe), nb), dev,
                    torch.int64), _t(K.pad1(rng.random(n_probe) < 0.05, nb,
                                            True), dev))]
        spec = None
    else:
        cols = [(rng.integers(1, 12, n_build).astype(np.int64),
                 rng.random(n_build) < 0.03) for _ in range(nk)]
        los, his, strides, comp, null_any, _tot = \
            devpipe._composite_spec(cols)
        gi = devpipe.GroupIndex([(comp, null_any)])
        spec = list(zip(los, his, strides))
        keys = [(_t(K.pad1(rng.integers(0, 14, n_probe), nb), dev,
                    torch.int64), _t(K.pad1(rng.random(n_probe) < 0.03, nb,
                                            True), dev)) for _ in range(nk)]
    tbl = gi.pos_table()
    ngb = K.bucket(max(gi.n_groups, 1))
    order = _t(K.pad1(gi.order, nbb), dev)
    ends = _t(K.pad1(gi.ends, ngb, fill=n_build - 1), dev)
    raw = gi.raw_counts()
    ob = K.bucket(int(raw.max()) * n_probe + n_probe)
    blanes = [(_t(rng.normal(size=nbb), dev), _t(rng.random(nbb) < 0.1, dev)),
              (_t(rng.integers(0, 99, nbb), dev, torch.int64), None)]
    plns = [(_t(rng.integers(0, 99, nb).astype(np.int32), dev),
             _t(rng.random(nb) < 0.1, dev))] + keys[:1]
    return (order, ends, gi.n_groups, n_build, _t(rng.random(nbb) < 0.8, dev),
            _t(tbl, dev), gi.lo, gi.hi, keys, spec,
            _t(K.pad1(rng.random(n_probe) < 0.9, nb), dev)), ob, plns, blanes


def test_csr_expand_matches_plain(dev):
    """HK8 against its plain version: one key and the composite lane,
    inner and LEFT, a skewed group, build-side filters, NULL keys, a
    bucket larger than the output; the same bytes from run to run."""
    rng = np.random.default_rng(6)
    for nk, skew in ((1, False), (1, True), (2, False), (3, False)):
        args, ob, plns, blanes = _csr_case(rng, dev, 3000, 2000, nk, skew)
        for outer in (False, True):
            a = K.csr_expand(*args, outer, ob, plns, blanes)
            b = K.csr_expand_plain(*args, outer, ob, plns, blanes)
            what = (nk, skew, outer)
            assert torch.equal(a[0], b[0]), what
            assert int(a[0].sum()) > 0, what
            _same_pairs(a[1], b[1], what)
            _same_pairs(a[2], b[2], what)
            c = K.csr_expand(*args, outer, ob, plns, blanes)
            assert torch.equal(a[0], c[0])
            _same_pairs(a[2], c[2], what)


def test_run_bounds_matches_plain(dev):
    """HK9 against its plain version over HK4's group-by order: int and
    float keys with NULLs, NaN, -0.0 and +0.0, invalid rows, one and two
    lanes, no valid row at all."""
    rng = np.random.default_rng(7)
    n = 1 << 15
    iv = _t(rng.integers(0, 40, n), dev, torch.int64)
    fv = _t(rng.integers(-3, 3, n).astype(np.float64), dev)
    fv[:6] = _t([float("nan"), -0.0, 0.0, float("nan"), -0.0, 1.5], dev)
    inl = _t(rng.random(n) < 0.1, dev)
    fnl = _t(rng.random(n) < 0.1, dev)
    for frac in (0.9, 0.0):
        valid = _t(rng.random(n) < frac, dev)
        for keys in ([(iv, inl)], [(fv, fnl)], [(iv, inl), (fv, None)]):
            perm = K.lex_order(K.sort_lanes(
                [(v, torch.zeros_like(valid) if m is None else m)
                 for v, m in keys], [False] * len(keys), valid), n)
            a = K.run_bounds(perm, valid, keys, want_gid=True)
            b = K.run_bounds_plain(perm, valid, keys, want_gid=True)
            for x, y in zip(a, b):
                assert torch.equal(x, y), (frac, len(keys))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float64
    tensors (equal NaNs count 0)."""
    ia, ib = a.view(torch.int64), b.view(torch.int64)
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = (ia - ib).abs()
    d = torch.where(both_nan | (ia == ib), torch.zeros_like(d), d)
    return int(d.max()) if d.numel() else 0


def _same_expr(a, b, what, float_ulps=0):
    """HK7 against its plain version: the mask and every output lane byte
    for byte (float lanes within ``float_ulps``)."""
    (ma, oa), (mb, ob) = a, b
    assert (ma is None) == (mb is None), what
    if ma is not None:
        assert torch.equal(ma, mb), f"{what}: mask"
    assert len(oa) == len(ob), what
    for j, ((va, na), (vb, nb)) in enumerate(zip(oa, ob)):
        assert torch.equal(na, nb), f"{what}: NULL lane {j}"
        assert (va is None) == (vb is None), what
        if va is None:
            continue
        assert va.dtype == vb.dtype, what
        if va.dtype == torch.float64 and float_ulps:
            assert _ulps(va, vb) <= float_ulps, f"{what}: lane {j}"
        else:
            assert torch.equal(va.view(torch.int64), vb.view(torch.int64)), \
                f"{what}: lane {j}"


def test_expr_eval_matches_plain(dev):
    """HK7 over the expression battery (every SQL function the device
    evaluates, NULLs, int64 extremes, zeros, unsigned words), K14's code
    compares, K15's layouts and the programs split past its limits: byte
    for byte against the plain interpreter (float % within 1 ulp), with
    and without a row cut and an incoming mask, and byte-stable."""
    from tinysql_tpu_torch.bench import exprcases as EC
    from tinysql_tpu_torch.ops import exprjit as X
    rng = np.random.default_rng(7)
    n = 5000
    vals, nulls = EC.columns(0, n)
    cols = [(_t(v, dev), _t(m, dev)) for v, m in zip(vals, nulls)]
    keep = _t(rng.random(n) < 0.8, dev)
    specs = [(name, s) for name, ss in EC.CASES.items() for s in ss]
    specs += list(EC.SPLIT_CASES.items())
    for name, spec in specs:
        e = EC.build(spec)
        pt = X.ParamTable()
        prog = X.compile_program([e], [e, ("null", e)], pt)
        pr = K._params_dev(pt.arrays())
        for kw in ({}, {"n_rows": n - 77, "mask_in": keep}):
            a = K.expr_eval(prog, cols, pr, n, **kw)
            _same_expr(a, K.expr_eval(prog, cols, pr, n, **kw), name)
            _same_expr(a, K.expr_eval_plain(prog, cols, pr, n, **kw),
                       f"{name} {spec}", 1 if name == "%" else 0)
    codes, cnull = EC.code_column(1, n)
    ccols = [(_t(codes, dev), _t(cnull, dev))]
    for op in EC.CODE_CMP_OPS:
        pt = X.ParamTable()
        prog = X.ExprProgram()
        r = prog.code_cmp(0, op, EC.CODE_LO, EC.CODE_HI, EC.CODE_CARD, pt)
        prog.cond(r)
        prog.store(r)
        pr = K._params_dev(pt.arrays())
        _same_expr(K.expr_eval(prog, ccols, pr, n),
                   K.expr_eval_plain(prog, ccols, pr, n), f"code {op}")
    ids = _t(rng.integers(0, 7 * 14 + 1, n), dev, torch.int64)
    lcols = [(ids, None), (ids < 7 * 14, None),
             (_t(rng.normal(size=n), dev), _t(rng.random(n) < 0.1, dev)),
             (_t(rng.integers(0, 4, n), dev, torch.int64), None)]
    pt = X.ParamTable()
    prog = X.ExprProgram()
    for stride, card, base in ((14, 6, -3), (1, 13, 1 << 40)):
        prog.store(prog.key_decode(prog.load(0, "i"), prog.load(1, "b"),
                                   stride, card, base, pt))
    prog.store(prog.avg(prog.load(2, "f"), prog.load(3, "i")))
    prog.store(prog.to_real(prog.load(3, "i")))
    pr = K._params_dev(pt.arrays())
    _same_expr(K.expr_eval(prog, lcols, pr, n),
               K.expr_eval_plain(prog, lcols, pr, n), "layout")


def test_tpch_on_the_card_matches_the_cpu_tier(dev):
    """Both device tiers on the card — the pipeline (the default) and the
    per-operator tier — launch every kernel between them, run no plain
    version, and give the CPU tier's rows, for Q1, Q3, Q6, the workload
    trio Q5, Q10, Q18 and Q13 (a LEFT join with a non-unique build side
    and two GROUP BYs above it)."""
    from tinysql_tpu_torch.bench import tpch
    from tinysql_tpu_torch.session import new_session
    s = new_session()
    assert s.device.type == "cuda"
    tpch.load(s, sf=0.01, seed=7)
    s.execute("set tidb_tpu_min_rows = 0")
    queries = {**tpch.ALL_QUERIES, "Q13": tpch.Q13}
    launched = dict.fromkeys(K.LAUNCHES, 0)
    gpu = {}
    for devpipe in (-1, 0):
        s.execute(f"set tidb_devpipe = {devpipe}")
        K.reset_kernel_counts()
        gpu[devpipe] = {q: s.query(sql).rows
                        for q, sql in queries.items()}
        counts = K.kernel_counts()
        assert not any(counts["plain_calls"].values()), counts
        for k, v in counts["launches"].items():
            launched[k] += v
    # the batched entry points launch only in a stacked round (the
    # serve phase of chip_smoke.py, the tests above), the mesh kernels
    # only under tidb_mesh_parallel (the mesh phase, the tests below)
    assert all(v for k, v in launched.items()
               if not k.endswith("_batched")
               and k not in K.MESH_LAUNCHES), launched
    s.execute("set tidb_use_tpu = 0")
    for q, sql in queries.items():
        cpu = tpch.canon_rows(s.query(sql).rows)
        for devpipe in (-1, 0):
            assert cpu == tpch.canon_rows(gpu[devpipe][q]), (devpipe, q)


# ---- K12: the batched entry points of a stacked round -------------------

def _batch_lanes(rng, dev, nmem, n):
    """Per-member and shared lanes of every kind and op."""
    v = _t(rng.normal(size=(nmem, n)), dev)
    vs = _t(rng.normal(size=n), dev)
    iv = _t(rng.integers(-9, 9, (nmem, n)), dev, torch.int64)
    m = _t(rng.random((nmem, n)) < 0.2, dev)
    ms = _t(rng.random(n) < 0.1, dev)
    return [(v, m, "sum"), (vs, None, "min"), (v, ms, "max"),
            (iv, m, "sum"), (iv, None, "max"), (None, m, "count"),
            (vs, ms, "sum")]


def test_batched_reductions_equal_solo_launches(dev):
    """HK1b and HK2b: member b's row / table is bit-identical to the solo
    kernel over member b's mask and lanes (both regimes of HK2, long
    runs included), and agrees with the batched plain versions."""
    rng = np.random.default_rng(11)
    n = 6000
    for nmem in (1, 3, 8):
        valid = _t(rng.random((nmem, n)) < 0.7, dev)
        lanes = _batch_lanes(rng, dev, nmem, n)
        a = K.masked_reduce_batched(valid, lanes)
        assert a.shape == (nmem, 2 + 2 * len(lanes))
        p = K.masked_reduce_batched_plain(valid, lanes)
        for b in range(nmem):
            solo = K.masked_reduce(valid[b], K._member_lanes(lanes, b))
            assert torch.equal(a[b], solo), (nmem, b)
        exact = [0, 1] + [3 + 2 * j for j in range(len(lanes))] \
            + [4, 6, 8, 10, 12]  # counts, min / max, integer sums
        assert torch.equal(a[:, exact], p[:, exact])
        for c in (2, 14):  # float sums: another order of addition
            torch.testing.assert_close(a[:, c].view(torch.float64),
                                       p[:, c].view(torch.float64),
                                       rtol=1e-9, atol=1e-12)
        for ns in (16, 4096):
            gid = np.where(rng.random(n) < 0.5, 3, rng.integers(0, ns, n))
            gid[:2000] = 1  # a run past kLongRun rows
            gid = _t(rng.permutation(gid), dev, torch.int64)
            t = K.segment_reduce_batched(gid, valid, ns, lanes)
            assert t.shape == (nmem, 2 + 2 * len(lanes), ns)
            tp = K.segment_reduce_batched_plain(gid, valid, ns, lanes)
            for b in range(nmem):
                solo = K.segment_reduce(gid, valid[b], ns,
                                        K._member_lanes(lanes, b))
                assert torch.equal(t[b], solo), (nmem, ns, b)
                for r in range(t.shape[1]):
                    if r in (2, 4, 6, 14):  # float value rows
                        torch.testing.assert_close(
                            t[b, r].view(torch.float64),
                            tp[b, r].view(torch.float64), rtol=1e-9,
                            atol=1e-12)
                    else:
                        assert torch.equal(t[b, r], tp[b, r]), (ns, b, r)


def test_batched_expr_eval_equals_solo_launches(dev):
    """HK7b over the expression battery and the split programs (several
    launches with temporaries): member b's mask and lanes equal, byte for
    byte, a solo HK7 launch with member b's parameters and the batched
    plain version."""
    from tinysql_tpu_torch.bench import exprcases as EC
    from tinysql_tpu_torch.ops import exprjit as X
    rng = np.random.default_rng(12)
    n = 3000
    vals, nulls = EC.columns(0, n)
    cols = [(_t(v, dev), _t(m, dev)) for v, m in zip(vals, nulls)]
    keep = _t(rng.random(n) < 0.8, dev)
    specs = [(name, ss[0]) for name, ss in EC.CASES.items()]
    specs += list(EC.SPLIT_CASES.items())
    for name, spec in specs:
        e = EC.build(spec)
        pt = X.ParamTable()
        prog = X.compile_program([e], [e, ("null", e)], pt)
        pi, pf = pt.arrays()
        for nmem in (1, 4):
            prs = K._params_dev(EC.stacked_params(pi, pf, nmem))
            for kw in ({}, {"n_rows": n - 77, "mask_in": keep}):
                got = K.expr_eval_batched(prog, cols, prs, n, **kw)
                plain = K.expr_eval_batched_plain(prog, cols, prs, n, **kw)
                _same_expr(got, plain, name, 1 if name == "%" else 0)
                for b in range(nmem):
                    solo = K.expr_eval(prog, cols, (prs[0][b], prs[1][b]),
                                       n, **kw)
                    mb = None if got[0] is None else got[0][b]
                    ob = [(None if v is None else v[b], m[b])
                          for v, m in got[1]]
                    _same_expr((mb, ob), solo, f"{name} member {b}")


def test_shard_merge_matches_plain(dev):
    """HK11: the mesh tier's merge of per-shard partial tables, byte for
    byte against its plain left fold (NaN partials, sentinels, int64
    wrap), and the sharded HK1 / HK2 routes against their single-device
    tables."""
    rng = np.random.default_rng(11)
    ops_all = K.MERGE_OPS
    for n, width in ((8, 1), (8, 4096), (2, 33)):
        ops = [ops_all["sum_i"], ops_all["first_seg"], ops_all["sum_f"],
               ops_all["sum_i"], ops_all["min_f"], ops_all["max_f"],
               ops_all["min_i"], ops_all["max_i"], ops_all["first_scalar"]]
        m = 1000
        parts = rng.integers(-(1 << 62), 1 << 62, (n, len(ops), width))
        parts[:, 1] = rng.integers(0, m + 1, (n, width))
        parts[:, 8] = rng.integers(0, m, (n, width))
        parts[:, 0] = rng.integers(0, 2, (n, width))
        for r in (2, 4, 5):
            f = rng.normal(size=(n, width)) * 1e3
            f[rng.random((n, width)) < 0.1] = np.nan
            parts[:, r] = f.view(np.int64)
        p = _t(parts.astype(np.int64), dev)
        a = K.shard_merge(p, ops, m, n * m)
        assert torch.equal(a, K.shard_merge_plain(p, ops, m, n * m))
        assert torch.equal(a, K.shard_merge(p, ops, m, n * m))
    nb, ns = 1 << 14, 50
    valid = _t(rng.random(nb) < 0.6, dev)
    gid = _t(rng.integers(0, ns, nb), dev, torch.int64)
    x = _t(rng.normal(size=nb), dev)
    lanes = [(x, None, "sum"), (x, None, "min"), (None, None, "count")]
    for got, one in ((K.sharded_segment_reduce(gid, valid, ns, lanes, 8),
                      K.segment_reduce(gid, valid, ns, lanes)),
                     (K.sharded_masked_reduce(valid, lanes, 8)[:, None],
                      K.masked_reduce(valid, lanes)[:, None])):
        assert torch.equal(got[[0, 3, 4, 5, 6, 7]], one[[0, 3, 4, 5, 6, 7]])
        torch.testing.assert_close(got[2].view(torch.float64),
                                   one[2].view(torch.float64), rtol=1e-12,
                                   atol=1e-12)


def test_shard_probe_matches_plain(dev):
    """HK12 over HK4's sort of the build blocks, byte for byte against
    its plain version (torch.searchsorted per shard), int64 and float64
    keys with their sentinels, NaN, -0.0 and padding slots."""
    from tinysql_tpu_torch.ops import shardops
    rng = np.random.default_rng(12)
    for dt in (np.int64, np.float64):
        n, cp, cb = 8, 2048, 512
        pk = rng.integers(-300, 300, n * cp).astype(dt)
        bk = rng.integers(-300, 300, n * cb).astype(dt)
        if dt == np.float64:
            pk[:3] = [np.nan, -0.0, np.inf]
            bk[:2] = [0.0, np.inf]
        else:
            pk[:2] = [K.I64_MAX, K.I64_MIN]
            bk[:2] = [K.I64_MAX, K.I64_MIN]
        pid = np.where(rng.random(n * cp) < 0.9, np.arange(n * cp), -1)
        bid = np.where(rng.random(n * cb) < 0.8, np.arange(n * cb), -1)
        args = [_t(a, dev) for a in (pk, pid.astype(np.int64), bk,
                                     bid.astype(np.int64))]
        hit, brow = shardops._local_unique_join(n, *args)
        blive = args[3] >= 0
        sent = float("inf") if dt == np.float64 else K.I64_MAX
        bord = K._u64_lane(torch.where(blive, args[2],
                                       torch.full_like(args[2], sent)),
                           False)
        perm = K.lex_order([K.shard_lane(n, cb), bord,
                            (~blive).to(torch.int64)], n * cb)
        ph, pb = K.shard_probe_plain(args[0], args[1], bord, args[3], perm,
                                     n)
        assert torch.equal(hit, ph) and torch.equal(brow, pb)
        assert bool(hit.any())


def test_shard_exchange_matches_plain(dev):
    """HK13 byte for byte against its plain version: n = 2, 4, 8 and 64
    shards, shards of fewer rows than a tile and of several tiles,
    padding rows, 1- and 8-byte lanes, more lanes than one launch takes;
    and an overflowing pair raises."""
    rng = np.random.default_rng(13)
    for n, m in ((2, 16), (4, 3000), (8, 1 << 14), (64, 256)):
        nb = n * m
        n_rows = nb - 7
        keys = rng.integers(-1000, 1000, nb)
        keys[:2] = [K.I64_MIN, K.I64_MAX]
        kt = _t(keys, dev, torch.int64)
        from tinysql_tpu_torch.parallel import dist
        cap = dist.shuffle_cap(keys.astype(np.int64), n, n_rows)
        lanes = []
        for j in range(9):
            lanes += [(_t(rng.normal(size=nb), dev), 0.0),
                      (_t(rng.random(nb) < 0.3, dev), True)]
        a = K.shard_exchange(kt, n_rows, lanes, cap, n)
        b = K.shard_exchange_plain(kt, n_rows, lanes, cap, n)
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        c = K.shard_exchange(kt, n_rows, lanes, cap, n)
        assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in zip(a, c))
    with pytest.raises(RuntimeError, match="capacity"):
        K.shard_exchange(_t(np.zeros(64), dev, torch.int64), 64,
                         [(_t(np.zeros(64), dev, torch.int64), 0)], 4, 4)


def test_shard_rank_matches_plain(dev):
    """HK14 against its plain version: a full merge of 8 runs of 2^14
    with heavy ties, and a top-k over 8 x 16 candidates."""
    rng = np.random.default_rng(14)
    n, m = 8, 1 << 14
    ordl = _t(rng.integers(-50, 50, n * m), dev, torch.int64)
    perm = K.lex_order([K.shard_lane(n, m), ordl], n * m)
    a = K.shard_rank(ordl, perm, m, m, n, n * m)
    assert torch.equal(a, K.shard_rank_plain(ordl, perm, m, m, n, n * m))
    assert torch.equal(a, K.lex_order([ordl], n * m))
    ids = torch.cat([K.lex_order([ordl[s * m:(s + 1) * m]], m, 16) + s * m
                     for s in range(n)])
    b = K.shard_rank(ordl, ids, 16, 16, n, 10)
    assert torch.equal(b, K.shard_rank_plain(ordl, ids, 16, 16, n, 10))
    assert torch.equal(b, K.lex_order([ordl], n * m, 10))


def test_shard_member_and_count_match_plain(dev):
    """HK12's member mode and count mode against their plain versions."""
    from tinysql_tpu_torch.ops import shardops
    rng = np.random.default_rng(15)
    n, cp, cb = 8, 1024, 512
    pk = _t(rng.integers(-300, 300, n * cp), dev, torch.int64)
    bk = _t(rng.integers(-300, 300, n * cb), dev, torch.int64)
    pid = _t(np.where(rng.random(n * cp) < 0.9, np.arange(n * cp), -1),
             dev, torch.int64)
    bid = _t(np.where(rng.random(n * cb) < 0.8, np.arange(n * cb), -1),
             dev, torch.int64)
    mem = shardops._local_member(n, pk, pid, bk, bid)
    bord, perm = shardops._build_order(n, bk, bid)
    assert torch.equal(mem, K.shard_probe_plain(pk, pid, bord, bid, perm, n,
                                                member=True))
    assert torch.equal(mem, shardops._local_unique_join(n, pk, pid, bk,
                                                        bid)[0])
    rs = torch.sort(bk).values
    lv = _t(rng.random(n * cp) < 0.9, dev)
    c, p = K.shard_count(pk, lv, rs, n)
    pc, pp = K.shard_count_plain(pk, lv, rs, n)
    assert torch.equal(c, pc) and torch.equal(p, pp)


def test_csr_expand_shard_mode_matches_plain(dev):
    """HK8's shard mode against its plain version (each shard's slice
    expanded on its own), inner and LEFT."""
    rng = np.random.default_rng(16)
    nbb, nb, n = 4096, 8192, 8
    keys = rng.integers(0, 500, nbb)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0]
    gk = sk[ends]
    tbl = np.full(int(gk.max()) + 1, -1, dtype=np.int32)
    tbl[gk] = np.arange(len(gk), dtype=np.int32)
    args = [_t(order, dev, torch.int64), _t(ends, dev, torch.int64),
            len(ends), nbb, _t(rng.random(nbb) < 0.8, dev),
            _t(tbl, dev), 0, int(gk.max())]
    pk = _t(rng.integers(-5, 520, nb), dev, torch.int64)
    pn = _t(rng.random(nb) < 0.05, dev)
    pv = _t(rng.random(nb) < 0.9, dev)
    plane = [(_t(rng.normal(size=nb), dev), pn)]
    blane = [(_t(rng.integers(0, 9, nbb), dev, torch.int64), None)]
    for outer in (False, True):
        ob = 1 << 15
        a = K.csr_expand(*args, [(pk, pn)], None, pv, outer, ob, plane,
                         blane, shards=n)
        b = K.csr_expand_plain(*args, [(pk, pn)], None, pv, outer, ob,
                               plane, blane, shards=n)
        assert torch.equal(a[0], b[0])
        for (x, xm), (y, ym) in zip(a[1] + a[2], b[1] + b[2]):
            assert torch.equal(x, y) and torch.equal(xm, ym)


# ---- the sort core's regimes (csrc/lex_sort.cuh) --------------------------
# Each case: (lanes, n, k) built on the device.  Above 2^16 rows the sort
# is the radix regime, which skips the digits equal in every row, so the
# cases cover digits that are all trivial, a trivial lane before one that
# is not, ties that cross the radix tiles (4,096 rows), sizes just past a
# tile and at the merge passes' limit, float and int64 extremes, more than
# eight lanes, top-k on both sides of the rounds' cut (k <= T / 4) and of
# the tile size.

def _sort_case(name, rng, dev):
    i64 = torch.int64
    ones = _t(np.ones(1 << 17, bool), dev)

    def key_lanes(v, n, desc=False, nulls=None):
        m = _t(np.zeros(n, bool), dev) if nulls is None else nulls
        return K.sort_lanes([(v, m)], [desc], ones[:n])
    if name == "ties_across_tiles":
        n = 17 * 4096 + 5
        return key_lanes(_t(rng.integers(0, 4, n), dev, i64), n), n, None
    if name == "all_equal":
        n = 1 << 17
        return key_lanes(_t(np.full(n, 9), dev, i64), n), n, None
    if name in ("n_1025", "n_2e16", "n_2e16_plus_3"):
        n = {"n_1025": 1025, "n_2e16": 1 << 16}.get(name, (1 << 16) + 3)
        v = _t(rng.integers(K.I64_MIN, K.I64_MAX, n, endpoint=True), dev,
               i64)
        return [v], n, None
    if name.startswith("float_specials"):
        n = 1 << 17
        f = _t(rng.integers(-3, 4, n).astype(np.float64), dev)
        f[:6] = _t([np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan], dev)
        f[rng.integers(0, n, 64)] = float("nan")
        return key_lanes(f, n, name.endswith("desc"),
                         _t(rng.random(n) < 0.1, dev)), n, None
    if name == "int64_extremes":
        n = 70000
        v = _t(rng.integers(-2, 3, n), dev, i64)
        v[:6] = _t([K.I64_MAX, K.I64_MIN, K.I64_MAX, K.I64_MIN, -1, 0], dev,
                  i64)
        return key_lanes(v, n, False, _t(rng.random(n) < 0.2, dev)), n, \
            None
    if name == "trivial_then_not":
        n = 70000
        return [_t(rng.integers(0, 9, n), dev, i64),
                _t(np.full(n, -5), dev, i64)], n, None
    if name == "ten_lanes":
        n = 70000
        keys = [(_t(rng.integers(0, 3, n), dev, i64),
                 _t(rng.random(n) < 0.1, dev)) for _ in range(5)]
        return K.sort_lanes(keys, [False, True, False, True, False],
                            ones[:n]), n, None
    if name == "mesh_five_lanes":
        n = 1 << 17
        valid = _t(rng.random(n) < 0.3, dev)
        keys = [(_t(np.round(rng.uniform(1e3, 5e5, n), 2), dev),
                 _t(np.zeros(n, bool), dev)),
                (_t(rng.integers(0, 2406, n), dev, i64),
                 _t(np.zeros(n, bool), dev))]
        lanes = K.sort_lanes(keys, [True, False], valid)
        return [K.shard_lane(8, n // 8)] + lanes, n, None
    if name.startswith("topk_"):
        n, k = 80000, int(name.split("_")[1])
        v = _t(rng.integers(0, 50, n), dev, i64)
        return key_lanes(v, n, True), n, k
    raise KeyError(name)


SORT_CASES = ("ties_across_tiles", "all_equal", "n_1025", "n_2e16",
              "n_2e16_plus_3",
              "float_specials_asc", "float_specials_desc", "int64_extremes",
              "trivial_then_not", "ten_lanes", "mesh_five_lanes",
              "topk_1", "topk_256", "topk_257", "topk_1023", "topk_1024",
              "topk_5000")


@pytest.mark.parametrize("case", SORT_CASES)
def test_lex_order_regimes_match_plain(dev, case):
    """HK4 in every regime of the sort core: equal, byte for byte, to its
    plain version and to a second launch."""
    rng = np.random.default_rng(SORT_CASES.index(case))
    lanes, n, k = _sort_case(case, rng, dev)
    a = K.lex_order(lanes, n, k)
    assert torch.equal(a, K.lex_order(lanes, n, k))
    want = K.lex_order_plain(lanes, n)
    assert torch.equal(a, want[:a.shape[0]])
    assert a.shape[0] == (n if k is None else min(k, n))


@pytest.mark.parametrize("ns", [1 << 12, 1 << 21])
def test_segment_reduce_sort_regime_ids(dev, ns):
    """HK2's sort regime over ids whose upper digits are all trivial
    (every id below 2^12) and over ids of three digits, a skewed group
    included, solo and batched: equal to the plain versions."""
    rng = np.random.default_rng(ns)
    n = (1 << 17) + 5
    gid = np.where(rng.random(n) < 0.3, 5, rng.integers(-1, ns + 1, n))
    gid = _t(gid, dev, torch.int64)
    valid = _t(rng.random((3, n)) < 0.8, dev)
    v = _t(rng.normal(size=(3, n)), dev)
    lanes = [(v, None, "sum"), (None, None, "count")]
    t = K.segment_reduce_batched(gid, valid, ns, lanes)
    p = K.segment_reduce_batched_plain(gid, valid, ns, lanes)
    for b in range(3):
        solo = K.segment_reduce(gid, valid[b], ns, K._member_lanes(lanes, b))
        assert torch.equal(t[b], solo)
        assert torch.equal(t[b, :2], p[b, :2])
        assert torch.equal(t[b, 3:], p[b, 3:])
        torch.testing.assert_close(t[b, 2].view(torch.float64),
                                   p[b, 2].view(torch.float64), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("case", sorted(RC.CASES))
def test_shard_rank_merge_rounds_edge_shapes(dev, case):
    """HK14's merge-path rounds at the edge shapes
    (tinysql_tpu_torch/bench/rankcases.py: keys tied in 0..3, all equal,
    n = 1, 2, 3 runs, a run length that is not a multiple of the tile,
    k_out below n * run, stride > run, the top-k's layout): equal, byte
    for byte, to its plain version and to a second launch."""
    keys, ids, stride, run, n, k_out = RC.case(case, 3)
    keys, ids = _t(keys, dev), _t(ids, dev)
    a = K.shard_rank(keys, ids, stride, run, n, k_out)
    assert torch.equal(a, K.shard_rank(keys, ids, stride, run, n, k_out))
    assert torch.equal(a, K.shard_rank_plain(keys, ids, stride, run, n,
                                             k_out))


def _null_heavy_columns(n, dev, seed):
    from tinysql_tpu_torch.bench import exprcases as EC
    rng = np.random.default_rng(seed)
    vals, _nulls = EC.columns(seed, n)
    return [(_t(v, dev), _t(rng.random(n) < 0.9, dev)) for v in vals]


@pytest.mark.parametrize("n", [3 * 1024 + 5, 1 << 16])
def test_expr_eval_tiles_at_the_edges(dev, n):
    """HK7's tiles: the programs at its limits (16 live registers and 64
    instructions in one launch; nested sums split into several launches),
    NULL-heavy columns, a bool lane read as a mask and as K15's live
    lane, n not a multiple of the tile with n_rows < n (the guard rows)
    and an incoming mask: byte for byte against the plain interpreter and
    a second launch; HK7b at B = 1, 3 and 16 against solo launches."""
    from tinysql_tpu_torch.bench import exprcases as EC
    from tinysql_tpu_torch.ops import exprjit as X
    rng = np.random.default_rng(n)
    cols = _null_heavy_columns(n, dev, 5)
    keep = _t(rng.random(n) < 0.7, dev)
    specs = list(EC.LIMIT_CASES.items()) + list(EC.SPLIT_CASES.items()) + \
        [(name, ss[0]) for name, ss in EC.CASES.items()]
    for name, spec in specs:
        e = EC.build(spec)
        pt = X.ParamTable()
        conds = [] if name in EC.LIMIT_CASES else [e]
        prog = X.compile_program(conds, [e, ("null", e)], pt)
        if name in EC.LIMIT_CASES:
            assert [(s.n_regs, s.code.shape[0]) for s in prog.segments()] \
                == [(X.MAX_REGS, X.MAX_PROG)], name
        pr = K._params_dev(pt.arrays())
        for kw in ({}, {"n_rows": n - 1029, "mask_in": keep}):
            a = K.expr_eval(prog, cols, pr, n, **kw)
            _same_expr(a, K.expr_eval(prog, cols, pr, n, **kw), name)
            _same_expr(a, K.expr_eval_plain(prog, cols, pr, n, **kw),
                       f"{name} {spec}", 1 if name == "%" else 0)
        if name not in EC.LIMIT_CASES and name not in EC.SPLIT_CASES:
            continue
        pi, pf = pt.arrays()
        for nmem in (1, 3, 16):
            prs = K._params_dev(EC.stacked_params(pi, pf, nmem))
            got = K.expr_eval_batched(prog, cols, prs, n, n_rows=n - 3)
            for b in range(nmem):
                solo = K.expr_eval(prog, cols, (prs[0][b], prs[1][b]), n,
                                   n_rows=n - 3)
                mb = None if got[0] is None else got[0][b]
                ob = [(None if v is None else v[b], m[b])
                      for v, m in got[1]]
                _same_expr((mb, ob), solo, f"{name} B={nmem} member {b}")
    live = _t(rng.random(n) < 0.6, dev)
    ids = _t(rng.integers(0, 7 * 14 + 1, n), dev, torch.int64)
    bcols = [(live, _t(rng.random(n) < 0.5, dev)), (ids, None)]
    pt = X.ParamTable()
    prog = X.ExprProgram()
    prog.cond(prog.load(0, "b"))
    prog.store(prog.key_decode(prog.load(1, "i"), prog.load(0, "b"), 14, 6,
                               -3, pt))
    pr = K._params_dev(pt.arrays())
    for kw in ({}, {"n_rows": n - 1029, "mask_in": keep}):
        a = K.expr_eval(prog, bcols, pr, n, **kw)
        _same_expr(a, K.expr_eval(prog, bcols, pr, n, **kw), "bool lane")
        _same_expr(a, K.expr_eval_plain(prog, bcols, pr, n, **kw),
                   "bool lane")


# ---- HK1 as one launch, HK3's unique probe without host pulls ------------

def _q6_lanes(rng, dev, n, nmem=None):
    shp = n if nmem is None else (nmem, n)
    return [(_t(np.round(rng.uniform(900.0, 105000.0, shp), 2), dev),
             _t(np.zeros(n, bool), dev), "sum")]


def _host_lanes(lanes):
    return [(None if v is None else v.cpu().numpy(),
             None if m is None else m.cpu().numpy(), op)
            for v, m, op in lanes]


@pytest.mark.parametrize("n", [0, 1, 16, 4097, 1 << 23])
def test_masked_reduce_one_launch_matches_plain_and_model(dev, n):
    """HK1 at Q6's shape (2^23 rows, 2% valid, one float64 SUM lane) and
    at n = 0, 1, 16 and one past a block's range: equal to the plain
    version (counts exactly, the sum within 1e-6 relative), bit-equal to
    the numpy model of its order (bench/hk1model.py) and to a second
    launch."""
    from tinysql_tpu_torch.bench import hk1model as M
    rng = np.random.default_rng(n)
    valid = _t(rng.random(n) < (0.02 if n > 4097 else 0.6), dev)
    lanes = _q6_lanes(rng, dev, n)
    if n <= 4097:
        iv = _t(rng.integers(-9, 9, n), dev, torch.int64)
        lanes += [(iv, _t(rng.random(n) < 0.3, dev), "max"),
                  (iv, None, "sum"), (None, None, "count")]
    a = K.masked_reduce(valid, lanes)
    assert torch.equal(a, K.masked_reduce(valid, lanes))
    p = K.masked_reduce_plain(valid, lanes)
    float_rows = (2,)
    keep = [r for r in range(a.shape[0]) if r not in float_rows]
    assert torch.equal(a[keep], p[keep])
    torch.testing.assert_close(a[2:3].view(torch.float64),
                               p[2:3].view(torch.float64), rtol=1e-6,
                               atol=1e-9)
    m = M.masked_reduce(valid.cpu().numpy(), _host_lanes(lanes))
    assert a.cpu().numpy().tobytes() == m.tobytes()


@pytest.mark.parametrize("nmem", [1, 3, 8, 17])
def test_masked_reduce_batched_rows_equal_solo(dev, nmem):
    """HK1b at Q6's shape cut to 2^20 + 5 rows: member b's row is
    byte-equal to a solo HK1 call over member b (a member's mask starts at
    any byte), and agrees with the batched plain version."""
    rng = np.random.default_rng(100 + nmem)
    n = (1 << 20) + 5
    valid = _t(rng.random((nmem, n)) < 0.02, dev)
    lanes = _q6_lanes(rng, dev, n, nmem)
    a = K.masked_reduce_batched(valid, lanes)
    p = K.masked_reduce_batched_plain(valid, lanes)
    for b in range(nmem):
        solo = K.masked_reduce(valid[b], K._member_lanes(lanes, b))
        assert a[b].cpu().numpy().tobytes() == solo.cpu().numpy().tobytes()
    assert torch.equal(a[:, [0, 1, 3]], p[:, [0, 1, 3]])
    torch.testing.assert_close(a[:, 2].view(torch.float64),
                               p[:, 2].view(torch.float64), rtol=1e-6,
                               atol=1e-9)


def _join_args(rng, dev, lk, rk, nullp=0.1, validp=0.9):
    nl, nr = len(lk), len(rk)
    return (_t(lk, dev, torch.int64), _t(rng.random(nl) < nullp, dev),
            _t(rng.random(nl) < validp, dev), _t(rk, dev, torch.int64),
            _t(rng.random(nr) < nullp, dev), _t(rng.random(nr) < validp, dev))


def _check_unique(args, outer):
    out = K.equi_join_unique_packed(*args, outer=outer)
    li, ri = K.equi_join_unique_plain(*args, outer)
    n = int(out[0])
    assert n == li.numel()
    assert torch.equal(out[1:1 + 2 * n:2], li)
    assert torch.equal(out[2:2 + 2 * n:2], ri)
    again = K.equi_join_unique_packed(*args, outer=outer)
    assert torch.equal(again[:1 + 2 * n], out[:1 + 2 * n])
    assert torch.equal(K.unique_match(*args),
                       K._unique_probe_plain(*args)[0])
    a = K.equi_join_mult(*args, outer=outer)
    b = K.equi_join_mult_plain(*args, outer)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n_live", [1000, 1 << 21])
@pytest.mark.parametrize("above", [False, True])
def test_equi_join_dense_hash_choice(dev, n_live, above):
    """The header's table kind on both sides of dense_ok: the live keys
    span card = max(2^22, 4 * n_live) (dense) or one more (hash); both
    equal the plain versions, inner and outer."""
    rng = np.random.default_rng(n_live + above)
    card = max(1 << 22, 4 * n_live) + int(above)
    rk = rng.choice(card, n_live, replace=False).astype(np.int64) - 77
    rk[:2] = [-77, card - 78]  # kmin and kmax
    lk = rng.integers(-100, card, max(1 << 16, n_live)).astype(np.int64)
    lk[:n_live // 2] = rng.choice(rk, n_live // 2)
    args = _join_args(rng, dev, lk, rk, nullp=0.0, validp=1.0)
    hdr = K.equi_join_header(*args[3:])[:5].tolist()
    assert hdr[:3] == [n_live, -77, card - 78]
    assert hdr[3] == int(K.dense_ok(card, n_live)) == int(not above)
    assert hdr[4] == (card if not above else
                      1 << (2 * n_live - 1).bit_length())
    for outer in (False, True):
        _check_unique(args, outer)


@pytest.mark.parametrize("case", ["top", "bottom", "both", "empty_build",
                                  "empty_probe", "no_match", "one_tile",
                                  "ragged"])
def test_equi_join_edges_match_plain(dev, case):
    """int64 extreme keys (R4 at both ends, a range past int64), an empty
    build side, an empty probe side, no match, and probe sides of one
    look-back tile and of a ragged last tile: the packed pairs, the
    membership and the multiplicity mode equal the plain versions."""
    rng = np.random.default_rng(7)
    I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
    lo, hi, nl, nr = {"top": (I64_MAX - 5000, I64_MAX, 4096, 2048),
                      "bottom": (I64_MIN, I64_MIN + 5000, 4096, 2048),
                      "both": (I64_MIN, I64_MAX, 4096, 2048),
                      "empty_build": (0, 100, 4096, 0),
                      "empty_probe": (0, 100, 0, 64),
                      "no_match": (0, 100, 3000, 64),
                      "one_tile": (0, 500, 1024, 300),
                      "ragged": (0, 500, 1024 * 37 + 5, 300)}[case]
    lk = rng.integers(lo, hi, nl, endpoint=True).astype(np.int64)
    rk = rng.integers(lo, hi, nr, endpoint=True).astype(np.int64)
    if case in ("top", "bottom", "both"):
        lk[:3] = [I64_MAX, I64_MIN, 0]
        rk[:2] = [I64_MAX, I64_MIN]
    if case == "no_match":
        lk += 1000
    for outer in (False, True):
        _check_unique(_join_args(rng, dev, lk, rk), outer)


@pytest.mark.parametrize("case", sorted(CC.COMPACT_CASES))
def test_present_compaction_edges_match_plain(dev, case):
    """HK2's one-pass compaction at 0, 1, PRESENT_HEAD, PRESENT_HEAD + 1,
    most and all segments present and at ns one past a tile:
    present_compact byte for byte against present_compact_plain (two
    launches byte-equal), the host layouts of present_rows and the
    per-operator extraction against numpy, each one launch."""
    tab = CC.compact_table(case)
    ns = tab.shape[1]
    t = _t(tab, dev)
    a, b = K.present_compact(t, ns), K.present_compact(t, ns)
    p = K.present_compact_plain(t, ns)
    assert a[0] == b[0] == p[0]
    assert torch.equal(a[1], p[1]) and torch.equal(a[1], b[1])
    before = K.kernel_counts()["launches"]["present_compact"]
    got = K.present_rows(t, ns)
    assert K.kernel_counts()["launches"]["present_compact"] == before + 1
    np.testing.assert_array_equal(got, CC.compact_plain(tab, 1, False))
    cols = K._pull_present(t, ns, 0, True)
    np.testing.assert_array_equal(cols, CC.compact_plain(tab))


@pytest.mark.parametrize("case", sorted(CC.HK9_CASES))
def test_run_bounds_edges_match_plain(dev, case):
    """HK9's one pass at the tile edges (runs across them, a run at a
    tile's first position, all-invalid tiles, n = 1, one past a tile),
    with float keys (NaN, +-0.0), NULLs and two lanes: equal to the plain
    version and to the tile model, two launches byte-equal, and no gid
    written without want_gid."""
    perm, valid, keys = CC.hk9_case(case)
    args = (_t(perm, dev), _t(valid, dev),
            [(_t(v, dev), _t(m, dev)) for v, m in keys])
    a = K.run_bounds(*args, want_gid=True)
    b = K.run_bounds(*args, want_gid=True)
    p = K.run_bounds_plain(*args, want_gid=True)
    for x, y, z in zip(a, b, p):
        assert torch.equal(x, y) and torch.equal(x, z)
    model = CC.hk9_model(perm, valid, keys)
    assert int(a[0][0]) == model[0]
    for x, m in zip(a[1:], model[1:]):
        np.testing.assert_array_equal(x.cpu().numpy(), m)
    c = K.run_bounds(*args)
    assert c[3] is None
    assert all(torch.equal(x, y) for x, y in zip(c[:3], p[:3]))
