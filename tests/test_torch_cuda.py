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
    # serve phase of chip_smoke.py, the tests above)
    assert all(v for k, v in launched.items()
               if not k.endswith("_batched")), launched
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
