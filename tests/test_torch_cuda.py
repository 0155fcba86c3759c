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


def test_tpch_on_the_card_matches_the_cpu_tier(dev):
    """Both device tiers on the card — the pipeline (the default) and the
    per-operator tier — launch every kernel between them, run no plain
    version, and give the CPU tier's rows."""
    from tinysql_tpu_torch.bench import tpch
    from tinysql_tpu_torch.session import new_session
    s = new_session()
    assert s.device.type == "cuda"
    tpch.load(s, sf=0.01, seed=7)
    s.execute("set tidb_tpu_min_rows = 0")
    launched = dict.fromkeys(K.LAUNCHES, 0)
    gpu = {}
    for devpipe in (-1, 0):
        s.execute(f"set tidb_devpipe = {devpipe}")
        K.reset_kernel_counts()
        gpu[devpipe] = {q: s.query(sql).rows
                        for q, sql in tpch.QUERIES.items()}
        counts = K.kernel_counts()
        assert not any(counts["plain_calls"].values()), counts
        for k, v in counts["launches"].items():
            launched[k] += v
    assert all(launched.values()), launched
    s.execute("set tidb_use_tpu = 0")
    for q, sql in tpch.QUERIES.items():
        cpu = tpch.canon_rows(s.query(sql).rows)
        for devpipe in (-1, 0):
            assert cpu == tpch.canon_rows(gpu[devpipe][q]), (devpipe, q)
