"""HK12 shard_probe (probe, member and count modes) and HK8 csr_expand:
numpy models of their staged search, gallop and tiled fill
(tinysql_tpu_torch/bench/meshjoincases.py, constants read from the
sources) against the plain versions at the kernels' edge shapes, and the
port's programs around them against the reference's on the CPU:
``unique_join_match_sharded`` and ``semi_join_match_sharded`` (K25,
tinysql_tpu/ops/shardops.py), HK8 against the reference's ``_prepare_mult``
kernel (tinysql_tpu/executor/devpipe.py) at the fill's edge shapes, and
TPC-H Q13 through SQL: the port's pipeline (HK8) against the reference's
device tier, and both under an 8-shard mesh (HK8's shard mode).  Every
comparison is exact (integers and row ids; Q13's rows are counts)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tinysql_tpu.bench import tpch as ref_tpch
from tinysql_tpu.columnar.store import store_of as ref_store_of
from tinysql_tpu.ops import progcache as ref_progcache
from tinysql_tpu.ops import shardops as ref_shardops
from tinysql_tpu.parallel import dist as ref_dist
from tinysql_tpu.session import new_session as ref_new_session
from tinysql_tpu_torch.bench import meshjoincases as MJ
from tinysql_tpu_torch.bench import tpch as port_tpch
from tinysql_tpu_torch.columnar.store import replica_from_numpy
from tinysql_tpu_torch.ops import kernels, shardops
from tinysql_tpu_torch.parallel import dist
from tinysql_tpu_torch.session import new_session as port_new_session

NDEV = 8


@pytest.fixture(scope="module", autouse=True)
def _fresh_reference_programs():
    """Leave the reference's program cache as a fresh worker has it."""
    yield
    ref_progcache.clear()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("TINYSQL_MESH_SHARDS", str(NDEV))
    with kernels.use_device("cpu"):
        yield


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---- HK12: the staged search against the plain version -------------------

def test_probe_cases_reach_the_search_edges():
    """Each case lands where its name says: the whole run or a sampled
    one (a length no multiple of S), an index at its cap, equal keys
    across sample points, a shard without a live slot."""
    strides = {name: MJ.index_stride(cb, cp, n)
               for name, (_d, n, cp, cb, _w) in MJ.PROBE_CASES.items()}
    assert strides["whole int64"] == 1 and strides["sampled int64"] > 1
    assert MJ.PROBE_CASES["sampled int64"][3] % strides["sampled int64"]
    _d, n, cp, cb, _w = MJ.PROBE_CASES["index cap"]
    assert cp // MJ.shard_blocks(cp, n) >= MJ.INDEX
    nt = -(-cb // strides["index cap"])  # index keys: at the cap's half
    assert MJ.INDEX // 4 < nt <= MJ.INDEX // 2
    n, pk, pid, bk, bid = MJ.probe_case("equal runs")
    s_ = strides["equal runs"]
    bord, perm = shardops._build_order(n, _t(bk), _t(bid))
    cb = len(bk) // n
    sk = bord.numpy()[perm.numpy()[:cb]]
    across = (sk[s_::s_] == sk[s_ - 1:-1:s_]).sum()
    assert across > 100  # runs of equal keys straddle sample points
    n, _pk, _pid, _bk, bid = MJ.probe_case("all dead")
    assert not (bid[:len(bid) // n] >= 0).any()


@pytest.mark.parametrize("member", [False, True])
@pytest.mark.parametrize("case", list(MJ.PROBE_CASES))
def test_staged_probe_model_matches_plain(case, member):
    n, pk, pid, bk, bid = MJ.probe_case(case)
    bord, perm = shardops._build_order(n, _t(bk), _t(bid))
    want = kernels.shard_probe_plain(_t(pk), _t(pid), bord, _t(bid), perm,
                                     n, member)
    got = MJ.staged_probe_model(pk, pid, bord.numpy(), bid, perm.numpy(),
                                n, member)
    if member:
        np.testing.assert_array_equal(got, want.numpy())
    else:
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        if case != "all dead":
            assert got[0].any()


@pytest.mark.parametrize("case", list(MJ.COUNT_CASES))
def test_gallop_count_model_matches_plain(case):
    n, lk, lv, rs = MJ.count_case(case)
    want = kernels.shard_count_plain(_t(lk), _t(lv), _t(rs), n)
    counts, partial, loads = MJ.gallop_count_model(lk, lv, rs, n)
    np.testing.assert_array_equal(counts, want[0].numpy())
    np.testing.assert_array_equal(partial, want[1].numpy())
    if case == "skew":  # 10^5 equal keys: a gallop, not a walk
        hits = int((lk[lv.astype(bool)] == 777).sum())
        assert counts.max() == 100_000
        assert loads <= hits * 2 * 18
    if case == "absent":
        assert (counts == 0).mean() > 0.8


# ---- HK8: the tiled fill against the plain version -----------------------

def _csr_args(case):
    (order, ends, ng, n_rows, bvalid, tbl, lo, hi, key, knull, pv, outer,
     ob, plns, blns, shards) = case
    return ((_t(order), _t(ends), ng, n_rows, _t(bvalid), _t(tbl), lo, hi,
             [(_t(key), _t(knull))], None, _t(pv)), outer, ob,
            [(_t(v), None if m is None else _t(m)) for v, m in plns],
            [(_t(v), None if m is None else _t(m)) for v, m in blns], shards)


def _same_expansion(got, want, what):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]),
                                  what)
    for (x, xn), (y, yn) in zip(got[1] + got[2], want[1] + want[2]):
        x, xn, y, yn = (np.asarray(a) for a in (x, xn, y, yn))
        np.testing.assert_array_equal(xn, yn, what)
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                      what)


@pytest.mark.parametrize("case", list(MJ.CSR_CASES))
def test_tiled_fill_model_matches_plain(case):
    c = MJ.csr_case(case)
    (order, ends, ng, n_rows, bvalid, tbl, lo, hi, key, knull, pv, outer,
     ob, plns, blns, shards) = c
    args, outer, ob, pl, bl, shards = _csr_args(c)
    want = kernels.csr_expand_plain(*args, outer, ob, pl, bl, shards=shards)
    valid, prow, brow, matched, chunked = MJ.csr_model(
        order, ends, ng, n_rows, bvalid, tbl, lo, hi, key, ~knull, pv, outer,
        ob, shards)
    got = MJ.gather_model(valid, prow, brow, matched, plns, blns)
    _same_expansion(got, [want[0]] + [[(a.numpy(), b.numpy()) for a, b in
                                       want[j]] for j in (1, 2)], case)
    tot = valid.reshape(shards, ob).sum(1)
    if case == "no pairs":
        assert tot.sum() == 0
    elif case == "full bucket":
        assert tot[0] == ob
    elif case == "staged twice":
        assert chunked > 0
    elif case == "shard without pairs":
        assert tot[1] == 0 and (tot > 0).sum() == shards - 1
    elif case == "long row":
        run = np.bincount(prow[matched])
        assert run.max() > 3 * MJ.FILL_TILE
    elif case == "zero rows at tile edges":
        assert tot.sum() >= 4 * MJ.FILL_TILE


# ---- HK8 against the reference's _prepare_mult kernel ----------------------
# the kernel of tinysql_tpu/executor/devpipe.py:1595-1656 (K18's
# multiplicity mode), line for line, one key

def _ref_mult(order, ends, ng, n_rows, lo, hi, tbl, key, knull, pvalid,
              bvalid, outer, ob, plns, blns):
    jn = jnp
    order, ends, tbl = jn.asarray(order), jn.asarray(ends), jn.asarray(tbl)
    pvalid, bvalid = jn.asarray(pvalid), jn.asarray(bvalid)
    nbb, ngb, nb, tbl_len = len(order), len(ends), len(pvalid), len(tbl)
    vs = bvalid[order] & (jn.arange(nbb) < n_rows)
    c = jn.cumsum(vs.astype(jn.int64))
    prev = jn.concatenate([jn.full((1,), -1, dtype=jn.int64), ends[:-1]])
    start_c = jn.where(prev >= 0, c[jn.maximum(prev, 0)], 0)
    vcnt = jn.where(jn.arange(ngb) < ng, c[ends] - start_c, 0)
    comp = order[jn.nonzero(vs, size=nbb, fill_value=0)[0]]
    kp, kn = jn.asarray(key), jn.asarray(knull)
    inr = (kp >= lo) & (kp <= hi) & ~kn & pvalid
    g = jn.where(inr, tbl[jn.clip(kp - lo, 0, tbl_len - 1)].astype(jn.int64),
                 -1)
    m = jn.where(g >= 0, vcnt[jn.clip(g, 0, ngb - 1)], 0)
    cnt = jn.where(pvalid, jn.maximum(m, 1), 0) if outer else m
    offs = jn.cumsum(cnt) - cnt
    total = offs[-1] + cnt[-1]
    tgt = jn.where(cnt > 0, offs, ob)
    base = jn.zeros(ob, dtype=jn.int64).at[tgt].set(jn.arange(nb) + 1,
                                                    mode="drop")
    pidx = lax.cummax(base, axis=0) - 1
    valid_out = (pidx >= 0) & (jn.arange(ob) < total)
    ps = jn.clip(pidx, 0, nb - 1)
    k = jn.arange(ob) - offs[ps]
    gj = g[ps]
    matched = (gj >= 0) & (k < m[ps]) & valid_out
    brow = comp[jn.clip(start_c[jn.clip(gj, 0, ngb - 1)] + k, 0, nbb - 1)]
    pcols = [(jn.asarray(v)[ps], jn.zeros(ob, bool) if mk is None else
              jn.asarray(mk)[ps]) for v, mk in plns]
    bcols = [(jn.asarray(v)[brow], ~matched if mk is None else
              jn.asarray(mk)[brow] | ~matched) for v, mk in blns]
    return valid_out, pcols, bcols


@pytest.mark.parametrize("case", [c for c in MJ.CSR_CASES
                                  if MJ.CSR_CASES[c][4] == 1])
def test_csr_expand_matches_reference_mult_kernel(case):
    """At the fill's edge shapes, the port's HK8 (its plain version on the
    CPU) gives the reference's valid slots, probe lanes and, where not
    NULL, build lanes."""
    c = MJ.csr_case(case)
    (order, ends, ng, n_rows, bvalid, tbl, lo, hi, key, knull, pv, outer,
     ob, plns, blns, _shards) = c
    args, outer, ob, pl, bl, shards = _csr_args(c)
    got = kernels.csr_expand(*args, outer, ob, pl, bl, shards=shards)
    want = _ref_mult(order, ends, ng, n_rows, lo, hi, tbl, key, knull, pv,
                     bvalid, outer, ob, plns, blns)
    live = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), live)
    for (gv, gm), (wv, wm) in zip(got[1] + got[2], want[1] + want[2]):
        gv, gm, wv, wm = (np.asarray(a) for a in (gv, gm, wv, wm))
        np.testing.assert_array_equal(gm[live], wm[live])
        keep = live & ~wm
        np.testing.assert_array_equal(gv[keep], wv[keep])


# ---- K25 against the reference's programs --------------------------------

def _join_keys(kind, rng, n):
    """Probe / build key lanes at HK12's edges: int64 ends, float64 with
    -0.0, +0.0, +-inf and NaN."""
    if kind == "int64 ends":
        v = rng.integers(-200, 200, n).astype(np.int64)
        v[::9] = kernels.I64_MAX
        v[4::13] = kernels.I64_MIN
    else:
        v = rng.integers(-200, 200, n).astype(np.float64) * 0.5
        v[::7] = -0.0
        v[1::11] = 0.0
        v[2::17] = np.inf
        v[3::19] = -np.inf
        v[5::23] = np.nan
    return v, rng.random(n) < 0.05


KINDS = ["int64 ends", "float64 zeros, inf, NaN"]


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_unique_join_sharded_matches_reference(kind, outer):
    rng = np.random.default_rng(151)
    n_left, n_right = 3000, 1200
    lk, ln = _join_keys(kind, rng, n_left)
    rk, rn = _join_keys(kind, rng, n_right)
    kw = dict(outer=outer, lvalid=rng.random(n_left) < 0.9,
              rvalid=rng.random(n_right) < 0.9)
    args = ((lk, ln), n_left, (rk, rn), n_right)
    want = ref_shardops.unique_join_match_sharded(ref_dist.sized_mesh(NDEV),
                                                  *args, **kw)
    got = shardops.unique_join_match_sharded(dist.sized_mesh(NDEV), *args,
                                             **kw)
    assert want is not None and got is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


@pytest.mark.parametrize("anti,null_aware",
                         [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("kind", KINDS)
def test_semi_join_sharded_matches_reference(kind, anti, null_aware):
    rng = np.random.default_rng(152 + anti + null_aware)
    n_left, n_right = 3000, 2500
    lk, ln = _join_keys(kind, rng, n_left)
    rk, rn = _join_keys(kind, rng, n_right)
    if null_aware:
        rn[:] = False
    kw = dict(anti=anti, null_aware=null_aware,
              lvalid=rng.random(n_left) < 0.9,
              rvalid=rng.random(n_right) < 0.9)
    args = ((lk, ln), n_left, (rk, rn), n_right)
    want = ref_shardops.semi_join_match_sharded(ref_dist.sized_mesh(NDEV),
                                                *args, **kw)
    got = shardops.semi_join_match_sharded(dist.sized_mesh(NDEV), *args,
                                           **kw)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


# ---- TPC-H Q13 through SQL -----------------------------------------------

SF13, SEED13 = 0.01, 15


@pytest.fixture(scope="module")
def q13_pair():
    """The reference loaded with TPC-H at SF13 and the port reading a
    replica of its columns; the reference's device tier runs its joins
    as device programs (TINYSQL_DEVICE_JOIN_ONLY=1)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    ref = ref_new_session()
    ref_tpch.load(ref, sf=SF13, seed=SEED13)
    port = port_new_session(device="cpu")
    port.execute("create database tpch")
    port.execute("use tpch")
    for name, ddl in port_tpch.SCHEMAS.items():
        port.execute(ddl)
        rinfo = ref.infoschema().table_by_name("tpch", name)
        pinfo = port.infoschema().table_by_name("tpch", name)
        rep = ref_store_of(ref.storage).get(rinfo.id)
        by_name = {c.name: c.id for c in rinfo.public_columns()}
        replica_from_numpy(port.storage, pinfo,
                           {c.id: rep.columns[by_name[c.name]]
                            for c in pinfo.public_columns()}, rep.handles)
    for s in (ref, port):
        s.execute("set tidb_tpu_min_rows = 0")
        s.execute("set tidb_use_tpu = 1")
    yield ref, port
    mp.undo()


def _q13(sess, devpipe: int, mesh: int):
    sess.execute(f"set tidb_devpipe = {devpipe}")
    sess.execute(f"set tidb_mesh_parallel = {mesh}")
    try:
        return sess.query(port_tpch.Q13).rows
    finally:
        sess.execute("set tidb_mesh_parallel = 0")
        sess.execute("set tidb_devpipe = -1")


def test_q13_pipeline_matches_reference_device_tier(q13_pair):
    """The port's pipeline Q13 (one HK8 expansion, LEFT) against the
    reference's per-operator device tier, and numpy's answer."""
    ref, port = q13_pair
    want = _q13(ref, 0, 0)
    kernels.reset_kernel_counts()
    got = _q13(port, 1, 0)
    assert kernels.kernel_counts()["plain_calls"]["csr_expand"] == 1
    assert port_tpch.canon_rows(got) == ref_tpch.canon_rows(want)
    assert got == port_tpch.q13_rows(port_tpch.generate(SF13, SEED13))


def test_q13_mesh_matches_reference_mesh(q13_pair):
    """Under an 8-shard mesh the port's pipeline Q13 expands per shard
    (HK8's shard mode) and gives the reference's mesh rows."""
    ref, port = q13_pair
    want = _q13(ref, 1, 1)
    kernels.reset_kernel_counts()
    got = _q13(port, 1, 1)
    assert kernels.kernel_counts()["plain_calls"]["csr_expand_shard"] == 1
    assert port_tpch.canon_rows(got) == ref_tpch.canon_rows(want)
    assert got == _q13(port, 1, 0)
