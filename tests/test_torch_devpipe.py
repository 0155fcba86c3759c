"""The device pipeline tier (tinysql_tpu_torch/executor/devpipe.py) on the
CPU against the reference's (tinysql_tpu/executor/devpipe.py).

Both sessions force the pipeline (tidb_devpipe=1, tidb_tpu_min_rows=0) and
read the same numpy data: bulk_load on both sides for the small tables,
columnar.store.replica_from_numpy from the reference's own replica for
TPC-H.  Each query must give the same rows (integers and strings exactly,
floats within 1e-6 relative — the reference's own bound: it differences a
running prefix sum where HK5 sums each group in sorted order), compile the
same node kinds and pull the result to the host as often.  The reference
runs its per-operator joins as device programs, not numpy twins
(TINYSQL_DEVICE_JOIN_ONLY=1), so a plan that mixes tiers counts alike.

On the CPU the port's wrappers run the plain versions of HK5 csr_reduce
and HK6 dense_probe; the kernels themselves are held to those plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import math

import numpy as np
import pytest
import torch

from tinysql_tpu.bench import tpch as ref_tpch
from tinysql_tpu.columnar.store import bulk_load as ref_bulk_load
from tinysql_tpu.columnar.store import store_of as ref_store_of
from tinysql_tpu.executor import devpipe as ref_devpipe
from tinysql_tpu.session import new_session as ref_new_session
from tinysql_tpu_torch import fail
from tinysql_tpu_torch.bench import tpch as port_tpch
from tinysql_tpu_torch.columnar.store import bulk_load as port_bulk_load
from tinysql_tpu_torch.columnar.store import replica_from_numpy
from tinysql_tpu_torch.executor import devpipe
from tinysql_tpu_torch.ops import kernels
from tinysql_tpu_torch.session import new_session as port_new_session


def _session(new, **kw):
    s = new(**kw)
    s.execute("create database d")
    s.execute("use d")
    s.execute("set @@tidb_tpu_min_rows = 0")
    s.execute("set @@tidb_devpipe = 1")
    return s


def _load(sessions, name, schema, cols):
    for s, bulk in zip(sessions, (ref_bulk_load, port_bulk_load)):
        s.execute(f"create table {name} ({schema})")
        info = s.infoschema().table_by_name("d", name)
        bulk(s.storage, info, {k: v for k, (v, _) in cols.items()},
             {k: m for k, (_, m) in cols.items() if m is not None})


def _tables(pair):
    """The reference test battery's fixtures (tests/test_devpipe.py):
    t/u (pk join), g (multi-key group-by), w (three-way chain), the
    miniature Q3 (cust/ord/line), p/dup (non-unique build side, its
    _dup_tables) and dimk/factk/dupd (multi-key joins, its _mk_fixture);
    big (70,000 rows) gives a join output past the small-pack bucket."""
    rng = np.random.default_rng(11)
    n = 3000
    _load(pair, "t", "a bigint primary key, b bigint, c double, fk bigint",
          {"a": (np.arange(1, n + 1, dtype=np.int64), None),
           "b": (rng.integers(-50, 50, n).astype(np.int64), None),
           "c": (rng.random(n) * 100, rng.random(n) < 0.1),
           "fk": (rng.integers(1, 400, n).astype(np.int64),
                  rng.random(n) < 0.05)})
    _load(pair, "u", "k bigint primary key, v bigint, w double",
          {"k": (np.arange(1, 301, dtype=np.int64), None),
           "v": (rng.integers(0, 1000, 300).astype(np.int64), None),
           "w": (rng.random(300) * 10, None)})
    rng = np.random.default_rng(23)
    n = 4000
    _load(pair, "g", "a bigint primary key, b bigint, c double, "
                     "seg varchar(4), d double",
          {"a": (np.arange(1, n + 1, dtype=np.int64), None),
           "b": (rng.integers(-5, 6, n).astype(np.int64),
                 rng.random(n) < 0.08),
           "c": (rng.random(n) * 100, rng.random(n) < 0.1),
           "seg": (np.array(["AA", "BB", "CC"])[rng.integers(0, 3, n)],
                   rng.random(n) < 0.05),
           "d": (rng.random(n) * 10, None)})
    rng = np.random.default_rng(3)
    _load(pair, "w", "g bigint primary key, z bigint",
          {"g": (np.arange(1, 51, dtype=np.int64), None),
           "z": (rng.integers(0, 5, 50).astype(np.int64), None)})
    rng = np.random.default_rng(5)
    nc, no, nl = 200, 1000, 4000
    _load(pair, "cust", "ck bigint primary key, seg bigint",
          {"ck": (np.arange(1, nc + 1, dtype=np.int64), None),
           "seg": (rng.integers(0, 5, nc).astype(np.int64), None)})
    _load(pair, "ord", "ok bigint primary key, ck bigint, pri bigint",
          {"ok": (np.arange(1, no + 1, dtype=np.int64), None),
           "ck": (rng.integers(1, nc + 1, no).astype(np.int64), None),
           "pri": (rng.integers(0, 3, no).astype(np.int64), None)})
    _load(pair, "line", "lk bigint, price double, disc double",
          {"lk": (rng.integers(1, no + 1, nl).astype(np.int64), None),
           "price": (rng.random(nl) * 1000, None),
           "disc": (rng.random(nl) * 0.1, None)})
    rng = np.random.default_rng(7)
    m = 600
    _load(pair, "dup", "k bigint, v bigint, w double",
          {"k": (rng.integers(1, 100, m).astype(np.int64),
                 rng.random(m) < 0.05),
           "v": (rng.integers(0, 1000, m).astype(np.int64), None),
           "w": (rng.random(m) * 10, rng.random(m) < 0.1)})
    rng = np.random.default_rng(8)
    n = 2500
    _load(pair, "p", "a bigint primary key, fk bigint, x double",
          {"a": (np.arange(1, n + 1, dtype=np.int64), None),
           "fk": (rng.integers(1, 80, n).astype(np.int64),
                  rng.random(n) < 0.05),
           "x": (rng.random(n) * 100, None)})
    _mk_tables(pair)
    rng = np.random.default_rng(9)
    n = 70000
    _load(pair, "big", "a bigint primary key, fk bigint, x double",
          {"a": (np.arange(1, n + 1, dtype=np.int64), None),
           "fk": (rng.integers(1, 320, n).astype(np.int64),
                  rng.random(n) < 0.02),
           "x": (rng.random(n), None)})


def _mk_tables(pair):
    """The reference's _mk_fixture: dimk unique on (k1, k2), factk probing
    it on two keys (some out of range, some NULL), dupd repeating every
    (g1, g2) pair twice."""
    rng = np.random.default_rng(13)
    k1, k2 = np.meshgrid(np.arange(1, 21), np.arange(1, 16), indexing="ij")
    k1, k2 = k1.reshape(-1).astype(np.int64), k2.reshape(-1).astype(np.int64)
    _load(pair, "dimk", "id bigint primary key, k1 bigint, k2 bigint, "
                        "v double",
          {"id": (np.arange(1, len(k1) + 1, dtype=np.int64), None),
           "k1": (k1, None), "k2": (k2, None), "v": (k1 * 100.0 + k2, None)})
    for s in pair:
        s.execute("create unique index uk on dimk (k1, k2)")
    n = 3000
    _load(pair, "factk", "fid bigint primary key, f1 bigint, f2 bigint, "
                         "x double",
          {"fid": (np.arange(1, n + 1, dtype=np.int64), None),
           "f1": (rng.integers(1, 25, n).astype(np.int64), None),
           "f2": (rng.integers(1, 18, n).astype(np.int64),
                  rng.random(n) < 0.05),
           "x": (rng.random(n) * 100, None)})
    rng = np.random.default_rng(5)
    _load(pair, "dupd", "id bigint primary key, g1 bigint, g2 bigint, "
                        "w double",
          {"id": (np.arange(1, 61, dtype=np.int64), None),
           "g1": (np.repeat(np.arange(1, 11, dtype=np.int64), 6), None),
           "g2": (np.tile(np.arange(1, 4, dtype=np.int64), 20), None),
           "w": (rng.random(60) * 10, None)})


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    ref = _session(ref_new_session)
    port = _session(port_new_session, device="cpu")
    _tables((ref, port))
    yield ref, port
    mp.undo()


@pytest.fixture
def kinds(monkeypatch):
    """Node kinds each package's pipeline builder keyed in the last
    query, whether or not its registered pipeline was already cached."""
    seen = {"ref": set(), "port": set()}
    for name, mod in (("ref", ref_devpipe), ("port", devpipe)):
        orig = mod._PipeBuilder.key

        def key(self, part, orig=orig, name=name):
            seen[name].add(part[0])
            return orig(self, part)
        monkeypatch.setattr(mod._PipeBuilder, "key", key)
    return seen


def _cell(v):
    if v is None:
        return ("N", 0.0)
    if isinstance(v, float):
        return ("f", v)
    return (type(v).__name__, v)


def _same_rows(got, want, ordered, what):
    assert len(got) == len(want), (what, len(got), len(want))
    if not ordered:
        key = (lambda r: [(t, x if t != "f" else round(x, 4))
                          for t, x in map(_cell, r)])
        got, want = sorted(got, key=key), sorted(want, key=key)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw), what
        for x, y in zip(rg, rw):
            if isinstance(y, float) and not math.isnan(y):
                assert isinstance(x, float), (what, x, y)
                assert math.isclose(x, y, rel_tol=1e-6, abs_tol=1e-9), \
                    (what, x, y)
            elif isinstance(y, float):
                assert isinstance(x, float) and math.isnan(x), (what, x)
            else:
                assert x == y, (what, x, y)


def _d2h(s) -> int:
    return int(s.last_query_stats.device_totals().get("d2h_transfers", 0))


def _both(pair, kinds, sql, ordered):
    ref, port = pair
    for k in kinds.values():
        k.clear()
    want = ref.query(sql).rows
    want_d2h = _d2h(ref)
    kernels.reset_kernel_counts()
    got = port.query(sql).rows
    _same_rows(got, want, ordered, sql)
    assert kinds["port"] == kinds["ref"], (sql, kinds)
    assert _d2h(port) == want_d2h, sql
    return got


CASES = {
    "pk_join_inner": ("select t.a, t.b, u.v from t join u on t.fk = u.k "
                      "where t.b > 0", False),
    "pk_join_left_null_extend": ("select t.a, u.v, u.w from t left join u "
                                 "on t.fk = u.k", False),
    "join_filters_both_sides": ("select t.a, u.v from t join u on t.fk = u.k"
                                " where t.c < 50 and u.v > 200", False),
    "topn_over_join": ("select t.a, t.c from t join u on t.fk = u.k "
                       "where u.v > 100 order by t.c desc, t.a limit 7",
                       True),
    "topn_offset_over_join": ("select t.a from t join u on t.fk = u.k "
                              "order by t.a limit 5, 11", True),
    "empty_result_join": ("select t.a, u.v from t join u on t.fk = u.k "
                          "where t.b > 1000", False),
    "three_way_chain": ("select count(*), sum(w.z) from t join u "
                        "on t.fk = u.k join w on t.b + 51 = w.g", False),
    "q3_shape": ("select line.lk, sum(line.price * (1 - line.disc)) as rev, "
                 "ord.pri from cust join ord on cust.ck = ord.ck "
                 "join line on line.lk = ord.ok "
                 "where cust.seg = 2 and ord.pri < 2 "
                 "group by line.lk, ord.pri order by rev desc, line.lk "
                 "limit 10", True),
    "multikey_int_string": ("select b, seg, count(*), sum(c) from g "
                            "group by b, seg order by b, seg", True),
    "multikey_avg_min_max": ("select seg, b, avg(c), min(d), max(d), "
                             "min(b), count(c) from g group by seg, b "
                             "order by seg, b", True),
    "multikey_q1_shape": ("select seg, b, sum(c) s1, sum(c * (1 - d/100)) "
                          "s2, avg(c), avg(d), count(*) from g where d < 9.5"
                          " group by seg, b order by seg, b", True),
    "single_null_group": ("select b, count(*), min(c) from g group by b "
                          "order by b", True),
    "real_group_key": ("select d, count(*) from g group by d order by d "
                       "limit 20", True),
    "int_key_min_max": ("select fk, count(*), sum(c), min(c), max(c) from t "
                        "group by fk order by fk limit 40", True),
    "agg_through_group_index_then_join": (
        "select count(*), sum(t.c), min(t.b) from t join u on t.fk = u.k "
        "where t.b > 10000", False),
    "scalar_agg_above_join": ("select count(*), sum(t.c), avg(t.c), "
                              "min(u.w), max(t.b) from t join u "
                              "on t.fk = u.k", False),
    "scalar_agg_both_sides": ("select sum(t.c * u.w), count(t.c) from t "
                              "join u on t.fk = u.k where t.b > 0", False),
    "scalar_agg_left_join": ("select count(*), sum(u.w) from t left join u "
                             "on t.fk = u.k", False),
    "semi_join": ("select t.a, t.b from t where t.fk in (select k from u "
                  "where v > 500) order by t.a limit 30", True),
    "anti_join": ("select t.a, t.b from t where not exists (select 1 from u"
                  " where u.k = t.fk) order by t.a limit 30", True),
    "sides_swapped": ("select u.k, u.v, t.a, t.fk from u join t "
                      "on u.k = t.fk where t.b > 0", False),
    "host_leaf_range_scan": ("select t.a, u.v from t join u on t.fk = u.k "
                             "where t.a < 500", False),
    "limit_below_scalar_agg": ("select count(*), sum(x.a) from (select t.a "
                               "from t join u on t.fk = u.k limit 10) x",
                               False),
    "limit_below_join": ("select x.a, u.v from (select a, fk from t "
                         "limit 100) x join u on x.fk = u.k", False),
    "large_output_compaction": ("select big.a, big.x, u.v from big join u "
                                "on big.fk = u.k", False),
    "large_output_left_join": ("select big.a, u.w from big left join u "
                               "on big.fk = u.k where big.x < 0.9", False),
    # K18's multiplicity mode (HK8): the reference's _dup_tables shapes
    "nonunique_build_inner": ("select p.a, dup.v, dup.w from p join dup "
                              "on p.fk = dup.k where p.x < 60", False),
    "nonunique_build_left_null_extend": ("select p.a, dup.v from p left "
                                         "join dup on p.fk = dup.k", False),
    "nonunique_build_filter_on_build": ("select p.a, dup.v from p join dup "
                                        "on p.fk = dup.k where dup.v > 500 "
                                        "and p.x > 20", False),
    "nonunique_then_topn": ("select p.a, dup.v, p.x from p join dup "
                            "on p.fk = dup.k order by p.x desc, p.a, dup.v "
                            "limit 9", True),
    "nonunique_large_output": ("select big.a, dup.v from big join dup "
                               "on big.fk = dup.k where big.x < 0.3", False),
    # K19 _SortGroupNode (HK4 + HK9 + HK5)
    "sortgroup_final": ("select u.w, count(*), sum(t.c) from t join u "
                        "on t.fk = u.k group by u.w", False),
    "sortgroup_raw": ("select u.v, sum(t.c * u.w), avg(t.c), min(u.w) "
                      "from t join u on t.fk = u.k group by u.v", False),
    "sortgroup_multikey": ("select u.v, t.b, count(*), avg(t.c) from t "
                           "join u on t.fk = u.k where t.c is not null "
                           "group by u.v, t.b order by u.v, t.b limit 50",
                           True),
    "sortgroup_null_keys_group_together": (
        "select t.fk, count(*), sum(u.w), max(t.c) from t left join u "
        "on t.fk = u.k group by t.fk order by t.fk", True),
    "sortgroup_null_float_and_int_keys": (
        "select t.c, t.b, count(*) from t join u on t.fk = u.k "
        "where t.a < 400 group by t.c, t.b", False),
    "leaf_null_keys_group_together": ("select b, seg, count(*) from g "
                                      "group by b, seg order by b, seg",
                                      True),
    "sortgroup_above_nonunique_join": (
        "select p.fk, count(dup.v), sum(dup.w), min(p.x) from p left join "
        "dup on p.fk = dup.k group by p.fk order by p.fk", True),
    # K18's multi-key mode: the reference's _mk_fixture shapes
    "multikey_join_inner": ("select factk.fid, dimk.v from factk join dimk "
                            "on factk.f1 = dimk.k1 and factk.f2 = dimk.k2 "
                            "where factk.x < 50 order by factk.fid limit 40",
                            True),
    "multikey_join_left_null_extend": (
        "select factk.fid, dimk.v from factk left join dimk "
        "on factk.f1 = dimk.k1 and factk.f2 = dimk.k2 "
        "order by factk.fid limit 100", True),
    "multikey_join_group_by_above": (
        "select dimk.k1, count(*), sum(factk.x), avg(factk.x) from factk "
        "join dimk on factk.f1 = dimk.k1 and factk.f2 = dimk.k2 "
        "group by dimk.k1 order by dimk.k1", True),
    "multikey_join_nonunique_build_csr": (
        "select factk.fid, dupd.w from factk join dupd "
        "on factk.f1 = dupd.g1 and factk.f2 = dupd.g2 "
        "order by factk.fid, dupd.w limit 40", True),
    "multikey_join_nonunique_build_csr_left": (
        "select factk.fid, dupd.w from factk left join dupd "
        "on factk.f1 = dupd.g1 and factk.f2 = dupd.g2 "
        "order by factk.fid, dupd.w limit 60", True),
}
#: cases whose pipeline must have compiled the node kind named (the
#: reference's own assertions, tests/test_devpipe.py)
CASE_KINDS = {"nonunique_build_inner": "joinm",
              "nonunique_build_left_null_extend": "joinm",
              "sortgroup_final": "sortgroup", "sortgroup_raw": "sortgroup",
              "sortgroup_null_keys_group_together": "sortgroup",
              "sortgroup_above_nonunique_join": "sortgroup",
              "multikey_join_inner": "joinmk",
              "multikey_join_nonunique_build_csr": "joinm"}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_reference(pair, kinds, case):
    sql, ordered = CASES[case]
    _both(pair, kinds, sql, ordered)
    assert kinds["port"] - {"host"}, kinds  # a pipeline ran
    if case in CASE_KINDS:
        assert CASE_KINDS[case] in kinds["port"], kinds


def test_multikey_join_other_conds_stay_off_the_pipeline(pair, kinds):
    """A non-equi ON conjunct puts other_conditions on the join: neither
    package's pipeline takes it (the reference's
    test_multikey_join_other_conds_cpu_guard), and the rows agree."""
    ref, port = pair
    sql = ("select factk.fid, dimk.v from factk join dimk "
           "on factk.f1 = dimk.k1 and factk.f2 = dimk.k2 "
           "and factk.x < dimk.v order by factk.fid limit 30")
    want = ref.query(sql).rows
    got = port.query(sql).rows
    _same_rows(got, want, True, sql)
    assert len(got) == 30
    assert kinds["port"] == kinds["ref"]
    assert not kinds["port"] & {"join", "joinm", "joinmk"}, kinds


def test_pipeline_kernels_run_their_plain_versions_on_the_cpu(pair, kinds):
    _both(pair, kinds, CASES["q3_shape"][0], True)
    counts = kernels.kernel_counts()
    assert counts["plain_calls"]["csr_reduce"] >= 1
    assert counts["plain_calls"]["dense_probe"] >= 2
    assert counts["plain_calls"]["lex_order"] >= 1
    assert not any(counts["launches"].values())


@pytest.mark.parametrize("sysvar,sql,item", [
    ("tidb_device_block_rows = 1000",
     "select t.a, t.c from t where t.b > 0 order by t.c desc, t.a limit 5",
     "tidb_device_block_rows.*ROADMAP queue 1, item 1"),
    ("tidb_mesh_parallel = 1",
     "select u.v, count(*), sum(t.c) from t join u on t.fk = u.k "
     "group by u.v", "tidb_mesh_parallel.*ROADMAP queue 1, item 10"),
])
def test_unported_modes_raise_when_forced(pair, sysvar, sql, item,
                                         monkeypatch):
    """Both modes that once raised under tidb_devpipe=1 are ported now
    and give the reference's rows under the same sysvar.  Block-wise
    execution (item 1): a TopN over a table past tidb_device_block_rows
    (a join or GROUP BY there takes the pipeline through a host leaf, as
    in the reference) runs block-wise.  The mesh tier's slice (item 10,
    8 virtual shards): the join + GROUP BY runs its unique join in the
    broadcast mode, keyed with the mesh size.  The other mesh routes run
    in tests/test_torch_mesh.py.  Without the sysvar the same
    statement runs as the reference runs it."""
    ref, port = pair
    name = sysvar.split("=")[0].strip()
    monkeypatch.setenv("TINYSQL_MESH_SHARDS", "8")
    before = set(devpipe.COMPILED_NODE_KEYS)
    for s in (ref, port):
        s.execute(f"set @@{sysvar}")
    try:
        _same_rows(port.query(sql).rows, ref.query(sql).rows, False, sql)
    finally:
        for s in (ref, port):
            s.execute(f"set @@{name} = 0")
    if name == "tidb_mesh_parallel":
        assert any(k[0] == "join" and k[-1] == 8
                   for k in set(devpipe.COMPILED_NODE_KEYS) - before)
    _same_rows(port.query(sql).rows, pair[0].query(sql).rows, False, sql)


def test_auto_on_the_cpu_runs_the_per_operator_tier(pair, kinds,
                                                    monkeypatch):
    _, port = pair
    built = []
    orig = devpipe.DevPipeExec._open_fallback

    def spy(self, ctx):
        built.append("fallback")
        return orig(self, ctx)
    monkeypatch.setattr(devpipe.DevPipeExec, "_open_fallback", spy)
    port.execute("set @@tidb_devpipe = -1")
    try:
        kernels.reset_kernel_counts()
        rows = port.query(CASES["q3_shape"][0]).rows
    finally:
        port.execute("set @@tidb_devpipe = 1")
    assert len(rows) == 10 and built and not kinds["port"]
    plain = kernels.kernel_counts()["plain_calls"]
    assert plain["equi_join"] >= 1 and not plain["dense_probe"]
    assert not plain["csr_reduce"]


def test_dirty_transaction_runs_on_the_per_operator_tier(pair):
    _, port = pair
    port.execute("set @@autocommit = 0")
    try:
        port.execute("insert into t values (100001, 5, 1.5, 7)")
        got = port.query("select count(*) from t join u on t.fk = u.k "
                         "where t.a = 100001").rows
        assert got == [[1]], got
    finally:
        port.execute("rollback")
        port.execute("set @@autocommit = 1")


def test_spill_pressure_steps_aside(pair, kinds):
    """Under spill pressure the pipeline (whole tables resident, no spill
    path) hands the statement to the per-operator tier, whose spill gate
    decides — in the port, the not-ported spill route raises."""
    _, port = pair
    with fail.armed("spillForceAll"):
        with pytest.raises(NotImplementedError, match="item 6"):
            port.query(CASES["q3_shape"][0])
    assert not kinds["port"]


@pytest.mark.parametrize("mode", ["forced", "auto"])
def test_pipeline_exception_fails_the_statement(pair, kinds, mode,
                                                monkeypatch):
    """An exception inside a pipeline fails the statement in every mode —
    no per-operator re-run — and the next statement runs the pipeline
    again."""
    _, port = pair
    sql = CASES["q3_shape"][0]
    if mode == "auto":
        # auto means the pipeline only on the card; enable it here
        monkeypatch.setattr(devpipe.DevPipeExec, "_enabled",
                            staticmethod(lambda ctx: True))
        port.execute("set @@tidb_devpipe = -1")
    fallbacks = []
    monkeypatch.setattr(devpipe.DevPipeExec, "_open_fallback",
                        lambda self, ctx: fallbacks.append(1))
    try:
        with fail.armed("kernelDispatchError",
                        exc=RuntimeError("card lost")):
            with pytest.raises(RuntimeError, match="card lost"):
                port.query(sql)
        assert not fallbacks
        kernels.reset_kernel_counts()
        assert len(port.query(sql).rows) == 10
        assert kernels.kernel_counts()["plain_calls"]["csr_reduce"] == 1
        assert not fallbacks
    finally:
        port.execute("set @@tidb_devpipe = 1")


def test_order_of_signed_zeros_and_nan_matches_reference(pair, kinds):
    """sort_lanes against the reference's _sort_ops: -0.0 ties +0.0 (the
    row decides), NaN sorts last ascending and descending; min/max keep
    -0.0 as the reference's segment ops do."""
    ref, port = pair
    x = np.array([0.0, -0.0, 1.0, -0.0, 0.0, 2.0, -1.0, np.nan, 3.0, -0.0])
    k = np.array([1, 1, 1, 2, 2, 2, 3, 3, 4, 4], dtype=np.int64)
    _load((ref, port), "zq", "id bigint primary key, k bigint, x double",
          {"id": (np.arange(1, 11, dtype=np.int64), None), "k": (k, None),
           "x": (x, None)})
    for sql in ("select id, x from zq order by x, id",
                "select id, x from zq order by x desc, id",
                "select z1.id, z1.x from zq z1 join zq z2 on z1.id = z2.id "
                "order by z1.x desc, z1.id limit 6"):
        got = _both(pair, kinds, sql, True)
        want = ref.query(sql).rows
        assert [repr(r) for r in got] == [repr(r) for r in want], sql
    sql = "select k, min(x), max(x) from zq where k <> 3 group by k " \
          "order by k"
    got = _both(pair, kinds, sql, True)
    assert [repr(r) for r in got] == [repr(r) for r in ref.query(sql).rows]


def test_r6_group_sums_are_exact_per_group(pair):
    """R6: the reference sums a group as the difference of a running
    prefix sum over the whole sorted table, so a group after a large one
    loses its value to cancellation, and a NaN poisons every later group.
    HK5 sums each group's own rows: the port equals its CPU tier, which
    sums per group too."""
    ref, port = pair
    x = np.array([1e17, 1e17, 1.5, 2.25, 0.125, np.nan, 4.0, 0.5])
    k = np.array([1, 1, 2, 2, 3, 4, 5, 5], dtype=np.int64)
    _load((ref, port), "zr", "id bigint primary key, k bigint, x double",
          {"id": (np.arange(1, 9, dtype=np.int64), None), "k": (k, None),
           "x": (x, None)})
    sql = "select k, sum(x), avg(x) from zr group by k order by k"
    got = port.query(sql).rows
    port.execute("set @@tidb_use_tpu = 0")
    try:
        cpu = port.query(sql).rows
    finally:
        port.execute("set @@tidb_use_tpu = 1")
    assert repr(got) == repr(cpu)
    assert got[1][1:] == [3.75, 1.875] and got[4][1:] == [4.5, 2.25]
    want = ref.query(sql).rows  # the defect the port does not copy
    assert want[1][1] == 0.0 and math.isnan(want[4][1])


def test_keyorder_swapped_group_bys_no_cache_clobber(pair, kinds):
    """Two group-bys differing only in key order (int64 <-> float64 key
    lanes swap) must not share a registered pipeline; the first runs
    again after the second (the reference's test of the same name), over
    the leaf and above a join."""
    for q1, q2 in (("select b, d, count(*) from g group by b, d",
                    "select d, b, count(*) from g group by d, b"),
                   ("select t.b, u.w, count(*) from t join u on t.fk = u.k "
                    "group by t.b, u.w",
                    "select u.w, t.b, count(*) from t join u on t.fk = u.k "
                    "group by u.w, t.b")):
        for sql in (q1, q2, q1):
            _both(pair, kinds, sql, False)


def test_large_view_with_few_rows_is_one_transfer(pair, kinds):
    """A GROUP BY above a 70,000-row join keeps the join's 2^17-row
    bucket; its few groups come back with their count in ONE transfer
    (kernels.present_rows), where the reference pulls the count first
    and the rows second."""
    ref, port = pair
    # arguments from both sides keep the aggregate above the join (no
    # partial aggregate below it)
    sql = ("select u.v, count(*), sum(big.x * u.w) from big join u "
           "on big.fk = u.k group by u.v")
    want = ref.query(sql).rows
    assert _d2h(ref) == 2
    got = port.query(sql).rows
    _same_rows(got, want, False, sql)
    assert kinds["port"] == kinds["ref"] and "sortgroup" in kinds["port"]
    assert _d2h(port) == 1 and 0 < len(got) <= kernels.PRESENT_HEAD


def test_r7_sortgroup_sums_are_exact_per_group(pair, kinds):
    """R7: the reference's _SortGroupNode sums a group as the difference
    of one cumsum over the whole sorted lane, so above a join a group
    after a large one loses its value to cancellation and a NaN poisons
    every later group.  HK5 over HK9's runs sums each group's own rows:
    the port equals its CPU tier, which sums per group too."""
    ref, port = pair
    x = np.array([1e17, 1e17, 1.5, 2.25, 0.125, np.nan, 4.0, 0.5])
    k = np.array([1, 1, 2, 2, 3, 4, 5, 5], dtype=np.int64)
    _load((ref, port), "zs", "id bigint primary key, k bigint, x double",
          {"id": (np.arange(1, 9, dtype=np.int64), None), "k": (k, None),
           "x": (x, None)})
    _load((ref, port), "zg", "k bigint primary key, g bigint",
          {"k": (np.arange(1, 6, dtype=np.int64), None),
           "g": (np.array([10, 20, 30, 40, 50], dtype=np.int64), None)})
    sql = ("select zg.g, sum(zs.x), avg(zs.x) from zs join zg "
           "on zs.k = zg.k group by zg.g order by zg.g")
    got = port.query(sql).rows
    assert "sortgroup" in kinds["port"], kinds
    port.execute("set @@tidb_use_tpu = 0")
    try:
        cpu = port.query(sql).rows
    finally:
        port.execute("set @@tidb_use_tpu = 1")
    assert repr(got) == repr(cpu)
    assert got[1][1:] == [3.75, 1.875] and got[4][1:] == [4.5, 2.25]
    want = ref.query(sql).rows  # the defect the port does not copy
    assert "sortgroup" in kinds["ref"], kinds
    assert want[1][1] == 0.0 and math.isnan(want[4][1])


def test_group_index_matches_reference():
    """GroupIndex is host numpy copied from the reference: the same
    order, boundaries, keys and dense key -> group table; all NULL keys
    collapse into ONE group."""
    vals = np.array([5, 1, 5, 9, 2, 7, 1], dtype=np.int64)
    nulls = np.array([False, True, False, True, False, True, False])
    gi = devpipe.GroupIndex([(vals, nulls)])
    assert gi.n_groups == 4  # {1, 2, 5}, one NULL group
    assert int(gi.gkey_null.sum()) == 1
    null_g = int(np.nonzero(gi.gkey_null)[0][0])
    start = 0 if null_g == 0 else int(gi.ends[null_g - 1]) + 1
    assert int(gi.ends[null_g]) - start + 1 == 3  # all three NULL rows
    rng = np.random.default_rng(4)
    for cols in ([(vals, nulls)],
                 [(rng.integers(0, 4, 500), rng.random(500) < 0.1),
                  (rng.random(500).round(1), rng.random(500) < 0.1)]):
        a, b = devpipe.GroupIndex(cols), ref_devpipe.GroupIndex(cols)
        assert (a.order == b.order).all() and (a.ends == b.ends).all()
        for (x, xn), (y, yn) in zip(a.keycols, b.keycols):
            assert (x == y).all() and (xn == yn).all()
        ta, tb = a.pos_table(), b.pos_table()
        assert (ta is None and tb is None) or (ta == tb).all()


def test_csr_reduce_plain_matches_the_reference_aggindex_node(pair):
    """HK5's plain version, called on seeded numpy inputs through the
    port's GroupIndex, against the reference's _AggIndexNode output over
    the same data (through SQL)."""
    ref, port = pair
    rng = np.random.default_rng(31)
    n = 2500
    key = rng.integers(0, 40, n).astype(np.int64)
    knull = rng.random(n) < 0.05
    f = rng.random(n)
    x = rng.normal(size=n) * 100
    xn = rng.random(n) < 0.1
    i = rng.integers(-1000, 1000, n).astype(np.int64)
    _load((ref, port), "hk5", "id bigint primary key, k bigint, f double, "
                              "x double, i bigint",
          {"id": (np.arange(n, dtype=np.int64), None), "k": (key, knull),
           "f": (f, None), "x": (x, xn), "i": (i, None)})
    want = ref.query("select k, count(*), count(x), sum(x), min(x), max(x),"
                     " sum(i), min(i), max(i) from hk5 where f < 0.7 "
                     "group by k order by k").rows
    gi = devpipe.GroupIndex([(key, knull)])
    nb = kernels.bucket(n)
    ngb = kernels.bucket(gi.n_groups)
    t = torch.from_numpy
    order = t(kernels.pad1(gi.order, nb))
    ends = t(kernels.pad1(gi.ends, ngb, fill=n - 1))
    valid = t(kernels.pad1(f < 0.7, nb))
    xv, xm = t(kernels.pad1(x, nb)), t(kernels.pad1(xn, nb, True))
    iv = t(kernels.pad1(i, nb))
    table = kernels.csr_reduce_plain(
        order, ends, valid, [(None, xm, "count"), (xv, xm, "sum"),
                             (xv, xm, "min"), (xv, xm, "max"),
                             (iv, None, "sum"), (iv, None, "min"),
                             (iv, None, "max")], n, gi.n_groups)
    tab = table.numpy()
    got = []
    for g in range(gi.n_groups):
        if tab[0, g] == 0:
            continue
        cx = int(tab[3, g])
        fx = [float(tab[r, g:g + 1].view(np.float64)[0]) if cx else None
              for r in (4, 6, 8)]
        got.append([None if gi.gkey_null[g] else int(gi.gkeys[g]),
                    int(tab[0, g]), cx] + fx
                   + [int(tab[10, g]), int(tab[12, g]), int(tab[14, g])])
    # the index puts the NULL group last, ORDER BY puts NULL first
    got.sort(key=lambda r: (r[0] is not None, r[0] or 0))
    _same_rows(got, want, True, "csr_reduce_plain")


def test_dense_probe_plain_matches_the_reference_join_node(pair):
    """HK6's plain version, called on seeded numpy inputs through the
    port's dense table, against the reference's _JoinNode output over the
    same data (through SQL), in every mode."""
    ref, port = pair
    rng = np.random.default_rng(37)
    n, m = 2000, 500
    pk = np.arange(1, m + 1, dtype=np.int64) * 3
    bv = rng.integers(0, 100, m).astype(np.int64)
    bw = rng.random(m)
    bwn = rng.random(m) < 0.1
    fk = rng.integers(-10, 3 * m + 20, n).astype(np.int64)
    fkn = rng.random(n) < 0.05
    pf = rng.random(n)
    _load((ref, port), "hk6b", "k bigint primary key, v bigint, w double",
          {"k": (pk, None), "v": (bv, None), "w": (bw, bwn)})
    _load((ref, port), "hk6p", "id bigint primary key, fk bigint, f double",
          {"id": (np.arange(n, dtype=np.int64), None), "fk": (fk, fkn),
           "f": (pf, None)})
    lo, hi = int(pk.min()), int(pk.max())
    tbl = np.full(hi - lo + 1, -1, dtype=np.int32)
    tbl[pk - lo] = np.arange(m, dtype=np.int32)
    nb, nbb = kernels.bucket(n), kernels.bucket(m)
    t = torch.from_numpy
    bvalid = t(kernels.pad1(bv >= 20, nbb))  # build-side filter
    args = (t(kernels.pad1(fk, nb)), t(kernels.pad1(fkn, nb, True)),
            t(kernels.pad1(pf < 0.8, nb)), lo, hi, t(tbl), bvalid,
            [(t(kernels.pad1(bv, nbb)), None),
             (t(kernels.pad1(bw, nbb)), t(kernels.pad1(bwn, nbb, True)))])
    where = "hk6p.f < 0.8"
    sqls = {
        "inner": f"select hk6p.id, hk6b.v, hk6b.w from hk6p join hk6b on "
                 f"hk6p.fk = hk6b.k where {where} and hk6b.v >= 20",
        "left": f"select hk6p.id, b.v, b.w from hk6p left join (select * "
                f"from hk6b where v >= 20) b on hk6p.fk = b.k where {where}",
        "semi": f"select hk6p.id from hk6p where {where} and hk6p.fk in "
                f"(select k from hk6b where v >= 20)",
        "anti": f"select hk6p.id from hk6p where {where} and not exists "
                f"(select 1 from hk6b where hk6b.k = hk6p.fk and "
                f"hk6b.v >= 20)",
    }
    for mode, sql in sqls.items():
        want = ref.query(sql).rows
        valid, lanes = kernels.dense_probe_plain(*args, mode)
        keep = np.nonzero(valid.numpy())[0]
        if mode in ("semi", "anti"):
            got = [[int(r)] for r in keep]
        else:
            (v, vn), (w, wn) = [(a.numpy(), b.numpy()) for a, b in lanes]
            got = [[int(r), None if vn[r] else int(v[r]),
                    None if wn[r] else float(w[r])] for r in keep]
        _same_rows(got, want, False, mode)


# ---- TPC-H at SF=0.01 ----------------------------------------------------

SF, SEED = 0.01, 7
TPCH_KINDS = {"Q1": {"leaf", "aggindex", "proj", "order"},
              "Q3": {"leaf", "join", "aggindex", "order"}}


def _tpch_pair(sf):
    """The reference session loaded with TPC-H at ``sf`` (seed 7) and the
    port's, reading a replica built from the reference's own columns;
    both force the pipeline."""
    ref = ref_new_session()
    ref_tpch.load(ref, sf=sf, seed=SEED)
    port = port_new_session(device="cpu")
    port.execute("create database tpch")
    port.execute("use tpch")
    for name, ddl in port_tpch.SCHEMAS.items():
        port.execute(ddl)
        rinfo = ref.infoschema().table_by_name("tpch", name)
        pinfo = port.infoschema().table_by_name("tpch", name)
        rep = ref_store_of(ref.storage).get(rinfo.id)
        by_name = {c.name: c.id for c in rinfo.public_columns()}
        cols = {c.id: rep.columns[by_name[c.name]]
                for c in pinfo.public_columns()}
        replica_from_numpy(port.storage, pinfo, cols, rep.handles)
    for s in (ref, port):
        s.execute("set tidb_tpu_min_rows = 0")
        s.execute("set tidb_devpipe = 1")
    return ref, port


@pytest.fixture(scope="module")
def tpch_pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    yield _tpch_pair(SF)
    mp.undo()


@pytest.mark.parametrize("q", ["Q1", "Q3"])
def test_tpch_pipeline_matches_reference(tpch_pair, kinds, q):
    ref, port = tpch_pair
    want = ref.query(ref_tpch.QUERIES[q]).rows
    want_d2h = _d2h(ref)
    got = port.query(port_tpch.QUERIES[q]).rows
    assert len(got) == {"Q1": 6, "Q3": 10}[q]
    _same_rows(got, want, True, q)
    assert kinds["port"] == kinds["ref"] == TPCH_KINDS[q]
    assert _d2h(port) == want_d2h == 1
    # the port's own per-operator tier agrees as well
    port.execute("set tidb_devpipe = 0")
    try:
        per_op = port.query(port_tpch.QUERIES[q]).rows
    finally:
        port.execute("set tidb_devpipe = 1")
    assert port_tpch.canon_rows(per_op) == port_tpch.canon_rows(got)


# ---- TPC-H Q13 at SF=0.02: the slice's own query ------------------------

SF13 = 0.02
#: the reference's compiled node kinds (one pipeline each)
KINDS13 = {"Q13": {"leaf", "joinm", "sortgroup", "proj", "order"},
           "status": {"leaf", "aggindex", "join", "sortgroup"}}
SQL13 = {"Q13": port_tpch.Q13,
         "status": "select o_orderstatus, count(*), sum(l_extendedprice) "
                   "from orders join lineitem on o_orderkey = l_orderkey "
                   "group by o_orderstatus"}


@pytest.fixture(scope="module")
def tpch13_pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    yield _tpch_pair(SF13)
    mp.undo()


@pytest.mark.parametrize("q", ["Q13", "status"])
def test_tpch_q13_pipeline_matches_reference(tpch13_pair, kinds, q):
    """Q13 (customer LEFT JOIN orders through HK8, two GROUP BYs through
    HK4 + HK9 + HK5) and the partial-below-join / FINAL-above shape: one
    pipeline and one transfer each, the reference's rows and node kinds,
    and for Q13 the numpy answer from the generated columns."""
    ref, port = tpch13_pair
    want = ref.query(SQL13[q]).rows
    assert _d2h(ref) == 1
    kernels.reset_kernel_counts()
    got = port.query(SQL13[q]).rows
    _same_rows(got, want, q == "Q13", q)
    assert kinds["port"] == kinds["ref"] == KINDS13[q]
    assert _d2h(port) == 1
    plain = kernels.kernel_counts()["plain_calls"]
    assert plain["run_bounds"] >= 1 and plain["csr_reduce"] >= 1
    if q == "Q13":
        assert plain["csr_expand"] == 1
        assert got == port_tpch.q13_rows(port_tpch.generate(SF13, SEED))
    port.execute("set tidb_devpipe = 0")
    try:
        per_op = port.query(SQL13[q]).rows
    finally:
        port.execute("set tidb_devpipe = 1")
    assert port_tpch.canon_rows(per_op) == port_tpch.canon_rows(got)
