"""The mesh tier through SQL: the port (tinysql_tpu_torch) under
``tidb_mesh_parallel = 1`` against the reference (tinysql_tpu) under the
same sysvar.

The reference shards over the 8 virtual CPU devices tests/conftest.py
forces; the port's mesh is 8 virtual shards on the CPU device
(TINYSQL_MESH_SHARDS=8), where its kernel wrappers run their plain
versions.  Rows must equal the reference's mesh rows (integers, strings,
NULLs and order exactly; floats within 1e-6 relative, the reference's
own bound, or at 9 significant digits where its battery canonicalizes
so), the port's mesh-off rows (floats 1e-6 relative: the shards add in
another order) and a second mesh run by ``repr`` (the port's merges fold
in a fixed order).  Where both packages count them, the shard rounds and
exchanged bytes must be equal.

Families: K11 (the sharded grouped aggregate, HK2 per shard + HK11),
K25's scalar aggregate (HK1 per shard + HK11), unique join (HK4 + HK12),
member (HK4 + HK12's member mode), sort and top-k (HK4 per shard +
HK14), K21 mesh (the pipeline's distributed TopN, HK4 twice), the
pipeline join's broadcast mode (HK6), its shuffle mode (K18 shuffle:
HK13 both sides, HK4 + HK12 per shard) and the CSR join's mesh mode
(HK8's shard mode).  TPC-H Q10, Q13, Q18, NOT IN, Q22, NOT EXISTS and a
single-key ORDER BY / TopN run sharded where the reference shards them,
with the same node kinds, mesh sizes and shard counters."""
import math
import random

import numpy as np
import pytest

from tinysql_tpu.bench import tpch as ref_tpch
from tinysql_tpu.columnar.store import bulk_load as ref_bulk_load
from tinysql_tpu.columnar.store import store_of as ref_store_of
from tinysql_tpu.executor import devpipe as ref_devpipe
from tinysql_tpu.ops import progcache as ref_progcache
from tinysql_tpu.ops import shardops as ref_shardops
from tinysql_tpu.session import new_session as ref_new_session
from tinysql_tpu_torch.bench import tpch as port_tpch
from tinysql_tpu_torch.columnar.store import bulk_load as port_bulk_load
from tinysql_tpu_torch.columnar.store import replica_from_numpy
from tinysql_tpu_torch.executor import devpipe
from tinysql_tpu_torch.ops import kernels, shardops
from tinysql_tpu_torch.session import new_session as port_new_session

I64_MIN, I64_MAX = kernels.I64_MIN, kernels.I64_MAX


def _canon(rows):
    return [[f"{v:.9g}" if isinstance(v, float) else v for v in r]
            for r in rows]


def _close(got, want, what):
    """Same rows in the same order: floats within 1e-6 relative (NaN
    equals NaN), everything else exactly."""
    assert len(got) == len(want), (what, len(got), len(want))
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw), what
        for x, y in zip(rg, rw):
            if isinstance(y, float):
                assert isinstance(x, float), (what, x, y)
                if math.isnan(y):
                    assert math.isnan(x), (what, x, y)
                else:
                    assert math.isclose(x, y, rel_tol=1e-6, abs_tol=1e-9), \
                        (what, x, y)
            else:
                assert x == y, (what, x, y)


def _set(sessions, sysvar):
    for s in sessions:
        s.execute(f"set @@{sysvar}")


def _mesh_rows(pair, sql, fresh_keys=False):
    """(port mesh rows, reference mesh rows, port mesh-off rows), the
    shard counters of both mesh runs and the port's kernel counts reset
    before them (and both packages' compiled node keys, ``fresh_keys``)."""
    ref, port = pair
    _set(pair, "tidb_mesh_parallel = 0")
    off = port.query(sql).rows
    _set(pair, "tidb_mesh_parallel = 1")
    if fresh_keys:
        _fresh_keys()
    try:
        kernels.reset_kernel_counts()
        shardops.reset_stats()
        ref_shardops.reset_stats()
        got = port.query(sql).rows
        want = ref.query(sql).rows
    finally:
        _set(pair, "tidb_mesh_parallel = 0")
    return got, want, off


def _same_shard_counts():
    got, want = shardops.stats_snapshot(), ref_shardops.stats_snapshot()
    for k in ("shard_rounds", "shard_rows_hwm", "shard_exchange_bytes",
              "shard_skew_retries"):
        assert got[k] == want[k], (k, got, want)
    return got


@pytest.fixture(scope="module")
def mesh_env():
    mp = pytest.MonkeyPatch()
    mp.setenv("TINYSQL_MESH_SHARDS", "8")
    mp.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    yield
    mp.undo()
    # the reference's programs built here have the shapes of its own mesh
    # battery (tests/test_mesh_parallel.py), which asserts that it compiles
    # them: leave its cache as a fresh worker process has it
    ref_progcache.clear()
    ref_devpipe.COMPILED_NODE_KEYS.clear()


def _session(new, db, **kw):
    s = new(**kw)
    s.execute(f"create database {db}")
    s.execute(f"use {db}")
    s.execute("set @@tidb_tpu_min_rows = 0")
    return s


def _load(pair, db, name, schema, cols):
    for s, bulk in zip(pair, (ref_bulk_load, port_bulk_load)):
        s.execute(f"create table {name} ({schema})")
        info = s.infoschema().table_by_name(db, name)
        bulk(s.storage, info, {k: v for k, (v, _) in cols.items()},
             {k: m for k, (_, m) in cols.items() if m is not None})


# =========================================================================
# K11 / K25 scalar: the sharded aggregates (tests/test_mesh_parallel.py)
# =========================================================================

@pytest.fixture(scope="module")
def tk(mesh_env):
    """The reference battery's table t (2,048 rows from random.seed(11),
    inserted through SQL), in both packages."""
    pair = (_session(ref_new_session, "test"),
            _session(port_new_session, "test", device="cpu"))
    for s in pair:
        s.execute("create table t (a int primary key, b int, "
                  "c varchar(8), d double)")
    random.seed(11)
    rows = []
    for i in range(1, 2049):
        b = random.choice([None, 1, 2, 3, 4])
        c = random.choice(["'x'", "'y'", "'z'", "null"])
        d = round(random.uniform(-7, 7), 3)
        rows.append(f"({i}, {b if b is not None else 'null'}, {c}, {d})")
    for s in pair:
        s.execute("insert into t values " + ", ".join(rows))
        s.query("select * from t")  # hydrate the replica
    return pair


AGG_QUERIES = [
    "select c, count(*), count(b), sum(d), min(d), max(d), avg(d) "
    "from t group by c order by c",
    "select b, c, count(*), sum(d * 2 - 1) from t where d > 0 "
    "group by b, c order by b, c",
    "select b, min(a), max(a) from t group by b order by b",
    "select sum(d), count(*), min(d), max(d), count(b) from t",
]


def test_sharded_agg_matches_single_device(tk):
    _, port = tk
    for q in AGG_QUERIES:
        port.execute("set @@tidb_mesh_parallel = 0")
        single = port.query(q).rows
        port.execute("set @@tidb_mesh_parallel = 1")
        sharded = port.query(q).rows
        assert _canon(sharded) == _canon(single), q
    port.execute("set @@tidb_mesh_parallel = 0")


def test_sharded_agg_matches_cpu_tier(tk):
    _, port = tk
    port.execute("set @@tidb_mesh_parallel = 1")
    for q in AGG_QUERIES:
        port.execute("set @@tidb_use_tpu = 1")
        sharded = port.query(q).rows
        port.execute("set @@tidb_use_tpu = 0")
        cpu = port.query(q).rows
        assert _canon(sharded) == _canon(cpu), q
    port.execute("set @@tidb_use_tpu = 1")
    port.execute("set @@tidb_mesh_parallel = 0")


@pytest.mark.parametrize("devpipe", [1, 0])
def test_sharded_agg_matches_reference_mesh(tk, devpipe):
    _set(tk, f"tidb_devpipe = {devpipe}")
    try:
        for q in AGG_QUERIES:
            got, want, off = _mesh_rows(tk, q)
            _close(got, want, q)
            _close(got, off, q)
            st = _same_shard_counts()
            assert st["shard_rounds"] >= 1, q
    finally:
        _set(tk, "tidb_devpipe = -1")


@pytest.fixture(scope="module")
def edge(mesh_env):
    """16,384 rows, so a query sharded 8 ways gives each shard 2,048:
    group 'last' lives only in the last shard, `r > 2048` empties shard 0,
    `nul` is NULL everywhere, `e` holds int64 extremes and `f` a NaN in
    shard 3."""
    pair = (_session(ref_new_session, "edge"),
            _session(port_new_session, "edge", device="cpu"))
    n = 16384
    rng = np.random.default_rng(41)
    g = np.array(["p", "q", "r"])[rng.integers(0, 3, n)].astype(object)
    g[n - 300:] = "last"
    e = rng.integers(-1000, 1000, n).astype(np.int64)
    e[[5, 9000]] = I64_MAX
    e[[7, 16000]] = I64_MIN
    f = rng.normal(size=n) * 10
    nanf = f.copy()
    nanf[3 * 2048 + 17] = np.nan
    _load(pair, "edge", "t", "a bigint primary key, r bigint, "
          "g varchar(8), e bigint, f double, nanf double, nul double",
          {"a": (np.arange(1, n + 1, dtype=np.int64), None),
           "r": (np.arange(1, n + 1, dtype=np.int64), None),
           "g": (g, None), "e": (e, None), "f": (f, None),
           "nanf": (nanf, None),
           "nul": (np.zeros(n), np.ones(n, dtype=bool))})
    for s in pair:
        s.query("select count(*) from t")
    return pair


EDGE_QUERIES = [
    # a segment present only in the last shard
    "select g, count(*), sum(f), min(f), max(f), min(e), max(e) "
    "from t group by g order by g",
    # an empty shard (shard 0 holds r <= 2048): K11's and K25's sentinels
    "select g, count(*), sum(f), min(a) from t where r > 2048 "
    "group by g order by g",
    "select count(*), sum(f), min(a), max(e), min(e) from t where r > 2048",
    # an all-NULL argument: SUM / MIN / MAX NULL, COUNT 0
    "select g, sum(nul), min(nul), max(nul), count(nul) from t "
    "group by g order by g",
    "select sum(nul), min(nul), max(nul), count(nul), count(*) from t",
    # NaN in a sum lane
    "select g, sum(nanf), count(nanf) from t group by g order by g",
    "select sum(nanf), avg(nanf) from t",
]


@pytest.mark.parametrize("q", EDGE_QUERIES)
def test_sharded_agg_edge_cases(edge, q):
    got, want, off = _mesh_rows(edge, q)
    _close(got, want, q)
    _close(got, off, q)
    st = _same_shard_counts()
    assert st["shard_rounds"] == 1 and st["shard_rows_hwm"] == 2048, st


@pytest.mark.parametrize("q", [
    "select min(nanf), max(nanf) from t",
    "select g, min(nanf), max(nanf) from t group by g order by g"])
def test_r10_mesh_min_max_keep_nan(edge, q):
    """R10: a NaN in a float MIN / MAX lane.  The port's mesh rows equal
    its single-device rows (NaN, as jnp.min / jnp.max over all rows give
    and the reference's own single-device tier gives); the reference's
    mesh merge (XLA:CPU pmin / pmax) drops the NaN partial and returns the
    other shards' extreme."""
    ref, port = edge
    got, want, off = _mesh_rows(edge, q)
    _close(got, off, q)
    nan_rows = [r for r in got if any(isinstance(x, float)
                                      and math.isnan(x) for x in r)]
    assert nan_rows, got
    for r in want:
        assert not any(isinstance(x, float) and math.isnan(x) for x in r)
    ref_single = ref.query(q).rows
    _close(got, ref_single, q)


# =========================================================================
# K18 unique (mesh) and K21 mesh: the pipeline's mesh modes
# =========================================================================

@pytest.fixture(scope="module")
def join_tk(mesh_env):
    """The reference battery's big / dim (tests/test_mesh_parallel.py),
    forced onto the pipeline tier, plus tn (heavy sort-key ties), dup
    (a non-unique build side) and sk / pr (a probe skewed into one
    shard)."""
    pair = (_session(ref_new_session, "jm"),
            _session(port_new_session, "jm", device="cpu"))
    _set(pair, "tidb_devpipe = 1")
    rng = np.random.default_rng(7)
    n = 4096
    _load(pair, "jm", "big", "a bigint primary key, fk bigint, x double",
          {"a": (np.arange(1, n + 1, dtype=np.int64), None),
           "fk": (rng.integers(1, 200, n).astype(np.int64), None),
           "x": (rng.random(n) * 10, None)})
    _load(pair, "jm", "dim", "k bigint primary key, v bigint",
          {"k": (np.arange(1, 151, dtype=np.int64), None),
           "v": (rng.integers(0, 50, 150).astype(np.int64), None)})
    rng = np.random.default_rng(31)
    n = 2048
    _load(pair, "jm", "tn", "id bigint primary key, g bigint, s double",
          {"id": (np.arange(1, n + 1, dtype=np.int64), None),
           "g": (rng.integers(0, 5, n).astype(np.int64), None),
           "s": (np.round(rng.random(n) * 3, 1), None)})
    rng = np.random.default_rng(23)
    _load(pair, "jm", "dup", "id bigint primary key, k bigint, w double",
          {"id": (np.arange(1, 161, dtype=np.int64), None),
           "k": (np.tile(np.arange(1, 41, dtype=np.int64), 4), None),
           "w": (rng.random(160) * 5, None)})
    rng = np.random.default_rng(29)
    _load(pair, "jm", "sk", "id bigint primary key, k bigint, w double",
          {"id": (np.arange(1, 4, dtype=np.int64), None),
           "k": (np.ones(3, dtype=np.int64), None),
           "w": (rng.random(3), None)})
    fk = np.full(1024, 999, dtype=np.int64)
    fk[:128] = 1
    _load(pair, "jm", "pr", "a bigint primary key, fk bigint",
          {"a": (np.arange(1, 1025, dtype=np.int64), None), "fk": (fk, None)})
    return pair


JOIN_QUERIES = [
    # the probe side (big) shards over the mesh; dim broadcast-builds
    "select big.a, dim.v from big join dim on big.fk = dim.k "
    "where big.x < 5 order by big.a limit 20",
    "select dim.v, count(*), sum(big.x) from big join dim "
    "on big.fk = dim.k group by dim.v order by dim.v",
    "select big.a, dim.v from big left join dim on big.fk = dim.k "
    "order by big.a limit 1000, 15",
]


def _port_keys(kind):
    return {k for k in devpipe.COMPILED_NODE_KEYS if k and k[0] == kind}


def test_sharded_join_matches_single_device(join_tk):
    """The pipeline's unique join in broadcast mode: the probe side
    sharded, the build table replicated; one HK6 over the probe lanes as
    they lie, keyed with the mesh size."""
    before = _port_keys("join")
    for q in JOIN_QUERIES:
        got, want, off = _mesh_rows(join_tk, q)
        assert _canon(got) == _canon(off), q
        assert _canon(got) == _canon(want), q
    assert any(k[-1] == 8 for k in _port_keys("join") - before)


def test_sharded_join_matches_cpu_tier(join_tk):
    _, port = join_tk
    q = JOIN_QUERIES[1]
    port.execute("set @@tidb_mesh_parallel = 1")
    try:
        sharded = port.query(q).rows
        port.execute("set @@tidb_use_tpu = 0")
        cpu = port.query(q).rows
    finally:
        port.execute("set @@tidb_use_tpu = 1")
        port.execute("set @@tidb_mesh_parallel = 0")
    assert _canon(sharded) == _canon(cpu)


def test_shuffle_vs_broadcast_cost_gate(join_tk):
    """Under the default broadcast budget a small build side broadcasts:
    the statement runs (no shuffle exchange is attempted) and gives the
    single-device rows."""
    q = ("select big.a, dim.v from big join dim on big.fk = dim.k "
         "where big.x >= 5 order by big.a limit 7")
    _, port = join_tk
    port.execute("set @@tidb_broadcast_build_max_rows = 1048576")
    before = _port_keys("joinshuf")
    got, want, off = _mesh_rows(join_tk, q)
    assert _canon(got) == _canon(off) == _canon(want)
    assert _port_keys("joinshuf") == before, \
        "a small build side must broadcast, not shuffle"


def test_mesh_topn_distributed(join_tk):
    """K21 mesh: per-shard top-(offset + count) candidates and their
    merge.  Tie rows and NULL sort keys come back bit-identical to the
    single-device stable sort (the global row index breaks ties)."""
    _, port = join_tk
    # a scan + TopN runs on the per-operator tier, where a two-key order
    # stays single-device (the reference's gate) and a single key takes
    # the sharded top-k (K25 top-k: HK4 per shard, HK14)
    qs = [
        "select id, g, s from tn order by g, s limit 25",
        "select id, g, s from tn order by s, g limit 25",
        "select tn.id, dim.v from tn join dim on tn.g = dim.k "
        "order by dim.v, tn.id limit 12",
        "select tn.id, dim.v from tn join dim on tn.g = dim.k "
        "order by dim.v desc, tn.id limit 100, 10",
        "select g, sum(s) from tn group by g order by sum(s) desc limit 3",
        "select id, g from tn order by g desc limit 100, 10",
    ]
    before = _port_keys("order_mesh")
    for q in qs:
        got, want, off = _mesh_rows(join_tk, q)
        if "sum(" in q:
            assert _canon(got) == _canon(off) == _canon(want), q
        else:
            assert got == off, q  # bit-identical incl. tie order
            assert got == want, q
        assert repr(port.query(q).rows) == repr(off), q
    assert _port_keys("order_mesh") - before, \
        "distributed TopN never compiled"
    kernels.reset_kernel_counts()
    shardops.reset_stats()
    ref_shardops.reset_stats()
    _set(join_tk, "tidb_mesh_parallel = 1")
    try:
        q = "select id, g from tn order by g desc limit 100, 10"
        assert port.query(q).rows == join_tk[0].query(q).rows
    finally:
        _set(join_tk, "tidb_mesh_parallel = 0")
    assert kernels.kernel_counts()["plain_calls"]["shard_rank"] == 1
    assert _same_shard_counts()["shard_rounds"] == 1


def test_mesh_join_strategy_cost_based(join_tk):
    """The planner's broadcast-vs-shuffle choice: EXPLAIN's mesh:
    strategy equals the reference's (small build broadcasts, a self-join
    shuffles, a left-unique tiny build broadcasts), and execution under
    the broadcast choice matches single-device."""
    ref, port = join_tk
    _set(join_tk, "tidb_mesh_parallel = 1")
    try:
        for sql, want in (
                ("select big.a, dim.v from big join dim on big.fk = dim.k",
                 "mesh:broadcast"),
                ("select t1.a from big t1 join big t2 on t1.fk = t2.a",
                 "mesh:shuffle"),
                ("select dim.v, big.a from dim join big on dim.k = big.fk",
                 "mesh:broadcast")):
            lines = [next(r for r in s.query("explain " + sql).rows
                          if "HashJoin" in r[0]) for s in (ref, port)]
            for line in lines:
                assert line[3].endswith(want), lines
    finally:
        _set(join_tk, "tidb_mesh_parallel = 0")
    q = ("select big.a, dim.v from big join dim on big.fk = dim.k "
         "where big.x < 5 order by big.a limit 20")
    got, want, off = _mesh_rows(join_tk, q)
    assert got == off == want


def test_mesh_csr_skew_retries_unsharded(join_tk, monkeypatch):
    """A probe whose matches cluster in one shard blows the per-shard
    expansion bound while the global bound fits: the CSR join runs
    unsharded (one skew retry, as the reference counts), not raised."""
    monkeypatch.setattr(devpipe, "MAX_EXPAND", 2048)
    monkeypatch.setattr(ref_devpipe, "MAX_EXPAND", 2048)
    q = ("select pr.a, sk.w from pr join sk on pr.fk = sk.k "
         "order by pr.a, sk.w")
    got, want, off = _mesh_rows(join_tk, q)
    assert got == off and _canon(got) == _canon(want)
    assert len(got) == 128 * 3
    assert _same_shard_counts()["shard_skew_retries"] == 1


def _fresh_keys():
    devpipe.COMPILED_NODE_KEYS.clear()
    ref_devpipe.COMPILED_NODE_KEYS.clear()


def _mesh_node_keys(sized=False):
    """(kind, mesh size) of the shuffle and CSR joins each package
    compiled (since :func:`_fresh_keys`); ``sized``: only those compiled
    for a mesh (a cached program notes no key again, so both packages'
    keys accumulate over the module's mesh runs)."""
    return [{(k[0], k[-1]) for k in keys if k and k[0] in ("joinshuf",
                                                          "joinm")
             and (k[-1] or not sized)}
            for keys in (devpipe.COMPILED_NODE_KEYS,
                         ref_devpipe.COMPILED_NODE_KEYS)]


def test_pipeline_shuffle_join_raises(join_tk):
    """K18 shuffle: where the reference exchanges both sides (the
    broadcast budget forced to 0 over two replica leaves) the port does
    too — HK13 for both sides, HK4 + HK12 per shard — with the
    reference's rows, node key and shard counters."""
    ref, port = join_tk
    q = ("select big.a, dim.v from big join dim on big.fk = dim.k "
         "where big.x >= 9 order by big.a limit 5")
    _set(join_tk, "tidb_broadcast_build_max_rows = 0")
    try:
        got, want, off = _mesh_rows(join_tk, q, fresh_keys=True)
        plain = kernels.kernel_counts()["plain_calls"]
    finally:
        _set(join_tk, "tidb_broadcast_build_max_rows = 1048576")
    assert got == want == off
    port_keys, ref_keys = _mesh_node_keys()
    assert port_keys == ref_keys == {("joinshuf", 8)}
    st = _same_shard_counts()
    assert st["shard_exchange_bytes"] > 0 and st["shard_rounds"] == 1
    assert plain["shard_exchange"] == 2 and plain["shard_probe"] == 1


def test_mesh_csr_join_raises(join_tk):
    """K18 mult on the mesh: the reference expands per shard, and so does
    the port (HK8's shard mode), with the same rows and node key."""
    q = ("select big.a, dup.w from big join dup on big.fk = dup.k "
         "where big.x < 5 order by big.a, dup.w limit 50")
    got, want, off = _mesh_rows(join_tk, q, fresh_keys=True)
    assert len(got) == 50 and got == off
    assert _canon(got) == _canon(want)
    port_keys, ref_keys = _mesh_node_keys()
    assert port_keys == ref_keys == {("joinm", 8)}
    assert kernels.kernel_counts()["plain_calls"]["csr_expand_shard"] == 1


def test_shuffle_join_partitioned_build(join_tk):
    """tests/test_mesh_parallel.py's battery: with the broadcast budget
    forced to zero both sides hash-repartition and each shard joins its
    partition; rows equal single-device, the CPU tier and the
    reference's."""
    ref, port = join_tk
    _set(join_tk, "tidb_broadcast_build_max_rows = 0")
    try:
        _fresh_keys()
        for q in JOIN_QUERIES:
            got, want, off = _mesh_rows(join_tk, q)
            port.execute("set @@tidb_use_tpu = 0")
            cpu = port.query(q).rows
            port.execute("set @@tidb_use_tpu = 1")
            assert _canon(got) == _canon(off) == _canon(cpu), q
            assert _canon(got) == _canon(want), q
            _same_shard_counts()
    finally:
        _set(join_tk, "tidb_broadcast_build_max_rows = 1048576")
    assert ("joinshuf", 8) in _mesh_node_keys()[0]


def test_mesh_csr_nonunique_join(join_tk):
    """tests/test_mesh_parallel.py's battery: non-unique joins shard the
    probe side with the CSR structures broadcast, per-shard buckets from
    host-exact per-shard bounds."""
    qs = ["select big.a, dup.w from big join dup on big.fk = dup.k "
          "where big.x < 5 order by big.a, dup.w limit 50",
          "select big.a, dup.w from big left join dup on big.fk = dup.k "
          "order by big.a, dup.w limit 50",
          "select dup.k, count(*), sum(big.x) from big join dup "
          "on big.fk = dup.k group by dup.k order by dup.k"]
    _fresh_keys()
    for q in qs:
        got, want, off = _mesh_rows(join_tk, q)
        assert _canon(got) == _canon(off) == _canon(want), q
    assert ("joinm", 8) in _mesh_node_keys()[0]


@pytest.fixture(scope="module")
def shuf_tk(mesh_env):
    """__graft_entry__._dryrun_shuffle_join's tables at 8 shards: a build
    side (dim, 512 rows) above the per-shard broadcast budget (64)."""
    s = _session(port_new_session, "shuf", device="cpu")
    s.execute("set @@tidb_devpipe = 1")
    rng = np.random.default_rng(9)
    n_fact, n_dim = 128 * 8, 64 * 8
    fk = rng.integers(1, n_dim + 2, n_fact).astype(np.int64)
    x = rng.random(n_fact) * 10
    v = rng.integers(0, 100, n_dim).astype(np.int64)
    for name, schema, cols in (
            ("fact", "a bigint primary key, fk bigint, x double",
             {"a": np.arange(1, n_fact + 1, dtype=np.int64), "fk": fk,
              "x": x}),
            ("dim", "k bigint primary key, v bigint",
             {"k": np.arange(1, n_dim + 1, dtype=np.int64), "v": v})):
        s.execute(f"create table {name} ({schema})")
        port_bulk_load(s.storage, s.infoschema().table_by_name("shuf", name),
                       cols)
    return s, fk, x, v, n_dim


def test_dryrun_shuffle_join_numpy_oracle(shuf_tk):
    """The shuffle join, inner and LEFT, against a numpy oracle computed
    from the generated arrays (__graft_entry__._dryrun_shuffle_join)."""
    s, fk, x, v, n_dim = shuf_tk
    s.execute("set @@tidb_mesh_parallel = 1")
    s.execute(f"set @@tidb_broadcast_build_max_rows = {n_dim // 8}")
    try:
        devpipe.COMPILED_NODE_KEYS.clear()
        got = s.query("select fact.a, dim.v from fact join dim "
                      "on fact.fk = dim.k where fact.x < 5 "
                      "order by fact.a").rows
        assert ("joinshuf", 8) in {(k[0], k[-1])
                                   for k in devpipe.COMPILED_NODE_KEYS}
        left = s.query("select fact.a, dim.v from fact left join dim "
                       "on fact.fk = dim.k order by fact.a limit 50").rows
    finally:
        s.execute("set @@tidb_mesh_parallel = 0")
        s.execute("set @@tidb_broadcast_build_max_rows = 1048576")
    a_ids = np.arange(1, len(fk) + 1, dtype=np.int64)
    hit = (x < 5) & (fk >= 1) & (fk <= n_dim)
    assert got == [[int(a), int(v[f - 1])]
                   for a, f in zip(a_ids[hit], fk[hit])]
    assert left == [[int(a), int(v[f - 1]) if 1 <= f <= n_dim else None]
                    for a, f in zip(a_ids[:50], fk[:50])]


# =========================================================================
# the slice: TPC-H Q1, Q3, Q6 at SF=0.01 on both device tiers
# =========================================================================

SF, SEED = 0.01, 7


@pytest.fixture(scope="module")
def tpch_pair(mesh_env):
    ref = ref_new_session()
    ref_tpch.load(ref, sf=SF, seed=SEED)
    ref.execute("set tidb_use_tpu = 1")
    ref.execute("set tidb_tpu_min_rows = 0")
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
    port.execute("set tidb_tpu_min_rows = 0")
    return ref, port


#: the mesh families each query reaches at SF=0.01, by tier (the
#: reference's own counts): Q6's filtered estimate stays below two
#: shards' MIN_SHARD_ROWS there, so it runs single-device in both
#: packages (it shards at SF=1, chip_smoke.py's mesh phase)
ROUNDS = {(1, "Q1"): 1, (1, "Q3"): 0, (1, "Q6"): 0,
          (0, "Q1"): 1, (0, "Q3"): 3, (0, "Q6"): 0}


@pytest.mark.parametrize("devpipe_mode", [1, 0])
@pytest.mark.parametrize("q", ["Q1", "Q3", "Q6"])
def test_tpch_slice_under_the_mesh(tpch_pair, devpipe_mode, q):
    sql = port_tpch.QUERIES[q]
    _set(tpch_pair, f"tidb_devpipe = {devpipe_mode}")
    try:
        kernels.reset_kernel_counts()
        got, want, off = _mesh_rows(tpch_pair, sql)
        plain = kernels.kernel_counts()["plain_calls"]
        st = _same_shard_counts()
        assert port_tpch.canon_rows(got) == ref_tpch.canon_rows(want), q
        _close(got, off, q)
        _set(tpch_pair, "tidb_mesh_parallel = 1")
        again = tpch_pair[1].query(sql).rows
    finally:
        _set(tpch_pair, "tidb_mesh_parallel = 0")
        _set(tpch_pair, "tidb_devpipe = -1")
    assert repr(again) == repr(got), q
    assert st["shard_rounds"] == ROUNDS[(devpipe_mode, q)], st
    if q == "Q1":  # K11: HK2 per shard, one HK11 merge
        assert plain["segment_reduce"] == 8 and plain["shard_merge"] == 1
    if q == "Q3" and devpipe_mode == 0:  # K25 join twice, K11 once
        assert plain["shard_probe"] == 2 and plain["shard_merge"] == 1
    if q == "Q3" and devpipe_mode == 1:  # K21 mesh
        assert _port_keys("order_mesh")
        assert plain["lex_order"] == 2 and plain["dense_probe"] == 2


def test_q6_shards_at_a_larger_estimate(tpch_pair):
    """K25's scalar aggregate on Q6's select list: with one of its
    conditions the estimate reaches 8 shards, HK1 runs per shard and HK11
    merges."""
    sql = ("select sum(l_extendedprice * l_discount) as revenue "
           "from lineitem where l_quantity < 24")
    kernels.reset_kernel_counts()
    got, want, off = _mesh_rows(tpch_pair, sql)
    plain = kernels.kernel_counts()["plain_calls"]
    assert port_tpch.canon_rows(got) == ref_tpch.canon_rows(want)
    _close(got, off, "Q6")
    st = _same_shard_counts()
    assert st["shard_rounds"] == 1, st
    assert plain["masked_reduce"] == 8 and plain["shard_merge"] == 1


@pytest.mark.parametrize("devpipe_mode,sql", [
    (1, port_tpch.WORKLOAD["Q10"]),
    (1, port_tpch.Q13),
    (0, port_tpch.WORKLOAD["Q18"]),
    (0, "select o_orderkey from orders order by o_totalprice"),
], ids=["q10_pipeline_shuffle", "q13_csr_mesh", "q18_semi_per_op",
        "single_key_order_by"])
def test_unported_mesh_routes_raise(tpch_pair, devpipe_mode, sql):
    """The routes that raised before this slice (the reference runs them
    sharded) now run sharded in the port: rows equal the reference's mesh
    rows and the port's mesh-off rows, shard counters equal."""
    _set(tpch_pair, f"tidb_devpipe = {devpipe_mode}")
    try:
        got, want, off = _mesh_rows(tpch_pair, sql)
    finally:
        _set(tpch_pair, "tidb_devpipe = -1")
    assert got and port_tpch.canon_rows(got) == ref_tpch.canon_rows(want)
    _close(got, off, sql)
    st = _same_shard_counts()
    if sql == port_tpch.Q13:  # the CSR mesh mode counts no round
        assert ("joinm", 8) in _mesh_node_keys(sized=True)[0]
    else:
        assert st["shard_rounds"] >= 1, st


#: the slice through SQL: TPC-H Q10 and Q13 on the pipeline tier; Q18,
#: NOT IN, Q22, NOT EXISTS and a single-key ORDER BY / TopN on both
SLICE = {"Q10": port_tpch.WORKLOAD["Q10"], "Q13": port_tpch.Q13,
         "Q18": port_tpch.WORKLOAD["Q18"], **port_tpch.K8_QUERIES,
         "ORDER_BY": "select o_orderkey, o_totalprice from orders "
                     "order by o_totalprice desc",
         "TOPN": "select o_orderkey, o_totalprice from orders "
                 "order by o_totalprice desc limit 10"}
SLICE_CASES = [(1, q) for q in SLICE] + [
    (0, q) for q in SLICE if q not in ("Q10", "Q13")]


@pytest.mark.parametrize("devpipe_mode,q", SLICE_CASES)
def test_mesh_slice_through_sql(tpch_pair, devpipe_mode, q):
    """Rows equal the reference's mesh rows (tpch.canon_rows) and the
    port's mesh-off rows; a second mesh run equal by repr; shard rounds,
    exchange bytes and skew retries equal; the shuffle and CSR joins
    compiled at the same mesh sizes as the reference's."""
    sql = SLICE[q]
    _set(tpch_pair, f"tidb_devpipe = {devpipe_mode}")
    try:
        got, want, off = _mesh_rows(tpch_pair, sql)
        st = _same_shard_counts()
        keys = _mesh_node_keys(sized=True)
        _set(tpch_pair, "tidb_mesh_parallel = 1")
        again = tpch_pair[1].query(sql).rows
    finally:
        _set(tpch_pair, "tidb_mesh_parallel = 0")
        _set(tpch_pair, "tidb_devpipe = -1")
    assert port_tpch.canon_rows(got) == ref_tpch.canon_rows(want), q
    _close(got, off, q)
    assert repr(again) == repr(got), q
    assert keys[0] == keys[1], (q, keys)
    if q in ("Q10", "Q13"):
        assert ("joinshuf" if q == "Q10" else "joinm", 8) in keys[0], keys
    else:
        assert st["shard_rounds"] >= 1, (q, st)
