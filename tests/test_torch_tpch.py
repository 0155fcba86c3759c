"""TPC-H Q1, Q3 and Q6 and K8's statements (NOT IN, Q22, NOT EXISTS) at
SF=0.01 (seed 7) through SQL: the port's device tier on the CPU against
the reference's per-operator device tier.

Reference: the JAX session with tidb_use_tpu=1, tidb_devpipe=0,
tidb_tpu_min_rows=0 and TINYSQL_DEVICE_JOIN_ONLY=1 (its device join
programs, not its numpy twins).  Port: a session with device="cpu" and
tidb_tpu_min_rows=0, reading a replica built from the reference's own
numpy columns (columnar.store.replica_from_numpy), so both engines read
identical data.  Integers and strings must match exactly, floats within
1e-6 relative (the reference's own bound: the two sum in other orders)."""
import math

import pytest

from tinysql_tpu.bench import tpch as ref_tpch
from tinysql_tpu.columnar.store import store_of as ref_store_of
from tinysql_tpu.session import new_session as ref_new_session
from tinysql_tpu_torch.bench import tpch as port_tpch
from tinysql_tpu_torch.columnar.store import replica_from_numpy
from tinysql_tpu_torch.executor import gpu_executors
from tinysql_tpu_torch.ops import kernels
from tinysql_tpu_torch.session import new_session as port_new_session

SF, SEED = 0.01, 7
EXECS = {"Q1": {"GPUHashAggExec", "GPUSortExec"},
         "Q3": {"GPUHashJoinExec", "GPUHashAggExec", "GPUTopNExec"},
         "Q6": {"GPUHashAggExec"}}


@pytest.fixture(scope="module")
def sessions():
    mp = pytest.MonkeyPatch()
    mp.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    ref = ref_new_session()
    ref_tpch.load(ref, sf=SF, seed=SEED)
    for v in ("tidb_use_tpu = 1", "tidb_devpipe = 0",
              "tidb_tpu_min_rows = 0"):
        ref.execute(f"set {v}")
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
    yield ref, port
    mp.undo()


def _same(a, b, q):
    assert len(a) == len(b), q
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb), q
        for x, y in zip(ra, rb):
            if isinstance(y, float):
                assert isinstance(x, float), (q, x, y)
                assert math.isclose(x, y, rel_tol=1e-6, abs_tol=1e-9), \
                    (q, x, y)
            else:
                assert x == y, (q, x, y)


@pytest.mark.parametrize("q", ["Q1", "Q3", "Q6"])
def test_tpch_matches_reference_device_tier(sessions, q, monkeypatch):
    ref, port = sessions
    built = []
    orig = gpu_executors._build_gpu_op

    def record(plan):
        # the per-operator executors (auto on the CPU: the pipeline tier
        # hands them every plan)
        ex = orig(plan)
        built.append(type(ex).__name__)
        return ex
    monkeypatch.setattr(gpu_executors, "_build_gpu_op", record)
    kernels.reset_kernel_counts()
    want = ref.query(ref_tpch.QUERIES[q]).rows
    got = port.query(port_tpch.QUERIES[q]).rows
    assert len(got) == {"Q1": 6, "Q3": 10, "Q6": 1}[q]
    _same(got, want, q)
    assert EXECS[q] <= set(built), built
    counts = kernels.kernel_counts()
    assert not any(counts["launches"].values())  # CPU: plain versions
    assert any(counts["plain_calls"].values())
    # the port's own CPU tier agrees under the benchmark's canonical form
    port.execute("set tidb_use_tpu = 0")
    try:
        cpu = port.query(port_tpch.QUERIES[q]).rows
    finally:
        port.execute("set tidb_use_tpu = 1")
    assert port_tpch.canon_rows(cpu) == port_tpch.canon_rows(got)


# K8's statements: chip_smoke.py's three at SF=0.01 (NOT_EXISTS and Q22
# keep no customer there) and a NOT EXISTS over early orders only, which
# keeps about half of the customers
K8_CASES = {**port_tpch.K8_QUERIES,
            "NOT_EXISTS_EARLY": """select count(*), sum(c_custkey)
from customer
where not exists (select * from orders
                  where o_custkey = c_custkey
                    and o_orderdate < '1993-01-01')"""}


@pytest.mark.parametrize("q", sorted(K8_CASES))
def test_k8_queries_match_reference_device_tier(sessions, q):
    """NOT IN, Q22 and NOT EXISTS reach semi_join_match (HK3's membership,
    then semi_pick's plain version on the CPU) and give the reference's
    rows and the port's CPU tier's."""
    ref, port = sessions
    kernels.reset_kernel_counts()
    want = ref.query(K8_CASES[q]).rows
    got = port.query(K8_CASES[q]).rows
    _same(got, want, q)
    assert kernels.kernel_counts()["plain_calls"]["semi_pick"] > 0
    if q == "NOT_EXISTS_EARLY":
        assert got[0][0] > 0
    port.execute("set tidb_use_tpu = 0")
    try:
        cpu = port.query(K8_CASES[q]).rows
    finally:
        port.execute("set tidb_use_tpu = 1")
    assert port_tpch.canon_rows(cpu) == port_tpch.canon_rows(got)


def test_q5_rows_match_cpu_tier_and_sqlite(sessions):
    """tpch.q5_rows, the numpy answer Q5's rows are held to on the card at
    SF=1, equals the port's CPU tier and the sqlite mirror on the same
    data."""
    _, port = sessions
    data = port_tpch.generate(SF, SEED)
    want = port_tpch.canon_rows(port_tpch.q5_rows(data))
    assert len(want) == 5
    port.execute("set tidb_use_tpu = 0")
    try:
        cpu = port.query(port_tpch.Q5).rows
    finally:
        port.execute("set tidb_use_tpu = 1")
    assert port_tpch.canon_rows(cpu) == want
    lite = port_tpch.sqlite_mirror(data).execute(port_tpch.Q5).fetchall()
    assert port_tpch.canon_rows(lite) == want


def test_generators_agree():
    a = ref_tpch.generate(0.001, SEED)
    b = port_tpch.generate(0.001, SEED)
    for t in a:
        for c in a[t]:
            assert (a[t][c] == b[t][c]).all(), (t, c)


def test_not_ported_paths_fail_loudly(sessions, monkeypatch):
    """What the port has not built raises, naming its ROADMAP item; what
    it has built runs.  Block-wise execution is ported: a TopN over a
    table past tidb_device_block_rows runs block-wise and gives the
    unblocked rows.  The mesh tier's slice is ported (8 virtual shards,
    TINYSQL_MESH_SHARDS): Q3 under tidb_mesh_parallel gives the
    reference's mesh rows on the per-operator tier (the sharded unique
    joins and grouped aggregate), and so does a single-key ORDER BY (the
    sharded sort)."""
    ref, port = sessions
    topn = ("select l_orderkey from lineitem order by l_extendedprice desc, "
            "l_orderkey limit 3")
    want = port.query(topn).rows
    port.execute("set tidb_device_block_rows = 1000")
    try:
        assert port.query(topn).rows == want
    finally:
        port.execute("set tidb_device_block_rows = 0")
    monkeypatch.setenv("TINYSQL_MESH_SHARDS", "8")
    from tinysql_tpu.ops import shardops as ref_shardops
    from tinysql_tpu_torch.ops import shardops
    for s in (ref, port):
        s.execute("set tidb_mesh_parallel = 1")
    try:
        shardops.reset_stats()
        ref_shardops.reset_stats()
        got = port.query(port_tpch.QUERIES["Q3"]).rows
        _same(got, ref.query(ref_tpch.QUERIES["Q3"]).rows, "Q3")
        assert shardops.stats_snapshot()["shard_rounds"] \
            == ref_shardops.stats_snapshot()["shard_rounds"] > 0
        q = "select o_orderkey from orders order by o_totalprice"
        assert port.query(q).rows == ref.query(q).rows
    finally:
        for s in (ref, port):
            s.execute("set tidb_mesh_parallel = 0")


@pytest.mark.parametrize("point", ["kernelDispatchError", "kernelD2HError"])
def test_device_error_fails_the_statement(sessions, point, monkeypatch):
    """A launch or a device->host pull that fails fails the statement:
    the port re-runs nothing on the CPU tier and pins nothing to it, so
    the next statement runs on the device tier again."""
    from tinysql_tpu_torch import fail
    _, port = sessions
    built = []
    orig = gpu_executors.build_gpu_executor

    def record(plan):
        ex = orig(plan)
        built.append(type(ex).__name__)
        return ex
    monkeypatch.setattr(gpu_executors, "build_gpu_executor", record)
    with fail.armed(point, exc=RuntimeError("card lost")):
        with pytest.raises(RuntimeError, match="card lost"):
            port.query(port_tpch.QUERIES["Q6"])
    built.clear()
    rows = port.query(port_tpch.QUERIES["Q6"]).rows
    assert len(rows) == 1 and "GPUHashAggExec" in built, built
