"""TPC-H Q5, Q10 and Q18 (tpch.WORKLOAD, the reference's workload trio) at
SF=0.02 (seed 7) through SQL: both of the port's device tiers on the CPU
against the reference's per-operator device tier.

Reference: the JAX session with tidb_use_tpu=1, tidb_devpipe=0,
tidb_tpu_min_rows=0 and TINYSQL_DEVICE_JOIN_ONLY=1 (its device join
programs, not its numpy twins) — not its pipeline tier, whose group sums
carry R6 (ROADMAP queue 3).  Port: a session with device="cpu" and
tidb_tpu_min_rows=0 under tidb_devpipe=0 (the per-operator tier) and =1
(the pipeline tier forced), reading a replica built from the reference's
own numpy columns (columnar.store.replica_from_numpy).  Integers,
strings and row order must match exactly, floats within 1e-6 relative
(the reference's own bound: the two sum in other orders).

The trio brings HK3's multiplicity mode (orders x lineitem), semi joins
(Q5's IN over region, Q18's IN over a HAVING aggregate), Q5's two-key
join and a HAVING selection onto the device path; every query also runs
its expressions through HK7's plain version here (kernels.expr_eval on
CPU tensors)."""
import math

import pytest

from tinysql_tpu.bench import tpch as ref_tpch
from tinysql_tpu.columnar.store import store_of as ref_store_of
from tinysql_tpu.session import new_session as ref_new_session
from tinysql_tpu_torch.bench import tpch as port_tpch
from tinysql_tpu_torch.columnar.store import replica_from_numpy
from tinysql_tpu_torch.executor import devpipe, gpu_executors
from tinysql_tpu_torch.ops import kernels
from tinysql_tpu_torch.session import new_session as port_new_session

SF, SEED = 0.02, 7
#: per tier (tidb_devpipe) and query: the per-operator executors built
EXECS = {
    0: {"Q5": {"GPUHashAggExec", "GPUHashJoinExec", "GPUProjectionExec",
               "GPUSortExec"},
        "Q10": {"GPUHashAggExec", "GPUHashJoinExec", "GPUTopNExec"},
        "Q18": {"GPUHashAggExec", "GPUHashJoinExec", "GPUProjectionExec",
                "GPUSelectionExec", "GPUTopNExec"}},
    1: {"Q5": {"GPUHashAggExec", "GPUHashJoinExec", "GPUSortExec"},
        "Q10": {"GPUHashAggExec", "GPUHashJoinExec", "GPUTopNExec"},
        "Q18": {"GPUHashAggExec", "GPUHashJoinExec", "GPUTopNExec"}},
}
#: the pipeline node kinds each query compiles under tidb_devpipe=1 (the
#: joins and aggregates above them run on the per-operator tier, as in
#: the reference)
PIPE_KINDS = {"Q5": {"leaf", "proj", "semijoin"},
              "Q10": {"leaf", "join"},
              "Q18": {"leaf", "aggindex", "sel", "proj", "semijoin",
                      "join"}}


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
    want = {q: ref.query(sql).rows for q, sql in ref_tpch.WORKLOAD.items()}
    yield want, port
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


@pytest.mark.parametrize("tier", [0, 1])
@pytest.mark.parametrize("q", ["Q5", "Q10", "Q18"])
def test_workload_matches_reference_device_tier(sessions, q, tier,
                                                 monkeypatch):
    want, port = sessions
    built = []
    orig = gpu_executors._build_gpu_op

    def record(plan):
        ex = orig(plan)
        built.append(type(ex).__name__)
        return ex
    monkeypatch.setattr(gpu_executors, "_build_gpu_op", record)
    port.execute(f"set tidb_devpipe = {tier}")
    try:
        devpipe.COMPILED_NODE_KEYS.clear()
        kernels.reset_kernel_counts()
        got = port.query(port_tpch.WORKLOAD[q]).rows
        kinds = {k[0] for k in devpipe.COMPILED_NODE_KEYS}
    finally:
        port.execute("set tidb_devpipe = -1")
    assert got, q
    _same(got, want[q], q)
    assert set(built) == EXECS[tier][q], built
    assert kinds == (PIPE_KINDS[q] if tier == 1 else set()), kinds
    counts = kernels.kernel_counts()
    assert not any(counts["launches"].values())  # CPU: plain versions
    assert counts["plain_calls"]["expr_eval"] > 0, counts


@pytest.mark.parametrize("q", ["Q5", "Q10", "Q18"])
def test_workload_cpu_tier_agrees(sessions, q):
    """The port's own CPU tier gives the device tier's rows under the
    benchmark's canonical form (chip_smoke.py's reference on the card)."""
    want, port = sessions
    port.execute("set tidb_use_tpu = 0")
    try:
        cpu = port.query(port_tpch.WORKLOAD[q]).rows
    finally:
        port.execute("set tidb_use_tpu = 1")
    assert port_tpch.canon_rows(cpu) == ref_tpch.canon_rows(want[q])
