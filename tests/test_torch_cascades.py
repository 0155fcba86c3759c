"""F1: the four statements that need the device-free modules the port's
session imports lazily — ANALYZE TABLE (statistics/analyze.py), ADMIN
CHECK TABLE (executor/admin.py), any statement under
tidb_enable_cascades_planner = 1 (planner/cascades/) and under
tidb_qlint_verify = 1 (analysis/plan_device.py).

Port copies of tests/test_cascades.py (all five), of the ANALYZE cases of
tests/test_index.py and tests/test_rules.py, of the ADMIN CHECK cases of
tests/test_ddl.py and of the tidb_qlint_verify case of tests/test_lint.py,
run on the port with ``device="cpu"``; then one test per F1 statement
that runs it through both packages (the reference on its device tier on
the CPU) and holds the port to the reference's rows or errors."""
import json
import os
import re

import pytest

from tinysql_tpu.session.session import new_session as ref_new_session
from tinysql_tpu_torch.session import new_session as port_new_session
from tinysql_tpu_torch.session.session import Session

GOLDEN = os.path.join(os.path.dirname(__file__), "testdata",
                      "plans_golden.json")


def _port(storage=None, db=""):
    return port_new_session(storage, db, device="cpu")


# ---- tests/test_cascades.py ---------------------------------------------

QUERIES = [
    "select a from t where b = 3 order by a",
    "select c, count(*), sum(b) from t group by c order by c",
    "select a + b from t where a < 10 and b > 2 order by a",
    "select t.a, u.v from t join u on t.b = u.k where u.k >= 5 "
    "order by t.a limit 5",
    "select a from t order by b desc, a limit 7",
    "select count(*) from t where b = 3 and c = 'x0'",
    "select a from t where a in (1, 5, 50) order by a",
    "select b, max(a) from t where c = 'x1' group by b order by b",
    "select a from t where a between 10 and 20 and b != 4 order by a",
    "select max(a) from t",
    "select a, count(*), sum(b) from t where a < 5 group by a order by a",
    "select t.a from t left join u on t.b = u.k order by t.a limit 4",
    "select count(*) from t join u on t.b = u.k "
    "join t t2 on t.a = t2.a",
    "select u.v, count(*), sum(t.a) from t join u on t.b = u.k "
    "group by u.v order by u.v",
    "select t.b, avg(t.a), max(t.c) from t join u on t.b = u.k "
    "group by t.b order by t.b",
    "select t.a, u.v from t left join u on t.b = u.k "
    "order by t.a desc limit 4",
    "select b + 1, count(*) from t group by b + 1 order by 1",
    "select a * 2 from t where b = 2 order by a limit 3",
]


def _cascades_tables(s):
    s.execute("create database test")
    s.execute("set @@tidb_tpu_min_rows = 0")
    s.execute("use test")
    s.execute("create table t (a int primary key, b int, c varchar(10), "
              "key ib (b))")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 7}, 'x{i % 3}')" for i in range(1, 101)))
    s.execute("create table u (k int primary key, v varchar(5))")
    s.execute("insert into u values " + ", ".join(
        f"({i}, 'u{i}')" for i in range(0, 7)))
    return s


@pytest.fixture(scope="module")
def tk():
    return _cascades_tables(_port())


def _normalize(rows):
    return [[re.sub(r"col#\d+", "col#?", c) if isinstance(c, str) else c
             for c in r] for r in rows]


def test_planners_agree_on_results(tk):
    for tpu in (0, 1):
        tk.execute(f"set @@tidb_use_tpu = {tpu}")
        for q in QUERIES:
            tk.execute("set @@tidb_enable_cascades_planner = 0")
            sysr = tk.query(q).rows
            tk.execute("set @@tidb_enable_cascades_planner = 1")
            casc = tk.query(q).rows
            assert sysr == casc, (q, tpu)
    tk.execute("set @@tidb_enable_cascades_planner = 0")
    tk.execute("set @@tidb_use_tpu = 1")


def test_cascades_pushes_selection_to_access_path(tk):
    tk.execute("set @@tidb_enable_cascades_planner = 1")
    try:
        rows = tk.query("explain select a from t where b = 3").rows
        ops = [r[0].strip() for r in rows]
        assert any(o.startswith("IndexReader") for o in ops), rows
        rows = tk.query("explain select a from t where a = 5").rows
        info = " ".join(r[3] for r in rows)
        assert "ranges:1 range" in info, rows
    finally:
        tk.execute("set @@tidb_enable_cascades_planner = 0")


def test_golden_plans(tk):
    """Both planners' plan shapes equal the reference's golden file."""
    plans = {}
    for planner in ("systemr", "cascades"):
        tk.execute("set @@tidb_enable_cascades_planner = "
                   + ("1" if planner == "cascades" else "0"))
        for q in QUERIES:
            plans[f"{planner}::{q}"] = _normalize(
                tk.query("explain " + q).rows)
    tk.execute("set @@tidb_enable_cascades_planner = 0")
    with open(GOLDEN) as f:
        want = json.load(f)
    assert set(plans) == set(want)
    for k in plans:
        assert plans[k] == want[k], f"plan drift for {k}:\n" \
            f"got  {plans[k]}\nwant {want[k]}"


def test_cascades_implementation_divergence(tk):
    def ops(q):
        return [r[0].strip() for r in tk.query("explain " + q).rows]

    q1 = "select t.a, u.v from t join u on t.a = u.k"
    q2 = ("select t.b, avg(t.a) from t join u on t.b = u.k "
          "group by t.b order by t.b")
    try:
        tk.execute("set @@tidb_enable_cascades_planner = 0")
        sysr1, sysr2 = ops(q1), ops(q2)
        r1s, r2s = tk.query(q1).rows, tk.query(q2).rows
        tk.execute("set @@tidb_enable_cascades_planner = 1")
        casc1, casc2 = ops(q1), ops(q2)
        r1c, r2c = tk.query(q1).rows, tk.query(q2).rows
    finally:
        tk.execute("set @@tidb_enable_cascades_planner = 0")
    assert any(o.startswith("MergeJoin") for o in sysr1), sysr1
    assert any(o.startswith("HashJoin") for o in casc1), casc1
    assert sysr2[0].startswith("Sort"), sysr2
    assert any(o.startswith("MergeJoin") for o in casc2), casc2
    join_at = next(i for i, o in enumerate(casc2)
                   if o.startswith("MergeJoin"))
    assert not any(o.startswith("Sort") for o in casc2[:join_at]), casc2
    assert sorted(map(tuple, r1s)) == sorted(map(tuple, r1c))
    assert r2s == r2c


def test_cascades_order_never_pushes_below_limit(tk):
    q = "select x.a from (select a from t limit 3) x order by x.a desc"
    tk.execute("set @@tidb_enable_cascades_planner = 0")
    sysr = tk.query(q).rows
    tk.execute("set @@tidb_enable_cascades_planner = 1")
    casc = tk.query(q).rows
    tk.execute("set @@tidb_enable_cascades_planner = 0")
    assert sysr == casc, (sysr, casc)


# ---- ANALYZE: tests/test_index.py and tests/test_rules.py ------------------

def test_stats_shift_path_choice():
    """tests/test_index.py: after ANALYZE, b = 3 matches ~10% of rows and
    the index lookup still wins over a full scan."""
    s = _port()
    s.execute("create database test")
    s.execute("use test")
    s.execute("set @@tidb_use_tpu = 0")
    s.execute("create table t (a int primary key, b int, c varchar(20), "
              "d bigint unsigned, key idx_b (b), unique key idx_c (c), "
              "key idx_bd (b, d))")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 10}, 'v{i}', {(1 << 63) + i if i % 2 else i})"
        for i in range(1, 101)))
    s.execute("analyze table t")
    ops = [r[0].strip() for r in
           s.query("explain select * from t where b = 3").rows]
    assert any(o.startswith("IndexLookUpReader") for o in ops), ops
    got = s.query("select a from t where b = 3 order by a").rows
    assert got == [[i] for i in range(3, 101, 10)]


def _rules_tk():
    s = _port()
    s.execute("create database test")
    s.execute("use test")
    s.execute("set @@tidb_use_tpu = 0")
    s.execute("create table t (a int primary key, b int, c varchar(10), "
              "key ib (b))")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 7}, 'x{i % 3}')" for i in range(1, 101)))
    s.execute("insert into t values (200, null, null)")
    s.execute("create table u (k int primary key, v varchar(5))")
    s.execute("insert into u values " + ", ".join(
        f"({i}, 'u{i}')" for i in range(0, 7)))
    s.execute("create table w (k int, v int)")
    s.execute("insert into w values (1, 10), (1, 11), (2, 20)")
    return s


def _chain_count():
    want = 0
    for i in range(1, 101):
        b = i % 7
        want += sum(1 for wk, _ in [(1, 10), (1, 11), (2, 20)] if wk == b)
    return want


def test_join_reorder_three_tables():
    """tests/test_rules.py: a chain of inner joins after ANALYZE."""
    tk = _rules_tk()
    for t in ("t", "u", "w"):
        tk.execute(f"analyze table {t}")
    q = ("select count(*) from t join u on t.b = u.k "
         "join w on u.k = w.k")
    assert tk.query(q).rows == [[_chain_count()]]


def test_dp_join_reorder_e2e():
    """tests/test_rules.py: a 4-way join through the DP solver after
    ANALYZE."""
    tk = _rules_tk()
    for t in ("t", "u", "w"):
        tk.execute(f"analyze table {t}")
    q = ("select count(*) from t join u on t.b = u.k "
         "join w on u.k = w.k join t t2 on t.a = t2.a")
    assert tk.query(q).rows == [[_chain_count()]]


# ---- ADMIN CHECK TABLE: tests/test_ddl.py -------------------------------

@pytest.fixture
def ddl():
    s = _port()
    s.execute("create database test")
    s.execute("use test")
    s.execute("set @@global.tidb_use_tpu = 0")
    s.execute("set @@tidb_use_tpu = 0")
    return s


def _ok(s, t):
    assert s.query(f"admin check table {t}").rows == [["OK"]]


def test_add_index_backfills_existing_rows(ddl):
    ddl.execute("create table t (a int primary key, b int)")
    for i in range(0, 600, 100):
        ddl.execute(f"insert into t values ({i}, {i * 2})")
    ddl.execute("create index ib on t (b)")
    _ok(ddl, "t")
    ddl.execute("insert into t values (1000, 2000)")
    _ok(ddl, "t")
    s2 = _port(ddl.storage, "test")
    s2.execute("create table big (a int primary key, b int)")
    s2.execute("begin")
    for i in range(700):
        s2.execute(f"insert into big values ({i}, {i % 7})")
    s2.execute("commit")
    s2.execute("create index ib on big (b)")
    _ok(s2, "big")
    assert s2.query("select count(*) from big where b = 3").rows == [[100]]


def test_unique_index_backfill_rollback_on_duplicate(ddl):
    ddl.execute("create table t (a int primary key, b int)")
    ddl.execute("insert into t values (1, 5), (2, 5)")
    with pytest.raises(Exception) as e:
        ddl.execute("create unique index ub on t (b)")
    assert "Duplicate" in str(e.value) or "rolled back" in str(e.value)
    idx_names = [str(r[2]) for r in ddl.query("show index from t").rows]
    assert "ub" not in idx_names
    ddl.execute("insert into t values (3, 5)")
    _ok(ddl, "t")


def test_drop_index(ddl):
    ddl.execute("create table t (a int primary key, b int)")
    ddl.execute("insert into t values (1, 2)")
    ddl.execute("create index ib on t (b)")
    ddl.execute("drop index ib on t")
    with pytest.raises(Exception, match="check that index exists"):
        ddl.execute("drop index ib on t")
    ddl.execute("insert into t values (2, 3)")
    _ok(ddl, "t")


def test_commit_aborts_when_schema_changed_mid_txn(ddl):
    from tinysql_tpu_torch.kv import RetryableError
    ddl.execute("create table sv (a int primary key, b int)")
    ddl.execute("begin")
    ddl.execute("insert into sv values (1, 1)")
    other = Session(ddl.storage, current_db="test")
    other.execute("alter table sv add index ib (b)")
    with pytest.raises(RetryableError, match="schema"):
        ddl.execute("commit")
    assert other.query("select count(*) from sv").rows == [[0]]
    _ok(other, "sv")
    ddl.execute("begin")
    ddl.execute("insert into sv values (1, 1)")
    ddl.execute("commit")
    assert other.query("select a from sv where b = 1").rows == [[1]]


def test_backfill_resumes_from_checkpoint_after_crash(ddl, monkeypatch):
    from tinysql_tpu_torch.ddl import worker as w
    from tinysql_tpu_torch.kv.errors import KVError
    monkeypatch.setattr(w, "REORG_BATCH", 10)
    ddl.execute("create table rz (a int primary key, b int)")
    ddl.execute("insert into rz values " + ", ".join(
        f"({i}, {i * 2})" for i in range(1, 101)))
    calls = {"n": 0}
    orig = w.DDLWorker._backfill_batch

    def crashy(self, job, t, idx_info):
        calls["n"] += 1
        if calls["n"] in (4, 5):
            raise KVError("crash mid-backfill")
        return orig(self, job, t, idx_info)
    monkeypatch.setattr(w.DDLWorker, "_backfill_batch", crashy)
    ddl.execute("alter table rz add index ib (b)")
    _ok(ddl, "rz")
    assert ddl.query("select a from rz where b = 84").rows == [[42]]
    assert len(ddl.query("select a from rz where b >= 0").rows) == 100
    jobs = ddl.query("admin show ddl jobs").rows
    add_idx = [r for r in jobs if "add index" in str(r).lower()
               or "ADD_INDEX" in str(r)]
    assert add_idx, jobs[:3]
    assert any("100" in str(cell) for cell in add_idx[0]), add_idx[0]


# ---- tidb_qlint_verify: tests/test_lint.py ----------------------------------

def test_runtime_verifier_sysvar():
    """tidb_qlint_verify=1 verifies every statement's plan inline; a
    healthy plan still executes."""
    s = _port()
    s.execute("create database rv")
    s.execute("use rv")
    s.execute("create table r (a int primary key, b int)")
    s.execute("insert into r values (1,2),(2,2)")
    s.execute("set @@tidb_qlint_verify = 1")
    s.execute("set @@tidb_tpu_min_rows = 0")
    assert s.query("select b, count(*) from r group by b").rows == [[2, 2]]


def test_runtime_verifier_refuses_a_drifted_plan(monkeypatch):
    """The verifier raises before the plan runs when the EXPLAIN task
    column disagrees with a node's placement (PD205, as
    tests/test_lint.py's test_pd205_explain_drift provokes it)."""
    from tinysql_tpu_torch.analysis import PlanDeviceError
    from tinysql_tpu_torch.planner import explain
    s = _port()
    s.execute("create database rv")
    s.execute("use rv")
    s.execute("create table r (a int primary key, b int)")
    s.execute("insert into r values (1,2),(2,2)")
    s.execute("set @@tidb_qlint_verify = 1")
    s.execute("set @@tidb_tpu_min_rows = 0")
    monkeypatch.setattr(explain, "_task", lambda p: "root")
    with pytest.raises(PlanDeviceError, match="PD205"):
        s.query("select b, count(*) from r group by b")


# ---- F1: each statement through both packages ---------------------------

@pytest.fixture(scope="module")
def both():
    out = []
    for s in (ref_new_session(), _port()):
        s.execute("create database f1")
        s.execute("use f1")
        s.execute("set @@tidb_tpu_min_rows = 0")
        s.execute("create table t (id bigint primary key, g bigint, "
                  "x double, key ig (g))")
        s.execute("insert into t values " + ", ".join(
            f"({i}, {i % 5}, {i * 0.5})" for i in range(1, 301)))
        s.execute("create table u (k bigint primary key, v varchar(5))")
        s.execute("insert into u values (0, 'a'), (1, 'b'), (2, 'c')")
        out.append(s)
    return out


def _outcome(s, sql):
    try:
        return ("rows", s.query(sql).rows)
    except Exception as e:  # the reference's error is the expected value
        return ("error", type(e).__name__, str(e))


F1_SELECT = ("select u.v, count(*), sum(t.x) from t join u on t.g = u.k "
             "where t.id > 10 group by u.v order by u.v")


def test_f1_analyze_table_both_packages(both):
    ref, port = both
    for s in both:
        s.execute("set @@tidb_use_tpu = 0")
    assert _outcome(port, "analyze table t") == \
        _outcome(ref, "analyze table t")
    assert _outcome(port, "analyze table nope")[:2] == \
        _outcome(ref, "analyze table nope")[:2]
    q = "explain select * from t where g = 3"
    assert _normalize(_outcome(port, q)[1]) == \
        _normalize(_outcome(ref, q)[1])
    q = "select id from t where g = 3 order by id"
    assert _outcome(port, q) == _outcome(ref, q)
    for s in both:
        s.execute("set @@tidb_use_tpu = 1")


def test_f1_admin_check_table_both_packages(both):
    ref, port = both
    for sql in ("admin check table t", "admin check table u"):
        got = _outcome(port, sql)
        assert got == _outcome(ref, sql) == ("rows", [["OK"]])
    assert _outcome(port, "admin check table nope")[:2] == \
        _outcome(ref, "admin check table nope")[:2]


def test_f1_cascades_planner_both_packages(both):
    ref, port = both
    for s in both:
        s.execute("set @@tidb_enable_cascades_planner = 1")
    try:
        for tpu in (0, 1):
            for s in both:
                s.execute(f"set @@tidb_use_tpu = {tpu}")
            got = _outcome(port, F1_SELECT)
            assert got[0] == "rows" and len(got[1]) == 3
            assert got == _outcome(ref, F1_SELECT), tpu
            q = "explain " + F1_SELECT
            assert _normalize(port.query(q).rows) == \
                _normalize(ref.query(q).rows), tpu
    finally:
        for s in both:
            s.execute("set @@tidb_enable_cascades_planner = 0")
            s.execute("set @@tidb_use_tpu = 1")


def test_f1_qlint_verify_both_packages(both):
    ref, port = both
    for s in both:
        s.execute("set @@tidb_qlint_verify = 1")
    try:
        for sql in (F1_SELECT, "select g, sum(x) from t group by g "
                               "order by g"):
            got = _outcome(port, sql)
            assert got[0] == "rows" and got == _outcome(ref, sql)
    finally:
        for s in both:
            s.execute("set @@tidb_qlint_verify = 0")
