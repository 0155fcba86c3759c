"""The port's serving layer: bounded statement pool, admission control,
connection cap, queued-state observability, and same-digest
micro-batching (tinysql_tpu_torch/server/pool.py, server/admission.py,
ops/batching.py) — the counterparts of tests/test_serve.py against the
port's Server(storage, port=0, device="cpu").

Wire-level scenarios ride the MiniClient protocol client from
test_server.py against a live server on an ephemeral port (every client
socket times out after 10 s); the batching protocol also gets a
deterministic embedded drive through the pool's batch runner.  The
module's server runs with the auto-prewarm worker off, so no prewarm
cycle lands in a counted window (R2 in ROADMAP queue 3).
"""
import threading
import time

import pytest

import numpy as np

from test_server import MiniClient
from tinysql_tpu_torch import fail
from tinysql_tpu_torch.columnar.store import bulk_load
from tinysql_tpu_torch.kv import new_mock_storage
from tinysql_tpu_torch.obs import stmtsummary
from tinysql_tpu_torch.ops import batching
from tinysql_tpu_torch.parser import parse
from tinysql_tpu_torch.server.admission import stats_snapshot as adm_stats
from tinysql_tpu_torch.server.pool import StatementPool, _Entry
from tinysql_tpu_torch.server.server import Server
from tinysql_tpu_torch.session.session import Session


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fail.disarm_all()
    yield
    fail.disarm_all()


@pytest.fixture(scope="module")
def server():
    storage = new_mock_storage()
    srv = Server(storage, port=0, device="cpu")
    srv.start()
    boot = Session(storage)
    boot.device = srv.device
    boot.execute("set global tidb_auto_prewarm = 0")
    boot.execute("create database if not exists sv")
    boot.execute("use sv")
    boot.execute("create table t (a int primary key, b int, c double)")
    # the reference test's rows, bulk-loaded (columnar ingest)
    i = np.arange(3000)
    bulk_load(storage, boot.infoschema().table_by_name("sv", "t"),
              {"a": i, "b": i % 53, "c": i * 0.25})
    boot.execute("set global tidb_tpu_min_rows = 16")
    boot.execute("select a, b, c from t")  # hydrate the columnar replica
    yield srv
    srv.close()


def _sess(server, db="sv"):
    s = Session(server.storage)
    s.device = server.device
    if db:
        s.execute(f"use {db}")
    return s


# =========================================================================
# pool + admission
# =========================================================================

def test_concurrent_wire_sessions_under_pool(server):
    """Distinct concurrent statements keep correct results and DISJOINT
    QueryObs scopes (per-digest summary counters don't cross-pollute)."""
    stmtsummary.STORE.reset()
    n = 6
    errs, results = [], {}

    def worker(i):
        try:
            c = MiniClient(server.port, db="sv")
            _, rows = c.query(f"select count(*), sum(b) from t "
                              f"where b < {10 + i}")
            results[i] = rows
            c.close()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and len(results) == n
    # same digest family; per-execution isolation means the aggregate
    # exec_count is exactly n and rows sum to the per-query results
    recs = [r for r in stmtsummary.snapshot()
            if "where b <" in r.get("sample_sql", "")]
    assert recs and sum(r["exec_count"] for r in recs) == n
    # every client observed its own (different) filter result
    counts = {int(rows[0][0]) for rows in results.values()}
    assert len(counts) > 1


def test_processlist_queued_state_roundtrip(server):
    """With a single wedged worker, a second statement is visible as
    state='queued' in processlist (and SHOW PROCESSLIST), then drains."""
    boot = _sess(server)
    boot.execute("set global tidb_stmt_pool_size = 1")
    try:
        c1 = MiniClient(server.port, db="sv")
        c2 = MiniClient(server.port, db="sv")
        fail.arm("admissionDelay", sleep=0.6, times=2)
        box = []

        def run(c, out):
            out.append(c.query("select count(*) from t"))

        t1 = threading.Thread(target=run, args=(c1, box))
        t2 = threading.Thread(target=run, args=(c2, box))
        t1.start()
        time.sleep(0.15)  # c1's worker is inside the wedge
        t2.start()
        # poll (not a fixed sleep): thread start can be starved under
        # suite load, and the queued window closes when the wedge lifts
        obs = _sess(server)
        deadline = time.monotonic() + 5.0
        rows = []
        while not rows and time.monotonic() < deadline:
            rows = obs.query(
                "select id, state, info from "
                "information_schema.processlist "
                "where state = 'queued'").rows
        assert rows, "queued statement not visible in processlist"
        assert "select count(*) from t" in rows[0][2]
        t1.join(30)
        t2.join(30)
        assert not t1.is_alive() and not t2.is_alive()
        assert [r[1][0][0] for r in box] == ["3000", "3000"]
        # drained: nothing queued anymore
        rows = _sess(server).query(
            "select id from information_schema.processlist "
            "where state = 'queued'").rows
        assert not rows
        c1.close()
        c2.close()
    finally:
        boot.execute("set global tidb_stmt_pool_size = 4")
        fail.disarm("admissionDelay")


def test_admission_reject_typed_error_with_retry_hint(server):
    """Queue at capacity -> MySQL 1041 with a retry hint; the connection
    survives and works once pressure clears."""
    boot = _sess(server)
    boot.execute("set global tidb_stmt_pool_size = 1")
    boot.execute("set global tidb_stmt_pool_queue_depth = 1")
    try:
        c1 = MiniClient(server.port, db="sv")
        c2 = MiniClient(server.port, db="sv")
        c3 = MiniClient(server.port, db="sv")
        fail.arm("admissionDelay", sleep=0.8, times=2)
        r0 = adm_stats()["rejected"]
        box = []
        t1 = threading.Thread(
            target=lambda: box.append(c1.query("select count(*) from t")))
        t1.start()
        time.sleep(0.2)  # worker wedged with c1's entry claimed
        t2 = threading.Thread(
            target=lambda: box.append(c2.query("select count(*) from t")))
        t2.start()
        time.sleep(0.2)  # c2 occupies the queue (depth 1)
        with pytest.raises(RuntimeError) as ei:
            c3.query("select count(*) from t")
        assert "1041" in str(ei.value) and "retry" in str(ei.value)
        assert adm_stats()["rejected"] > r0
        t1.join(30)
        t2.join(30)
        assert len(box) == 2
        # pressure gone: the rejected connection retries successfully
        assert c3.query("select 1 + 1")[1] == [["2"]]
        for c in (c1, c2, c3):
            c.close()
    finally:
        boot.execute("set global tidb_stmt_pool_size = 4")
        boot.execute("set global tidb_stmt_pool_queue_depth = 64")
        fail.disarm("admissionDelay")


def test_kill_queued_statement(server):
    """KILL QUERY reaches a statement still WAITING in the admission
    queue: it aborts with 1317 without ever occupying a worker."""
    boot = _sess(server)
    boot.execute("set global tidb_stmt_pool_size = 1")
    try:
        c1 = MiniClient(server.port, db="sv")
        victim = MiniClient(server.port, db="sv")
        victim.query("select 1")
        victim_id = max(server.conns)
        fail.arm("admissionDelay", sleep=1.0, times=1)
        t1 = threading.Thread(
            target=lambda: c1.query("select count(*) from t"))
        t1.start()
        time.sleep(0.2)
        box = []

        def queued_victim():
            try:
                box.append(victim.query("select count(*) from t"))
            except RuntimeError as e:
                box.append(e)
        t2 = threading.Thread(target=queued_victim)
        t2.start()
        time.sleep(0.2)
        killer = MiniClient(server.port)
        killer.query(f"kill query {victim_id}")
        t2.join(10)
        assert not t2.is_alive(), "KILL did not reach the queued statement"
        assert isinstance(box[0], RuntimeError) and "1317" in str(box[0])
        t1.join(30)
        for c in (c1, victim, killer):
            c.close()
    finally:
        boot.execute("set global tidb_stmt_pool_size = 4")
        fail.disarm("admissionDelay")


def test_connection_cap_1040(server):
    """tidb_max_server_connections: over-cap connects get ERR 1040 as
    the first packet, before any handshake."""
    import socket
    import struct
    boot = _sess(server, db="")
    keep = [MiniClient(server.port) for _ in range(2)]
    cap = len(server.conns)
    boot.execute(f"set global tidb_max_server_connections = {cap}")
    try:
        s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        from tinysql_tpu_torch.server.packetio import PacketIO
        d = PacketIO(s).read_packet()
        assert d[0] == 0xFF
        assert struct.unpack_from("<H", d, 1)[0] == 1040
        assert b"Too many connections" in d
        s.close()
        # capacity released -> connects succeed again
        keep.pop().close()
        time.sleep(0.2)
        MiniClient(server.port).close()
    finally:
        boot.execute("set global tidb_max_server_connections = 0")
        for c in keep:
            c.close()


# =========================================================================
# micro-batching
# =========================================================================

def _variants(n):
    return [f"select sum(c), count(*) from t where b < {5 + i}"
            for i in range(n)]


def test_batched_equals_solo_byte_identical(server):
    """The deterministic batch drive: constant variants through one
    batch round return results byte-identical to solo execution, with
    zero compiles and per-query coalesced/dispatch attribution."""
    qs = _variants(6)
    solo = [_sess(server).query(q).rows for q in qs]  # warms + notes family
    digest, _ = stmtsummary.normalize(qs[0])
    assert batching.family_batchable(digest)

    from tinysql_tpu_torch.ops import kernels, progcache
    kernels.prewarm_stacked()  # B-bucket variants warm, like the worker
    st0 = batching.stats_snapshot()
    miss0 = progcache.stats_snapshot()["misses"]
    pool = StatementPool(server.storage)
    sessions = [_sess(server) for _ in qs]
    entries = [_Entry(s, parse(q)[0], q, digest, True)
               for s, q in zip(sessions, qs)]
    pool._run_batch(entries)
    for e, ref in zip(entries, solo):
        assert e.error is None, e.error
        assert repr(e.result.rows) == repr(ref)  # byte-identical
    st = batching.stats_snapshot()
    assert st["batches"] == st0["batches"] + 1
    assert st["occupancy_sum"] == st0["occupancy_sum"] + len(qs)
    assert st["fallbacks"] == st0["fallbacks"]
    # the whole round rode ONE stacked dispatch (6 members -> B=8)
    assert st["stacked_rounds"] == st0["stacked_rounds"] + 1
    assert st["stacked_occupancy_sum"] \
        == st0["stacked_occupancy_sum"] + len(qs)
    assert progcache.stats_snapshot()["misses"] == miss0  # zero compiles
    for s in sessions:
        d = s.last_query_stats.device_totals()
        # occupancy-weighted share of the one stacked dispatch: the sum
        # across members reconciles with the global counter
        assert d.get("coalesced") == 1 and d.get("dispatches", 0) > 0
    total = sum(s.last_query_stats.device_totals().get("dispatches", 0)
                for s in sessions)
    assert total == pytest.approx(1.0)


def test_batch_duplicate_statements_share_round(server):
    """IDENTICAL statements (same digest AND same literals) from
    different clients coalesce; each member still gets its own result."""
    q = "select sum(c), count(*) from t where b < 9"
    ref = _sess(server).query(q).rows
    digest, _ = stmtsummary.normalize(q)
    pool = StatementPool(server.storage)
    sessions = [_sess(server) for _ in range(4)]
    entries = [_Entry(s, parse(q)[0], q, digest, True) for s in sessions]
    st0 = batching.stats_snapshot()
    pool._run_batch(entries)
    for e in entries:
        assert e.error is None and repr(e.result.rows) == repr(ref)
    st = batching.stats_snapshot()
    assert st["replays"] == st0["replays"] + 4
    assert st["fallbacks"] == st0["fallbacks"]


def test_storm_coalesces_over_wire(server):
    """Same-digest constant-variant storm through real wire connections:
    at least one multi-member batch, zero compiles, results equal solo."""
    boot = _sess(server)
    qs = [_variants(12)[i] for i in range(12)]
    solo = {q: _sess(server).query(q).rows for q in qs}
    boot.execute("set global tidb_batch_window_ms = 25")
    boot.execute("set global tidb_stmt_pool_size = 2")
    try:
        st0 = batching.stats_snapshot()
        errs = []

        def client(jobs):
            try:
                c = MiniClient(server.port, db="sv")
                for q in jobs:
                    _, rows = c.query(q)
                    want = [[f"{float(v):.12g}" for v in r]
                            for r in solo[q]]
                    got = [[f"{float(v):.12g}" for v in r] for r in rows]
                    assert want == got, (q, want, got)
                c.close()
            except Exception as e:
                errs.append(e)

        for _attempt in range(3):
            threads = [threading.Thread(
                target=client, args=([qs[(i + j * 4) % len(qs)]
                                      for j in range(3)],))
                for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            st = batching.stats_snapshot()
            if st["batches"] > st0["batches"] \
                    and st["occupancy_sum"] - st0["occupancy_sum"] \
                    > st["batches"] - st0["batches"]:
                break
        assert not errs, errs
        st = batching.stats_snapshot()
        assert st["batches"] > st0["batches"], (st0, st)
        assert st["occupancy_sum"] - st0["occupancy_sum"] \
            > st["batches"] - st0["batches"], "no occupancy > 1"
    finally:
        boot.execute("set global tidb_batch_window_ms = 2")
        boot.execute("set global tidb_stmt_pool_size = 4")


def test_batching_visible_in_statements_summary(server):
    """The coalesced counter flows into statements_summary like any
    other device counter (satellite: obs parity for the batching path)."""
    stmtsummary.STORE.reset()
    qs = _variants(4)
    for q in qs:  # warm + note family (ingests into the fresh window)
        _sess(server).query(q)
    pool = StatementPool(server.storage)
    digest, _ = stmtsummary.normalize(qs[0])
    entries = [_Entry(_sess(server), parse(q)[0], q, digest, True)
               for q in qs]
    pool._run_batch(entries)
    cols = [c for c, _ in stmtsummary.COLUMNS]
    i_coal, i_digest = cols.index("coalesced"), cols.index("digest")
    rows = [r for r in stmtsummary.rows() if r[i_digest] == digest]
    assert rows and rows[0][i_coal] >= len(qs)


def test_killed_member_aborts_inside_batch_round(server):
    """A member whose session was killed never executes in a round —
    it completes with QueryKilled while the other members proceed.
    Covers both round legs: the collect-leg pre-check, and the
    replay-leg pre-check (a parked member's replay would otherwise
    reset the kill flag via guard.begin and silently survive KILL)."""
    from tinysql_tpu_torch.utils.interrupt import QueryKilled
    qs = _variants(3)
    solo = [_sess(server).query(q).rows for q in qs]  # warm + note
    digest, _ = stmtsummary.normalize(qs[0])
    pool = StatementPool(server.storage)
    sessions = [_sess(server) for _ in qs]
    entries = [_Entry(s, parse(q)[0], q, digest, True)
               for s, q in zip(sessions, qs)]
    sessions[1].guard.kill()
    pool._run_batch(entries)
    assert isinstance(entries[1].error, QueryKilled)
    for i in (0, 2):
        assert entries[i].error is None
        assert repr(entries[i].result.rows) == repr(solo[i])
    # replay leg end to end: member 0 parks during collect, then member
    # 1's statement IS the kill of member 0's session — delivered after
    # the park, so only the replay-leg pre-check can honor it
    victim = _sess(server)
    killer = _sess(server)
    group = [
        _Entry(victim, parse(qs[0])[0], qs[0], digest, True),
        _Entry(killer, parse(f"kill query {victim.conn_id}")[0],
               "kill", digest, True),
    ]
    pool._run_batch(group)
    assert group[1].error is None  # the KILL itself succeeded
    assert isinstance(group[0].error, QueryKilled), group[0].error


def test_batch_fallback_after_replica_invalidation(server):
    """A write between a family's executions rotates the replica; the
    coalescer must fall back to solo dispatch (consume misses on the
    staged-array identity) and still return fresh, correct results."""
    s = _sess(server)
    s.execute("create table if not exists inval "
              "(a int primary key, b int, c double)")
    s.execute("delete from inval")
    s.execute("insert into inval values " + ", ".join(
        f"({i}, {i % 7}, {float(i)})" for i in range(500)))
    s.query("select a, b, c from inval")  # hydrate
    q = "select sum(c), count(*) from inval where b < 3"
    before = s.query(q).rows  # warm + note family
    digest, _ = stmtsummary.normalize(q)
    assert batching.family_batchable(digest)
    # collect+park against the CURRENT replica, then invalidate it
    pool = StatementPool(server.storage)
    rnd = batching.BatchRound()
    rnd.collecting = True
    tok = batching.activate(rnd)
    try:
        with pytest.raises(batching.Parked):
            _sess(server).execute_stmt(parse(q)[0], q)
    finally:
        batching.deactivate(tok)
        rnd.collecting = False
    rnd.dispatch()
    s.execute("insert into inval values (1000, 1, 10.0)")
    st0 = batching.stats_snapshot()
    rnd.replaying = True
    tok = batching.activate(rnd)
    try:
        rows = _sess(server).execute_stmt(parse(q)[0], q).rows
    finally:
        batching.deactivate(tok)
        rnd.replaying = False
    st = batching.stats_snapshot()
    # the new row (b=1 < 3, c=10.0) must be visible: stale batch output
    # would return `before`.  The invalidated replica either drops the
    # statement off the fused path entirely (cop re-scan, consume never
    # reached) or rebuilds with fresh arrays (consume misses on leaf
    # identity -> fallback) — what can NEVER happen is a stale replay
    assert rows[0][1] == before[0][1] + 1
    assert rows[0][0] == pytest.approx(before[0][0] + 10.0)
    assert st["replays"] == st0["replays"]


def test_metrics_expose_admission_and_batching(server):
    """Satellite: the serving counters render on /metrics."""
    from tinysql_tpu_torch.obs.metrics import render_prometheus
    text = render_prometheus()
    for name in ("tinysql_admission_admitted_total",
                 "tinysql_admission_queued_total",
                 "tinysql_admission_rejected_total",
                 "tinysql_batch_rounds_total",
                 "tinysql_batch_statements_total",
                 "tinysql_batch_occupancy_sum",
                 "tinysql_pool_queued", "tinysql_pool_running"):
        assert name in text, name


def test_pool_off_runs_on_connection_thread(server):
    """tidb_stmt_pool_size = 0 disables pooling entirely (statements
    execute unpooled but correctly)."""
    boot = _sess(server)
    boot.execute("set global tidb_stmt_pool_size = 0")
    try:
        c = MiniClient(server.port, db="sv")
        assert c.query("select count(*) from t")[1] == [["3000"]]
        c.close()
    finally:
        boot.execute("set global tidb_stmt_pool_size = 4")


def test_pool_size_zero_drains_queued_entries(server):
    """Setting the pool size to 0 with statements already queued must
    DRAIN them (one worker keeps claiming), never strand the waiting
    connections."""
    boot = _sess(server)
    boot.execute("set global tidb_stmt_pool_size = 1")
    try:
        c1 = MiniClient(server.port, db="sv")
        c2 = MiniClient(server.port, db="sv")
        fail.arm("admissionDelay", sleep=0.5, times=1)
        box = []

        def run(c):
            box.append(c.query("select count(*) from t"))
        t1 = threading.Thread(target=run, args=(c1,))
        t1.start()
        time.sleep(0.15)  # worker wedged with c1's entry
        t2 = threading.Thread(target=run, args=(c2,))
        t2.start()
        time.sleep(0.1)   # c2 queued
        boot.execute("set global tidb_stmt_pool_size = 0")
        t1.join(30)
        t2.join(30)
        assert not t1.is_alive() and not t2.is_alive(), \
            "queued statement stranded after pool size -> 0"
        assert [r[1][0][0] for r in box] == ["3000", "3000"]
        c1.close()
        c2.close()
    finally:
        boot.execute("set global tidb_stmt_pool_size = 4")
        fail.disarm("admissionDelay")
