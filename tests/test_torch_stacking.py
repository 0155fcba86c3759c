"""Stacked same-digest batching in the port (K12): one launch of each
batched kernel per round of N coalesced statements.

The port's counterparts of tests/test_stacking.py, against the port's
Server(storage, port=0, device="cpu"): byte-identity with solo execution
across occupancies, the occupancy-bucket keys, attribution that sums to
the global counters on both dispatch legs, the legacy leg for refusals
decided before a launch, KILL of a parked member, identical statements
in one round.  Then what the port adds or does otherwise:

- a stacked round makes ONE call of each batched entry point (HK7b and
  HK1b / HK2b; on the CPU their plain versions, counted in PLAIN_CALLS);
- no fallback: a launch error fails every member of the round, and the
  next round runs on the same path;
- R1: the attribution split (ops/batching.split_exact) is exact under
  math.fsum and a left fold, where the reference's shardops.split_exact
  is exact only under a left fold;
- R2: the module's server runs with ``tidb_auto_prewarm = 0``, so no
  prewarm cycle lands in a window that counts registry misses; one test
  drives a prewarm cycle itself;
- parity: the same rounds through the reference's StatementPool (JAX on
  the CPU) and the port's, over TPC-H at SF=0.02 — integers, counts,
  NULLs and row order equal, floats within 1e-6 relative.
"""
import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from test_server import MiniClient  # noqa: F401  (fixture parity w/ serve)
from tinysql_tpu_torch.columnar.store import bulk_load
from tinysql_tpu_torch.kv import new_mock_storage
from tinysql_tpu_torch.obs import stmtsummary
from tinysql_tpu_torch.ops import batching, kernels, progcache
from tinysql_tpu_torch.ops.exprjit import ParamTable
from tinysql_tpu_torch.parser import parse
from tinysql_tpu_torch.server.pool import StatementPool, _Entry
from tinysql_tpu_torch.server.server import Server
from tinysql_tpu_torch.session.session import Session


@pytest.fixture(scope="module")
def server():
    storage = new_mock_storage()
    srv = Server(storage, port=0, device="cpu")
    srv.start()
    boot = _sess_on(srv)
    # R2: no auto-prewarm cycle may land inside a counted window
    boot.execute("set global tidb_auto_prewarm = 0")
    boot.execute("create database if not exists stk")
    boot.execute("use stk")
    boot.execute("create table t (a int primary key, b int, c double)")
    # the rows of tests/test_stacking.py's table, bulk-loaded (columnar
    # ingest) rather than through one 4000-row INSERT
    i = np.arange(4000)
    bulk_load(storage, boot.infoschema().table_by_name("stk", "t"),
              {"a": i, "b": i % 41, "c": i * 0.5})
    boot.execute("set global tidb_tpu_min_rows = 16")
    boot.execute("select a, b, c from t")  # hydrate the columnar replica
    yield srv
    srv.close()


def _sess_on(server, db=""):
    s = Session(server.storage)
    s.device = server.device
    if db:
        s.execute(f"use {db}")
    return s


def _sess(server):
    return _sess_on(server, "stk")


def _variants(n, lo=3):
    return [f"select sum(c), count(*), max(c) from t where b < {lo + i}"
            for i in range(n)]


def _drive_round(server, qs, stack_max=16):
    """One embedded batch round over ``qs`` (the pool's deterministic
    drive); returns the completed entries."""
    digest, _ = stmtsummary.normalize(qs[0])
    pool = StatementPool(server.storage)
    entries = [_Entry(_sess(server), parse(q)[0], q, digest, True)
               for q in qs]
    pool._run_batch(entries)
    return entries


# =========================================================================
# byte-identity across occupancies + no build on a warm path
# =========================================================================

def test_stacked_equals_solo_across_occupancies(server):
    """Occupancies 2 / 3 / 5 / 8 through the stacked leg: results
    byte-identical to solo execution, no program built once the B-bucket
    variants are registered, one stacked round per drive."""
    qs = _variants(8)
    solo = {q: _sess(server).query(q).rows for q in qs}  # warm + note
    kernels.prewarm_stacked()  # B in {2, 4, 8, 16}, like the worker
    boot = _sess(server)
    boot.execute("set global tidb_batch_stack_max = 16")
    for occ in (2, 3, 5, 8):
        st0 = batching.stats_snapshot()
        miss0 = progcache.stats_snapshot()["misses"]
        entries = _drive_round(server, qs[:occ])
        for e, q in zip(entries, qs[:occ]):
            assert e.error is None, (occ, e.error)
            assert repr(e.result.rows) == repr(solo[q]), (occ, q)
        st = batching.stats_snapshot()
        assert st["stacked_rounds"] == st0["stacked_rounds"] + 1, occ
        assert st["stacked_occupancy_sum"] \
            == st0["stacked_occupancy_sum"] + occ
        assert st["fallbacks"] == st0["fallbacks"]
        assert progcache.stats_snapshot()["misses"] == miss0, \
            f"occupancy {occ} built a program on a warm path"


def test_occupancy_bucket_semantics(server):
    """Occupancy 3 rides the B=4 variant: the first 3-member round may
    register it, after which 3-member AND 4-member rounds are both plain
    hits on the SAME ("stacked", 4)-keyed variant."""
    assert kernels.occupancy_bucket(2) == 2
    assert kernels.occupancy_bucket(3) == 4
    assert kernels.occupancy_bucket(5) == 8
    assert kernels.occupancy_bucket(8) == 8
    qs = _variants(4, lo=20)
    solo = {q: _sess(server).query(q).rows for q in qs}
    _drive_round(server, qs[:3])  # registers the B=4 variant if cold
    stacked_keys = [k for k in progcache.keys("scalar")
                    if kernels.is_stacked_key(k)]
    assert any(k[-1] == ("stacked", 4) for k in stacked_keys), stacked_keys
    miss0 = progcache.stats_snapshot()["misses"]
    st0 = batching.stats_snapshot()
    for qset in (qs[:3], qs[:4]):  # occupancy 3 AND 4 -> the B=4 hit
        for e, q in zip(_drive_round(server, qset), qset):
            assert e.error is None and repr(e.result.rows) == repr(solo[q])
    st = batching.stats_snapshot()
    assert st["stacked_rounds"] == st0["stacked_rounds"] + 2
    assert progcache.stats_snapshot()["misses"] == miss0


def test_stacked_group_by_tree_outputs(server):
    """The fused segment (group-by) path stacks too — "tree" outputs
    slice per member on the device.  Round 1 may register the batchable
    fused program (solo runs can ride the passthrough variant); round 2
    must stack with no build and equal solo by repr.  R2: this module's
    server has the auto-prewarm worker off, so no worker cycle can add
    misses to the window."""
    qs = [f"select b, sum(c), count(*) from t where c < {500.0 + i * 7} "
          "group by b" for i in range(3)]
    solo = {q: _sess(server).query(q).rows for q in qs}
    digest, _ = stmtsummary.normalize(qs[0])
    assert batching.family_batchable(digest)
    _drive_round(server, qs)       # round 1: warms the batchable route
    kernels.prewarm_stacked()
    st0 = batching.stats_snapshot()
    miss0 = progcache.stats_snapshot()["misses"]
    entries = _drive_round(server, qs)
    for e, q in zip(entries, qs):
        assert e.error is None, e.error
        assert repr(e.result.rows) == repr(solo[q])
    st = batching.stats_snapshot()
    assert st["stacked_rounds"] == st0["stacked_rounds"] + 1
    assert progcache.stats_snapshot()["misses"] == miss0


@pytest.mark.parametrize("grouped", [False, True])
def test_stacked_round_is_one_call_of_each_batched_kernel(server, grouped):
    """A stacked round of N members calls HK7b once and HK1b (scalar) or
    HK2b (grouped) once — on the CPU their plain versions — and no solo
    expression or reduction kernel."""
    if grouped:
        qs = [f"select b, max(c), count(*) from t where c < {900.0 + i} "
              "group by b" for i in range(5)]
    else:
        qs = _variants(5, lo=27)
    for q in qs:
        _sess(server).query(q)
    _drive_round(server, qs)  # warms the batchable route
    kernels.prewarm_stacked()
    kernels.reset_kernel_counts()
    st0 = batching.stats_snapshot()
    entries = _drive_round(server, qs)
    assert all(e.error is None for e in entries)
    assert batching.stats_snapshot()["stacked_rounds"] \
        == st0["stacked_rounds"] + 1
    calls = kernels.kernel_counts()["plain_calls"]
    red = "segment_reduce" if grouped else "masked_reduce"
    assert calls["expr_eval_batched"] == 1, calls
    assert calls[f"{red}_batched"] == 1, calls
    assert calls["expr_eval"] == 0 and calls[red] == 0, calls


# =========================================================================
# attribution: member shares sum to the global truth on both legs
# =========================================================================

def _attribution_drive(server, stack_max, occ=3):
    from tinysql_tpu_torch.ops import profiler
    qs = _variants(occ, lo=9)
    solo = {q: _sess(server).query(q).rows for q in qs}
    kernels.prewarm_stacked()
    boot = _sess(server)
    boot.execute(f"set global tidb_batch_stack_max = {stack_max}")
    boot.execute("set global tidb_device_profile_rate = 1")
    try:
        d0 = dict(kernels.STATS)
        entries = _drive_round(server, qs)
        d1 = dict(kernels.STATS)
    finally:
        boot.execute("set global tidb_device_profile_rate = 0")
        boot.execute("set global tidb_batch_stack_max = 16")
        profiler.reset()
    for e, q in zip(entries, qs):
        assert e.error is None and repr(e.result.rows) == repr(solo[q])
    totals = [e.session.last_query_stats.device_totals()
              for e in entries]
    return d0, d1, totals


def test_device_time_attribution_conserved_stacked(server):
    """Profile rate 1 + a stacked round: the members' device_s and
    dispatch shares sum to the global counters' delta (math.fsum: R1)."""
    d0, d1, totals = _attribution_drive(server, stack_max=16)
    disp_delta = d1["dispatches"] - d0["dispatches"]
    dev_delta = d1["device_s"] - d0["device_s"]
    assert disp_delta == 1  # THE one stacked dispatch for the round
    assert math.fsum(t.get("dispatches", 0) for t in totals) == disp_delta
    assert dev_delta > 0
    assert math.fsum(t.get("device_s", 0.0) for t in totals) \
        == pytest.approx(dev_delta, rel=1e-9)
    assert all(t.get("device_s", 0.0) > 0 for t in totals)
    shares = {round(t["device_s"], 12) for t in totals}
    assert len(shares) == 1  # occupancy-weighted: equal splits
    for key in ("h2d_transfers", "h2d_bytes",
                "d2h_transfers", "d2h_bytes"):
        delta = d1[key] - d0[key]
        assert delta > 0, key  # a round moves real data both ways
        assert math.fsum(t.get(key, 0) for t in totals) \
            == pytest.approx(delta, rel=1e-9), key


def test_device_time_attribution_conserved_legacy(server):
    """tidb_batch_stack_max = 0 restores the back-to-back leg — and the
    per-member capture still conserves the sum."""
    d0, d1, totals = _attribution_drive(server, stack_max=0)
    disp_delta = d1["dispatches"] - d0["dispatches"]
    dev_delta = d1["device_s"] - d0["device_s"]
    assert disp_delta == 3  # one solo replay per member
    assert sum(t.get("dispatches", 0) for t in totals) == disp_delta
    assert dev_delta > 0
    assert math.fsum(t.get("device_s", 0.0) for t in totals) \
        == pytest.approx(dev_delta, rel=1e-9)
    assert all(t.get("dispatches") == 1 for t in totals)
    for key in ("h2d_transfers", "h2d_bytes",
                "d2h_transfers", "d2h_bytes"):
        delta = d1[key] - d0[key]
        assert delta > 0, key
        assert math.fsum(t.get(key, 0) for t in totals) \
            == pytest.approx(delta, rel=1e-9), key


# =========================================================================
# refusals before a launch, and no fallback after one
# =========================================================================

def _park(server, qs, stack_max=8):
    rnd = batching.BatchRound(stack_max=stack_max)
    rnd.collecting = True
    tok = batching.activate(rnd)
    try:
        for q in qs:
            with pytest.raises(batching.Parked):
                _sess(server).execute_stmt(parse(q)[0], q)
    finally:
        batching.deactivate(tok)
        rnd.collecting = False
    assert rnd.parked_count == len(qs)
    return rnd


def _replay(server, rnd, qs):
    rnd.replaying = True
    tok = batching.activate(rnd)
    out = []
    try:
        for q in qs:
            try:
                out.append(_sess(server).execute_stmt(parse(q)[0], q).rows)
            except Exception as e:  # noqa: BLE001 — the member's error
                out.append(e)
    finally:
        batching.deactivate(tok)
        rnd.replaying = False
    return out


def test_layout_mismatch_falls_back_to_legacy_leg(server):
    """A parked member whose param vector no longer matches the group's
    slot layout fails ParamTable.stack before any launch — the chunk
    takes the back-to-back leg, results stay correct, stack_fallbacks
    counts the refusal."""
    qs = _variants(2, lo=30)
    solo = {q: _sess(server).query(q).rows for q in qs}
    rnd = _park(server, qs)
    p = rnd._parked[1]  # sabotage member 1's layout: one extra int slot
    p.params = (np.append(p.params[0], np.int64(7)), p.params[1])
    st0 = batching.stats_snapshot()
    assert rnd.dispatch() == 2
    st = batching.stats_snapshot()
    assert st["stack_fallbacks"] == st0["stack_fallbacks"] + 1
    assert st["stacked_rounds"] == st0["stacked_rounds"]
    assert st["batches"] == st0["batches"] + 1
    for rows, q in zip(_replay(server, rnd, qs), qs):
        assert repr(rows) == repr(solo[q])


def test_stacked_dispatch_error_fails_every_member(server):
    """No fallback: kernelDispatchError armed during a stacked round
    fails every member's statement with that error; no member is re-run
    on the legacy leg (no solo dispatch, no stack_fallbacks); the next
    round on the same path succeeds."""
    from tinysql_tpu_torch import fail
    qs = _variants(3, lo=33)
    solo = {q: _sess(server).query(q).rows for q in qs}
    kernels.prewarm_stacked()
    rnd = _park(server, qs)
    st0 = batching.stats_snapshot()
    d0 = kernels.STATS["dispatches"]
    with fail.armed("kernelDispatchError",
                    exc=RuntimeError("card lost mid-round")):
        assert rnd.dispatch() == 3
    got = _replay(server, rnd, qs)
    for r in got:
        assert isinstance(r, RuntimeError) and "card lost" in str(r), r
    st = batching.stats_snapshot()
    assert st["stack_fallbacks"] == st0["stack_fallbacks"]
    assert st["stacked_rounds"] == st0["stacked_rounds"]
    assert st["fallbacks"] == st0["fallbacks"]  # no solo re-dispatch
    assert kernels.STATS["dispatches"] == d0  # the failed call counts none
    entries = _drive_round(server, qs)
    for e, q in zip(entries, qs):
        assert e.error is None and repr(e.result.rows) == repr(solo[q])
    assert batching.stats_snapshot()["stacked_rounds"] \
        == st0["stacked_rounds"] + 1


def test_stack_max_zero_restores_legacy_back_to_back(server):
    """The 0 = legacy knob: rounds still coalesce and stay correct, but
    no stacked dispatch forms."""
    qs = _variants(3, lo=14)
    solo = {q: _sess(server).query(q).rows for q in qs}
    boot = _sess(server)
    boot.execute("set global tidb_batch_stack_max = 0")
    try:
        st0 = batching.stats_snapshot()
        entries = _drive_round(server, qs)
        for e, q in zip(entries, qs):
            assert e.error is None and repr(e.result.rows) == repr(solo[q])
        st = batching.stats_snapshot()
        assert st["batches"] == st0["batches"] + 1
        assert st["stacked_rounds"] == st0["stacked_rounds"]
        assert st["replays"] == st0["replays"] + 3
    finally:
        boot.execute("set global tidb_batch_stack_max = 16")


def test_kill_parked_member_mid_stacked_round(server):
    """A KILL delivered while the member sits PARKED aborts it at the
    replay pre-check; the OTHER stacked member still consumes its slice
    of the one dispatch."""
    from tinysql_tpu_torch.utils.interrupt import QueryKilled
    qs = _variants(3, lo=22)
    solo = {q: _sess(server).query(q).rows for q in qs}
    kernels.prewarm_stacked()
    digest, _ = stmtsummary.normalize(qs[0])
    pool = StatementPool(server.storage)
    victim, other = _sess(server), _sess(server)
    killer = _sess(server)
    group = [
        _Entry(victim, parse(qs[0])[0], qs[0], digest, True),
        _Entry(other, parse(qs[1])[0], qs[1], digest, True),
        # the kill lands during collect of member 3 — AFTER both parks
        _Entry(killer, parse(f"kill query {victim.conn_id}")[0],
               "kill", digest, True),
    ]
    st0 = batching.stats_snapshot()
    pool._run_batch(group)
    st = batching.stats_snapshot()
    assert group[2].error is None            # the KILL itself succeeded
    assert isinstance(group[0].error, QueryKilled), group[0].error
    assert group[1].error is None
    assert repr(group[1].result.rows) == repr(solo[qs[1]])
    assert st["stacked_rounds"] == st0["stacked_rounds"] + 1
    assert st["stacked_occupancy_sum"] == st0["stacked_occupancy_sum"] + 2
    assert st["replays"] == st0["replays"] + 1


def test_duplicate_identical_statements_in_one_stacked_round(server):
    """IDENTICAL statements (same digest AND literals) stack into one
    dispatch; each member consumes its own stored slice."""
    q = _variants(1, lo=17)[0]
    ref = _sess(server).query(q).rows
    kernels.prewarm_stacked()
    st0 = batching.stats_snapshot()
    entries = _drive_round(server, [q] * 4)
    for e in entries:
        assert e.error is None and repr(e.result.rows) == repr(ref)
    st = batching.stats_snapshot()
    assert st["stacked_rounds"] == st0["stacked_rounds"] + 1
    assert st["stacked_occupancy_sum"] == st0["stacked_occupancy_sum"] + 4
    assert st["replays"] == st0["replays"] + 4
    assert st["fallbacks"] == st0["fallbacks"]


def test_prewarm_cycle_registers_stacked_variants(server):
    """One auto-prewarm cycle, driven directly (the module keeps the
    worker off, R2): it warms the hottest family and registers the
    B-bucketed stacked variants of its batchable program."""
    from tinysql_tpu_torch.session import prewarm
    q = "select min(c), count(*) from t where b < 5 and c > 1.5"
    for _ in range(2):
        _sess(server).query(q)
    boot = _sess(server)
    boot.execute("set global tidb_auto_prewarm = 1")
    try:
        s0 = prewarm.stats_snapshot()["stacked_programs"]
        report = server.prewarm.run_cycle()
    finally:
        boot.execute("set global tidb_auto_prewarm = 0")
    assert report["enabled"] and report["warmed"], report
    assert prewarm.stats_snapshot()["stacked_programs"] > s0
    digest, _ = stmtsummary.normalize(q)
    assert batching.family_batchable(digest)
    base = [k for k in progcache.keys("scalar")
            if not kernels.is_stacked_key(k)
            and getattr(progcache.peek(k), "stack_info", None)]
    for key in base:
        for b in (2, 4, 8, 16):
            assert progcache.peek(key + (("stacked", b),)) is not None


# =========================================================================
# primitives
# =========================================================================

def test_paramtable_stack_contract():
    a = (np.array([1, 2], dtype=np.int64), np.array([0.5]))
    b = (np.array([3, 4], dtype=np.int64), np.array([0.7]))
    pi, pf = ParamTable.stack([a, b], 4)
    assert pi.shape == (4, 2) and pf.shape == (4, 1)
    assert pi[1].tolist() == [3, 4]
    # padding rows repeat member 0 (inert)
    assert pi[2].tolist() == pi[0].tolist() == [1, 2]
    assert pf[3].tolist() == [0.5]
    # layout mismatch is a loud ValueError (the legacy-leg trigger)
    with pytest.raises(ValueError):
        ParamTable.stack([a, (np.array([1], dtype=np.int64),
                              np.array([0.7]))])
    # bucket below occupancy is refused
    with pytest.raises(ValueError):
        ParamTable.stack([a, b], 1)
    t = ParamTable()
    t.add_int(9)
    t.add_int(8)
    t.add_real(0.25)
    pi, pf = ParamTable.stack([t, a], 2)
    assert pi[0].tolist() == [9, 8] and pf[0].tolist() == [0.25]


def test_stack_sysvar_validation(server):
    s = _sess(server)
    from tinysql_tpu_torch.session.session import SessionError
    with pytest.raises(SessionError):
        s.execute("set global tidb_batch_stack_max = -1")
    with pytest.raises(SessionError):
        s.execute("set global tidb_batch_stack_max = 1.5")
    s.execute("set global tidb_batch_stack_max = 16")


def test_stacked_metrics_render(server):
    from tinysql_tpu_torch.obs.metrics import render_prometheus
    text = render_prometheus()
    assert "tinysql_batch_stacked_rounds_total" in text
    assert "tinysql_batch_stacked_occupancy_sum" in text


# =========================================================================
# R1: the attribution split is exact
# =========================================================================

_TOTALS = {"dispatches": 1, "device_time_s": 0.777, "h2d_bytes": 123457.0}


def _nested(totals, b, n):
    return [batching.split_exact(m, n)
            for m in batching.split_exact(totals, b)]


def _left_fold(xs):
    acc = 0.0
    for x in xs:
        acc += x
    return acc


def _assert_conserves(totals, b, n):
    cells = _nested(totals, b, n)
    assert len(cells) == b and all(len(row) == n for row in cells)
    for key, v in totals.items():
        flat = [c[key] for row in cells for c in row]
        assert math.fsum(flat) == v, (b, n, key)
        assert _left_fold(_left_fold(c[key] for c in row)
                          for row in cells) == v, (b, n, key)
    for m, row in zip(batching.split_exact(totals, b), cells):
        for key, v in m.items():
            assert math.fsum(c[key] for c in row) == v, key
            assert _left_fold(c[key] for c in row) == v, key


def test_r1_split_exact_conserves():
    """R1: at (b, n) = (7, 8) the reference's split, summed with Python
    3.12's compensated sum(), gives 1.0000000000000002 for `dispatches`.
    The port's shares sum exactly under math.fsum and a left fold."""
    _assert_conserves(_TOTALS, 7, 8)
    cells = _nested(_TOTALS, 7, 8)
    assert math.fsum(c["dispatches"] for row in cells for c in row) == 1
    for b, n in ((2, 8), (3, 4), (5, 2)):
        _assert_conserves(_TOTALS, b, n)


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(b=st.integers(1, 17), n=st.integers(1, 17),
       v=st.one_of(st.integers(0, 1 << 40),
                   st.floats(0, 1e12, allow_nan=False)))
def test_r1_split_exact_conserves_sweep(b, n, v):
    _assert_conserves({"k": v, "dispatches": 1}, b, n)


# =========================================================================
# parity: the same rounds through the reference package and the port
# =========================================================================

SF, SEED = 0.02, 7


@pytest.fixture(scope="module")
def tpch_pair():
    """TPC-H at SF=0.02 in both packages: the reference's storage loaded
    by its tpch.load, the port's replica built from the reference's own
    numpy columns.  Both run their per-operator device tier
    (tidb_devpipe=0, tidb_tpu_min_rows=0) — the reference's JAX programs
    on the CPU, the port's plain kernel versions."""
    from tinysql_tpu.bench import tpch as ref_tpch
    from tinysql_tpu.columnar.store import store_of as ref_store_of
    from tinysql_tpu.session import new_session as ref_new_session
    from tinysql_tpu_torch.bench import tpch as port_tpch
    from tinysql_tpu_torch.columnar.store import replica_from_numpy
    from tinysql_tpu_torch.session import new_session as port_new_session
    from tinysql_tpu.columnar.store import bulk_load as ref_bulk_load
    # lineitem alone: both streams read only it
    ref = ref_new_session()
    ref.execute("create database tpch")
    ref.execute("use tpch")
    ref.execute(ref_tpch.SCHEMAS["lineitem"])
    ref_bulk_load(ref.storage, ref.infoschema().table_by_name(
        "tpch", "lineitem"), ref_tpch.generate(SF, SEED)["lineitem"])
    port = port_new_session(device="cpu")
    port.execute("create database tpch")
    port.execute("use tpch")
    for name in ("lineitem",):
        port.execute(port_tpch.SCHEMAS[name])
        rinfo = ref.infoschema().table_by_name("tpch", name)
        pinfo = port.infoschema().table_by_name("tpch", name)
        rep = ref_store_of(ref.storage).get(rinfo.id)
        by_name = {c.name: c.id for c in rinfo.public_columns()}
        cols = {c.id: rep.columns[by_name[c.name]]
                for c in pinfo.public_columns()}
        replica_from_numpy(port.storage, pinfo, cols, rep.handles)
    for s in (ref, port):
        for v in ("tidb_use_tpu = 1", "tidb_devpipe = 0",
                  "tidb_tpu_min_rows = 0", "tidb_batch_stack_max = 16",
                  "tidb_auto_prewarm = 0"):
            s.execute(f"set global {v}")
    return ref.storage, port.storage


def _pkg_round(storage, qs, port: bool, rounds: int):
    """Warm each statement solo, then drive ``rounds`` batch rounds over
    ``qs`` through the package's own StatementPool; returns (solo rows,
    the last round's rows, stacked rounds in that round)."""
    if port:
        from tinysql_tpu_torch.ops import batching as B
        from tinysql_tpu_torch.parser import parse as P
        from tinysql_tpu_torch.server.pool import StatementPool as SP
        from tinysql_tpu_torch.server.pool import _Entry as E
        from tinysql_tpu_torch.session.session import Session as S
        from tinysql_tpu_torch.obs.stmtsummary import normalize
    else:
        from tinysql_tpu.ops import batching as B
        from tinysql_tpu.parser import parse as P
        from tinysql_tpu.server.pool import StatementPool as SP
        from tinysql_tpu.server.pool import _Entry as E
        from tinysql_tpu.session.session import Session as S
        from tinysql_tpu.obs.stmtsummary import normalize

    def sess():
        s = S(storage)
        if port:
            s.device = "cpu"
        s.execute("use tpch")
        return s
    solo = [sess().query(q).rows for q in qs]
    digest, _ = normalize(qs[0])
    assert B.family_batchable(digest)
    for _ in range(rounds):
        st0 = B.stats_snapshot()["stacked_rounds"]
        entries = [E(sess(), P(q)[0], q, digest, True) for q in qs]
        SP(storage)._run_batch(entries)
        for e in entries:
            assert e.error is None, e.error
    return solo, [e.result.rows for e in entries], \
        B.stats_snapshot()["stacked_rounds"] - st0


def _same_rows(a, b, what):
    assert len(a) == len(b), what
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb), what
        for x, y in zip(ra, rb):
            if isinstance(y, float):
                assert isinstance(x, float), (what, x, y)
                assert math.isclose(x, y, rel_tol=1e-6, abs_tol=1e-9), \
                    (what, x, y)
            else:
                assert x == y, (what, x, y)


@pytest.mark.parametrize("template", ["Q6", "Q1"])
def test_stacked_rounds_match_reference_package(tpch_pair, template):
    """A Q6 stream (the scalar family: HK7b + HK1b) and a Q1 stream (the
    grouped family: HK7b + HK2b) with TPC-H substitution parameters, one
    batch round each through both packages: every member's rows equal the
    reference's (floats within 1e-6 relative), and the port's stacked
    rows equal its solo rows by repr."""
    from tinysql_tpu_torch.bench import tpch as port_tpch
    ref_storage, port_storage = tpch_pair
    rng = np.random.default_rng(5)
    if template == "Q6":
        qs, rounds = port_tpch.q6_stream(rng, 4), 1
    else:
        # round 1 registers the batchable segment program (solo runs
        # ride the device-resident variant); round 2 stacks
        qs, rounds = port_tpch.q1_stream(rng, 3), 2
    want_solo, want, ref_stacked = _pkg_round(ref_storage, qs, False,
                                              rounds)
    solo, got, stacked = _pkg_round(port_storage, qs, True, rounds)
    assert stacked == 1 and ref_stacked == 1, (stacked, ref_stacked)
    for i, q in enumerate(qs):
        assert repr(got[i]) == repr(solo[i]), q
        _same_rows(got[i], want[i], q)
        _same_rows(solo[i], want_solo[i], q)
