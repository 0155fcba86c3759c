"""Block-wise execution under tidb_device_block_rows, the port against the
reference: copies of the 11 tests of tests/test_blockwise.py, each run
through both packages' sessions under tidb_devpipe = 1 and = 0.

With the block budget (512 rows) below the table sizes (5,000 rows), the
per-operator tier runs block-wise: HashAgg reduces row blocks and carries
partial states on the host (the port: HK7 + HK2 or HK1 per block),
HashJoin streams its probe side in blocks against the resident build keys
(HK3 per block), TopN carries its candidates across blocks (HK4 per
block), and a full Sort orders on the host.  Each query must give the
reference's block-wise rows, the CPU tier's rows and, where the reference
test says so, one program run per block.  Integers, counts, NULLs and row
order exactly; floats within 1e-6 relative (the reference's own bound for
float aggregates: blocks change the order of a float sum).

On the CPU the port's wrappers run their kernels' plain versions; the
kernels are held to those on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import math

import numpy as np
import pytest

from tinysql_tpu.columnar.store import bulk_load as ref_bulk_load
from tinysql_tpu.ops import kernels as ref_kernels
from tinysql_tpu.session.session import new_session as ref_new_session
from tinysql_tpu_torch.columnar.store import bulk_load as port_bulk_load
from tinysql_tpu_torch.ops import kernels as port_kernels
from tinysql_tpu_torch.session import new_session as port_new_session

N = 5000
BLOCK = 512
DEVPIPE = [1, 0]
PKGS = (("ref", ref_new_session, ref_bulk_load, ref_kernels, {}),
        ("port", port_new_session, port_bulk_load, port_kernels,
         {"device": "cpu"}))


def _load(s, bulk, name, schema, cols, nulls=None):
    s.execute(f"create table {name} ({schema})")
    info = s.infoschema().table_by_name("bw", name)
    bulk(s.storage, info, cols, nulls or {})


def _fixture_tables(s, bulk):
    """tests/test_blockwise.py's tables: li (its tk fixture), g (its
    min/max test), fact and d (its join_tk fixture), same seeds."""
    rng = np.random.default_rng(31)
    flag = np.array(["A", "N", "R"])[rng.integers(0, 3, N)]
    status = np.array(["O", "F"])[rng.integers(0, 2, N)]
    qty = rng.random(N) * 50
    price = rng.random(N) * 1000
    disc = rng.integers(0, 11, N) * 0.01
    ship = np.array([f"1998-{m:02d}-{d:02d}" for m, d in
                     zip(rng.integers(1, 13, N), rng.integers(1, 29, N))])
    _load(s, bulk, "li", "id bigint primary key, flag varchar(1), "
          "status varchar(1), qty double, price double, disc double, "
          "ship varchar(10)",
          {"id": np.arange(1, N + 1, dtype=np.int64), "flag": flag,
           "status": status, "qty": qty, "price": price, "disc": disc,
           "ship": ship})
    rng = np.random.default_rng(7)
    x = rng.random(N) * 100
    xnull = rng.random(N) < 0.15
    y = rng.integers(-50, 50, N).astype(np.int64)
    k = rng.integers(0, 9, N).astype(np.int64)
    _load(s, bulk, "g", "a bigint primary key, k bigint, x double, "
          "y bigint",
          {"a": np.arange(1, N + 1, dtype=np.int64), "k": k, "x": x,
           "y": y}, {"x": xnull})
    rng = np.random.default_rng(47)
    _load(s, bulk, "fact", "id bigint primary key, k bigint, v double",
          {"id": np.arange(1, N + 1, dtype=np.int64),
           "k": rng.integers(1, 80, N).astype(np.int64),
           "v": np.round(rng.random(N) * 9, 2)})
    _load(s, bulk, "d", "k bigint primary key, tag bigint",
          {"k": np.arange(1, 80, dtype=np.int64),
           "tag": rng.integers(0, 6, 79).astype(np.int64)})
    s.query("select * from fact")
    s.query("select * from d")


@pytest.fixture(scope="module")
def pair(monkeypatch_module):
    # the reference's join kernels as its device programs, not numpy twins
    monkeypatch_module.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    out = {}
    for name, new, bulk, _, kw in PKGS:
        s = new(**kw)
        s.execute("create database bw")
        s.execute("use bw")
        s.execute("set @@tidb_tpu_min_rows = 0")
        _fixture_tables(s, bulk)
        out[name] = s
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _query(s, q, tpu, block, devpipe):
    s.execute(f"set @@tidb_devpipe = {devpipe}")
    s.execute(f"set @@tidb_use_tpu = {tpu}")
    s.execute(f"set @@tidb_device_block_rows = {block}")
    try:
        return s.query(q).rows
    finally:
        s.execute("set @@tidb_device_block_rows = 0")
        s.execute("set @@tidb_use_tpu = 1")


def _both(pair, q, devpipe):
    """Per package: (block-wise device rows, CPU-tier rows, counters moved
    by the block-wise run) — the reference test's ``_both``."""
    out = {}
    for name, _, _, kern, _ in PKGS:
        s = pair[name]
        snap = kern.stats_snapshot()
        a = _query(s, q, 1, BLOCK, devpipe)
        d = kern.stats_delta(snap)
        b = _query(s, q, 0, 0, devpipe)
        out[name] = (a, b, d)
    return out


def _same(a, b, ordered, what):
    if not ordered:
        key = lambda r: tuple((v is None, str(type(v)), v if v is not None
                               else 0) for v in r)  # noqa: E731
        a, b = sorted(a, key=key), sorted(b, key=key)
    assert len(a) == len(b), (what, len(a), len(b))
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb), (what, ra, rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert math.isclose(x, y, rel_tol=1e-6, abs_tol=1e-9), \
                    (what, ra, rb)
            else:
                assert x == y, (what, ra, rb)


def _check(pair, q, devpipe, ordered=False, min_dispatches=0):
    from tinysql_tpu.executor import devpipe as ref_devpipe
    from tinysql_tpu_torch.executor import devpipe as port_devpipe
    port_devpipe.COMPILED_NODE_KEYS.clear()
    ref_devpipe.COMPILED_NODE_KEYS.clear()
    got = _both(pair, q, devpipe)
    compiled = {k[0] for k in port_devpipe.COMPILED_NODE_KEYS}
    assert compiled == {k[0] for k in ref_devpipe.COMPILED_NODE_KEYS}, q
    pa, pb, pd = got["port"]
    ra, rb, rd = got["ref"]
    _same(pa, ra, ordered, f"port vs reference block-wise: {q}")
    _same(pa, pb, ordered, f"port block-wise vs its CPU tier: {q}")
    _same(ra, rb, ordered, f"reference block-wise vs its CPU tier: {q}")
    if min_dispatches and (devpipe == 0 or not compiled):
        # one program run per block; under tidb_devpipe = 1 a join above
        # an over-budget table may compile as a pipeline through a host
        # leaf instead (both packages do), which runs once
        assert pd["dispatches"] >= min_dispatches, pd
        assert rd["dispatches"] >= min_dispatches, rd
    return got


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_q1_shape_blockwise(pair, devpipe):
    q = ("select flag, status, sum(qty), sum(price), "
         "sum(price * (1 - disc)), avg(qty), avg(disc), count(*) "
         "from li where ship <= '1998-09-02' group by flag, status "
         "order by flag, status")
    got = _check(pair, q, devpipe, min_dispatches=N // BLOCK)
    # one fused program per block
    assert got["port"][2]["pipe_blocks"] >= N // BLOCK


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_q6_shape_blockwise_scalar(pair, devpipe):
    q = ("select sum(price * disc) from li "
         "where ship >= '1998-03-01' and ship < '1998-06-01' "
         "and disc >= 0.03 and disc <= 0.07 and qty < 24")
    got = _check(pair, q, devpipe, min_dispatches=N // BLOCK)
    assert got["port"][2]["pipe_blocks"] >= N // BLOCK


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_min_max_and_nulls(pair, devpipe):
    q = ("select k, min(x), max(x), min(y), max(y), count(x), sum(x) "
         "from g group by k order by k")
    _check(pair, q, devpipe, ordered=True)


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_empty_result(pair, devpipe):
    q = "select sum(price), count(*) from li where qty > 1e9"
    got = _check(pair, q, devpipe)
    assert got["port"][0] == [[None, 0]]  # COUNT 0, SUM NULL via the carry


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_matches_unblocked_device(pair, devpipe):
    q = ("select flag, count(*), sum(price) from li group by flag "
         "order by flag")
    for name in ("ref", "port"):
        s = pair[name]
        a = _query(s, q, 1, BLOCK, devpipe)
        c = _query(s, q, 1, 0, devpipe)
        _same(a, c, True, f"{name}: block-wise vs unblocked device")
    _same(_query(pair["port"], q, 1, BLOCK, devpipe),
          _query(pair["ref"], q, 1, BLOCK, devpipe), True, q)


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_negative_budget_is_ignored(pair, devpipe):
    """A negative tidb_device_block_rows behaves like 0 (unlimited)."""
    q = "select count(*), sum(price) from li"
    for name in ("ref", "port"):
        s = pair[name]
        a = _query(s, q, 1, -1, devpipe)
        b = _query(s, q, 1, 0, devpipe)
        assert a == b and a[0][0] == N, (name, a, b)


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_join_above_budget(pair, devpipe):
    """fact (5000 rows) > budget (512): the probe side streams in blocks
    against the resident build keys."""
    q = ("select d.tag, count(*), sum(fact.v) from fact join d "
         "on fact.k = d.k group by d.tag order by d.tag")
    # the join ran block-wise: >= ceil(5000/512) = 10 match dispatches
    _check(pair, q, devpipe, ordered=True, min_dispatches=10)


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_left_join(pair, devpipe):
    q = ("select fact.id, d.tag from fact left join d "
         "on fact.k = d.k and d.tag < 3 order by fact.id limit 40")
    _check(pair, q, devpipe, ordered=True)


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_topn_above_budget(pair, devpipe):
    """TopN carries its candidate set across blocks: per-block top-k,
    merge, final k — identical rows AND order."""
    q = "select id, k, v from fact order by k desc, v, id limit 100, 25"
    got = _check(pair, q, devpipe, ordered=True)
    assert got["port"][0] == got["ref"][0]  # exact order


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_full_sort_above_budget(pair, devpipe):
    q = "select id, v from fact where k < 40 order by v desc, id limit 4500"
    got = _check(pair, q, devpipe, ordered=True)
    assert got["port"][0] == got["ref"][0]


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_blockwise_join_topn_pipeline(pair, devpipe):
    """join + group-by + TopN over an above-budget table, all under the
    block budget."""
    q = ("select fact.k, sum(fact.v * (1 + d.tag)) as s from fact, d "
         "where fact.k = d.k group by fact.k order by s desc limit 7")
    _check(pair, q, devpipe, ordered=True)


@pytest.mark.parametrize("devpipe", DEVPIPE)
def test_pipeline_depth_zero_and_two_give_the_same_bytes(pair, devpipe,
                                                        monkeypatch):
    """TINYSQL_PIPELINE_DEPTH=0 stages every block inline (no thread, no
    side stream); depth 2 stages on the pipeline's thread.  The fold
    order is block order either way, so the rows are byte-equal."""
    queries = (
        "select flag, status, sum(qty), sum(price * (1 - disc)), avg(disc), "
        "count(*) from li group by flag, status order by flag, status",
        "select sum(price * disc), min(qty), max(price) from li "
        "where disc >= 0.03",
        "select d.tag, count(*), sum(fact.v) from fact join d "
        "on fact.k = d.k group by d.tag order by d.tag",
        "select fact.id, d.tag from fact left join d on fact.k = d.k "
        "and d.tag < 3 order by fact.id limit 40",
        "select id, k, v from fact order by k desc, v, id limit 100, 25")
    s = pair["port"]
    got = {}
    for depth in ("0", "2"):
        monkeypatch.setenv("TINYSQL_PIPELINE_DEPTH", depth)
        snap = port_kernels.stats_snapshot()
        got[depth] = [repr(_query(s, q, 1, BLOCK, devpipe))
                      for q in queries]
        d = port_kernels.stats_delta(snap)
        assert d["pipe_blocks"] >= N // BLOCK, d
    assert got["0"] == got["2"]


# ---- devpipe.BlockPipeline: copies of tests/test_devpipe_pipeline.py's
# unit tests, run on the port's pipeline (CPU device scope) ---------------

@pytest.fixture
def cpu_scope():
    with port_kernels.use_device("cpu"):
        yield


def _pipeline():
    from tinysql_tpu_torch.executor.devpipe import BlockPipeline
    return BlockPipeline


def test_pipeline_order_and_results_preserved(cpu_scope):
    for depth in (0, 1, 2, 4):
        got = list(_pipeline()(lambda i: i * i, range(20), depth=depth))
        assert got == [i * i for i in range(20)], depth


def test_pipeline_depth0_is_synchronous_no_thread(cpu_scope):
    pipe = _pipeline()(lambda i: i, range(5), depth=0)
    assert pipe._thread is None and pipe._side is None
    assert list(pipe) == [0, 1, 2, 3, 4]


def test_pipeline_empty_items(cpu_scope):
    pipe = _pipeline()(lambda i: i, [], depth=2)
    assert list(pipe) == []
    assert not pipe._thread.is_alive()


def test_pipeline_stage_error_reraises_on_caller(cpu_scope):
    """A staging exception surfaces on the consumer at the failed block's
    position; earlier blocks still deliver; the producer exits."""
    def stage(i):
        if i == 3:
            raise ValueError("boom@3")
        return i

    pipe = _pipeline()(stage, range(10), depth=2)
    got = []
    with pytest.raises(ValueError, match="boom@3"):
        for v in pipe:
            got.append(v)
    assert got == [0, 1, 2]
    pipe._thread.join(timeout=5)
    assert not pipe._thread.is_alive()


def test_pipeline_consumer_abandonment_unblocks_producer(cpu_scope):
    staged = []

    def stage(i):
        staged.append(i)
        return i

    pipe = _pipeline()(stage, range(100), depth=1)
    it = iter(pipe)
    assert next(it) == 0
    it.close()  # generator close -> finally -> pipe.close()
    pipe._thread.join(timeout=5)
    assert not pipe._thread.is_alive()
    assert len(staged) < 100


def test_pipeline_producer_runs_ahead_on_its_thread(cpu_scope):
    import threading
    import time
    main = threading.get_ident()
    tids = []

    def stage(i):
        tids.append(threading.get_ident())
        return i

    pipe = _pipeline()(stage, range(8), depth=2)
    out = []
    for v in pipe:
        time.sleep(0.02)  # device-compute stand-in
        out.append(v)
    assert out == list(range(8))
    st = pipe.stats()
    assert st["blocks"] == 8 and st["depth_hwm"] >= 1
    assert tids and all(t != main for t in tids)


def test_pipeline_depth_resolution(monkeypatch):
    from tinysql_tpu_torch.executor.devpipe import pipeline_depth
    from tinysql_tpu_torch.session.session import DEFAULT_SYSVARS
    monkeypatch.delenv("TINYSQL_PIPELINE_DEPTH", raising=False)
    # inline staging by default: uploads from pageable memory leave a
    # side stream nothing to overlap (PERF.md §6)
    assert pipeline_depth(None) == 0
    assert pipeline_depth(DEFAULT_SYSVARS) == 0
    assert pipeline_depth({}) == 0
    assert pipeline_depth({"tidb_pipeline_depth": 5}) == 5
    assert pipeline_depth({"tidb_pipeline_depth": 0}) == 0
    monkeypatch.setenv("TINYSQL_PIPELINE_DEPTH", "3")
    assert pipeline_depth({"tidb_pipeline_depth": 0}) == 3  # env wins
    monkeypatch.setenv("TINYSQL_PIPELINE_DEPTH", "0")
    assert pipeline_depth({"tidb_pipeline_depth": 7}) == 0


def test_pipeline_stage_failpoint_fails_the_statement(pair, monkeypatch):
    """An armed devpipeStageError fails a block-wise statement on the
    consumer, at depth 2 (thread) and 0 (inline); the next statement
    runs."""
    from tinysql_tpu_torch import fail
    s = pair["port"]
    q = "select count(*), sum(price) from li"
    for depth in ("2", "0"):
        monkeypatch.setenv("TINYSQL_PIPELINE_DEPTH", depth)
        with fail.armed("devpipeStageError",
                        exc=RuntimeError("stage lost")):
            with pytest.raises(RuntimeError, match="stage lost"):
                _query(s, q, 1, BLOCK, 0)
        assert _query(s, q, 1, BLOCK, 0)[0][0] == N
