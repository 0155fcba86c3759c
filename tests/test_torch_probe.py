"""HK10 semi_pick and HK6 dense_probe, on the CPU.

HK10 answers the build side's two questions of K8's ladder (a valid build
row, a valid build row with a NULL key) with two flags, then ranks and
compacts the kept probe rows in one pass with a decoupled look-back over
tiles of ``probecases.SP_TILE`` rows (the tile read from
csrc/semi_pick.cu).  HK6 takes ``probecases.DP_ROWS`` probe rows a
thread and, where kernels._dense_records says they pay, reads the build
side through one packed record a row.  Here the plain versions run (the
tensors lie on the CPU):

- the port's ``semi_join_match`` against the reference's (its device
  program, TINYSQL_DEVICE_JOIN_ONLY, and its host twin _np_semi_match)
  in semi, anti and NOT IN modes at probe sizes on HK10's tile edges,
  with an empty build side, a NULL build key and NULL probe keys, each
  call's ``d2h_transfers`` exact (one pull at <= PRESENT_HEAD kept rows,
  two above) and no tensor read outside a counted pull;
- a numpy model of HK10's tiles (``bench/probecases.hk10_model``) against
  ``semi_pick_plain`` where kept runs cross tile edges and a tile keeps
  nothing or everything;
- the pipeline's unique joins (K18: inner, left, semi, anti and the
  composite key) through SQL on both packages against the reference's
  devpipe, at probe counts that are not a multiple of DP_ROWS, with NULL
  keys and keys at the ends of int64;
- ``dense_probe`` with 1-, 2-, 4- and 8-byte build lanes (which SQL does
  not reach: the pipeline's lanes are int64 and float64) against a numpy
  statement of its contract, and the wrapper's one buffer and records
  rule.

Tolerance: exact (integers, masks, row order, gathered bytes; SQL floats
as tests/test_torch_devpipe.py compares them).  tests/test_torch_cuda.py
holds both kernels against their plain versions on the card.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (the reference runs on the CPU)

from tinysql_tpu.columnar.store import bulk_load as ref_bulk_load
from tinysql_tpu.executor import devpipe as ref_devpipe
from tinysql_tpu.ops import kernels as ref
from tinysql_tpu.session import new_session as ref_new_session
from tinysql_tpu_torch.bench import probecases as PC
from tinysql_tpu_torch.columnar.store import bulk_load as port_bulk_load
from tinysql_tpu_torch.executor import devpipe
from tinysql_tpu_torch.ops import kernels as port
from tinysql_tpu_torch.session import new_session as port_new_session

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
HEAD = port.PRESENT_HEAD


@pytest.fixture(autouse=True)
def _cpu_device():
    with port.use_device("cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def _reference_registry_unchanged():
    """The reference programs built here leave its process-global
    registry when the module ends (as in tests/test_torch_kernels.py)."""
    from tinysql_tpu.ops import progcache as ref_progcache
    before = set(ref_progcache.keys())
    yield
    with ref_progcache._mu:
        for k in [k for k in ref_progcache._REG if k not in before]:
            ref_progcache._REG.pop(k, None)
            ref_progcache._CATALOG.pop(k, None)


@pytest.fixture
def device_joins(monkeypatch):
    """The reference's DEVICE join programs, not its numpy twins."""
    monkeypatch.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")


#: the Python-level ways a tensor reaches the host
_HOST_READS = ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
               "__bool__", "__index__", "__array__")


@contextlib.contextmanager
def _pulls(monkeypatch):
    """Yields a record of one call: ``d2h`` (counted pulls, from
    STATS["d2h_transfers"]) and ``stray`` (tensor -> host reads outside
    kernels.d2h / d2h_many, which would be uncounted syncs on the card;
    the watch of tests/test_torch_pulls.py)."""
    rec = {"stray": []}
    depth = [0]

    def counted(fn):
        def call(*a, **k):
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return call

    def watched(name, fn):
        def call(self, *a, **k):
            if not depth[0]:
                rec["stray"].append(name)
            return fn(self, *a, **k)
        return call

    monkeypatch.setattr(port, "d2h", counted(port.d2h))
    monkeypatch.setattr(port, "d2h_many", counted(port.d2h_many))
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            watched(name, getattr(torch.Tensor, name)))
    before = port.STATS["d2h_transfers"]
    try:
        yield rec
    finally:
        rec["d2h"] = port.STATS["d2h_transfers"] - before
        monkeypatch.undo()


# ---- HK10: K8's ladder and compaction ---------------------------------------

def _semi_inputs(n: int, build: str, seed: int = 14):
    """Probe keys 0..2n (about half of them in a unique build side of n
    keys), 90% valid; ``build``: "empty" (no build row), "null key" (one
    valid build row with a NULL key), "null probe keys" (10% of the probe
    keys NULL)."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 2 * n + 1, n).astype(np.int64)
    ln = np.zeros(n, bool)
    lv = rng.random(n) < 0.9
    nr = 0 if build == "empty" else n
    rk = rng.permutation(2 * n + 1)[:nr].astype(np.int64)
    rn = np.zeros(nr, bool)
    rv = rng.random(nr) < 0.9
    if build == "null key":
        rn[nr // 2] = rv[nr // 2] = True
    elif build == "null probe keys":
        ln = rng.random(n) < 0.1
    return lk, ln, lv, rk, rn, rv


@pytest.mark.parametrize("build", ["empty", "null key", "null probe keys"])
@pytest.mark.parametrize("mode", list(PC.SEMI_MODES))
@pytest.mark.parametrize("size", list(PC.SP_SIZES))
def test_semi_join_match_at_tile_edges(device_joins, monkeypatch, size, mode,
                                       build):
    """The port's semi_join_match equals the reference's device program
    and host twin at probe sizes 1, one HK10 tile - 1, one tile, one tile
    + 1 and three tiles + 5, and makes exactly one counted pull at <=
    PRESENT_HEAD kept rows and two above, with no other host read."""
    n = PC.SP_SIZES[size]
    anti, null_aware = PC.SEMI_MODES[mode]
    lk, ln, lv, rk, rn, rv = _semi_inputs(n, build)
    args = ((lk, ln), n, (rk, rn), len(rk))
    kw = dict(anti=anti, null_aware=null_aware, lvalid=lv, rvalid=rv)
    with _pulls(monkeypatch) as rec:
        got = port.semi_join_match(*args, **kw)
    want = ref.semi_join_match(*args, **kw)
    twin = ref._np_semi_match(lk, ln, lv, rk, rn, rv, anti, null_aware)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, twin)
    assert rec["d2h"] == (2 if got.size > HEAD else 1), (got.size, rec)
    assert rec["stray"] == [], rec
    if build == "empty" and anti:
        np.testing.assert_array_equal(got, np.nonzero(lv)[0])
    if build == "null key" and null_aware:
        assert got.size == 0


@pytest.mark.parametrize("mode", list(PC.SEMI_MODES))
@pytest.mark.parametrize("case", list(PC.HK10_CASES))
def test_hk10_tile_model_matches_plain(case, mode):
    """The numpy model of HK10's tiles (ranks in (round, warp, lane,
    byte) order, tile prefixes in tile order) gives semi_pick_plain's
    count and kept rows, where kept runs cross tile and thread edges and a
    tile keeps nothing or everything."""
    anti, null_aware = PC.SEMI_MODES[mode]
    arrays = PC.hk10_case(case)
    count, rows = PC.hk10_model(*arrays, anti, null_aware)
    out = port.semi_pick_plain(*[torch.as_tensor(a) for a in arrays], anti,
                               null_aware)
    assert count == int(out[0])
    np.testing.assert_array_equal(rows, out[1:1 + count].numpy())
    if case.endswith("head") and mode == "semi":
        assert count == HEAD
    if case.endswith("head+1") and mode == "semi":
        assert count == HEAD + 1
    if case == "tile all" and mode == "semi":
        assert count == PC.SP_TILE


def test_hk10_tile_mirrors_the_source():
    """The wrapper sizes its one buffer (1 + n_probe output words, three
    scratch words, a look-back word a tile) from kSpTile, mirrored."""
    assert port._HK10_TILE == PC.SP_TILE


# ---- HK6 through SQL: the pipeline's unique joins ---------------------------

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


#: live probe rows of each probe table: none a multiple of DP_ROWS
PROBE_ROWS = (1, 2 * PC.DP_ROWS + 1, 1003)


def _tables(pair):
    """A unique build side ``bd`` (k 1..300, an int and a double lane with
    NULLs, 10% of its rows outside the probe's reach), one near the top
    of int64 ``bx`` (k in [I64_MAX - 99, I64_MAX]), a two-key unique
    ``dk`` (k1 1..20 x k2 1..15); per size in PROBE_ROWS a probe table
    ``pN`` (fk with NULLs and keys outside [1, 300]; e, keys at both ends
    of int64; f1, f2 for the composite, some out of range, f2 with
    NULLs)."""
    rng = np.random.default_rng(31)
    nb = 300
    _load(pair, "bd", "k bigint primary key, v bigint, w double",
          {"k": (np.arange(1, nb + 1, dtype=np.int64), None),
           "v": (rng.integers(-50, 50, nb).astype(np.int64),
                 rng.random(nb) < 0.1),
           "w": (rng.random(nb) * 100, rng.random(nb) < 0.1)})
    top = np.arange(I64_MAX - 99, I64_MAX + 1, dtype=np.int64)
    _load(pair, "bx", "k bigint primary key, v bigint",
          {"k": (rng.permutation(top)[:80], None),
           "v": (rng.integers(0, 9, 80).astype(np.int64), None)})
    k1, k2 = np.meshgrid(np.arange(1, 21), np.arange(1, 16), indexing="ij")
    _load(pair, "dk", "id bigint primary key, k1 bigint, k2 bigint, "
                      "v double",
          {"id": (np.arange(1, 301, dtype=np.int64), None),
           "k1": (k1.reshape(-1).astype(np.int64), None),
           "k2": (k2.reshape(-1).astype(np.int64), None),
           "v": (rng.random(300) * 10, None)})
    for s in pair:
        s.execute("create unique index uk on dk (k1, k2)")
    ends = np.array([I64_MIN, I64_MIN + 1, -1, 0, I64_MAX - 100,
                     I64_MAX - 99, I64_MAX - 1, I64_MAX], np.int64)
    for n in PROBE_ROWS:
        _load(pair, f"p{n}", "id bigint primary key, fk bigint, e bigint, "
                             "f1 bigint, f2 bigint, x double",
              {"id": (np.arange(1, n + 1, dtype=np.int64), None),
               "fk": (rng.integers(-20, 330, n).astype(np.int64),
                      rng.random(n) < 0.1),
               "e": (np.where(rng.random(n) < 0.5, ends[rng.integers(
                   0, len(ends), n)], rng.integers(I64_MAX - 120, I64_MAX,
                                                   n)).astype(np.int64),
                     rng.random(n) < 0.05),
               "f1": (rng.integers(0, 23, n).astype(np.int64), None),
               "f2": (rng.integers(0, 18, n).astype(np.int64),
                      rng.random(n) < 0.05),
               "x": (rng.random(n) * 100, None)})


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("TINYSQL_DEVICE_JOIN_ONLY", "1")
    ref_s = _session(ref_new_session)
    port_s = _session(port_new_session, device="cpu")
    _tables((ref_s, port_s))
    yield ref_s, port_s
    mp.undo()


@pytest.fixture
def kinds(monkeypatch):
    """Node kinds each package's pipeline builder keyed in the last
    query."""
    seen = {"ref": set(), "port": set()}
    for name, mod in (("ref", ref_devpipe), ("port", devpipe)):
        orig = mod._PipeBuilder.key

        def key(self, part, orig=orig, name=name):
            seen[name].add(part[0])
            return orig(self, part)
        monkeypatch.setattr(mod._PipeBuilder, "key", key)
    return seen


def _same_rows(got, want, what):
    def cell(v):
        if v is None:
            return ("N", 0.0)
        return ("f", round(v, 6)) if isinstance(v, float) else \
            (type(v).__name__, v)
    assert len(got) == len(want), (what, len(got), len(want))
    got = sorted(got, key=lambda r: [cell(x) for x in r])
    want = sorted(want, key=lambda r: [cell(x) for x in r])
    for rg, rw in zip(got, want):
        for x, y in zip(rg, rw):
            if isinstance(y, float):
                assert isinstance(x, float) and math.isclose(
                    x, y, rel_tol=1e-6, abs_tol=1e-9), (what, x, y)
            else:
                assert x == y, (what, x, y)


#: query -> (SQL over probe table {p}, the node kind HK6 runs under)
JOINS = {
    "inner": ("select {p}.id, bd.v, bd.w from {p} join bd "
              "on {p}.fk = bd.k", "join"),
    "left": ("select {p}.id, {p}.fk, bd.v, bd.w from {p} left join bd "
             "on {p}.fk = bd.k", "join"),
    "filtered build": ("select {p}.id, bd.w from {p} join bd "
                       "on {p}.fk = bd.k where bd.v > 0 and {p}.x < 70",
                       "join"),
    "semi": ("select {p}.id from {p} where {p}.fk in (select k from bd "
             "where v > -20)", "semijoin"),
    "anti": ("select {p}.id, {p}.fk from {p} where not exists (select 1 "
             "from bd where bd.k = {p}.fk)", "semijoin"),
    "int64 ends inner": ("select {p}.id, {p}.e, bx.v from {p} join bx "
                         "on {p}.e = bx.k", "join"),
    "int64 ends left": ("select {p}.id, bx.v from {p} left join bx "
                        "on {p}.e = bx.k", "join"),
    "composite inner": ("select {p}.id, dk.v from {p} join dk "
                        "on {p}.f1 = dk.k1 and {p}.f2 = dk.k2", "joinmk"),
    "composite left": ("select {p}.id, dk.id, dk.v from {p} left join dk "
                       "on {p}.f1 = dk.k1 and {p}.f2 = dk.k2", "joinmk"),
}


@pytest.mark.parametrize("n", PROBE_ROWS)
@pytest.mark.parametrize("query", list(JOINS))
def test_pipeline_unique_joins_match_reference(pair, kinds, query, n):
    """K18's unique modes (inner, left, semi, anti, composite) through
    SQL on both packages' pipelines: the same rows, the same node kinds
    and the same pulls, with HK6 (its plain version here) run at least
    once."""
    ref_s, port_s = pair
    sql = JOINS[query][0].format(p=f"p{n}")
    for k in kinds.values():
        k.clear()
    want = ref_s.query(sql).rows
    want_d2h = int(ref_s.last_query_stats.device_totals().get(
        "d2h_transfers", 0))
    port.reset_kernel_counts()
    got = port_s.query(sql).rows
    _same_rows(got, want, sql)
    assert kinds["port"] == kinds["ref"], (sql, kinds)
    assert JOINS[query][1] in kinds["port"], kinds
    assert port.kernel_counts()["plain_calls"]["dense_probe"] >= 1
    assert int(port_s.last_query_stats.device_totals().get(
        "d2h_transfers", 0)) == want_d2h, sql


# ---- HK6 at the wrapper: lane widths, the buffer, the records rule ----------

def _torch_args(args):
    kp, kn, pv, lo, hi, tb, bv, bl = args
    t = torch.as_tensor
    return (t(kp), t(kn), t(pv), lo, hi, t(tb), t(bv),
            [(t(v), None if m is None else t(m)) for v, m in bl])


@pytest.mark.parametrize("mode", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("lo", [-50, I64_MAX - 299, I64_MIN])
@pytest.mark.parametrize("nb", PC.DP_SIZES)
def test_dense_probe_lane_widths_match_contract(nb, lo, mode):
    """dense_probe with five build lanes of 1, 2, 4, 8 and 1 bytes (NULL
    masks on some), probe keys outside the table's range, NULL, and at
    both ends of int64, against the contract in numpy: the valid mask,
    and for inner and left every lane gathered at clip(pos, 0, nbb - 1)
    with its NULL flag or-ed with "unmatched", unmatched slots
    included."""
    args = PC.hk6_case(nb, 5, lo)
    valid, lanes = port.dense_probe(*_torch_args(args), mode)
    want_valid, want_lanes = PC.hk6_plain(*args, mode)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert len(lanes) == len(want_lanes)
    for (v, m), (wv, wm) in zip(lanes, want_lanes):
        assert v.dtype == torch.as_tensor(wv).dtype
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(m.numpy(), wm)


def test_dense_probe_seventeen_lanes_match_contract():
    """More lanes than one launch takes (kMaxLanes = 16): all 17 come
    back gathered, in order."""
    args = PC.hk6_case(PC.DP_SIZES[3], 17, -50)
    valid, lanes = port.dense_probe(*_torch_args(args), "left")
    want_valid, want_lanes = PC.hk6_plain(*args, "left")
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert len(lanes) == 17
    for (v, m), (wv, wm) in zip(lanes, want_lanes):
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(m.numpy(), wm)


@pytest.mark.parametrize("lanes", [0, 1, 2, 5, 16, 17])
@pytest.mark.parametrize("nb", [1, 13, 1 << 21])
def test_dense_probe_buffer_plan(nb, lanes):
    """HK6's one buffer: the mask at 0, each lane's values and NULL flags
    at 16-byte boundaries, none overlapping, then room for the records of
    the largest launch; a launch of at most kMaxLanes lanes each."""
    widths = [1, 2, 4, 8]
    bl = [(torch.zeros(1, dtype=(torch.bool, torch.int16, torch.int32,
                                 torch.int64)[j % 4]), None)
          for j in range(lanes)]
    nbb, tbl_len = 1 << 18, 150_000
    at, sws, rec_at, total = port._probe_plan(nb, nbb, tbl_len, bl)
    assert len(sws) == max(1, -(-lanes // 16))
    end = nb
    for j, (ov, on) in enumerate(at):
        w = widths[j % 4]
        assert ov % 16 == 0 and on % 16 == 0 and ov >= end
        assert on >= ov + nb * w
        end = on + nb
    assert rec_at % 16 == 0 and rec_at >= end
    for k, sw in enumerate(sws):
        chunk = min(lanes - 16 * k, 16)
        assert sw % 2 == 0 and (sw == 0 or sw >= 1 + chunk)
        assert total >= rec_at + 8 * sw * (tbl_len + 1)


def test_dense_records_rule_at_the_measured_shapes():
    """The records rule on the shapes that set it (kernels._dense_records,
    measured by bench/probe_bench.py): Q3's join 1 reads records, in every
    mode and with 16 lanes; join 2 (a 6M-slot table) and the composite
    probe (2M slots) take the row path; so does a probe too small to pay
    for the pack."""
    def lanes(n, dtype=torch.int64, null=True):
        return [(torch.zeros(1, dtype=dtype),
                 torch.zeros(1, dtype=torch.bool) if null else None)] * n
    nb = 1 << 21
    assert port._dense_records(nb, 1 << 18, 150_000, lanes(2)) == 4
    assert port._dense_records(nb, 1 << 18, 150_000, lanes(16)) == 18
    assert port._dense_records(nb, 1 << 18, 150_000,
                               lanes(1, torch.bool)) == 2
    assert port._dense_records(nb, 1 << 18, 150_000, []) == 2
    assert port._dense_records(nb, 1 << 21, 5_999_994, lanes(2)) == 0
    assert port._dense_records(nb, 1 << 20, 2_000_000, lanes(2)) == 0
    assert port._dense_records(16, 1 << 18, 150_000, lanes(2)) == 0
