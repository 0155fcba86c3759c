"""HK2's present-segment compaction and HK9 run_bounds, on the CPU.

HK2's compaction (``kernels.present_pack``) writes the first present
columns right after a count word and all of them in a body, so a host
consumer pulls the count and the first ``PRESENT_HEAD`` columns in one
transfer and the columns from the body in a second only when there are
more: ``present_rows`` (the pipeline's large outputs)
and the per-operator ``_present_extract`` above ``SMALL_PACK`` segments.
``group_aggregate`` pulls [count, leader rows] the same way.  Here the
plain versions run (the tensors lie on the CPU):

- the port's ``segment_group_aggregate`` and ``group_aggregate`` against
  the reference's on the same seeded inputs (0, 1, ``PRESENT_HEAD``,
  ``PRESENT_HEAD`` + 1 and most segments present above ``SMALL_PACK``;
  Hypothesis-drawn keys with NULLs, NaN and -0.0), with each call's
  ``d2h_transfers`` counted exactly and no tensor read outside a counted
  pull (the watch of tests/test_torch_pulls.py; the plain versions of the
  other kernels a call reaches, which stand for launches on the card, are
  left out of it);
- a numpy model of HK9's tiles and halo (``bench/compactcases.py``, the
  tile read from csrc/run_bounds.cu) against ``run_bounds_plain`` where
  runs cross tile edges, start at a tile's first position, a tile is all
  invalid, at n = 1 and one past a tile.

Tolerance: integers, counts, NULL masks and row order exactly; float sums
to 1e-9 relative (the two sides add in different orders; the reference's
own bound is 1e-6).  tests/test_torch_cuda.py holds both kernels against
their plain versions on the card.
"""
import contextlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import jax.numpy as jnp  # noqa: F401  (the reference runs on the CPU)

from tinysql_tpu.ops import kernels as ref
from tinysql_tpu_torch.bench import compactcases as C
from tinysql_tpu_torch.ops import kernels as port

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


#: the Python-level ways a tensor reaches the host
_HOST_READS = ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
               "__bool__", "__index__", "__array__")
#: plain versions of the kernels these calls reach besides the
#: compaction: launches on the card, where they read nothing back
_KERNELS = ("lex_order_plain", "run_bounds_plain", "segment_reduce_plain")


@contextlib.contextmanager
def _pulls(monkeypatch):
    """Yields a record of one call: ``d2h`` (counted pulls, from
    STATS["d2h_transfers"]) and ``stray`` (tensor -> host reads outside
    kernels.d2h / d2h_many and the plain kernels of ``_KERNELS``)."""
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

    for name in ("d2h", "d2h_many") + _KERNELS:
        monkeypatch.setattr(port, name, counted(getattr(port, name)))
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            watched(name, getattr(torch.Tensor, name)))
    before = port.STATS["d2h_transfers"]
    try:
        yield rec
    finally:
        rec["d2h"] = port.STATS["d2h_transfers"] - before
        monkeypatch.undo()


def _assert_aggs(got, want, what):
    assert len(got) == len(want), what
    for i, ((gv, gm), (wv, wm)) in enumerate(zip(got, want)):
        gv, gm, wv, wm = (np.asarray(x) for x in (gv, gm, wv, wm))
        np.testing.assert_array_equal(gm, wm, err_msg=f"{what} null {i}")
        live = ~wm.astype(bool)
        assert gv.dtype == wv.dtype, (what, i, gv.dtype, wv.dtype)
        if wv.dtype == np.float64:
            np.testing.assert_allclose(gv[live], wv[live], rtol=1e-9,
                                       err_msg=f"{what} value {i}")
        else:
            np.testing.assert_array_equal(gv[live], wv[live],
                                          err_msg=f"{what} value {i}")


_SPECS = [("count_star", False), ("sum", True), ("min", True),
          ("count", True)]

#: present segments of a 2^17-segment aggregate (above SMALL_PACK)
_PRESENT = {"none": 0, "one": 1, "head": HEAD, "head+1": HEAD + 1,
            "most": "most"}


@pytest.mark.parametrize("case", sorted(_PRESENT))
def test_segment_group_aggregate_present_columns(monkeypatch, case):
    """Above SMALL_PACK the present segments come back through HK2's
    compaction: the same ids, aggregates and first rows as the
    reference's, in one counted pull at <= PRESENT_HEAD present, two above,
    and nothing read outside them."""
    ns = 1 << 17
    assert ns > port.SMALL_PACK
    rng = np.random.default_rng(len(case))
    k = _PRESENT[case]
    if k == "most":
        n = ns
        gids = rng.permutation(ns).astype(np.int64)
        mask = rng.random(n) < 0.8
    else:
        n = 20000
        segs = rng.choice(ns, max(k, 1), replace=False)
        gids = segs[np.concatenate([np.arange(len(segs)), rng.integers(
            0, len(segs), n - len(segs))])].astype(np.int64)
        mask = np.ones(n, bool) if k else np.zeros(n, bool)
    cols = [(rng.normal(size=n), rng.random(n) < 0.1),
            (rng.integers(-50, 50, n).astype(np.int64),
             rng.random(n) < 0.2),
            (rng.normal(size=n), rng.random(n) < 0.5)]
    want = ref.segment_group_aggregate(gids, ns, _SPECS, cols, n,
                                       filter_mask=mask)
    with _pulls(monkeypatch) as rec:
        got = port.segment_group_aggregate(gids, ns, _SPECS, cols, n,
                                           filter_mask=mask)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    _assert_aggs(got[1], want[1], case)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    n_present = len(got[0])
    if k != "most":
        assert n_present == k
    assert rec["d2h"] == (1 if n_present <= HEAD else 2), rec
    assert rec["stray"] == []


#: (rows, distinct keys): the extraction's pulls (1 at a bucket <=
#: SMALL_PACK, else 1 or 2 by the present count) and the leaders' (1 at
#: <= PRESENT_HEAD groups, 2 above)
_GROUPS = {"small": (900, 12), "large_few": (70000, 50),
           "large_many": (70000, 9000)}


@pytest.mark.parametrize("case", sorted(_GROUPS))
def test_group_aggregate_pulls(monkeypatch, case):
    """group_aggregate's groups equal the reference's; its pulls are the
    extraction's and one of [count, leader rows] (a second above
    PRESENT_HEAD groups), with no read outside them."""
    n, card = _GROUPS[case]
    rng = np.random.default_rng(n + card)
    keys = [(rng.integers(0, card, n).astype(np.int64),
             rng.random(n) < 0.05),
            (rng.integers(0, 2, n).astype(np.float64), rng.random(n) < 0.05)]
    cols = [(rng.normal(size=n), rng.random(n) < 0.1),
            (rng.integers(-9, 9, n).astype(np.int64), rng.random(n) < 0.1),
            (rng.normal(size=n), rng.random(n) < 0.1)]
    mask = rng.random(n) < 0.9
    want = ref.group_aggregate(keys, _SPECS, cols, n, filter_mask=mask)
    with _pulls(monkeypatch) as rec:
        got = port.group_aggregate(keys, _SPECS, cols, n, filter_mask=mask)
    _same_groups(got, want, case)
    ng = len(got[2])
    nb = port.bucket(n)
    extract = 1 if nb <= port.SMALL_PACK or ng <= HEAD else 2
    assert rec["d2h"] == extract + (1 if ng <= HEAD else 2), (rec, ng)
    assert rec["stray"] == []
    assert (ng > HEAD) == (case == "large_many")


def _same_groups(got, want, what):
    for (gv, gm), (wv, wm) in zip(got[0], want[0]):
        np.testing.assert_array_equal(np.asarray(gm), np.asarray(wm))
        live = ~np.asarray(wm)
        np.testing.assert_array_equal(np.asarray(gv)[live],
                                      np.asarray(wv)[live])
    _assert_aggs(got[1], want[1], what)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))


_FKEYS = st.sampled_from([-2.5, -0.0, 0.0, 1.0, np.nan, np.inf, -np.inf])
_IKEYS = st.integers(-3, 4)


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(data=st.data(), n=st.integers(1, 60),
       lanes=st.sampled_from(["int", "float", "int_float"]))
def test_group_aggregate_sweep(monkeypatch, data, n, lanes):
    """group_aggregate against the reference over drawn keys: NULLs, NaN
    (equal to nothing), -0.0 and +0.0 (equal), one or two key lanes, a
    filter; two counted pulls and no stray read."""
    keys = []
    for kind in {"int": ["i"], "float": ["f"],
                 "int_float": ["i", "f"]}[lanes]:
        vals = data.draw(st.lists(_IKEYS if kind == "i" else _FKEYS,
                                  min_size=n, max_size=n))
        nulls = data.draw(st.lists(st.booleans(), min_size=n, max_size=n))
        keys.append((np.array(vals, np.int64 if kind == "i"
                              else np.float64), np.array(nulls, bool)))
    mask = np.array(data.draw(st.lists(st.sampled_from([True] * 4 + [False]),
                                       min_size=n, max_size=n)), bool)
    rng = np.random.default_rng(n)
    cols = [(rng.normal(size=n), rng.random(n) < 0.2),
            (rng.integers(-9, 9, n).astype(np.int64), rng.random(n) < 0.2),
            (rng.normal(size=n), rng.random(n) < 0.2)]
    want = ref.group_aggregate(keys, _SPECS, cols, n, filter_mask=mask)
    with _pulls(monkeypatch) as rec:
        got = port.group_aggregate(keys, _SPECS, cols, n, filter_mask=mask)
    _same_groups(got, want, lanes)
    assert rec["d2h"] == 2 and rec["stray"] == []


@pytest.mark.parametrize("k", [0, 1, HEAD, HEAD + 1, 20000])
def test_present_rows_pulls(monkeypatch, k):
    """present_rows brings rows 1.. of the present columns: one counted
    pull at <= PRESENT_HEAD present columns (the count rides along), two
    above; nothing read outside them."""
    ns = 1 << 15
    rng = np.random.default_rng(k)
    tab = rng.integers(-(1 << 40), 1 << 40, (5, ns), dtype=np.int64)
    tab[0] = 0
    tab[0, rng.choice(ns, k, replace=False)] = 1
    with _pulls(monkeypatch) as rec:
        got = port.present_rows(torch.from_numpy(tab), ns)
    np.testing.assert_array_equal(got, C.compact_plain(tab, 1, False))
    assert rec["d2h"] == (1 if k <= HEAD else 2) and rec["stray"] == []


@pytest.mark.parametrize("head", [0, 7, HEAD])
@pytest.mark.parametrize("case", sorted(C.COMPACT_CASES))
def test_present_pack_layout(case, head):
    """present_pack's buffer: the count at ``off``, the first ``head``
    present columns after it as rows [w, head], then every present column
    as rows [w, ns]; its size depends on ns, the row count and ``head``
    alone."""
    tab = C.compact_table(case)
    rows, ns = tab.shape
    head = min(head, ns)
    t = torch.from_numpy(tab)
    for lo, ids in ((0, True), (1, False)):
        w = int(ids) + rows - lo
        buf, off = port.present_pack(t, ns, lo, ids, head)
        assert off == 1 + -(-ns // C.PC_TILE)
        assert buf.shape == (off + 1 + w * (head + ns),)
        want = C.compact_plain(tab, lo, ids)
        n = int(buf[off])
        assert n == want.shape[1]
        hd = buf[off + 1:off + 1 + w * head].numpy().reshape(w, head)
        np.testing.assert_array_equal(hd[:, :min(n, head)], want[:, :head])
        body = buf[off + 1 + w * head:].numpy().reshape(w, ns)
        np.testing.assert_array_equal(body[:, :n], want)


def test_mirrored_tiles():
    """The wrappers size the look-back words from the sources' tiles."""
    assert port._HK2_PRESENT_TILE == C.PC_TILE
    assert port._HK9_TILE == C.RB_TILE


def _bounds_plain(perm, valid, keys):
    t = torch.from_numpy
    return port.run_bounds_plain(t(perm), t(valid),
                                 [(t(v), None if m is None else t(m))
                                  for v, m in keys], want_gid=True)


@pytest.mark.parametrize("case", sorted(C.HK9_CASES))
def test_hk9_model_matches_plain(case):
    """The tile model of HK9 (halo, per-(round, warp) leader counts,
    look-back prefix, padding) equals run_bounds_plain at the tile-edge
    shapes, and so does the wrapper."""
    perm, valid, keys = C.hk9_case(case)
    count, lead, ends, gid = C.hk9_model(perm, valid, keys)
    want = _bounds_plain(perm, valid, keys)
    assert count == int(want[0][0])
    for got, exp in zip((lead, ends, gid), want[1:]):
        np.testing.assert_array_equal(got, exp.numpy())
    t = torch.from_numpy
    via = port.run_bounds(t(perm), t(valid), [(t(v), t(m)) for v, m in keys],
                          want_gid=True)
    for a, b in zip(via, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_hk9_model_sorted_lanes(seed):
    """The model over HK4's order of drawn lanes (runs of any length,
    NULL, NaN and +-0.0 keys, a ragged last tile) equals the plain
    version."""
    rng = np.random.default_rng(seed)
    n = 3 * C.RB_TILE + 5 + seed
    fv = rng.integers(-2, 2, n).astype(np.float64)
    fv[rng.random(n) < 0.05] = np.nan
    fv[rng.random(n) < 0.2] = -0.0
    keys = [(rng.integers(0, 4 + 40 * seed, n).astype(np.int64),
             rng.random(n) < 0.1), (fv, rng.random(n) < 0.1)]
    valid = rng.random(n) < (0.9, 0.5, 1.0, 0.0)[seed]
    t = torch.from_numpy
    perm = port.lex_order_plain(port.sort_lanes(
        [(t(v), t(m)) for v, m in keys], [False, False], t(valid)), n)
    got = C.hk9_model(perm.numpy(), valid, keys)
    want = _bounds_plain(perm.numpy(), valid, keys)
    assert got[0] == int(want[0][0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b.numpy())
