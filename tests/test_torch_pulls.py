"""Host pulls of the port's join paths, and HK1's order of work, on the CPU.

HK3's unique probe writes its pairs into one packed buffer, [count, li_0,
ri_0, ...] (``kernels.equi_join_unique_packed``), and makes no host pull
before them: ``unique_join_match`` pulls an outer join's pairs in one exact
transfer (the output size is the host's count of valid probe rows), an
inner join's count and first ``PRESENT_HEAD`` pairs in one, the rest in a
second only when there are more; ``join_match`` pulls its output size, then
its pairs; ``semi_join_match`` its kept rows as before.  Here the packed
plain path runs (the tensors lie on the CPU) and is held to the
reference's device programs (``TINYSQL_DEVICE_JOIN_ONLY=1``) over
Hypothesis-drawn keys, NULLs, masks and both join kinds; each call's
``d2h_transfers`` is counted exactly, and no tensor reaches the host
outside a counted pull.

HK1 (csrc/masked_reduce.cu) folds in an order its numpy model
(``tinysql_tpu_torch/bench/hk1model.py``, constants read from the source)
describes: the model agrees with ``masked_reduce_plain`` (integers and
counts exactly, float sums within 1e-6 relative, the reference's bound)
at Q6's shape cut to 2^16 rows and at the edge shapes, a member of a batch
equals its solo call bit for bit, and the wrapper's mirrored plan equals
the source's.  tests/test_torch_cuda.py holds the kernel to the model on
the card.
"""
import contextlib
import math
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import jax.numpy as jnp  # noqa: F401  (the reference runs on the CPU)

from tinysql_tpu.ops import kernels as ref
from tinysql_tpu_torch.bench import hk1model as M
from tinysql_tpu_torch.ops import kernels as port

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
_CSRC = os.path.join(os.path.dirname(port.__file__), os.pardir, "csrc")


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
    kernels.d2h / d2h_many, which would be uncounted syncs on the card)."""
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


def _inputs(seed, nl, nr, lo, hi, unique=False):
    rng = np.random.default_rng(seed)
    lk = rng.integers(lo, hi, nl, endpoint=True).astype(np.int64)
    rk = (rng.permutation(nr).astype(np.int64) + lo if unique
          else rng.integers(lo, hi, nr, endpoint=True).astype(np.int64))
    return (lk, rng.random(nl) < 0.1, rng.random(nl) < 0.9,
            rk, rng.random(nr) < 0.1, rng.random(nr) < 0.9)


# ---- the packed plain path against the reference --------------------------

_KEYS = {
    "small": st.integers(-3, 12),
    "extremes": st.sampled_from([I64_MIN, I64_MIN + 1, -1, 0, 1,
                                 I64_MAX - 1, I64_MAX]),
    "float": st.sampled_from([-2.5, -0.0, 0.0, 0.5, 1.0, 1e300, -np.inf,
                              np.inf]),
}


@st.composite
def _join_case(draw, unique_build):
    kind = draw(st.sampled_from(sorted(_KEYS)))
    keys = _KEYS[kind]
    nl = draw(st.integers(0, 40))
    nr = draw(st.integers(0, 30))
    lk = draw(st.lists(keys, min_size=nl, max_size=nl))
    if unique_build:
        rk = draw(st.lists(keys, max_size=nr, unique_by=(
            lambda x: 0.0 if x == 0 else x)))
        nr = len(rk)
    else:
        rk = draw(st.lists(st.one_of(keys, st.sampled_from(lk or [0])),
                           min_size=nr, max_size=nr))

    def bools(n, p):
        return np.array(draw(st.lists(st.sampled_from(
            [True] * p + [False] * (10 - p)), min_size=n, max_size=n)),
            dtype=bool)
    dt = np.float64 if kind == "float" else np.int64
    return (np.array(lk, dtype=dt), bools(nl, draw(st.sampled_from([0, 2]))),
            bools(nl, 9), np.array(rk, dtype=dt),
            bools(nr, draw(st.sampled_from([0, 1, 3]))),
            bools(nr, draw(st.sampled_from([10, 8, 0]))))


_SWEEP = settings(max_examples=40, deadline=None, derandomize=True,
                  suppress_health_check=[HealthCheck.function_scoped_fixture,
                                         HealthCheck.too_slow])


@_SWEEP
@given(case=_join_case(unique_build=True), outer=st.booleans())
def test_unique_join_match_sweep(device_joins, case, outer):
    """unique_join_match through the packed plain path equals the
    reference's device program: keys of every kind, NULLs, validity
    masks, empty sides, inner and outer."""
    lk, ln, lv, rk, rn, rv = case
    args = ((lk, ln), len(lk), (rk, rn), len(rk))
    got = port.unique_join_match(*args, outer=outer, lvalid=lv, rvalid=rv)
    want = ref.unique_join_match(*args, outer=outer, lvalid=lv, rvalid=rv)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@_SWEEP
@given(case=_join_case(unique_build=False), outer=st.booleans())
def test_join_match_sweep(device_joins, case, outer):
    """join_match (its two phases and the counted pull between them)
    equals the reference's device program, duplicate build keys
    included."""
    lk, ln, lv, rk, rn, rv = case
    args = ((lk, ln), len(lk), (rk, rn), len(rk))
    got = port.join_match(*args, outer=outer, lvalid=lv, rvalid=rv)
    want = ref.join_match(*args, outer=outer, lvalid=lv, rvalid=rv)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@_SWEEP
@given(case=_join_case(unique_build=False),
       mode=st.sampled_from([(False, False), (True, False), (True, True)]))
def test_semi_join_match_sweep(device_joins, case, mode):
    """semi_join_match (HK3's membership, no pull, then HK10's kept rows)
    equals the reference's device program in the semi, anti and NOT IN
    modes."""
    lk, ln, lv, rk, rn, rv = case
    if not len(lk):
        return  # the reference's semi kernel takes at least one probe row
    anti, null_aware = mode
    args = ((lk, ln), len(lk), (rk, rn), len(rk))
    got = port.semi_join_match(*args, anti=anti, null_aware=null_aware,
                               lvalid=lv, rvalid=rv)
    want = ref.semi_join_match(*args, anti=anti, null_aware=null_aware,
                               lvalid=lv, rvalid=rv)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("keys", ["dense", "wide", "extremes"])
def test_packed_buffer_layout(outer, keys):
    """[count, li_0, ri_0, ...]: the pairs of equi_join_unique_plain,
    interleaved after the count, li ascending."""
    lo, hi = {"dense": (0, 60), "wide": (-(1 << 50), 1 << 50),
              "extremes": (I64_MAX - 40, I64_MAX)}[keys]
    lk, ln, lv, rk, rn, rv = (torch.as_tensor(a) for a in
                              _inputs(4, 300, 90, lo, hi))
    out = port.equi_join_unique_packed(lk, ln, lv, rk, rn, rv, outer=outer)
    li, ri = port.equi_join_unique_plain(lk, ln, lv, rk, rn, rv, outer)
    n = int(out[0])
    assert out.shape == (1 + 2 * len(lk),) and n == len(li)
    assert torch.equal(out[1:1 + 2 * n:2], li)
    assert torch.equal(out[2:2 + 2 * n:2], ri)
    assert bool((li[1:] > li[:-1]).all())
    got = port.equi_join_unique(lk, ln, lv, rk, rn, rv, outer=outer)
    assert torch.equal(got[0], li) and torch.equal(got[1], ri)


@pytest.mark.parametrize("outer", [False, True])
def test_mult_phases_equal_the_plain_version(outer):
    """equi_join_mult's two phases (the output size as a device tensor,
    then the pairs) equal equi_join_mult_plain."""
    lk, ln, lv, rk, rn, rv = (torch.as_tensor(a) for a in
                              _inputs(5, 500, 200, 0, 40))
    plan, total = port.equi_join_mult_count(lk, ln, lv, rk, rn, rv, outer)
    assert total.shape == (1,) and total.dtype == torch.int64
    li, ri = port.equi_join_mult_expand(plan, int(total[0]))
    want = port.equi_join_mult_plain(lk, ln, lv, rk, rn, rv, outer)
    assert torch.equal(li, want[0]) and torch.equal(ri, want[1])


# ---- pulls per call ---------------------------------------------------------

_PULL_CASES = {
    # (probe rows, build rows, key range, outer): pairs vs PRESENT_HEAD
    "outer_small": (600, 200, 400, True),
    "outer_large": (9000, 3000, 4000, True),
    "inner_small": (600, 200, 400, False),
    "inner_large": (9000, 3000, 4000, False),
    "inner_empty": (300, 100, 0, False),
}


@pytest.mark.parametrize("case", sorted(_PULL_CASES))
def test_unique_join_match_pulls(monkeypatch, case):
    """One counted pull for an outer join (exactly its pairs) and for an
    inner join whose pairs fit PRESENT_HEAD, two above it; nothing reaches
    the host outside them."""
    nl, nr, span, outer = _PULL_CASES[case]
    lk, ln, lv, rk, rn, rv = _inputs(6, nl, nr, 0, nr - 1, unique=True)
    if span == 0:
        lk = lk + 10 * nr  # no probe key matches
    args = ((lk, ln), nl, (rk, rn), nr)
    with _pulls(monkeypatch) as rec:
        li, ri = port.unique_join_match(*args, outer=outer, lvalid=lv,
                                        rvalid=rv)
    want = ref._np_unique_join(lk, ln, lv, rk, rn, rv, outer)
    np.testing.assert_array_equal(li, want[0])
    np.testing.assert_array_equal(ri, want[1])
    big = len(li) > port.PRESENT_HEAD
    assert big == case.endswith("large")
    assert rec["d2h"] == (2 if big and not outer else 1), rec
    assert rec["stray"] == [], rec


@pytest.mark.parametrize("outer", [False, True])
def test_unique_join_match_outer_with_no_valid_row_pulls_nothing(
        monkeypatch, outer):
    """An outer join whose probe side has no valid row knows its empty
    output on the host: no pull; an inner one pulls the count once."""
    lk, ln, lv, rk, rn, rv = _inputs(7, 50, 20, 0, 19, unique=True)
    with _pulls(monkeypatch) as rec:
        li, ri = port.unique_join_match((lk, ln), 50, (rk, rn), 20,
                                        outer=outer,
                                        lvalid=np.zeros(50, bool), rvalid=rv)
    assert li.size == 0 and ri.size == 0
    assert rec["d2h"] == (0 if outer else 1) and rec["stray"] == []


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("dups", [1, 4])
def test_join_match_pulls_twice(monkeypatch, outer, dups):
    """join_match: the output size, then the pairs (2 counted pulls, none
    uncounted)."""
    lk, ln, lv, rk, rn, rv = _inputs(8, 700, 300 * dups, 0, 300)
    with _pulls(monkeypatch) as rec:
        li, ri = port.join_match((lk, ln), 700, (rk, rn), 300 * dups,
                                 outer=outer, lvalid=lv, rvalid=rv)
    want = ref.join_match((lk, ln), 700, (rk, rn), 300 * dups, outer=outer,
                          lvalid=lv, rvalid=rv)
    np.testing.assert_array_equal(li, np.asarray(want[0]))
    np.testing.assert_array_equal(ri, np.asarray(want[1]))
    assert rec["d2h"] == 2 and rec["stray"] == [], rec


@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("anti,null_aware", [(False, False), (True, False),
                                             (True, True)])
def test_semi_join_match_pulls(monkeypatch, large, anti, null_aware):
    """semi_join_match: HK3's membership makes no pull; HK10's kept rows
    come in one pull when they fit PRESENT_HEAD, two above it."""
    nl = 9000 if large else 500
    nr = 300 if anti else 6000  # most probe keys miss / hit the build
    lk, ln, lv, rk, rn, rv = _inputs(9, nl, nr, 0, 5999, unique=True)
    rn = np.zeros_like(rn)
    with _pulls(monkeypatch) as rec:
        got = port.semi_join_match((lk, ln), nl, (rk, rn), nr, anti=anti,
                                   null_aware=null_aware, lvalid=lv,
                                   rvalid=rv)
    np.testing.assert_array_equal(got, ref._np_semi_match(
        lk, ln, lv, rk, rn, rv, anti, null_aware))
    assert (got.size > port.PRESENT_HEAD) == large
    assert rec["d2h"] == (2 if large else 1) and rec["stray"] == [], rec


def test_the_watch_sees_an_uncounted_read(monkeypatch):
    """The watch itself: an item() outside d2h is recorded, one inside
    is not."""
    t = torch.arange(4)
    with _pulls(monkeypatch) as rec:
        t[1].item()
        port.d2h(t)
    assert rec["stray"] == ["item"] and rec["d2h"] == 1


# ---- HK1's order of work ----------------------------------------------------

def _src_const(path: str, name: str) -> int:
    src = open(os.path.join(_CSRC, path)).read()
    return int(re.search(rf"constexpr (?:int|int64_t) {name} = (\d+);",
                         src).group(1))


def test_mirrored_constants_match_the_sources():
    """The wrappers size their scratch from constants mirrored from the
    sources: they must agree."""
    assert port._HK1_TILE == M.THREADS * M.WORD
    assert port._HK1_MAX_BLOCKS == M.MAX_BLOCKS
    for n in (0, 1, 16, 4095, 4096, 4097, 1 << 20, (1 << 22) + 1, 1 << 23,
              4096 * 1024 + 1, 3 << 24):
        assert port._hk1_blocks(n) == M.plan(n)[1], n
    hdr = _src_const("equi_join.cu", "kHdrWords")
    stat = _src_const("equi_join.cu", "kStatBlocks")
    threads = _src_const("equi_join.cu", "kThreads")
    rows = _src_const("equi_join.cu", "kPickRows")
    assert port._HK3_ZERO_OFF == hdr + 3 * stat
    assert port._HK3_PICK_TILE == threads * rows
    assert _src_const("equi_join.cu", "kHashMin") == 1024
    assert port.dense_ok(1 << 22, 0) and not port.dense_ok((1 << 22) + 1, 0)
    assert port.dense_ok(4 * 5_000_000, 5_000_000)


def _q6_case(n, seed, sel=0.02, nmem=None):
    rng = np.random.default_rng(seed)
    shp = n if nmem is None else (nmem, n)
    valid = rng.random(shp) < sel
    price = np.round(rng.uniform(900.0, 105000.0, shp), 2)
    return valid, [(price, np.zeros(n, bool), "sum")]


def _edge_case(n, seed):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.6
    vi = rng.integers(-5, 5, n).astype(np.int64)
    vi[:min(n, 4)] = [I64_MAX, I64_MIN, I64_MAX, I64_MIN][:min(n, 4)]
    vf = rng.normal(size=n) * 1e6
    return valid, [(vi, rng.random(n) < 0.3, "sum"), (vi, None, "min"),
                   (vi, None, "max"), (vf, np.ones(n, bool), "sum"),
                   (vf, rng.random(n) < 0.5, "min"), (vf, None, "max"),
                   (vf, None, "sum"), (None, rng.random(n) < 0.5, "count")]


def _torch_lanes(lanes):
    return [(None if v is None else torch.as_tensor(v),
             None if m is None else torch.as_tensor(m), op)
            for v, m, op in lanes]


def _same_within(got, want, lanes, what):
    """Integers and counts exactly, float sums within 1e-6 relative."""
    got, want = np.asarray(got), np.asarray(want)
    assert got[0] == want[0] and got[1] == want[1], what
    for j, (v, _m, op) in enumerate(lanes):
        assert got[3 + 2 * j] == want[3 + 2 * j], (what, j)
        if v is not None and np.asarray(v).dtype == np.float64:
            a, b = (x[2 + 2 * j:3 + 2 * j].view(np.float64)[0]
                    for x in (got, want))
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=what)
        else:
            assert got[2 + 2 * j] == want[2 + 2 * j], (what, j, op)


_SHAPES = {
    "q6_2^16": lambda: _q6_case(1 << 16, 1),
    "n0": lambda: _edge_case(0, 2),
    "n1": lambda: _edge_case(1, 3),
    "n16": lambda: _edge_case(16, 4),
    "one_past_a_block": lambda: _edge_case(M.TILE + 1, 5),
    "ragged_tiles": lambda: _edge_case(7 * M.TILE + 13, 6),
    "two_tiles_a_block": lambda: _q6_case(M.TILE * M.MAX_BLOCKS + 1, 7,
                                          sel=0.3),
    "all_invalid": lambda: (np.zeros(5000, bool), _edge_case(5000, 8)[1]),
}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_hk1_model_matches_the_plain_version(shape):
    valid, lanes = _SHAPES[shape]()
    got = M.masked_reduce(valid, lanes)
    want = port.masked_reduce_plain(torch.as_tensor(valid),
                                    _torch_lanes(lanes))
    _same_within(got, want.numpy(), lanes, shape)


@pytest.mark.parametrize("nmem", [1, 3, 8, 17])
def test_hk1b_members_equal_solo_calls(nmem):
    """Q6's shape cut to 2^16 rows at B members (each its own mask and
    prices, the NULL mask shared): member b's row of the batched model is
    the solo model's bit for bit, and agrees with the plain HK1b."""
    valid, lanes = _q6_case(1 << 16, 10 + nmem, nmem=nmem)
    rows = M.masked_reduce_batched(valid, lanes)
    plain = port.masked_reduce_batched_plain(torch.as_tensor(valid),
                                             _torch_lanes(lanes)).numpy()
    for b in range(nmem):
        solo = M.masked_reduce(valid[b], [(v[b], m, op)
                                          for v, m, op in lanes])
        assert rows[b].tobytes() == solo.tobytes(), b
        _same_within(rows[b], plain[b], lanes, f"member {b}")


def test_hk1_model_sums_in_its_own_order():
    """The model adds in the kernel's order, not numpy's pairwise order:
    on values spread over many magnitudes the two differ in their last
    bits, and both stay within 1e-9 relative of the exact sum."""
    rng = np.random.default_rng(12)
    n = 1 << 16
    vals = rng.normal(size=n) * 10.0 ** rng.integers(-8, 9, n)
    live = rng.random(n) < 0.5
    got = M.float_sum(vals, live)
    pairwise = float(np.sum(vals[live]))
    exact = math.fsum(vals[live])
    assert got != pairwise
    assert abs(got - exact) <= 1e-9 * abs(exact)
    assert abs(pairwise - exact) <= 1e-9 * abs(exact)
