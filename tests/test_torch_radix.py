"""The sort core shared by HK4 lex_order and HK2's sort regime
(tinysql_tpu_torch/csrc/lex_sort.cuh) at its edge shapes, on the CPU.

Two parts:

1. The reference's sort_permutation / top_k (tinysql_tpu/ops/kernels.py,
   K9 and K10, JAX on the CPU) against the port's sort_permutation /
   top_k / lex_order (their plain versions here: the tensors lie on the
   CPU) on the same numpy-seeded keys: ties across 1,024-row tiles,
   all-equal keys, n = T + 1, NaN / -0.0 / +-inf, int64 extremes, NULLs
   first and last, more than eight lanes.  Row order must be equal.
2. A numpy model of the radix regime's pass plan, as the CUDA code
   follows it: one histogram per (lane, 8-bit digit) with the digits
   taken unsigned, a digit whose bins put every row in one bin skipped,
   lanes from the last to the first and digits from the least
   significant, each pass reading the buffers its parity names (the
   first pass of the sort the lane and the identity, the first of a lane
   a gather through the current positions), the last pass writing the
   first `want` positions, the identity when no pass runs.  A Hypothesis
   sweep holds the model to lex_order_plain, so the plan the kernel
   follows is pinned where there is no card; tests/test_torch_cuda.py
   holds the kernel to lex_order_plain on the card.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tinysql_tpu.ops import kernels as ref
from tinysql_tpu_torch.ops import kernels as port

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


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


# ---- 1. the reference against the port at the edge shapes ---------------

def _keys(case, rng):
    """(key columns, n) for one edge shape."""
    def no_nulls(n):
        return np.zeros(n, bool)
    if case == "ties_across_tiles":
        n = 3 * 1024 + 17
        return [(rng.integers(0, 4, n).astype(np.int64), no_nulls(n))], n
    if case == "all_equal":
        n = 2100
        return [(np.full(n, 7, np.int64), no_nulls(n)),
                (np.full(n, 2.5), no_nulls(n))], n
    if case == "n_tile_plus_1":
        n = 1025
        return [(rng.integers(-9, 9, n).astype(np.int64), no_nulls(n))], n
    if case == "float_specials":
        n = 1500
        f = rng.integers(-2, 3, n).astype(np.float64)
        f[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan, -0.0, 0.0]
        f[rng.integers(8, n, 40)] = np.nan
        return [(f, no_nulls(n))], n
    if case == "int64_extremes":
        n = 1300
        v = rng.integers(-2, 3, n).astype(np.int64)
        v[:6] = [I64_MAX, I64_MIN, I64_MAX, I64_MIN, -1, 0]
        return [(v, no_nulls(n))], n
    if case == "nulls":
        n = 1400
        return [(rng.integers(-3, 3, n).astype(np.int64),
                 rng.random(n) < 0.3),
                (np.round(rng.random(n), 1), rng.random(n) < 0.3)], n
    if case == "more_than_8_lanes":
        n = 1100
        return [(rng.integers(0, 3, n).astype(np.int64),
                 rng.random(n) < 0.1) for _ in range(5)], n
    raise KeyError(case)


CASES = ("ties_across_tiles", "all_equal", "n_tile_plus_1",
         "float_specials", "int64_extremes", "nulls", "more_than_8_lanes")


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_sort_permutation_edges_match_reference(case, desc):
    rng = np.random.default_rng(CASES.index(case))
    keys, n = _keys(case, rng)
    descs = [desc if i % 2 == 0 else not desc for i in range(len(keys))]
    want = np.asarray(ref.sort_permutation(keys, descs, n))
    got = port.sort_permutation(keys, descs, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 10, 256, 257, 1024, 1025])
@pytest.mark.parametrize("case", ["ties_across_tiles", "nulls",
                                  "more_than_8_lanes"])
def test_top_k_edges_match_reference(case, k):
    rng = np.random.default_rng(100 + k)
    keys, n = _keys(case, rng)
    descs = [i % 2 == 1 for i in range(len(keys))]
    want = np.asarray(ref.top_k(keys, descs, n, k))
    got = port.top_k(keys, descs, n, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_lex_order_is_a_stable_lexsort(case):
    """lex_order over sort_lanes equals numpy's lexsort of the same
    uint64 lanes (row index last), and its top-k is the prefix."""
    rng = np.random.default_rng(7 + CASES.index(case))
    keys, n = _keys(case, rng)
    cols = [(torch.from_numpy(v), torch.from_numpy(m)) for v, m in keys]
    lanes = port.sort_lanes(cols, [False] * len(cols),
                            torch.ones(n, dtype=torch.bool))
    u = [t.numpy().view(np.uint64) for t in lanes]
    want = np.lexsort(u[::-1])
    np.testing.assert_array_equal(port.lex_order(lanes, n).numpy(), want)
    np.testing.assert_array_equal(port.lex_order(lanes, n, 300).numpy(),
                                  want[:300])


# ---- 2. the pass plan's model -------------------------------------------

DIGITS, BINS = 8, 256


def _digit(x: np.ndarray, d: int) -> np.ndarray:
    """Digit d of uint64 keys, unsigned: a sign-extending shift would put
    the lanes of descending and float keys out of order."""
    return ((x >> np.uint64(8 * d)) & np.uint64(0xFF)).astype(np.int64)


def radix_plan(lanes):
    """{(lane, digit): None (trivial) or its pass}: the histogram pass's
    plan, in the order the passes run."""
    m, n = len(lanes), len(lanes[0])
    plan, k, last = {}, 0, None
    for l in range(m - 1, -1, -1):
        prev = None
        for d in range(DIGITS):
            hist = np.bincount(_digit(lanes[l], d), minlength=BINS)
            if hist.max() == n:
                plan[(l, d)] = None
                continue
            mode = "lane" if k == 0 else ("gather" if prev is None
                                          else "buffer")
            if prev is not None:
                plan[prev]["keys_out"] = True
            plan[(l, d)] = {"k": k, "mode": mode, "keys_out": False,
                            "last": False,
                            "start": np.cumsum(hist) - hist}
            prev = last = (l, d)
            k += 1
    if last is not None:
        plan[last]["last"] = True
    return plan, k


def radix_model(lanes, want: int):
    """The positions of the first `want` rows as the radix regime writes
    them; lanes: uint64 arrays."""
    n = len(lanes[0])
    plan, total = radix_plan(lanes)
    keys, pos = [None, None], [None, None]
    wrote, keys_of = [None, None], [None, None]
    out = np.full(want, -1, np.int64)
    for l in range(len(lanes) - 1, -1, -1):
        for d in range(DIGITS):
            p = plan[(l, d)]
            if p is None:
                continue
            src, dst = p["k"] & 1, (p["k"] + 1) & 1
            if p["mode"] == "lane":
                kin, pin = lanes[l], np.arange(n)
            else:  # the buffers the previous pass wrote
                assert wrote[src] == p["k"] - 1
                pin = pos[src]
                if p["mode"] == "gather":
                    kin = lanes[l][pin]
                else:  # the keys of this lane's previous pass
                    assert keys_of[src] == (p["k"] - 1, l)
                    kin = keys[src]
            dig = _digit(kin, d)
            # rank among equal digits in element order: the tiles' ranks
            # and the look-back's offsets together
            rank = np.empty(n, np.int64)
            for b in np.unique(dig):
                at = np.nonzero(dig == b)[0]
                rank[at] = np.arange(at.size)
            dest = p["start"][dig] + rank
            if p["last"]:
                keep = dest < want
                out[dest[keep]] = pin[keep]
                continue
            pos[dst] = np.empty(n, np.int64)
            pos[dst][dest] = pin
            if p["keys_out"]:
                keys[dst] = np.empty(n, np.uint64)
                keys[dst][dest] = kin
                keys_of[dst] = (p["k"], l)
            wrote[dst] = p["k"]
    if total == 0:
        out[:] = np.arange(want)
    return out


def _as_u64(lanes_t):
    return [t.numpy().view(np.uint64) for t in lanes_t]


def test_plan_skips_the_digits_equal_in_every_row():
    rng = np.random.default_rng(3)
    n = 5000
    v = torch.from_numpy(rng.integers(0, 1 << 62, n))
    one = port.sort_lanes([(v, torch.zeros(n, dtype=torch.bool))], [False],
                          torch.ones(n, dtype=torch.bool))
    plan, total = radix_plan(_as_u64(one))
    assert all(plan[(0, d)] is None for d in range(DIGITS))  # NULL rank
    assert total == DIGITS  # the value lane's eight digits
    assert plan[(1, 0)]["mode"] == "lane" and plan[(1, 7)]["last"]
    # HK2's clamped group ids below ns = 2^21: three digits
    gid = np.minimum(rng.integers(0, 1_500_000, n), 1 << 21).astype(
        np.uint64)
    assert radix_plan([gid])[1] == 3
    # all keys equal: no pass, the identity
    eq = [np.full(n, 9, np.uint64), np.full(n, 1 << 63, np.uint64)]
    assert radix_plan(eq)[1] == 0
    np.testing.assert_array_equal(radix_model(eq, n), np.arange(n))


def test_plan_gathers_a_new_lane_through_the_positions():
    rng = np.random.default_rng(4)
    n = 3000
    lanes = [rng.integers(0, 300, n).astype(np.uint64),
             np.full(n, 5, np.uint64),
             rng.integers(0, 4, n).astype(np.uint64)]
    plan, total = radix_plan(lanes)
    assert plan[(2, 0)]["mode"] == "lane"
    assert all(plan[(1, d)] is None for d in range(DIGITS))
    assert plan[(0, 0)]["mode"] == "gather"
    assert plan[(0, 0)]["keys_out"] and plan[(0, 1)]["mode"] == "buffer"
    assert plan[(0, 1)]["last"] and total == 3
    np.testing.assert_array_equal(radix_model(lanes, n),
                                  np.lexsort(lanes[::-1]))


def test_digits_are_unsigned():
    """Lanes with the top bit set (the order lanes of negative-free keys,
    ~v of DESC keys) sort after the lanes without it."""
    v = np.array([1 << 63, 1, (1 << 64) - 1, 0, 1 << 62], dtype=np.uint64)
    np.testing.assert_array_equal(radix_model([v], 5), [3, 1, 4, 0, 2])
    lanes = [torch.from_numpy(v.view(np.int64))]
    np.testing.assert_array_equal(port.lex_order_plain(lanes, 5).numpy(),
                                  [3, 1, 4, 0, 2])


_LANE_KINDS = ("constant", "small", "one_byte", "wide", "signs")


def _lane(kind, rng, n):
    if kind == "constant":
        return np.full(n, rng.integers(I64_MIN, I64_MAX), np.int64)
    if kind == "small":
        return rng.integers(0, 4, n).astype(np.int64)
    if kind == "one_byte":  # one non-trivial digit, at a random place
        return (rng.integers(0, 3, n) << (8 * int(rng.integers(0, 8)))) \
            .astype(np.int64)
    if kind == "wide":
        return rng.integers(I64_MIN, I64_MAX, n, endpoint=True)
    return rng.choice(np.array([I64_MIN, -1, 0, 1, I64_MAX]), n)


@settings(max_examples=80, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 32 - 1),
       kinds=st.lists(st.sampled_from(_LANE_KINDS), min_size=1,
                      max_size=10),
       n=st.integers(1, 700), k=st.one_of(st.none(), st.integers(0, 800)))
def test_radix_model_matches_lex_order_plain(seed, kinds, n, k):
    rng = np.random.default_rng(seed)
    lanes = [torch.from_numpy(_lane(kd, rng, n)) for kd in kinds]
    want = n if k is None else min(k, n)
    got = radix_model(_as_u64(lanes), want)
    np.testing.assert_array_equal(
        got, port.lex_order_plain(lanes, n)[:want].numpy())
    np.testing.assert_array_equal(
        got, port.lex_order(lanes, n, k).numpy())
