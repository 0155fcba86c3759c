"""The few-segment reduction shared by HK2 segment_reduce, HK2b and HK5
csr_reduce (tinysql_tpu_torch/csrc/few_reduce.cuh) on the CPU, where there
is no card.

A numpy model follows the kernel's order of work with the constants the
header compiles with: tiles of TILE rows, one block each, thread t owning
the row pairs base + 2 * (k * THREADS + t) + {0, 1}; each (lane, member)
pass adds a thread's live rows in row order into its own slot of each
segment; the block folds each segment the tile holds (P = their count
rounded up to a power of two, C = THREADS / P chunks of P slots, thread
c + C * i in order, a shuffle tree over groups of min(C, 32) chunks, the
groups in order); then FOLD threads fold the tile partials (runs of
ceil(T / FOLD) tiles in tile order, a shuffle tree a warp, the warps in
order).  HK5's route first maps each row to its group through the index
(rows that no live position names, or at or past n_rows, have none).

The model is held to the plain versions the kernels are held to on the
card (segment_reduce_plain, csr_reduce_plain: integers, counts, first rows
and MIN/MAX exactly, float sums within 1e-6 relative), and, through the
port's fused segment path, to the reference's fused_segment_aggregate
(tinysql_tpu/ops/kernels.py) at a Q1-like shape.  HK2b's member b equals
its solo model bit for bit, and the tiles' partials do not depend on the
order in which blocks run them.
"""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from tinysql_tpu.ops import kernels as ref
from tinysql_tpu_torch.ops import kernels as port

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
_HDR = os.path.join(os.path.dirname(port.__file__), os.pardir, "csrc",
                    "few_reduce.cuh")
_SRC = open(_HDR).read()


def _const(name: str) -> str:
    return re.search(rf"constexpr (?:int|int64_t|uint32_t) {name} = "
                     rf"([^;]+);", _SRC).group(1)


THREADS = int(_const("kFThreads"))
PAIRS = int(_const("kFPairs"))
ROWS = 2 * PAIRS
TILE = THREADS * ROWS
FOLD = int(_const("kFFold"))
SMALL = int(_const("kSmallSeg"))
MEM = int(_const("kFMem"))
NONE = int(_const("kNone"), 16)


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


# ---- the model -------------------------------------------------------------

def _order_key(bits):
    return np.where(bits < 0, bits ^ I64_MAX, bits)


def _ident(op):
    return {"sum": 0, "max": I64_MIN}.get(op, I64_MAX)


def _merge(op, f64, a, b):
    """a then b, value bits (int64): the kernel's few_merge."""
    if op == "sum":
        if f64:
            return (a.view(np.float64) + b.view(np.float64)).view(np.int64)
        return a + b  # int64 wraps
    if op in ("min", "pres"):
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    return a


class _Part:
    """Partials of one (member, pass): value bits, live count, NaN flag."""

    def __init__(self, v, c, nan):
        self.v, self.c, self.nan = v, c, nan

    def merge(self, other, op, f64):
        return _Part(_merge(op, f64, self.v, other.v), self.c + other.c,
                     self.nan | other.nan)

    def at(self, idx):
        return _Part(self.v[idx], self.c[idx], self.nan[idx])


def tile_rows(n_tiles: int) -> np.ndarray:
    """rows[tile, thread, i]: row i of a thread (pair i // 2, half i % 2)."""
    i = np.arange(ROWS)
    return (np.arange(n_tiles)[:, None, None] * TILE
            + 2 * ((i[None, None, :] >> 1) * THREADS
                   + np.arange(THREADS)[None, :, None])
            + (i[None, None, :] & 1))


def _slots(op, f64, key, live, x, rows, ns):
    """Per-thread slots [T, THREADS, ns + 1] (column ns takes no row),
    each adding its rows in row order."""
    T = key.shape[0]
    v = np.full((T, THREADS, ns + 1), _ident(op), np.int64)
    c = np.zeros((T, THREADS, ns + 1), np.int64)
    nan = np.zeros((T, THREADS, ns + 1), bool)
    I, J = np.ogrid[:T, :THREADS]
    with np.errstate(over="ignore", invalid="ignore"):
        for i in range(ROWS):
            kk = np.where(live[..., i], key[..., i], ns)
            c[I, J, kk] += 1
            if op == "pres":
                v[I, J, kk] = np.minimum(v[I, J, kk], rows[..., i])
            elif op == "sum":
                v[I, J, kk] = _merge("sum", f64, v[I, J, kk], x[..., i])
            elif op in ("min", "max"):
                xi = x[..., i]
                if f64:
                    isnan = np.isnan(xi.view(np.float64))
                    nan[I, J, kk] |= isnan
                    xi = np.where(isnan, _ident(op), _order_key(xi))
                v[I, J, kk] = _merge(op, f64, v[I, J, kk], xi)
    return _Part(v, c, nan)


def _empty(op, shape):
    return _Part(np.full(shape, _ident(op), np.int64),
                 np.zeros(shape, np.int64), np.zeros(shape, bool))


def _tree(acc: _Part, width: int, op, f64) -> _Part:
    """A shuffle-down tree over groups of `width` lanes (axis 0): lane c
    takes lane c + o for o = width / 2 .. 1; lane 0 of each group holds
    its group's fold."""
    o = width >> 1
    while o:
        r = np.array([c for c in range(acc.v.shape[0]) if c % width < o])
        m = acc.at(r).merge(acc.at(r + o), op, f64)
        acc.v[r], acc.c[r], acc.nan[r] = m.v, m.c, m.nan
        o >>= 1
    return acc


def _fold_tile(slots: _Part, present, tile, op, f64) -> _Part:
    """One tile's partial [ns] of each segment (few_fold_tile); a segment
    the tile lacks keeps the empty partial."""
    ns = present.shape[1]
    segs = np.nonzero(present[tile])[0]
    out = _empty(op, ns)
    if not len(segs):
        return out
    P = 1 if len(segs) <= 1 else 1 << int(len(segs) - 1).bit_length()
    C = THREADS // P
    G = min(C, 32)
    col = _Part(slots.v[tile][:, segs], slots.c[tile][:, segs],
                slots.nan[tile][:, segs])  # [THREADS, np]
    acc = _empty(op, (C, len(segs)))
    for i in range(P):
        acc = acc.merge(col.at(np.arange(C) + C * i), op, f64)
    acc = _tree(acc, G, op, f64)
    r = acc.at(0)
    for q in range(1, C // G):
        r = r.merge(acc.at(q * G), op, f64)
    out.v[segs], out.c[segs], out.nan[segs] = r.v, r.c, r.nan
    return out


def _fold_tiles(parts: _Part, op, f64) -> _Part:
    """The tile partials [T, ns] folded (few_fold): thread c the run of
    ceil(T / FOLD) tiles from c * ceil(T / FOLD), a tree a warp, the
    warps in order."""
    T, ns = parts.v.shape
    per = -(-T // FOLD)
    acc = _empty(op, (FOLD, ns))
    for k in range(per):
        q = np.arange(FOLD) * per + k
        ok = np.nonzero(q < T)[0]
        m = acc.at(ok).merge(parts.at(q[ok]), op, f64)
        acc.v[ok], acc.c[ok], acc.nan[ok] = m.v, m.c, m.nan
    acc = _tree(acc, 32, op, f64)
    out = acc.at(0)
    for w in range(1, FOLD // 32):
        out = out.merge(acc.at(32 * w), op, f64)
    return out


def _finish(op, f64, v, c, nan):
    if op == "count":
        return 0
    if op == "sum":
        return int(v)
    if f64 and nan:
        return int(np.array(np.nan).view(np.int64))
    if c == 0:
        if f64:
            inf = np.inf if op == "min" else -np.inf
            return int(np.array(inf).view(np.int64))
        return I64_MAX if op == "min" else I64_MIN
    if f64:
        return int(_order_key(np.array(v, np.int64)))
    return int(v)


def _np(t):
    return None if t is None else np.asarray(t)


def few_model(keys, valid, lanes, ns: int, ld: int = None,
              sentinel: int = None, tile_order=None) -> np.ndarray:
    """The regime over rows [0, n): keys int [n] (a segment < ns or NONE),
    valid bool [B, n], lanes [(values, NULL mask, op)] each [B, n], [n] or
    None.  Returns int64 [B, 2 + 2 * len(lanes), ld] tables.  tile_order:
    the order the tiles' blocks run in (their partials do not depend on
    it)."""
    assert 1 <= ns <= SMALL
    keys = np.asarray(keys)
    valid = np.asarray(valid, bool)
    B, n = valid.shape
    ld = ns if ld is None else ld
    sentinel = n if sentinel is None else sentinel
    T = -(-n // TILE)
    rows = tile_rows(T)
    inside = rows < n
    rr = np.where(inside, rows, 0)
    key = np.where(inside, keys[rr] if n else NONE, NONE)
    keyed = key != NONE
    present = np.zeros((T, ns), bool)
    for tile in (range(T) if tile_order is None else tile_order):
        present[tile, np.unique(key[tile][keyed[tile]])] = True

    def member(a, b):
        a = _np(a)
        return None if a is None else (a[b] if a.ndim == 2 else a)

    out = np.zeros((B, 2 + 2 * len(lanes), ld), np.int64)
    for b in range(B):
        vb = np.where(inside, valid[b][rr], False) & keyed
        passes = [("pres", False, None, None, -1)]
        for j, (x, m, op) in enumerate(lanes):
            xb, mb = member(x, b), member(m, b)
            f64 = xb is not None and xb.dtype == np.float64
            passes.append((op, f64, xb, mb, j))
        for op, f64, xb, mb, j in passes:
            nul = np.zeros_like(vb) if mb is None else \
                np.where(inside, mb.astype(bool)[rr], False)
            live = vb & ~nul
            xbits = np.zeros(rows.shape, np.int64) if xb is None else \
                np.where(inside, xb.view(np.int64)[rr], 0)
            slots = _slots(op, f64, key, live, xbits, rows, ns)
            tiles = _empty(op, (T, ns))
            for tile in (range(T) if tile_order is None else tile_order):
                p = _fold_tile(slots, present, tile, op, f64)
                tiles.v[tile], tiles.c[tile], tiles.nan[tile] = \
                    p.v, p.c, p.nan
            r = _fold_tiles(tiles, op, f64) if T else _empty(op, ns)
            for g in range(ld):
                if g < ns:
                    v, c, nan = int(r.v[g]), int(r.c[g]), bool(r.nan[g])
                else:
                    v, c, nan = _ident(op), 0, False
                if op == "pres":
                    out[b, 0, g] = c
                    out[b, 1, g] = v if c else sentinel
                    continue
                if mb is None:  # the presence count
                    c = int(out[b, 0, g])
                out[b, 2 + 2 * j, g] = _finish(op, f64, v, c, nan)
                out[b, 3 + 2 * j, g] = c
    return out


def row_group_map(order, ends, n_rows: int, ng: int) -> np.ndarray:
    """HK5's few-group map: the group byte of each row named by a live
    position (the first g < ng with ends[g] >= q), NONE elsewhere."""
    order = np.asarray(order)
    m = np.full(n_rows, NONE, np.int64)
    q = np.arange(n_rows)
    g = np.searchsorted(np.asarray(ends)[:ng], q, side="left")
    r = order[:n_rows]
    ok = (g < ng) & (r >= 0) & (r < n_rows)
    m[r[ok]] = g[ok]
    return m


def csr_model(order, ends, valid, lanes, n_rows: int, ng: int):
    ngb = int(np.asarray(ends).shape[0])
    keys = row_group_map(order, ends, n_rows, ng)
    cut = [(None if x is None else np.asarray(x)[:n_rows],
            None if m is None else np.asarray(m)[:n_rows], op)
           for x, m, op in lanes]
    return few_model(keys, np.asarray(valid)[None, :n_rows], cut, ng, ngb,
                     n_rows)[0]


# ---- comparisons -----------------------------------------------------------

def _assert_table(got, want, lanes, what, bits_minmax=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    for r in range(got.shape[0]):
        j = (r - 2) // 2
        x = lanes[j][0] if r >= 2 else None
        f64 = x is not None and np.asarray(x).dtype == np.float64
        if r >= 2 and r % 2 == 0 and f64 and lanes[j][2] == "sum":
            np.testing.assert_allclose(got[r].view(np.float64),
                                       want[r].view(np.float64), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{what} row {r}")
        elif r >= 2 and r % 2 == 0 and f64 and not bits_minmax:
            a, b = got[r].view(np.float64), want[r].view(np.float64)
            assert np.all((a == b) | (np.isnan(a) & np.isnan(b))), (what, r)
        else:
            np.testing.assert_array_equal(got[r], want[r],
                                          err_msg=f"{what} row {r}")


def _lanes(rng, n, lead=(), nulls=0.2, nan=0.0):
    shp = tuple(lead) + (n,)
    vf = np.round(rng.normal(size=shp) * 1e3, 3)
    flat = vf.reshape(-1)
    if nan:
        flat[rng.random(flat.size) < nan] = np.nan
    special = [0.0, -0.0, np.inf, -np.inf, -0.0, 1e300]
    flat[:min(6, flat.size)] = special[:min(6, flat.size)]
    vi = rng.integers(-(1 << 62), 1 << 62, shp)
    vi.reshape(-1)[:min(2, vi.size)] = [I64_MAX, I64_MIN][:min(2, vi.size)]
    m = rng.random(shp) < nulls
    return [(vf, m, "sum"), (vf, m, "min"), (vf, None, "max"),
            (vi, None, "sum"), (vi, m, "min"), (vi, None, "max"),
            (None, m, "count"), (None, None, "count"), (vf, None, "sum")]


def _t(lanes):
    return [(None if x is None else torch.as_tensor(x),
             None if m is None else torch.as_tensor(m), op)
            for x, m, op in lanes]


def _hk2_case(rng, n, ns, frac=0.8, nulls=0.2, nan=0.0, gid=None):
    if gid is None:
        gid = rng.integers(-1, ns + 1, n)
    valid = rng.random(n) < frac
    lanes = _lanes(rng, n, nulls=nulls, nan=nan)
    keys = np.where((gid >= 0) & (gid < ns), gid, NONE)
    got = few_model(keys, valid[None], lanes, ns)[0]
    want = port.segment_reduce_plain(torch.as_tensor(gid),
                                     torch.as_tensor(valid), ns,
                                     _t(lanes)).numpy()
    # the plain version ties -0.0 with +0.0 in MIN/MAX; the kernels order
    # them (-0.0 < +0.0), so float MIN/MAX compare as floats here
    _assert_table(got, want, lanes, f"n={n} ns={ns}", bits_minmax=False)
    return got


# ---- tests -----------------------------------------------------------------

def test_model_constants_are_the_kernels():
    """The model's tile, fold width and limits are the constants
    csrc/few_reduce.cuh compiles with."""
    assert _const("kFRows") == "2 * kFPairs"
    assert _const("kFTile") == "(int64_t)kFThreads * kFRows"
    assert _const("kFWarps") == "kFThreads / 32"
    assert (THREADS, PAIRS, FOLD, SMALL, MEM, NONE) == \
        (256, 8, 256, 64, 16, 0xFF)
    src = open(os.path.join(os.path.dirname(_HDR), "segment_reduce.cu")).read()
    assert "if (ns <= kSmallSeg)" in src
    src = open(os.path.join(os.path.dirname(_HDR), "csr_reduce.cu")).read()
    assert "if (ng > 0 && ng <= kSmallSeg)" in src


@pytest.mark.parametrize("n", [1, 7, 513, TILE - 1, TILE, TILE + 1,
                               2 * TILE + 1001],
                         ids=lambda n: f"n{n}")
def test_tiles_partition_the_rows(n):
    """Every row lies in exactly one tile and one thread's pair; a
    thread's rows ascend; the partition is a function of n alone."""
    T = -(-n // TILE)
    rows = tile_rows(T)
    live = rows[rows < n]
    assert np.array_equal(np.sort(live), np.arange(n))
    assert np.all(np.diff(rows, axis=2) > 0)


@pytest.mark.parametrize("ns", [1, 4, 16, 33, SMALL], ids=lambda s: f"ns{s}")
@pytest.mark.parametrize("n", [5, 4097, TILE + 3, 3 * TILE - 5],
                         ids=lambda n: f"n{n}")
def test_model_matches_segment_reduce_plain(n, ns):
    _hk2_case(np.random.default_rng(n * 131 + ns), n, ns)


@pytest.mark.parametrize("case", ["all_invalid", "all_null", "null_heavy",
                                  "nan_minmax", "one_group", "no_group"])
def test_model_edges_match_plain(case):
    rng = np.random.default_rng(len(case))
    n, ns = 2 * TILE + 77, 16
    kw = {"all_invalid": dict(frac=0.0), "all_null": dict(nulls=1.0),
          "null_heavy": dict(nulls=0.9), "nan_minmax": dict(nan=0.1),
          "one_group": dict(gid=np.full(n, 3)),
          "no_group": dict(gid=np.full(n, 99))}[case]
    _hk2_case(rng, n, ns, **kw)


@pytest.mark.parametrize("nmem", [1, 3, MEM + 1], ids=lambda b: f"B{b}")
def test_batched_member_equals_its_solo_model(nmem):
    """HK2b: members over one key lane, each with its own valid mask and
    its own or shared lanes; member b bit for bit the solo model over
    member b, whatever B (members run in chunks of kFMem)."""
    rng = np.random.default_rng(nmem)
    n, ns = TILE + 301, 16
    keys = np.where(rng.random(n) < 0.9, rng.integers(0, 6, n), NONE)
    valid = rng.random((nmem, n)) < 0.9
    own, shared = _lanes(rng, n, (nmem,)), _lanes(rng, n)
    lanes = [own[0], shared[1], (own[0][0], shared[0][1], "sum"), own[3],
             (None, own[6][1], "count"), shared[6], own[4]]
    got = few_model(keys, valid, lanes, ns)
    for b in range(nmem):
        solo = [(None if x is None else (x[b] if x.ndim == 2 else x),
                 None if m is None else (m[b] if m.ndim == 2 else m), op)
                for x, m, op in lanes]
        assert np.array_equal(got[b], few_model(keys, valid[b][None], solo,
                                                ns)[0]), b


def test_tile_partials_do_not_depend_on_block_order():
    rng = np.random.default_rng(7)
    n, ns = 4 * TILE + 9, 16
    keys = rng.integers(0, 12, n)
    valid = rng.random((1, n)) < 0.98
    lanes = _lanes(rng, n)
    a = few_model(keys, valid, lanes, ns)
    b = few_model(keys, valid, lanes, ns,
                  tile_order=rng.permutation(-(-n // TILE)))
    assert np.array_equal(a, b)


def _index(keys, nb, drop=None):
    order = np.argsort(keys, kind="stable")
    if drop is not None:
        order = order[~np.isin(order, drop)]
    sk = keys[order]
    ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0] if len(sk) else \
        np.zeros(0, np.int64)
    return (port.pad1(order.astype(np.int64), nb),
            port.pad1(ends.astype(np.int64), port.bucket(max(len(ends), 1)),
                      fill=max(len(order) - 1, 0)), len(ends))


@pytest.mark.parametrize("ng", [1, 4, 6, SMALL], ids=lambda g: f"ng{g}")
def test_csr_model_matches_csr_reduce_plain(ng):
    rng = np.random.default_rng(ng)
    n_rows, nb = TILE + 2049, 2 * TILE
    keys = rng.integers(0, ng, n_rows)
    drop = rng.choice(n_rows, n_rows // 10, replace=False)
    order, ends, got_ng = _index(keys, nb, drop)
    valid = rng.random(nb) < 0.85
    lanes = _lanes(rng, nb)
    got = csr_model(order, ends, valid, lanes, n_rows, got_ng)
    want = port.csr_reduce_plain(torch.as_tensor(order),
                                 torch.as_tensor(ends),
                                 torch.as_tensor(valid), _t(lanes), n_rows,
                                 got_ng).numpy()
    _assert_table(got, want, lanes, f"csr ng={ng}")


def test_row_group_map_leaves_out_unnamed_rows():
    """Rows no live position names, rows at or past n_rows, positions
    past the last group and padding positions get no group."""
    n_rows = 50
    order = np.array([3, 7, 49, 50, 60, -1, 8, 9, 10, 11] + [0] * 54)
    ends = np.array([1, 4, 6, 6])  # group 3 repeats group 2's end: empty
    m = row_group_map(order, ends, n_rows, 4)
    want = np.full(n_rows, NONE)
    want[[3, 7]] = 0
    want[49] = 1
    want[8] = 2
    assert np.array_equal(m, want)
    named = set(order[:7][(order[:7] >= 0) & (order[:7] < n_rows)])
    assert set(np.nonzero(m != NONE)[0]) == named - {9, 10, 11}


def _pair(v, m, nb, lib):
    if lib == "ref":
        return (ref.h2d_pad(v, nb), ref.h2d_pad(m, nb, True))
    return (port.h2d_pad(v, nb), port.h2d_pad(m, nb, True))


def _port_program(specs):
    """The port's fused path takes one HK7 program; every aggregate reads
    slot 0, a float column (as tests/test_torch_kernels.py builds it)."""
    from tinysql_tpu_torch.executor.gpu_executors import _agg_program
    from tinysql_tpu_torch.expression import Column
    from tinysql_tpu_torch.mytypes import new_real_type
    from tinysql_tpu_torch.ops.exprjit import ParamTable
    col = Column(new_real_type(), index=0)
    pt = ParamTable()
    prog, lane_of, _ = _agg_program(
        specs, [col if has else None for _, has in specs], [], pt)
    return prog, lane_of, pt.arrays()


SPECS = [("count_star", False), ("sum", True), ("sum", True),
         ("count", True), ("sum0", True), ("min", True), ("max", True),
         ("count", True)]


def _model_segment_reduce(gid, valid, ns, lanes, out=None):
    gid = gid.numpy()
    keys = np.where((gid >= 0) & (gid < ns), gid, NONE)
    table = torch.as_tensor(few_model(
        keys, valid.numpy()[None],
        [(None if x is None else x.numpy(),
          None if m is None else m.numpy(), op) for x, m, op in lanes],
        ns)[0])
    return table if out is None else out.copy_(table)


@pytest.mark.parametrize("n_segments", [1, 4, 16, SMALL, SMALL + 1],
                         ids=lambda s: f"segs{s}")
def test_model_through_the_fused_path_matches_the_reference(
        n_segments, monkeypatch):
    """Q1's shape at a small n: a float lane summed, counted and taken
    min / max through the port's fused segment path with the model in
    HK2's place (the sort regime past kSmallSeg: the plain version),
    against the reference's fused_segment_aggregate."""
    rng = np.random.default_rng(n_segments)
    n = TILE + 1500
    v = np.round(rng.uniform(900.0, 105000.0, n), 2)
    m = rng.random(n) < 0.05
    gid = rng.choice(n_segments, n).astype(np.int64)
    nb = ref.bucket(n)
    mask = np.zeros(nb, dtype=bool)
    mask[:n] = rng.random(n) < 0.98
    gid_pad = np.concatenate([gid, np.full(nb - n, n_segments, np.int64)])
    want = ref.fused_segment_aggregate(
        [_pair(v, m, nb, "ref")], jnp.asarray(gid_pad), n_segments,
        SPECS, [None] + [(lambda cols, pr: cols[0])] * (len(SPECS) - 1), n,
        ("host", jnp.asarray(mask)),
        program_key=("few", n_segments))
    calls = []

    def seg(gid, valid, ns, lanes, out=None):
        calls.append(ns)
        if ns > SMALL:
            return port.segment_reduce_plain(gid, valid, ns, lanes)
        return _model_segment_reduce(gid, valid, ns, lanes, out)
    monkeypatch.setattr(port, "segment_reduce", seg)
    prog, lane_of, params = _port_program(SPECS)
    got = port.fused_segment_aggregate(
        [_pair(v, m, nb, "port")], port.h2d(gid_pad), n_segments,
        SPECS, prog, lane_of, n, ("host", port.h2d(mask)),
        program_key=("few", n_segments), params=params)
    assert calls and (calls[0] <= SMALL) == (n_segments <= SMALL)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    for i, ((gv, gm), (wv, wm)) in enumerate(zip(got[1], want[1])):
        np.testing.assert_array_equal(np.asarray(gm), np.asarray(wm))
        live = ~np.asarray(wm, bool)
        np.testing.assert_allclose(np.asarray(gv)[live],
                                   np.asarray(wv)[live], rtol=1e-6,
                                   err_msg=f"aggregate {i}")


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 3 * TILE), ns=st.integers(1, SMALL),
       frac=st.sampled_from([0.0, 0.5, 0.98, 1.0]),
       nulls=st.sampled_from([0.0, 0.3, 1.0]),
       seed=st.integers(0, 1 << 16))
def test_model_sweep_matches_plain(n, ns, frac, nulls, seed):
    _hk2_case(np.random.default_rng(seed), n, ns, frac=frac, nulls=nulls)
