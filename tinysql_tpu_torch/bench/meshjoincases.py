"""Edge shapes of HK12 shard_probe (probe, member and count modes) and of
HK8 csr_expand, and numpy models of their staged search and tiled fill.

The constants are read from the sources (csrc/shard_join.cu's kIndex,
csrc/csr_expand.cu's tile sizes), so the cases land on the edges the
kernels have: a whole run and sampled runs in shared memory, sample
points and window edges inside runs of equal keys, build and probe tiles
and fill tiles, and more probe rows in a fill tile than it stages at
once.  Used by tests/test_torch_meshjoin.py (each model against the
plain version on the CPU), tests/test_torch_cuda.py and chip_smoke.py
(each kernel against its plain version on the card).

An HK12 probe case is (n, pk, pid, bk, bid): shards, probe keys and ids
(-1 = padding) over [n * cap_p], build keys and ids (-1 = dead) over
[n * cap_b]; ``shardops._build_order`` gives bord and perm.  A count
case is (n, lk, lvalid, rsorted).  An HK8 case is the arguments of
``kernels.csr_expand`` as numpy arrays (build lanes, probe lanes, shards).
"""
from __future__ import annotations

import os
import re

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")


def _const(source: str, name: str) -> int:
    with open(os.path.join(_CSRC, source)) as f:
        src = f.read()
    return int(re.search(rf"constexpr (?:int|int64_t) {name} = (\d+);",
                         src).group(1))


#: keys of HK12's shared-memory index at most, and its grid: threads a
#: block, slots a thread at once, blocks in all at most
INDEX = _const("shard_join.cu", "kIndex")
SJ_THREADS = _const("shard_join.cu", "kThreads")
SJ_ROWS = _const("shard_join.cu", "kRows")
SJ_BLOCKS = _const("shard_join.cu", "kBlocks")
#: sorted positions of an HK8 build tile, output slots of a fill tile,
#: probe rows a fill tile stages at once
BUILD_TILE = (_const("csr_expand.cu", "kBuildThreads")
              * _const("csr_expand.cu", "kBuildPer"))
FILL_TILE = (_const("csr_expand.cu", "kThreads")
             * _const("csr_expand.cu", "kFillPer"))
FILL_ROWS = _const("csr_expand.cu", "kFillRows")

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
_SIGN = np.uint64(1 << 63)
#: the order key of a dead build slot (int64 max, +inf)
SENTINEL = {False: np.uint64(0xFFFFFFFFFFFFFFFF),
            True: np.uint64(0xFFF0000000000000)}


def shard_blocks(per_shard: int, n: int) -> int:
    """HK12's blocks a shard: one for each SJ_THREADS * SJ_ROWS slots, at
    most SJ_BLOCKS in all."""
    group = SJ_THREADS * SJ_ROWS
    return max(1, min(-(-per_shard // group), max(SJ_BLOCKS // n, 1)))


def index_stride(length: int, per_shard: int, n: int,
                 half: bool = True) -> int:
    """HK12's sample stride for a run of ``length`` slots probed by
    ``per_shard`` slots a shard: 1 (the whole run is staged) when the run
    fits the slots a block probes (rounded up to a power of two, at most
    INDEX), else the least power of two S with ceil(length / S) at most
    half that (``half``: probe and member modes) or all of it (count
    mode)."""
    per_block = -(-per_shard // shard_blocks(per_shard, n))
    cap = SJ_THREADS
    while cap < per_block and cap < INDEX:
        cap <<= 1
    if length <= cap:
        return 1
    keys = cap // 2 if half else cap
    s = 1
    while -(-length // s) > keys:
        s <<= 1
    return s


def order_keys(v: np.ndarray) -> np.ndarray:
    """HK4's uint64 order lane: the sign-bit flip of int64, the monotone
    bits of float64 after -0.0 folds into +0.0 (NaN stays NaN)."""
    if v.dtype == np.float64:
        b = (v + 0.0).view(np.int64)
        return np.where(b < 0, ~b, b ^ np.int64(I64_MIN)).view(np.uint64)
    return v.view(np.uint64) ^ _SIGN


def _lower(a: np.ndarray, x) -> int:
    return int(np.searchsorted(a, x, side="left"))


# ---- HK12: the staged search ---------------------------------------------

def staged_probe_model(pk, pid, bord, bid, perm, n: int, member: bool):
    """HK12 as its blocks compute it: per shard the index of every S-th
    key of the run, U = nu * S for nu the first index key at or past the
    sentinel (the run's end at most), then per live, non-NaN probe slot
    the index's lower bound t among the nu keys, the window ((t - 1) * S,
    min(t * S, U)] and the candidate at its first position >= the key.
    Returns (hit, brow) as shard_probe_plain does (hit alone for
    ``member``)."""
    is_float = pk.dtype == np.float64
    npb, nbb = len(pk), len(bord)
    cap_p, cap_b = npb // n, nbb // n
    s_ = index_stride(cap_b, cap_p, n)
    sent = SENTINEL[is_float]
    xs = order_keys(pk)
    nan = np.isnan(pk) if is_float else np.zeros(npb, bool)
    hit = np.zeros(npb, bool)
    brow = np.full(npb, -1, np.int64)
    for s in range(n):
        run = perm[s * cap_b:(s + 1) * cap_b]
        sk = bord[run].view(np.uint64)
        idx = sk[::s_]
        nu = _lower(idx, sent)
        u = min(nu * s_, cap_b)
        sl = slice(s * cap_p, (s + 1) * cap_p)
        x = xs[sl]
        t = np.searchsorted(idx[:nu], x, side="left")
        lo = np.where(t == 0, 0, (t - 1) * s_ + 1)
        hi = np.where(t == 0, 0, np.minimum(t * s_, u))
        # a window's lower bound is the run's, clipped to the window
        r = np.clip(np.searchsorted(sk[:u], x, side="left"), lo, hi)
        rc = np.minimum(r, cap_b - 1)
        b = bid[run[rc]]
        h = (pid[sl] >= 0) & ~nan[sl] & (r < cap_b) & (sk[rc] == x) & (b >= 0)
        hit[sl] = h
        brow[sl] = np.where(h, b, -1)
    return hit if member else (hit, brow)


def gallop_count_model(lk, lvalid, rs, n: int):
    """HK12's count mode as its blocks compute it: the index of every
    S-th key of the replicated run, the window's lower bound, then a
    gallop over equal keys (lo + 1, lo + 2, lo + 4, ...) and a bisection
    of the last gap.  Returns (counts, partial [n, 1, 1], loads): loads
    counts the run entries the gallops read."""
    nr = len(rs)
    s_ = index_stride(nr, len(lk) // n, n, half=False)
    idx = rs[::s_]
    counts = np.zeros(len(lk), np.int64)
    loads = 0
    for i in np.nonzero(lvalid)[0]:
        x = lk[i]
        t = _lower(idx, x)
        lo = 0 if t == 0 else (t - 1) * s_ + 1
        hi = 0 if t == 0 else min(t * s_, nr)
        lo += _lower(rs[lo:hi], x)
        if lo >= nr or rs[lo] != x:
            continue
        a, step, b = lo, 1, lo + 1
        while b < nr and rs[b] == x:
            loads += 1
            a, step = b, step * 2
            b = lo + step
        b = min(b, nr)
        while b - a > 1:
            loads += 1
            mid = a + (b - a) // 2
            if rs[mid] == x:
                a = mid
            else:
                b = mid
        counts[i] = b - lo
    return counts, counts.reshape(n, 1, -1).sum(axis=2, keepdims=True), loads


#: name -> (dtype, n, cap_p, cap_b, what): "whole" (a run inside the
#: index), "sampled" (a run of 3 * INDEX + 5 slots: S = 32 for 2,000
#: probe slots a shard, its length no multiple of S), "equal runs" (runs
#: of 2 .. 3 * S equal keys across sample points and window edges),
#: "index cap" (64 shards of 32,768 probe slots: a block probes INDEX
#: slots, so the index reaches its cap), "all dead" (one shard without a
#: live slot), "ends" (int64 min and max on both sides, the sentinel's
#: key live but in shard 0, where only dead slots sit at it), "zeros"
#: (-0.0 and +0.0 on both sides, +inf live as "ends" has it), "nan"
#: (NaN probe keys and NaN build keys), "padding" (most probe slots
#: padding)
PROBE_CASES = {
    "whole int64": (np.int64, 8, 512, 300, "whole"),
    "whole float64": (np.float64, 8, 512, 300, "whole"),
    "sampled int64": (np.int64, 2, 2000, 3 * INDEX + 5, "sampled"),
    "equal runs": (np.int64, 2, 3000, 3 * INDEX + 5, "equal runs"),
    "index cap": (np.int64, 64, 32768, 2 * INDEX + 1, "sampled"),
    "all dead": (np.int64, 4, 256, 64, "all dead"),
    "ends": (np.int64, 4, 256, 2 * INDEX + 1, "ends"),
    "zeros": (np.float64, 4, 256, 300, "zeros"),
    "nan": (np.float64, 2, 512, 3 * INDEX + 5, "nan"),
    "padding": (np.int64, 4, 512, 300, "padding"),
}


def probe_case(name: str, seed: int = 12):
    """(n, pk, pid, bk, bid) of the case, numpy."""
    dt, n, cp, cb, what = PROBE_CASES[name]
    rng = np.random.default_rng(seed)
    span = max(cb // 2, 8)
    pk = rng.integers(-span, span, n * cp)
    bk = rng.integers(-span, span, n * cb)
    live_b = rng.random(n * cb) < 0.8
    pid = np.where(rng.random(n * cp) < 0.9, np.arange(n * cp), -1)
    if what == "equal runs":
        s_ = index_stride(cb, cp, n)
        lens = rng.integers(2, 3 * s_ + 1, n * cb)
        bk = np.repeat(np.arange(len(lens)), lens)[:n * cb] - n * cb // 4
        bk = rng.permutation(bk)
        pk = rng.integers(bk.min() - 3, bk.max() + 3, n * cp)
    elif what == "all dead":
        live_b[:cb] = False
    elif what == "ends":
        bk[::7] = I64_MAX
        bk[3::11] = I64_MIN
        pk[::5] = I64_MAX
        pk[2::9] = I64_MIN
        bk[:cb][bk[:cb] == I64_MAX] = I64_MAX - 1  # shard 0: dead slots only
    elif what == "padding":
        pid = np.where(rng.random(n * cp) < 0.2, np.arange(n * cp), -1)
    pk, bk = pk.astype(dt), bk.astype(dt)
    if what == "zeros":
        bk[::5] = -0.0
        bk[1::7] = 0.0
        bk[2::13] = np.inf
        pk[::3] = -0.0
        pk[1::4] = 0.0
        pk[2::9] = np.inf
        pk[3::11] = -np.inf
        bk[:cb][bk[:cb] == np.inf] = 1e300  # shard 0: dead slots only
    elif what == "nan":
        bk[::9] = np.nan
        pk[::4] = np.nan
    bid = np.where(live_b, np.arange(n * cb), -1)
    return n, pk, pid.astype(np.int64), bk, bid.astype(np.int64)


#: name -> (n, rows, nr, what): "absent" (probe keys mostly absent from
#: the run), "skew" (one key repeated over 10^5 slots), "small" (a run
#: inside the index), "empty" (no build key)
COUNT_CASES = {
    "absent": (4, 2000, 50_000, "absent"),
    "skew": (2, 3000, 150_000, "skew"),
    "small": (4, 1000, 700, "small"),
    "empty": (2, 500, 0, "empty"),
}


def count_case(name: str, seed: int = 26):
    """(n, lk, lvalid, rsorted) of the case, numpy."""
    n, rows, nr, what = COUNT_CASES[name]
    rng = np.random.default_rng(seed)
    rk = rng.integers(0, max(nr, 1), nr)
    lk = rng.integers(0, max(nr, 1), n * rows)
    if what == "absent":
        rk = rk * 3
        lk = lk * 3 + (rng.random(n * rows) < 0.9)
    elif what == "skew":
        rk[:100_000] = 777
        lk[::3] = 777
    lk[:2] = [I64_MIN, I64_MAX]
    return (n, lk.astype(np.int64), rng.random(n * rows) < 0.9,
            np.sort(rk).astype(np.int64))


# ---- HK8: the look-back passes and the tiled fill ----------------------

def csr_model(order, ends, ng: int, n_rows: int, bvalid, tbl, lo: int,
              hi: int, key, key_ok, pvalid, outer: bool, ob: int,
              shards: int = 1):
    """HK8 as its passes compute it, from the probe key lane ``key`` and
    its usable flags ``key_ok`` (kernels.probe_keys_plain): ce_build's
    tiles (comp, and ce[g] from the tile holding group g's end),
    ce_probe's rows (incl, (start, m), the shard bases) and ce_fill's
    tiles of FILL_TILE slots, each staging its rows FILL_ROWS at a time.
    Returns (valid, prow, brow, matched) over shards * ob slots and the
    number of fill tiles that staged more than one chunk of rows."""
    nb = len(pvalid)
    v = bvalid[order[:n_rows]].astype(bool)
    comp = order[:n_rows][v]
    tiles_b = max(-(-n_rows // BUILD_TILE), 1)
    ce = np.zeros(max(ng, 1), np.int64)
    prefix = 0
    for tile in range(tiles_b):
        t0 = tile * BUILD_TILE
        ln = max(0, min(BUILD_TILE, n_rows - t0))
        ga = _lower(ends[:ng], t0)
        gb = ng if tile == tiles_b - 1 else _lower(ends[:ng], t0 + ln)
        incl_t = np.cumsum(v[t0:t0 + ln])
        for g in range(ga, gb):
            e = min(int(ends[g]) - t0, ln - 1)
            ce[g] = prefix + (int(incl_t[e]) if ln else 0)
        prefix += int(incl_t[-1]) if ln else 0
    ok = pvalid.astype(bool) & key_ok
    inr = ok & (key >= lo) & (key <= hi)
    off = np.where(inr, key - np.where(inr, lo, 0), 0)
    g = np.where(inr, tbl[np.minimum(off, len(tbl) - 1)], -1).astype(np.int64)
    g = np.where(g < ng, g, -1)
    st = np.where(g > 0, ce[np.maximum(g - 1, 0)], 0)
    m = np.where(g >= 0, ce[np.maximum(g, 0)] - st, 0)
    cnt = np.where(pvalid, np.maximum(m, 1), 0) if outer else m
    incl = np.cumsum(cnt)
    nbl = nb // shards
    sbase = np.concatenate([incl[::nbl] - cnt[::nbl], incl[-1:]])
    n_out = shards * ob
    valid = np.zeros(n_out, bool)
    prow = np.zeros(n_out, np.int64)
    brow = np.zeros(n_out, np.int64)
    matched = np.zeros(n_out, bool)
    chunked = 0
    for s in range(shards):
        r0, base = s * nbl, int(sbase[s])
        tot = int(sbase[s + 1]) - base
        for j0 in range(0, ob, FILL_TILE):
            j1 = min(j0 + FILL_TILE, ob)
            live = min(max(tot, j0), j1)
            prow[s * ob + j0:s * ob + j1] = r0
            if j0 >= live:
                continue
            pa = r0 + _lower(incl[r0:r0 + nbl], base + j0 + 1)
            pb = r0 + _lower(incl[r0:r0 + nbl], base + live - 1 + 1)
            chunked += pb - pa + 1 > FILL_ROWS
            for c0 in range(pa, pb + 1, FILL_ROWS):
                cn = min(FILL_ROWS, pb - c0 + 1)
                e = np.concatenate([[incl[c0 - 1] if c0 > 0 else 0],
                                    incl[c0:c0 + cn]])
                j = base + np.arange(j0, live)
                j = j[(j >= e[0]) & (j < e[cn])]
                a = np.searchsorted(e[1:], j, side="right")
                k = j - e[a]
                o = s * ob + j - base
                p = c0 + a
                mt = k < m[p]
                valid[o] = True
                prow[o] = p
                matched[o] = mt
                brow[o] = np.where(mt, comp[np.where(mt, st[p] + k, 0)]
                                   if len(comp) else 0, 0)
    return valid, prow, brow, matched, chunked


def gather_model(valid, prow, brow, matched, probe_lanes, build_lanes):
    """The lanes HK8's fill gathers at (prow, brow): probe lanes with
    their NULL flags, build lanes NULL where a slot is unmatched."""
    pc = [(pv[prow], np.zeros(len(prow), bool) if pm is None else pm[prow])
          for pv, pm in probe_lanes]
    bc = [(bv[brow], ~matched if bm is None else bm[brow] | ~matched)
          for bv, bm in build_lanes]
    return valid, pc, bc


#: name -> (n_build, n_probe, what, outer, shards): "long row" (one probe
#: row with more build rows than three fill tiles), "zero rows at tile
#: edges" (unmatched rows around every fill tile's first and last slot),
#: "no pairs" (total = 0), "full bucket" (total = ob), "left absent" (LEFT
#: with absent keys and invalid rows), "staged twice" (a fill tile
#: spanning more than FILL_ROWS probe rows), "shard without pairs" (shard
#: mode, inner, one shard's probe rows all unmatched), "build tiles"
#: (build positions over several build tiles, groups ending on their
#: edges; shard mode, LEFT)
CSR_CASES = {
    "long row": (4 * FILL_TILE + 700, 300, "long row", False, 1),
    "zero rows at tile edges": (FILL_TILE, 64, "tile edges", False, 1),
    "no pairs": (2000, 1500, "no pairs", False, 1),
    "full bucket": (2 * FILL_TILE, 2 * FILL_TILE, "full", False, 1),
    "left absent": (3000, 2500, "absent", True, 1),
    "staged twice": (500, 4 * FILL_ROWS + 37, "sparse", False, 1),
    "shard without pairs": (2000, 4096, "dead shard", False, 4),
    "build tiles": (3 * BUILD_TILE + 11, 2000, "build tiles", True, 2),
}


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b <<= 1
    return b


def csr_case(name: str, seed: int = 8):
    """The case's (order, ends, ng, n_rows, bvalid, tbl, lo, hi, key,
    key_null, pvalid, outer, ob, probe_lanes, build_lanes, shards) as
    numpy arrays: one int64 key, a group index over the build keys (the
    one devpipe.GroupIndex builds: rows sorted by key, stable), lanes of
    1, 4 and 8 bytes with and without NULL flags."""
    n_build, n_probe, what, outer, shards = CSR_CASES[name]
    rng = np.random.default_rng(seed)
    nbb, nb = _bucket(n_build), _bucket(n_probe)
    nkeys = max(n_build // 5, 1)
    bk = rng.integers(1, nkeys + 1, n_build)
    bvalid_rows = rng.random(n_build) < 0.85
    pk = rng.integers(1, nkeys + 1, n_probe)
    pnull = rng.random(n_probe) < 0.03
    pvalid = rng.random(n_probe) < 0.9
    if what == "long row":
        bk[:4 * FILL_TILE] = 5
        pk[:] = rng.integers(1, nkeys + 1, n_probe)
        pk[::37] = 5
    elif what == "tile edges":
        # four keys of FILL_TILE / 4 valid rows each; every other probe
        # row matches one, so a fill tile holds four matched rows exactly
        # and an unmatched row sits on every tile edge
        bk = np.arange(n_build) % 4 + 1
        bvalid_rows[:] = True
        i = np.arange(n_probe)
        pk = np.where(i % 2 == 0, (i // 2) % 4 + 1, 10 * nkeys)
        pnull[:] = False
        pvalid[:] = True
    elif what == "no pairs":
        pk = pk + 10 * nkeys
    elif what == "full":
        bk = np.arange(n_build) % n_probe + 1
        pk = np.arange(n_probe) + 1
        pnull[:] = False
        pvalid[:] = True
        bvalid_rows[:] = True
    elif what == "absent":
        pk = np.where(rng.random(n_probe) < 0.5, pk, pk + 10 * nkeys)
    elif what == "sparse":
        pk = np.where(rng.random(n_probe) < 0.002, pk, 10 * nkeys)
    elif what == "dead shard":
        nbl = nb // shards
        pk[nbl:2 * nbl] = 10 * nkeys
    elif what == "build tiles":
        bk = np.repeat(np.arange(1, n_build + 1), 1)[:n_build] // 7 + 1
    order = np.argsort(bk, kind="stable").astype(np.int64)
    sk = bk[order]
    starts = np.concatenate([[True], sk[1:] != sk[:-1]])
    ends_ = np.concatenate([np.nonzero(starts)[0][1:] - 1, [n_build - 1]])
    ng = len(ends_)
    keys_sorted = sk[starts]
    lo, hi = int(keys_sorted[0]), int(keys_sorted[-1])
    tbl = np.full(hi - lo + 1, -1, np.int32)
    tbl[keys_sorted - lo] = np.arange(ng, dtype=np.int32)
    ngb = _bucket(ng)
    ends = np.full(ngb, n_build - 1, np.int64)
    ends[:ng] = ends_
    order_p = np.zeros(nbb, np.int64)
    order_p[:n_build] = order
    bvalid = np.zeros(nbb, bool)
    bvalid[:n_build] = bvalid_rows
    key = np.zeros(nb, np.int64)
    key[:n_probe] = pk
    knull = np.ones(nb, bool)
    knull[:n_probe] = pnull
    pv = np.zeros(nb, bool)
    pv[:n_probe] = pvalid
    counts = np.bincount(bk[bvalid_rows], minlength=nkeys + 2)
    m = np.where((pk >= 0) & (pk < len(counts)), counts[np.clip(
        pk, 0, len(counts) - 1)], 0) * (pvalid & ~pnull)
    per = m if not outer else np.where(pvalid, np.maximum(m, 1), 0)
    nbl = nb // shards
    tot = [int(per[s * nbl:(s + 1) * nbl].sum()) for s in range(shards)]
    ob = _bucket(max(max(tot), 1))
    if what == "full":
        ob = max(tot)
    probe_lanes = [(rng.integers(-9, 9, nb).astype(np.int32),
                    rng.random(nb) < 0.1), (key, knull)]
    build_lanes = [(rng.normal(size=nbb), rng.random(nbb) < 0.1),
                   (rng.random(nbb) < 0.5, None),
                   (rng.integers(0, 1 << 40, nbb), None)]
    return (order_p, ends, ng, n_build, bvalid, tbl, lo, hi, key, knull, pv,
            outer, ob, probe_lanes, build_lanes, shards)
