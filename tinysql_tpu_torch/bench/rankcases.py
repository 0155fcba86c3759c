"""Edge shapes of HK14 shard_rank (csrc/shard_rank.cu): seeded sorted runs
for holding the kernel against its plain version (tests and
chip_smoke.py) and a numpy model of its merge-path rounds against both.

A case is n runs of ``run`` elements: run s is the first ``run`` places of
the stable order (unsigned key, then row) of the rows s * stride ..
s * stride + stride - 1, as HK4 sorts one shard's rows; ``ids`` holds each
shard's whole order, so stride > run is the top-k's layout (the first kb
places of per-shard orders).  Keys are int64 words compared unsigned.
"""
from __future__ import annotations

import numpy as np

#: name -> (n, run, stride, k_out, lo, hi): keys uniform in [lo, hi)
CASES = {
    "ties_0_3": (8, 3000, 3000, 24000, 0, 4),
    "all_equal": (8, 2500, 2500, 20000, 5, 6),
    "n1": (1, 5000, 5000, 4000, 0, 4),
    "n2": (2, 4096, 4096, 8192, 0, 100),
    "n3": (3, 3001, 3001, 9003, 0, 4),
    "ragged_tiles": (5, 2049, 2049, 10245, 0, 1000),
    "k_out_cut": (8, 3000, 3000, 5000, 0, 4),
    "stride_gt_run": (8, 1500, 4096, 12000, -5, 5),
    "topk_layout": (8, 16, 1 << 14, 10, 0, 3),
    "topk_ties": (8, 16, 16, 16, 0, 2),
    "small_n3": (3, 300, 300, 900, 0, 4),
    "wide_keys": (8, 1 << 15, 1 << 15, 1 << 18, -(1 << 62), 1 << 62),
}


def runs(n: int, run: int, stride: int, lo: int, hi: int, seed: int):
    """(keys int64[n * stride], ids int64[n * stride]): each shard's rows
    in their stable unsigned order."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, hi, n * stride, dtype=np.int64)
    ids = np.empty(n * stride, np.int64)
    for s in range(n):
        sl = slice(s * stride, (s + 1) * stride)
        ids[sl] = np.argsort(keys[sl].view(np.uint64), kind="stable") \
            + s * stride
    return keys, ids


def case(name: str, seed: int = 0):
    """(keys, ids, stride, run, n, k_out) of a named case."""
    n, run, stride, k_out, lo, hi = CASES[name]
    keys, ids = runs(n, run, stride, lo, hi, seed)
    return keys, ids, stride, run, n, k_out


# ---- the numpy model of the kernel's rounds --------------------------------

#: the kernel's constants (kTile, kItems, kSmall in csrc/shard_rank.cu)
TILE, ITEMS, SMALL = 1024, 4, 1024


def _split(ka, kb, d: int) -> int:
    """Left elements among the first d outputs of merging ka and kb, a tie
    taking the left: ka[i] comes first iff ka[i] <= kb[j].  One thread's
    binary search, as split_in runs it in shared memory."""
    lo, hi = max(0, d - len(kb)), min(d, len(ka))
    while lo < hi:
        mid = (lo + hi) >> 1
        if ka[mid] <= kb[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def tile_cuts(ka, kb, d0: int, d1: int, probes: int):
    """The kernel's tile_cuts: the splits of diagonals d0 and d1, each
    found by one half of the block, ``probes`` threads probing its range
    at once a step.  Probe l of range [lo, top) reads position lo + l
    (all of a range no longer than ``probes``) or lo + l * len // probes;
    the last probe that holds sets the next lo, the first active one that
    does not the next top.  Returns ((cut0, cut1), steps); asserts that
    one thread at most writes each shared word a step."""
    la, lb = len(ka), len(kb)
    ds = (d0, d1)
    cut = [max(0, d - lb) for d in ds]
    top = [min(d, la) for d in ds]
    steps = 0
    while cut[0] < top[0] or cut[1] < top[1]:
        steps += 1
        new_cut, new_top = list(cut), list(top)
        for e, d in enumerate(ds):
            lo, n = cut[e], top[e] - cut[e]
            if n <= 0:
                continue
            ps = [lo + l * n // probes if n > probes else lo + l
                  for l in range(probes)]
            flag = [l < n and ka[ps[l]] <= kb[d - 1 - ps[l]]
                    for l in range(probes)]
            cw = [l for l in range(probes) if flag[l]
                  and not (l + 1 < probes and flag[l + 1])]
            tw = [l for l in range(probes) if l < n and not flag[l]
                  and (l == 0 or flag[l - 1])]
            assert len(cw) <= 1 and len(tw) <= 1, (cw, tw)
            for l in cw:
                new_cut[e] = ps[l] + 1
            for l in tw:
                new_top[e] = ps[l]
        cut, top = new_cut, new_top
    return (cut[0], cut[1]), steps


def _block(ka, ia, kb, ib, d0: int, d1: int, tile: int, items: int):
    """One block's tile [d0, d1) of the merge: the two cuts in device
    memory (tile_cuts, half the block's threads each), the ranges staged,
    each thread's own split and its items merged in sequence."""
    (i0, i1), _steps = tile_cuts(ka, kb, d0, d1, tile // items // 2)
    sk = list(ka[i0:i1]) + list(kb[d0 - i0:d1 - i1])
    si = list(ia[i0:i1]) + list(ib[d0 - i0:d1 - i1])
    na, cnt = i1 - i0, d1 - d0
    nb = cnt - na
    ok, oi = [None] * cnt, [None] * cnt
    for tid in range(tile // items):
        o0 = min(tid * items, cnt)
        o1 = min(o0 + items, cnt)
        a = _split(sk[:na], sk[na:], o0)
        b = o0 - a
        for o in range(o0, o1):
            if b >= nb or (a < na and sk[a] <= sk[na + b]):
                s, a = a, a + 1
            else:
                s, b = na + b, b + 1
            ok[o], oi[o] = sk[s], si[s]
    return ok, oi


def merge_rounds(keys, ids, stride: int, run: int, n: int, k_out: int,
                 tile: int = TILE, items: int = ITEMS,
                 small: int = SMALL) -> np.ndarray:
    """The row ids HK14 writes, computed as its kernels compute them."""
    u = [int(x) for x in np.asarray(keys).view(np.uint64)]
    ids = [int(x) for x in ids]
    total = n * run
    rounds = max(0, (n - 1).bit_length())
    if n == 1:
        return np.asarray(ids[:k_out], np.int64)
    if total <= small:
        return _small_rounds(u, ids, stride, run, n, k_out, rounds)
    cur_k = cur_i = None
    for j in range(rounds):
        w = run << j
        pairs = ((n + (1 << j) - 1) >> j) // 2 + ((n + (1 << j) - 1) >> j) % 2
        last = j == rounds - 1
        lim = k_out if last else total
        tpp = -(-min(2 * w, total, lim) // tile)
        nk, ni = [None] * total, [None] * total
        for q in range(pairs):
            base = q * 2 * w
            la = min(w, total - base)
            lb = max(0, min(w, total - base - w))
            if j == 0:
                ia = ids[2 * q * stride:2 * q * stride + la]
                ib = ids[(2 * q + 1) * stride:(2 * q + 1) * stride + lb]
                ka, kb = [u[r] for r in ia], [u[r] for r in ib]
            else:
                ka, ia = cur_k[base:base + la], cur_i[base:base + la]
                kb = cur_k[base + w:base + w + lb]
                ib = cur_i[base + w:base + w + lb]
            for t in range(tpp):
                d0, dend = t * tile, min(la + lb, lim)
                if d0 >= dend:
                    continue
                d1 = min(d0 + tile, dend)
                ok, oi = _block(ka, ia, kb, ib, d0, d1, tile, items)
                nk[base + d0:base + d1] = ok
                ni[base + d0:base + d1] = oi
        cur_k, cur_i = nk, ni
    return np.asarray(cur_i[:k_out], np.int64)


def _small_rounds(u, ids, stride, run, n, k_out, rounds) -> np.ndarray:
    """One block, every round in shared memory: each element placed by a
    binary search in its partner run (the partner's smaller keys before a
    left element, its keys <= the key before a right one)."""
    total = n * run
    si = [ids[(e // run) * stride + e % run] for e in range(total)]
    sk = [u[r] for r in si]
    for j in range(rounds):
        w = run << j
        nk, ni = [None] * total, [None] * total
        for e in range(total):
            p, r = divmod(e, w)
            ob = (p ^ 1) * w
            ol = max(0, min(w, total - ob))
            x, left = sk[e], p % 2 == 0
            lo, hi = 0, ol
            while lo < hi:
                mid = (lo + hi) >> 1
                y = sk[ob + mid]
                if (y < x) if left else (y <= x):
                    lo = mid + 1
                else:
                    hi = mid
            to = (p & ~1) * w + r + lo
            nk[to], ni[to] = x, si[e]
        sk, si = nk, ni
    return np.asarray(si[:k_out], np.int64)
