"""Edge shapes of HK2's present-segment compaction and of HK9 run_bounds,
and a numpy model of HK9's tiles.

The tile sizes are read from the sources (csrc/segment_reduce.cu's
kPcThreads x 2 x kPcRounds segments, csrc/run_bounds.cu's kRbThreads x
kRbRows sorted positions), so the cases land on the tile edges the kernels
have.  Used by tests/test_torch_compact.py (the model against
``run_bounds_plain`` on the CPU), tests/test_torch_cuda.py and
chip_smoke.py (each kernel against its plain version on the card).

A compaction case is a table int64[rows, ns] whose row 0 is the presence
row.  An HK9 case is (perm, valid, keys) in row space, built in sorted
position space first: ``perm`` maps each position to a shuffled row, the
valid rows come first (as ``kernels.sort_lanes`` orders them), and the
keys of a position are chosen so that runs start and end where the case
wants them.
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
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


PC_TILE = (_const("segment_reduce.cu", "kPcThreads") * 2
           * _const("segment_reduce.cu", "kPcRounds"))
RB_THREADS = _const("run_bounds.cu", "kRbThreads")
RB_ROWS = _const("run_bounds.cu", "kRbRows")
RB_TILE = RB_THREADS * RB_ROWS
RB_WARPS = RB_THREADS // 32

#: PRESENT_HEAD of ops/kernels.py (no import: chip_smoke.py's checks use
#: this module before they import the port)
HEAD = 1 << 12

#: name -> (ns, rows, present): present a count of segments, "all",
#: "most" (70%, spread) or "tile+1" (every segment of a table one past a
#: tile)
COMPACT_CASES = {
    "none": (1 << 17, 4, 0),
    "one": (1 << 17, 4, 1),
    "head": (1 << 17, 4, HEAD),
    "head+1": (1 << 17, 4, HEAD + 1),
    "most": (1 << 17, 8, "most"),
    "all": (1 << 17, 4, "all"),
    "tile+1": (PC_TILE + 1, 4, "all"),
    "tile+1 sparse": (PC_TILE + 1, 3, 5),
}


def compact_table(case: str, seed: int = 13) -> np.ndarray:
    """The case's table: row 0 positive at the present segments (zero or
    negative elsewhere), the other rows any int64."""
    ns, rows, present = COMPACT_CASES[case]
    rng = np.random.default_rng(seed)
    tab = rng.integers(-(1 << 62), 1 << 62, (rows, ns), dtype=np.int64)
    if present == "all":
        tab[0] = rng.integers(1, 100, ns)
    elif present == "most":
        tab[0] = np.where(rng.random(ns) < 0.7, rng.integers(1, 9, ns),
                          -rng.integers(0, 9, ns))
    else:
        tab[0] = -rng.integers(0, 3, ns)
        at = rng.choice(ns, present, replace=False)
        if present:
            at[0] = ns - 1  # the last segment present, past the last tile
        tab[0, at] = rng.integers(1, 9, present)
    return tab


def compact_plain(tab: np.ndarray, lo: int = 0, ids: bool = True):
    """The present columns in numpy: int64[w, n_present]."""
    present = np.nonzero(tab[0] > 0)[0]
    cols = tab[lo:, present]
    return np.vstack([present[None, :], cols]) if ids else cols


#: name -> (n, n_valid, run lengths in position order, lanes); lanes is
#: "int", "int2" (an int lane and a float lane with NaN, -0.0 and +0.0),
#: each with NULL runs
HK9_CASES = {
    "cross_edges": (3 * RB_TILE + 100, 3 * RB_TILE + 50, [300], "int2"),
    "run_at_tile_start": (4 * RB_TILE, 4 * RB_TILE, [256, 1, 255, 512],
                          "int"),
    "tile_all_invalid": (4 * RB_TILE, RB_TILE + 7, [97], "int2"),
    "n1": (1, 1, [1], "int"),
    "n1_invalid": (1, 0, [1], "int"),
    "tile+1 joined": (RB_TILE + 1, RB_TILE + 1, [RB_TILE - 3, 4], "int"),
    "tile+1 alone": (RB_TILE + 1, RB_TILE + 1, [RB_TILE, 1], "int2"),
    "floats": (2 * RB_TILE + 9, 2 * RB_TILE, [3, 1, 2, 7], "int2"),
}


def hk9_case(case: str, seed: int = 9):
    """(perm int64[n], valid bool[n], [(values, NULL mask or None)]) in
    row space."""
    n, n_valid, lens, lanes = HK9_CASES[case]
    rng = np.random.default_rng(seed)
    # run r of the cycle of lengths covers positions [start, start + len)
    run = np.empty(n, np.int64)
    q, r = 0, 0
    while q < n:
        ln = lens[r % len(lens)]
        run[q:q + ln] = r
        q += ln
        r += 1
    run = run[:n]
    # an int lane: the run's number, NULL on every fifth run (NULLs equal
    # each other: two NULL runs in a row join, so NULL runs take every
    # fifth run alone)
    null_i = (run % 5) == 3
    iv = np.where(null_i, rng.integers(-9, 9, n), run)
    keys_pos = [(iv, null_i)]
    if lanes == "int2":
        # a float lane constant over runs of the int lane, and inside
        # them -0.0 / +0.0 mixed (equal), NaN splitting every position of
        # its runs, NULL runs
        fv = (run // 2).astype(np.float64)
        zero = (run % 4) == 1
        fv[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
        nan = (run % 7) == 5
        fv[nan] = np.nan
        null_f = (run % 11) == 9
        keys_pos.append((fv, null_f))
    valid_pos = np.arange(n) < n_valid
    perm = rng.permutation(n).astype(np.int64)
    keys = []
    for v, m in keys_pos:
        vr = np.empty_like(v)
        vr[perm] = v
        mr = np.empty(n, bool)
        mr[perm] = m
        keys.append((vr, mr))
    valid = np.empty(n, bool)
    valid[perm] = valid_pos
    return perm, valid, keys


def _same(vals, nulls, a, b) -> np.ndarray:
    """The NULL-aware equality of entries a and b (index arrays) of the
    gathered lanes: both NULL, or neither NULL and equal values (floats as
    floats)."""
    out = np.ones(len(a), bool)
    for v, m in zip(vals, nulls):
        out &= (m[a] == m[b]) & (m[a] | (v[a] == v[b]))
    return out


def hk9_model(perm: np.ndarray, valid: np.ndarray, keys):
    """HK9's outputs as its tiles compute them: (count, lead, ends, gid).
    Tile i holds positions [i * RB_TILE, (i + 1) * RB_TILE) and gathers
    them with one position of halo on each side; position base + r *
    RB_THREADS + t belongs to round r, warp t // 32; the 32 (round, warp)
    leader counts of a tile are scanned in that order, and the tiles'
    totals by the look-back (an exclusive prefix in tile order)."""
    n = len(perm)
    tiles = -(-n // RB_TILE)
    flags, totals = [], []
    for tile in range(tiles):
        base = tile * RB_TILE
        q = np.arange(base - 1, base + RB_TILE + 1)
        inside = (q >= 0) & (q < n)
        row = np.where(inside, perm[np.clip(q, 0, n - 1)], -1)
        v = np.where(row >= 0, valid[np.clip(row, 0, None)], False)
        vals = [np.where(v, k[np.clip(row, 0, None)], 0) for k, _ in keys]
        nulls = [np.where(v, np.zeros(len(q), bool) if m is None
                          else m[np.clip(row, 0, None)], False)
                 for _, m in keys]
        e = np.arange(1, RB_TILE + 1)
        mine = v[e]
        lead = mine & (~v[e - 1] | ~_same(vals, nulls, e - 1, e))
        end = mine & (~v[e + 1] | ~_same(vals, nulls, e, e + 1))
        chunks = lead.reshape(RB_ROWS, RB_WARPS, 32)
        flags.append((q[1:-1], row[1:-1], mine, chunks, end))
        totals.append(int(lead.sum()))
    prefix = np.concatenate([[0], np.cumsum(totals)[:-1]]).astype(np.int64)
    count = int(sum(totals))
    lead_out = np.zeros(n, np.int64)
    ends = np.zeros(n, np.int64)
    gid = np.zeros(n, np.int64)
    for tile, (q, row, mine, chunks, end) in enumerate(flags):
        c = chunks.sum(-1).reshape(-1)
        off = prefix[tile] + np.concatenate([[0], np.cumsum(c)[:-1]])
        incl = off.reshape(RB_ROWS, RB_WARPS, 1) + np.cumsum(chunks, -1)
        g = (incl - 1).reshape(-1)
        ld = chunks.reshape(-1)
        keep = q < n
        lead_out[g[ld & keep]] = q[ld & keep]
        ends[g[end & keep]] = q[end & keep]
        gid[row[keep]] = np.where(mine[keep], g[keep], n)
    lead_out[count:] = 0
    ends[count:] = ends[count - 1] if count else -1
    return count, lead_out, ends, gid
