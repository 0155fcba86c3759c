"""Edge shapes of HK10 semi_pick and HK6 dense_probe, and a numpy model
of HK10's tiles.

The tile of HK10 (csrc/semi_pick.cu's kSpThreads x 16 x kSpRounds probe
rows) and the rows a thread of HK6 takes (csrc/dense_probe.cu's
kDpRows) are read from the sources, so the cases land on the edges the
kernels have.  Used by tests/test_torch_probe.py (the model against
``semi_pick_plain`` on the CPU), tests/test_torch_cuda.py and
chip_smoke.py (each kernel against its plain version on the card).

An HK10 case is (match, ln, lv, rn, rv): a probe row's membership, NULL
key and validity, the build rows' NULL key and validity (numpy bool).
An HK6 case is the arguments of ``kernels.dense_probe`` as numpy arrays.
"""
from __future__ import annotations

import contextlib
import os
import re

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")


def _const(source: str, name: str) -> int:
    with open(os.path.join(_CSRC, source)) as f:
        src = f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


SP_THREADS = _const("semi_pick.cu", "kSpThreads")
SP_ROUNDS = _const("semi_pick.cu", "kSpRounds")
SP_TILE = SP_THREADS * 16 * SP_ROUNDS
DP_ROWS = _const("dense_probe.cu", "kDpRows")

#: PRESENT_HEAD of ops/kernels.py (no import: chip_smoke.py's checks use
#: this module before they import the port)
HEAD = 1 << 12

#: HK10's modes: name -> (anti, null_aware)
SEMI_MODES = {"semi": (False, False), "anti": (True, False),
              "not in": (True, True)}

#: probe sizes at HK10's tile edges
SP_SIZES = {"1": 1, "tile-1": SP_TILE - 1, "tile": SP_TILE,
            "tile+1": SP_TILE + 1, "3 tiles+5": 3 * SP_TILE + 5}

#: name -> (n_probe, what is kept): "random" (half the valid rows are
#: members), "none", "all", "runs" (kept runs of 1..3 * 16 rows crossing
#: every tile and thread edge), "tile kept, tile not" (every other tile
#: keeps all its rows), "head" / "head+1" (exactly PRESENT_HEAD or one
#: more kept in semi mode)
HK10_CASES = {
    "1 random": (1, "random"),
    "tile-1 none": (SP_TILE - 1, "none"),
    "tile all": (SP_TILE, "all"),
    "tile+1 runs": (SP_TILE + 1, "runs"),
    "3 tiles+5 random": (3 * SP_TILE + 5, "random"),
    "3 tiles+5 alternate tiles": (3 * SP_TILE + 5, "tile kept, tile not"),
    "3 tiles+5 head": (3 * SP_TILE + 5, "head"),
    "3 tiles+5 head+1": (3 * SP_TILE + 5, "head+1"),
}


def hk10_case(case: str, seed: int = 10):
    """(match, ln, lv, rn, rv) of the case; the build side has 1,000 rows,
    half valid, no NULL key (the ladder's build rungs come from the
    tests)."""
    n, kind = HK10_CASES[case]
    rng = np.random.default_rng(seed)
    lv = rng.random(n) < 0.9
    ln = rng.random(n) < 0.05
    match = rng.random(n) < 0.5
    if kind == "none":
        match[:] = False
        lv[:] = False
    elif kind == "all":
        match[:] = True
        ln[:] = False
        lv[:] = True
    elif kind == "runs":
        edge = np.zeros(n, bool)
        q = 0
        while q < n:
            ln_ = int(rng.integers(1, 48))
            edge[q:q + ln_] = (q // ln_) % 2 == 0
            q += ln_
        match, ln, lv = edge, np.zeros(n, bool), np.ones(n, bool)
    elif kind == "tile kept, tile not":
        tile = np.arange(n) // SP_TILE
        match = tile % 2 == 0
        ln, lv = np.zeros(n, bool), np.ones(n, bool)
    elif kind in ("head", "head+1"):
        k = HEAD + (kind == "head+1")
        match = np.zeros(n, bool)
        match[rng.choice(n, k, replace=False)] = True
        ln, lv = np.zeros(n, bool), np.ones(n, bool)
    rv = rng.random(1000) < 0.5
    rn = np.zeros(1000, bool)
    return match, ln, lv, rn, rv


def hk10_flags(rn: np.ndarray, rv: np.ndarray):
    """sp_flags: (a valid build row exists, a valid build row has a NULL
    key)."""
    return bool(rv.any()), bool((rv & rn).any())


def hk10_model(match, ln, lv, rn, rv, anti: bool, null_aware: bool):
    """HK10's output as its tiles compute it: (count, kept rows).  Tile i
    holds rows [i * SP_TILE, (i + 1) * SP_TILE); row base + (r *
    SP_THREADS + t) * 16 + b is byte b of thread t's 16-byte load in
    round r; the (round, warp) totals of a tile are scanned in that order
    and each thread's rows ranked by a scan over its warp's lanes; the
    tiles' totals by the look-back (an exclusive prefix in tile order).
    The ladder's rule is chosen once a launch from the build flags."""
    n = len(match)
    any_valid, any_null = hk10_flags(rn, rv)
    if not anti:
        keep = match & lv & ~ln
    elif not any_valid:
        keep = lv.copy()
    elif not null_aware:
        keep = lv & ~match
    elif any_null:
        keep = np.zeros(n, bool)
    else:
        keep = lv & ~ln & ~match
    tiles = max(-(-n // SP_TILE), 1)
    pad = np.zeros(tiles * SP_TILE, bool)
    pad[:n] = keep
    # [tile, round, warp, lane, byte]
    k = pad.reshape(tiles, SP_ROUNDS, SP_THREADS // 32, 32, 16)
    per_thread = k.sum(-1)
    excl_lane = np.cumsum(per_thread, -1) - per_thread
    per_warp = per_thread.sum(-1).reshape(tiles, -1)
    excl_warp = (np.cumsum(per_warp, -1) - per_warp).reshape(
        tiles, SP_ROUNDS, SP_THREADS // 32, 1)
    totals = per_warp.sum(-1)
    prefix = np.cumsum(totals) - totals
    out = np.zeros(int(totals.sum()), np.int64)
    rows = np.arange(tiles * SP_TILE).reshape(k.shape)
    pos = (prefix[:, None, None, None, None] + excl_warp[..., None]
           + excl_lane[..., None] + np.cumsum(k, -1) - 1)
    out[pos[k]] = rows[k]
    return int(totals.sum()), out


#: HK6 probe sizes around a thread's rows
DP_SIZES = (1, DP_ROWS - 1, DP_ROWS + 1, 5 * DP_ROWS + 3, 4099)

#: HK6 build lanes by width: numpy dtype, with a NULL mask
DP_WIDTHS = {1: (np.bool_, True), 2: (np.int16, False), 4: (np.int32, True),
             8: (np.float64, True)}


def hk6_case(nb: int, lanes: int, lo: int, seed: int = 6):
    """The arguments of ``kernels.dense_probe`` (kp, knull, pvalid, lo, hi,
    tbl, bvalid, [(values, NULL mask or None)]) as numpy arrays: nb probe
    keys around a 300-key range [lo, lo + 299] (some outside, some at the
    ends of int64, 10% NULL), a table of 250 of the 300 keys, 512 build
    rows (80% valid), and ``lanes`` build lanes cycling through 1-, 2-, 4-
    and 8-byte values."""
    i64 = np.iinfo(np.int64)
    rng = np.random.default_rng(seed)
    hi = lo + 299
    tb = np.full(300, -1, np.int32)
    tb[rng.choice(300, 250, replace=False)] = rng.choice(
        512, 250, replace=False).astype(np.int32)
    off = rng.integers(-20, 320, nb)
    kp = np.array([min(max(lo + int(o), int(i64.min)), int(i64.max))
                   for o in off], np.int64)
    ends = [int(i64.max), int(i64.min), lo, hi]
    kp[:min(4, nb)] = ends[:min(4, nb)]
    blanes = []
    widths = list(DP_WIDTHS)
    for j in range(lanes):
        dt, nulls = DP_WIDTHS[widths[j % 4]]
        v = (rng.random(512) < 0.5) if dt == np.bool_ else \
            rng.integers(-1000, 1000, 512).astype(dt)
        blanes.append((v, rng.random(512) < 0.2 if nulls else None))
    return (kp, rng.random(nb) < 0.1, rng.random(nb) < 0.9, lo, hi, tb,
            rng.random(512) < 0.8, blanes)


def hk6_plain(kp, knull, pvalid, lo, hi, tbl, bvalid, blanes, mode: str):
    """HK6's contract in numpy: (valid_out, [(values, NULL flags)])."""
    inr = ~knull & (kp >= lo) & (kp <= hi)
    off = np.where(inr, kp, lo) - lo  # taken only inside [lo, hi]
    pos = np.where(inr, tbl[np.minimum(off, len(tbl) - 1)], -1)
    ps = np.clip(pos, 0, len(bvalid) - 1)
    match = (pos >= 0) & bvalid[ps]
    valid = {"left": pvalid, "anti": pvalid & ~match}.get(
        mode, pvalid & match)
    if mode not in ("inner", "left"):
        return valid, []
    return valid, [(v[ps], (~match if m is None else m[ps] | ~match))
                   for v, m in blanes]


#: HK6's two paths (kernels._dense_records picks one a launch): the row
#: path, and records a table slot
RECORD_KINDS = ("rows", "records")


@contextlib.contextmanager
def records(K, kind: str):
    """HK6 (the port's kernels module ``K``) on the path ``kind`` of
    RECORD_KINDS, whatever its rule would pick."""
    keep = K._dense_records

    def force(nb, nbb, tbl_len, lanes):
        return 2 * -(-(1 + len(lanes)) // 2) if kind == "records" else 0
    K._dense_records = force
    try:
        yield
    finally:
        K._dense_records = keep
