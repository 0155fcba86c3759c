"""A numpy model of HK1 masked_reduce's order of work (csrc/masked_reduce.cu).

The constants are read from the source: tiles of THREADS * WORD rows, a
block owning ``tpb`` consecutive tiles (tpb = ceil(tiles / MAX_BLOCKS),
then ceil(tiles / tpb) blocks: the plan depends on n alone), thread t
owning rows tile * TILE + WORD * t .. + WORD - 1 of each of its block's
tiles.  A thread adds its live rows in row order; a block folds its
threads in a fixed tree (a shuffle tree over each warp's 32 lanes,
offsets 16 .. 1, then one over the warp results, offsets WARPS / 2 .. 1);
the last block folds the block partials, thread t those at t, t +
THREADS, ... in block order, then the same tree.  Float sums follow that
order exactly; integer sums, counts and min / max do not depend on it.

Used by tests/test_torch_pulls.py (the model against the plain version,
and a member of a batch against a solo call) and tests/test_torch_cuda.py
(the kernel against the model, bit for bit).
"""
from __future__ import annotations

import os
import re

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "masked_reduce.cu")


def _const(name: str) -> int:
    src = open(_SRC).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


THREADS = _const("kThreads")
WORD = _const("kWord")
MAX_BLOCKS = _const("kMaxBlocks")
WARPS = THREADS // 32
TILE = THREADS * WORD
I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)


def plan(n: int):
    """(tiles per block, blocks) for n rows."""
    tiles = -(-n // TILE)
    tpb = max(1, -(-tiles // MAX_BLOCKS))
    return tpb, max(1, -(-tiles // tpb))


def _tree(x: np.ndarray) -> np.ndarray:
    """The block tree over the last axis (THREADS float64 partials)."""
    x = x.reshape(x.shape[:-1] + (WARPS, 32)).copy()
    o = 16
    while o:
        x[..., :o] = x[..., :o] + x[..., o:2 * o]
        o >>= 1
    w = x[..., 0].copy()
    o = WARPS // 2
    while o:
        w[..., :o] = w[..., :o] + w[..., o:2 * o]
        o >>= 1
    return w[..., 0]


def float_sum(vals: np.ndarray, live: np.ndarray) -> float:
    """HK1's float64 SUM of ``vals`` over ``live`` rows, in its order."""
    n = len(vals)
    tpb, nblk = plan(n)
    rows = nblk * tpb * TILE
    x = np.zeros(rows, dtype=np.float64)
    x[:n] = np.where(live, vals, 0.0)
    # [block, tile of the block, thread, row of the word] -> per thread
    # its rows in order: tile-major, then the word's rows
    x = x.reshape(nblk, tpb, THREADS, WORD).transpose(0, 2, 1, 3)
    x = x.reshape(nblk, THREADS, tpb * WORD)
    # +0.0 first (the identity): a dead row adds +0.0, which changes no
    # partial (a partial that starts at +0.0 is never -0.0)
    x = np.concatenate([np.zeros((nblk, THREADS, 1)), x], axis=2)
    part = _tree(np.add.accumulate(x, axis=2)[..., -1])
    per = -(-nblk // THREADS)
    f = np.zeros(per * THREADS, dtype=np.float64)
    f[:nblk] = part
    f = np.concatenate([np.zeros((1, THREADS)), f.reshape(per, THREADS)])
    return float(_tree(np.add.accumulate(f, axis=0)[-1]))


def masked_reduce(valid: np.ndarray, lanes) -> np.ndarray:
    """The kernel's output, int64[2 + 2 * len(lanes)]: [n_valid, first
    valid row (0 when none), (value bits, live count) per lane].
    ``lanes``: (values int64 / float64 or None, NULL mask or None, op)."""
    valid = np.asarray(valid, dtype=bool)
    out = [int(valid.sum()), int(np.argmax(valid)) if valid.any() else 0]
    for v, m, op in lanes:
        live = valid if m is None else valid & ~np.asarray(m, dtype=bool)
        cnt = int(live.sum())
        if op == "count":
            out += [0, cnt]
            continue
        v = np.asarray(v)
        f = v.dtype == np.float64
        x = v[live]
        if op == "sum":
            if f:
                r = np.float64(float_sum(v, live))
            else:
                with np.errstate(over="ignore"):
                    r = np.int64(x.astype(np.uint64).sum(dtype=np.uint64)
                                 .astype(np.int64))
        elif f and np.isnan(x).any():
            r = np.float64(np.nan)
        elif op == "min":
            r = x.min() if len(x) else (np.float64(np.inf) if f
                                        else np.int64(I64_MAX))
        else:
            r = x.max() if len(x) else (np.float64(-np.inf) if f
                                        else np.int64(I64_MIN))
        out += [int(np.asarray(r, dtype=v.dtype).view(np.int64)), cnt]
    return np.array(out, dtype=np.int64)


def masked_reduce_batched(valid: np.ndarray, lanes) -> np.ndarray:
    """HK1b: member b's row is masked_reduce over member b's mask and
    lanes (a lane [B, n] per member, [n] shared): the same plan and trees,
    whatever B."""
    valid = np.asarray(valid, dtype=bool)

    def row(a, b):
        return None if a is None else (a[b] if np.ndim(a) == 2 else a)
    return np.stack([masked_reduce(valid[b], [(row(v, b), row(m, b), op)
                                              for v, m, op in lanes])
                     for b in range(valid.shape[0])])
