"""HK2's present-segment compaction and HK9 run_bounds on the card, at the
main path's shapes, with the host syncs and the launches of each call.

    python3 tinysql_tpu_torch/bench/compact_bench.py [--root DIR]
        [--out FILE] [--ptxas]

Each shape is first checked against the kernel's plain version (exactly),
then timed: the median of CUDA events around one call (``ms``: the host
work between the launches and any wait for a pull included), the device
time of one call from a whole torch.profiler trace (``device_ms``), the
kernels, memsets and copies one call enqueues by name (``by_kernel``,
``launches``: their count a call), and the bound (the bytes the call must
move at 3.35 TB/s).  ``syncs`` counts the synchronizing CUDA calls of one
call (torch.cuda.set_sync_debug_mode), ``d2h`` its counted pulls.  Shapes:

- ``present_compact`` at per-operator Q3's aggregate table (2^21
  segments, ~1.43M present, 4 rows: presence, first row, a SUM lane's
  value and count), the device-resident compaction of
  ``fused_segment_aggregate_keep``;
- ``present_rows`` (the pipeline's large outputs) over that table with 0,
  1, PRESENT_HEAD, PRESENT_HEAD + 1 and ~1.43M present columns;
- ``_present_extract`` through ``segment_group_aggregate`` (host group
  ids, 2^20 rows, 2^20 segments: HK2's sort regime, then the extraction)
  with 1,000 and ~495,000 groups present;
- HK9 at pipeline Q13's two GROUP BYs (2^21 sorted rows: 1.5M valid rows
  of ~150,000 c_custkey runs; 150,000 valid c_count values) and at 2^23
  rows with two keys (an int lane and a float lane, 10% NULL).

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions are measured by
one script, in one call, on one card: run parent, change, change, parent,
each as a file.  ``--ptxas`` prints the registers, stack and spills of the
root's ``segment_reduce.cu`` and ``run_bounds.cu``.  One JSON object per
shape, the card's name and power limit in each.  Exits 2 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__:
    from .expr_bench import card, cuda_ms, ptxas
    from .scalar_join_bench import syncs_of
    from .trace_tpch import device_trace
else:  # run as a file, as --root needs
    from expr_bench import card, cuda_ms, ptxas
    from scalar_join_bench import syncs_of
    from trace_tpch import device_trace

SEED = 13
MEM_BPS = 3.35e12
HEAD = 1 << 12  # kernels.PRESENT_HEAD


def device_of(fn) -> dict:
    """One call's device time, its kernels / memsets / copies by name and
    their count (None when no trace of three was whole)."""
    fn()
    evts, _wall, whole = device_trace(fn, 10, tries=3)
    if not whole:
        return {"device_ms": None, "launches": None, "by_kernel": {}}
    by = {}
    for k, us, c in evts:
        ms, n = by.get(k[:48], (0.0, 0))
        by[k[:48]] = (ms + us / 1e3, n + c)
    return {"device_ms": sum(ms for ms, _n in by.values()),
            "launches": sum(n for _ms, n in by.values()),
            "by_kernel": {k: [round(ms, 5), n] for k, (ms, n) in by.items()}}


def run(root: str, out, with_ptxas: bool) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from tinysql_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", torch.cuda.current_device())
    name = card()
    rng = np.random.default_rng(SEED)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    def emit(rec):
        rec.update({"root": root, "card": name})
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    def timed(fn, **extra):
        return {"ms": cuda_ms(fn), **device_of(fn), **syncs_of(K, fn),
                **extra}

    if with_ptxas:
        ptxas(root, emit, ("segment_reduce", "run_bounds"))
    with K.use_device(dev):
        # -- HK2's compaction at Q3's table -------------------------------
        ns = 1 << 21
        pres = np.zeros(ns, np.int64)
        pres[:1_500_000] = rng.binomial(4, 0.54, 1_500_000)
        rows = np.vstack([pres, rng.integers(0, 1 << 23, (3, ns))])
        tab = t(rows)
        ids = np.nonzero(pres > 0)[0]
        nq3 = len(ids)

        def compact_check(tb):
            a, b = K.present_compact(tb, ns), K.present_compact_plain(tb, ns)
            if a[0] != b[0] or not torch.equal(a[1], b[1]):
                raise SystemExit("present_compact differs from the plain "
                                 "version")
            return a[0]

        compact_check(tab)
        ob = min(K.bucket(nq3), ns)
        emit({"kernel": "present_compact", "shape":
              f"Q3 table: 2^21 segments, {nq3} present, 4 rows",
              **timed(lambda: K.present_compact(tab, ns)),
              "bound_ms": (8 * ns + 8 * 3 * nq3 + 8 * 5 * ob) / MEM_BPS * 1e3,
              "partial_mask_select_ms": cuda_ms(
                  lambda: tab[:, tab[0] > 0])})
        for k in (0, 1, HEAD, HEAD + 1, nq3):
            p = np.zeros(ns, np.int64)
            p[ids[:k]] = pres[ids[:k]]
            tk = tab.clone()
            tk[0] = t(p)
            want = rows[1:, ids[:k]]
            if not np.array_equal(K.present_rows(tk, ns), want):
                raise SystemExit(f"present_rows differs at {k} present")
            emit({"kernel": "present_rows", "shape":
                  f"2^21 segments, {k} present, 4 rows",
                  **timed(lambda: K.present_rows(tk, ns)),
                  "bound_ms": (8 * ns + 8 * 3 * k + 8) / MEM_BPS * 1e3})
        del tab, tk
        torch.cuda.empty_cache()

        # -- the per-operator extraction (segment_group_aggregate) ----------
        n = 1 << 20
        specs = [("count_star", False), ("sum", True)]
        for groups in (1000, 600_000):
            gids = rng.integers(0, groups, n).astype(np.int64)
            cols = [(rng.random(n), np.zeros(n, bool))]
            fn = lambda: K.segment_group_aggregate(  # noqa: E731
                gids, n, specs, cols, n)
            got = fn()
            with K.use_device("cpu"):
                want = K.segment_group_aggregate(gids, n, specs, cols, n)
            if not np.array_equal(got[0], want[0]) or not np.allclose(
                    got[1][1][0], want[1][1][0], rtol=1e-9):
                raise SystemExit(f"segment_group_aggregate differs "
                                 f"({groups} groups)")
            emit({"kernel": "segment_group_aggregate", "shape":
                  f"2^20 rows, 2^20 segments, {len(got[0])} present",
                  **timed(fn)})

        # -- HK9 ------------------------------------------------------------
        def hk9(what, perm, valid, keys, n_valid):
            a = K.run_bounds(perm, valid, keys, want_gid=True)
            b = K.run_bounds_plain(perm, valid, keys, want_gid=True)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise SystemExit(f"run_bounds differs: {what}")
            nn = int(perm.shape[0])
            lane = sum(8 + (m is not None) for _v, m in keys)
            emit({"kernel": "run_bounds", "shape": what,
                  "groups": int(a[0][0]),
                  **timed(lambda: K.run_bounds(perm, valid, keys)),
                  "bound_ms": (9 * nn + lane * n_valid + 16 * nn + 8)
                  / MEM_BPS * 1e3})

        n9 = 1 << 21
        n_o, n_c = 1_500_000, 150_000
        zeros = t(np.zeros(n9, bool))
        valid9 = t(np.arange(n9) < n_o)
        cust = rng.integers(1, n_c + 1, n_o)
        k9 = [(t(K.pad1(cust, n9), torch.int64), zeros)]
        perm9 = K.lex_order(K.sort_lanes(k9, [False], valid9), n9)
        hk9(f"Q13 GROUP BY c_custkey: 2^21 rows, {n_o} valid", perm9,
            valid9, k9, n_o)
        cnt = np.bincount(cust, minlength=n_c + 1)[1:]
        validc = t(np.arange(n9) < n_c)
        kc = [(t(K.pad1(cnt, n9), torch.int64), zeros)]
        permc = K.lex_order(K.sort_lanes(kc, [False], validc), n9)
        hk9(f"Q13 GROUP BY c_count: 2^21 rows, {n_c} valid", permc, validc,
            kc, n_c)
        del perm9, permc, k9, kc
        n23 = 1 << 23
        v23 = t(rng.random(n23) < 0.9)
        k23 = [(t(rng.integers(0, 1 << 20, n23), torch.int64),
                t(rng.random(n23) < 0.1)),
               (t(rng.integers(-3, 4, n23).astype(np.float64)),
                t(rng.random(n23) < 0.1))]
        p23 = K.lex_order(K.sort_lanes(k23, [False, False], v23), n23)
        hk9("2^23 rows, 90% valid, int64 + float64 keys, 10% NULL", p23,
            v23, k23, int(v23.sum()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compact_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(a.root)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            run(root, f, a.ptxas)
    else:
        run(root, None, a.ptxas)
    return 0


if __name__ == "__main__":
    sys.exit(main())
