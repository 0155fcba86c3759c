#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tinysql_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any mismatch raises, and the script exits nonzero without a
result line):

1. the card's name and power limit (nvidia-smi) and the build of the
   ten hand-written kernel sources (HK1-HK10; K12's batched entry points
   live in HK7's, HK1's and HK2's) from tinysql_tpu_torch/csrc;
2. each kernel against its plain torch version on the card, at the shapes
   the main path gives it at TPC-H SF=1 plus edge cases: integers, counts,
   NULL masks and row order exactly, float sums within 1e-6 relative; each
   kernel runs twice and must give the same bytes.  Median CUDA-event
   times of the kernel (and its device-only time from torch.profiler,
   which leaves out the host work between launches), its plain version
   and, where one exists, the single PyTorch call computing the same
   function, beside the bound (the bytes this run's data needs each input
   read once and each output written once take at 3.35 TB/s, or the
   operations at the card's peak, whichever is larger).
   Calls that compute only part of a kernel's function are timed too and
   printed under names that say which part, never as library_ms;
   HK7 (expr_eval) runs Q6's filter mask and revenue lane, Q1's argument
   lanes and Q3's leaf masks at SF=1 shapes, then the expression battery
   (tinysql_tpu_torch/bench/exprcases.py: every SQL function, K14's code
   compares, K15's layouts, programs split past its limits), byte for
   byte against its plain version (float % within 1 ulp, the largest
   distance printed); HK8 (csr_expand) runs Q13's join (150,000
   customers LEFT JOIN 1.5M orders), HK9 (run_bounds) its two GROUP BYs,
   HK6's composite mode a two-key probe of 2^21 rows; K12's batched
   entry points (a stacked round's one launch for B members) byte for
   byte against B solo launches and their plain versions: HK7b
   (expr_eval_batched) and HK1b (masked_reduce_batched) at Q6's SF=1
   program for B = 2, 3 (the B = 4 launch with an inert padding row), 8
   and 16, HK2b (segment_reduce_batched) at Q1's 16 segments and at a
   2^21-segment sort regime for B = 4, each beside the time of B solo
   calls and a bound that counts the shared columns once; HK10
   (semi_pick, K8's ladder and compaction over HK3's membership) in the
   semi, anti and NOT IN modes at NOT IN's SF=1 shape (1.5M orders
   probing ~3M lineitem keys), with an empty build side, one NULL build
   key and NULL probe keys, byte for byte against its plain version,
   beside torch.nonzero over the same keep mask (a partial call);
3. the main path: new_session() on cuda, tpch.load at SF=1 (seed 7), then
   TPC-H Q1, Q3, Q6, Q13 and the workload trio Q5, Q10, Q18 through SQL
   with tidb_use_tpu=1, on each device tier in turn: the pipeline tier
   (tidb_devpipe=-1, the default: plans with a join or a grouped
   aggregate run as executor/devpipe.py pipelines, whose compiled node
   kinds are checked, and Q13's single device->host copy) and the
   per-operator tier (tidb_devpipe=0); Q1, Q3 and Q6 on both tiers
   first, then Q13, then K8's path (tpch.K8_QUERIES: a NOT IN subquery,
   planned as a null-aware anti join, which EXPLAIN must show, TPC-H
   Q22 with its NOT EXISTS, and that NOT EXISTS alone, whose count of
   customers without an order must not be 0), then a block-wise run of
   Q1, Q3, Q6 and NOT IN on both tiers under tidb_device_block_rows =
   2^20 (rows equal to the unblocked run's, floats within 1e-6 relative;
   blocks streamed for Q1, Q3 and Q6; block counts and warm walls at
   staging depth 0 and 2 printed, rows byte-equal), then the trio.
   The launch counters are set to 0 just before each such run and read
   just after it.  The rows must
   equal the port's own CPU tier (tidb_use_tpu=0) under tpch.canon_rows
   — Q13's and Q5's must equal numpy's answers over the generated
   columns (tpch.q13_rows, tpch.q5_rows), because the CPU tier's
   row-at-a-time joins take minutes on them at SF=1 —, each wrapper's
   launch counter (one
   count per launching wrapper call) must rise on the queries that use
   it, and no plain version may run.  One more warm run of each query
   under torch.profiler counts the CUDA kernels and copies it launches
   (a warm Q6, which runs the per-operator executors on both tiers, may
   launch at most six kernels);
   then the serve phase: the port's MySQL wire server (Server(storage,
   port=0), on the card) over phase 3's tables answers a Q6 substitution
   stream (8 connections, TPC-H Clause 2.4.6.3) and a Q1 stream (4,
   Clause 2.4.1.3, under tidb_devpipe=0) sent together: every member's
   row packets must equal its statement run solo in a Session, a stacked
   storm must form a stacked round of occupancy >= 4 that launches the
   batched HK7b and HK1b / HK2b once, and no plain version may run;
   each storm's wall is printed with tidb_batch_stack_max 16 and 0, with
   the server's host profilers on (their defaults) and off;
4. one JSON line listing the kernels ({"kernels": [...]}; launches: the
   main path's and the serve phase's), then the result line {"ok": true,
   "device": {...}}.

Needs one CUDA card and the CUDA toolkit (nvcc); no network.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BPS = 3.35e12   # H100 SXM HBM3 memory rate
OPS_PS = 67e12      # H100 SXM non-tensor-core float32 peak
SF = 1.0
SEED = 7
FLOAT_RTOL = 1e-6   # the reference's own bound (executor/devpipe.py)

KERNELS = {
    "masked_reduce": ("tinysql_tpu_torch/csrc/masked_reduce.cu",
                      "tinysql_tpu/ops/kernels.py:1388"),
    "segment_reduce": ("tinysql_tpu_torch/csrc/segment_reduce.cu",
                       "tinysql_tpu/ops/kernels.py:1007"),
    "present_compact": ("tinysql_tpu_torch/csrc/segment_reduce.cu",
                        "tinysql_tpu/ops/kernels.py:954"),
    "equi_join": ("tinysql_tpu_torch/csrc/equi_join.cu",
                  "tinysql_tpu/ops/kernels.py:1803"),
    "lex_order": ("tinysql_tpu_torch/csrc/lex_order.cu",
                  "tinysql_tpu/ops/kernels.py:2165"),
    "csr_reduce": ("tinysql_tpu_torch/csrc/csr_reduce.cu",
                   "tinysql_tpu/executor/devpipe.py:757"),
    "dense_probe": ("tinysql_tpu_torch/csrc/dense_probe.cu",
                    "tinysql_tpu/executor/devpipe.py:1420"),
    "expr_eval": ("tinysql_tpu_torch/csrc/expr_eval.cu",
                  "tinysql_tpu/ops/exprjit.py:123"),
    "csr_expand": ("tinysql_tpu_torch/csrc/csr_expand.cu",
                   "tinysql_tpu/executor/devpipe.py:1502"),
    "run_bounds": ("tinysql_tpu_torch/csrc/run_bounds.cu",
                   "tinysql_tpu/executor/devpipe.py:1833"),
    # K12 (stacked_variant, ops/kernels.py:1228): the batched entry
    # points a stacked round of the serve phase launches
    "expr_eval_batched": ("tinysql_tpu_torch/csrc/expr_eval.cu",
                          "tinysql_tpu/ops/kernels.py:1228"),
    "masked_reduce_batched": ("tinysql_tpu_torch/csrc/masked_reduce.cu",
                              "tinysql_tpu/ops/kernels.py:1228"),
    "segment_reduce_batched": ("tinysql_tpu_torch/csrc/segment_reduce.cu",
                               "tinysql_tpu/ops/kernels.py:1228"),
    # K8's ladder and compaction (_semi_kernel :1987, _semi_pick_kernel
    # :2030); its membership is HK3's
    "semi_pick": ("tinysql_tpu_torch/csrc/semi_pick.cu",
                  "tinysql_tpu/ops/kernels.py:1987"),
}
# per device tier (its tidb_devpipe value), the kernels each query of the
# main path must launch
TIERS = {"pipeline": -1, "per_op": 0}
USES = {
    "pipeline": {"Q1": ("expr_eval", "csr_reduce", "lex_order"),
                 "Q3": ("expr_eval", "dense_probe", "csr_reduce",
                        "lex_order"),
                 "Q6": ("expr_eval", "masked_reduce"),
                 "Q5": ("expr_eval", "equi_join", "segment_reduce",
                        "lex_order"),
                 "Q10": ("expr_eval", "dense_probe", "equi_join",
                         "segment_reduce", "lex_order"),
                 "Q18": ("expr_eval", "csr_reduce", "dense_probe",
                         "equi_join", "segment_reduce", "lex_order"),
                 "Q13": ("expr_eval", "csr_expand", "run_bounds",
                         "lex_order", "csr_reduce", "present_compact")},
    "per_op": {"Q1": ("expr_eval", "segment_reduce", "lex_order"),
               "Q3": ("expr_eval", "equi_join", "segment_reduce",
                      "present_compact", "lex_order"),
               "Q6": ("expr_eval", "masked_reduce"),
               "Q5": ("expr_eval", "equi_join", "segment_reduce",
                      "lex_order"),
               "Q10": ("expr_eval", "equi_join", "segment_reduce",
                       "lex_order"),
               "Q18": ("expr_eval", "equi_join", "segment_reduce",
                       "present_compact", "lex_order"),
               "Q13": ("expr_eval", "equi_join", "segment_reduce",
                       "lex_order")},
}
# K8 runs on the per-operator tier on both device tiers: the pipeline's
# compile rules refuse a null-aware anti join, Q22's anti join sits
# under a projection the planner leaves on the CPU, and NOT_EXISTS's under
# a scalar aggregate (the reference plans them so too)
for _tier in USES:
    USES[_tier]["NOT_IN"] = ("equi_join", "semi_pick", "masked_reduce")
    USES[_tier]["Q22"] = ("equi_join", "semi_pick")
    USES[_tier]["NOT_EXISTS"] = ("equi_join", "semi_pick", "masked_reduce")
# node kinds each pipeline compiles (executor/devpipe.py COMPILED_NODE_KEYS).
# Q5 compiles none at SF=1: under the default tidb_tpu_min_rows (8192)
# its only pipeline-shaped subtree, nation semi-joined with region (25
# and 5 rows), runs on the CPU tier, and its joins above are multi-key or
# non-unique (per-operator tier, as in the reference)
PIPE_KINDS = {"Q1": {"leaf", "aggindex", "proj", "order"},
              "Q3": {"leaf", "join", "aggindex", "order"},
              "Q5": set(),
              "Q10": {"leaf", "join"},
              "Q18": {"leaf", "aggindex", "sel", "proj", "semijoin",
                      "join"},
              "Q13": {"leaf", "joinm", "sortgroup", "proj", "order"},
              "NOT_IN": set(), "Q22": set(), "NOT_EXISTS": set()}
#: pipeline queries that must pull their result in ONE device->host copy
ONE_D2H = ("Q13",)
#: queries whose rows are held to numpy's answer over the generated
#: columns instead of the CPU tier's (whose row-at-a-time joins take
#: minutes on them at SF=1)
NUMPY_ROWS = {"Q13": "q13_rows", "Q5": "q5_rows"}
#: warm repeats per query; the workload trio takes one on the
#: per-operator tier (Q5's host joins take seconds a run at SF=1)
WARM = 3
TRIO_PER_OP_WARM = 1
#: queries whose answer may hold no row (Q22: this generator leaves ~7 of
#: 150,000 customers without an order)
EMPTY_OK = ("Q22",)
#: queries whose first column is a count that must not be 0: Q22 answers
#: no row at SF=1, seed 7, so NOT_EXISTS shows the anti join's own keep
NONZERO_COUNT = ("NOT_EXISTS",)
#: the block-wise run: tidb_device_block_rows, the queries it drives (on
#: both tiers), and the warm repeats per query
BLOCK_ROWS = 1 << 20
BLOCK_QUERIES = ("Q1", "Q3", "Q6", "NOT_IN")
BLOCK_WARM = 2
#: staging depths the block-wise warm runs alternate between
#: (tidb_pipeline_depth: 0 = inline staging, the default; 2 = the
#: producer thread and the side stream), BLOCK_WARM runs each, rows
#: byte-equal
BLOCK_DEPTHS = (0, 2)
#: queries whose block-wise run must stream blocks (the semi join of
#: NOT IN runs unblocked, as in the reference)
BLOCK_STREAMS = ("Q1", "Q3", "Q6")
#: the most CUDA kernels one warm Q6 may launch (the per-operator
#: executors: HK7, HK1's two passes; copies are counted apart)
Q6_PER_OP_MAX_KERNELS = 6


class Mismatch(AssertionError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float | None:
    """Device-only time of one call of fn: the self device time of every
    kernel, copy and memset it enqueues, summed over a torch.profiler trace
    of reps calls.  Unlike cuda_ms it leaves out the host work between the
    launches.  A trace that comes back without device events is taken
    again, up to three times in all; None when none had any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tinysql_tpu_torch.bench.trace_tpch import device_us
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(device_us(e) for e in prof.key_averages())
        if us > 0:
            return us / reps / 1e3
    return None


def timed(fn) -> dict:
    """The kernel's median CUDA-event time (host work between its launches
    included) and its device-only time."""
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}


def same_bytes(a, b, what: str) -> None:
    """Every kernel output is an int64 tensor (float results as bits), so
    torch.equal compares bytes."""
    import torch
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    for x, y in zip(a, b):
        if x.shape != y.shape or not torch.equal(x, y):
            raise Mismatch(f"{what}: two runs of the kernel differ")


def check_table(k, p, float_rows, what: str, exact_float_rows=()) -> float:
    """k/p: int64 tables (rows x n).  Rows in float_rows hold float64 bits
    of sums (1e-6 relative); rows in exact_float_rows hold float64 bits of
    min/max (equal as floats, NaN equal to NaN); every other row must
    match exactly.  Returns the max absolute difference of the float
    rows."""
    import torch
    if k.shape != p.shape:
        raise Mismatch(f"{what}: shape {tuple(k.shape)} vs {tuple(p.shape)}")
    err = 0.0
    for r in range(k.shape[0]):
        if r in exact_float_rows:
            kv, pv = k[r].view(torch.float64), p[r].view(torch.float64)
            same = (kv == pv) | (torch.isnan(kv) & torch.isnan(pv))
            if not bool(same.all()):
                raise Mismatch(f"{what}: float min/max row {r} differs")
        elif r in float_rows:
            kv, pv = k[r].view(torch.float64), p[r].view(torch.float64)
            if not torch.allclose(kv, pv, rtol=FLOAT_RTOL, atol=1e-9,
                                  equal_nan=True):
                raise Mismatch(f"{what}: float row {r} beyond 1e-6 rel")
            fin = torch.isfinite(kv) & torch.isfinite(pv)
            if fin.any():
                err = max(err, float((kv[fin] - pv[fin]).abs().max()))
        elif not torch.equal(k[r], p[r]):
            bad = int((k[r] != p[r]).nonzero()[0])
            raise Mismatch(f"{what}: row {r} differs at {bad}: "
                           f"{int(k[r][bad])} vs {int(p[r][bad])}")
    return err


def reduce_bytes(valid, lanes, table_rows: int, gid: bool = False) -> int:
    """Bytes a masked or segment reduction must move: each member's valid
    mask over every row, then only over its valid rows its lanes' values
    and NULL bytes (a member's own lane [B, n] per member, a shared lane
    [n] and the shared group ids once over the rows valid in any member),
    and each member's table of ``table_rows`` int64 written once.  A
    solo call is one member (``valid`` [n])."""
    v = valid if valid.dim() == 2 else valid[None]
    nmem, n = int(v.shape[0]), int(v.shape[1])
    nv = [int(x) for x in v.sum(dim=1).tolist()]
    nu = int(v.any(dim=0).sum())
    shared, own = (8 if gid else 0), 0
    for x, m, _op in lanes:
        for a, size in ((x, 8), (m, 1)):
            if a is None:
                continue
            if a.dim() == 2 or valid.dim() == 1:
                own += size
            else:
                shared += size
    return nu * shared + sum(n + k * own for k in nv) + \
        nmem * 8 * table_rows


def lane_float_rows(lanes, head: int, ops=("sum",)):
    import torch
    return {head + 2 * j for j, (v, _m, op) in enumerate(lanes)
            if v is not None and v.dtype == torch.float64 and op in ops}


# ---- phase 2 -------------------------------------------------------------

def phase_kernels(K, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    rec = {}
    I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    def rnd_f(n):
        return t(np.round(rng.uniform(900.0, 105000.0, n), 2))

    def rnd_null(n, p):
        return t(rng.random(n) < p)

    # -- HK1 masked_reduce: Q6 (2^23 rows, one float64 SUM lane) ---------
    def hk1_case(n, lanes, valid, what):
        k1 = K.masked_reduce(valid, lanes)
        k2 = K.masked_reduce(valid, lanes)
        same_bytes(k1, k2, what)
        p = K.masked_reduce_plain(valid, K._norm_lanes(lanes, n, dev, what))
        return check_table(k1.reshape(-1, 1), p.reshape(-1, 1),
                           lane_float_rows(lanes, 2), what)

    n = 1 << 23
    valid = t(rng.random(n) < 0.02)  # Q6 keeps ~2% of lineitem
    q6 = [(rnd_f(n), t(np.zeros(n, bool)), "sum")]
    err = hk1_case(n, q6, valid, "masked_reduce Q6")
    rec["masked_reduce"] = {
        "max_abs_err": err,
        **timed(lambda: K.masked_reduce(valid, q6)),
        "plain_ms": cuda_ms(lambda: K.masked_reduce_plain(valid, q6)),
        "library_ms": None,
        "bytes": reduce_bytes(valid, q6, 4), "ops": 2 * int(valid.sum()),
        "shape": "n=2^23, 1 float64 SUM lane (Q6)"}
    # edge cases: all-invalid, all-NULL lane, int64 extremes, min/max
    ne = 4096
    vi = t(rng.integers(-5, 5, ne), torch.int64)
    vi[:4] = t([I64_MAX, I64_MIN, I64_MAX, I64_MIN], torch.int64)
    vf = t(rng.normal(size=ne))
    lanes_e = [(vi, rnd_null(ne, 0.3), "sum"), (vi, None, "min"),
               (vi, None, "max"), (vf, t(np.ones(ne, bool)), "sum"),
               (vf, rnd_null(ne, 0.5), "min"), (vf, None, "max"),
               (None, rnd_null(ne, 0.5), "count")]
    hk1_case(ne, lanes_e, t(rng.random(ne) < 0.6), "masked_reduce edges")
    hk1_case(ne, lanes_e, t(np.zeros(ne, bool)), "masked_reduce empty")
    hk1_case(16, [(vi[:16], None, "sum")], t(np.ones(16, bool)),
             "masked_reduce n=16")

    # -- HK2 segment_reduce: Q1 (6 groups, 10 lanes), Q3 (2^21 segs) ----
    def hk2_case(gid, valid, ns, lanes, what):
        nn = int(valid.shape[0])
        k1 = K.segment_reduce(gid, valid, ns, lanes)
        k2 = K.segment_reduce(gid, valid, ns, lanes)
        same_bytes(k1, k2, what)
        p = K.segment_reduce_plain(gid, valid, ns,
                                   K._norm_lanes(lanes, nn, dev, what))
        err = check_table(k1, p, lane_float_rows(lanes, 2), what)
        npk, pk = K.present_compact(k1, ns)
        npp, pp = K.present_compact_plain(k1, ns)
        if npk != npp:
            raise Mismatch(f"{what}: present count {npk} vs {npp}")
        same_bytes(pk, pp, f"{what} present compaction")
        return err

    gid1 = t(rng.integers(0, 12, n), torch.int64)
    valid1 = t(rng.random(n) < 0.98)
    q1 = []
    for j in range(10):
        if j in (5, 7, 9):
            q1.append((None, t(np.zeros(n, bool)), "count"))
        else:
            q1.append((rnd_f(n), t(np.zeros(n, bool)), "sum"))
    hk2_case(gid1, valid1, 16, q1, "segment_reduce Q1")
    q1_ms = cuda_ms(lambda: K.segment_reduce(gid1, valid1, 16, q1))
    ns3 = 1 << 21
    gid3 = t(np.concatenate([np.repeat(np.arange(1_500_000), 4),
                             np.zeros(n - 6_000_000, np.int64)]),
             torch.int64)
    valid3 = t(np.concatenate([rng.random(6_000_000) < 0.54,
                               np.zeros(n - 6_000_000, bool)]))
    q3 = [(rnd_f(n), t(np.zeros(n, bool)), "sum")]
    err = hk2_case(gid3, valid3, ns3, q3, "segment_reduce Q3")
    g_all = torch.where(valid3, gid3, torch.full_like(gid3, ns3))
    x3 = q3[0][0]
    # skew: one group holds 90% of the rows (a low-cardinality key through
    # the sort-based GROUP BY, which always asks for ns = the row bucket)
    gid_sk = t(np.where(rng.random(n) < 0.9, 0,
                        rng.integers(0, ns3, n)), torch.int64)
    valid_sk = t(rng.random(n) < 0.98)
    hk2_case(gid_sk, valid_sk, ns3, q3, "segment_reduce skew")
    rec["segment_reduce"] = {
        "max_abs_err": err,
        **timed(lambda: K.segment_reduce(gid3, valid3, ns3, q3)),
        "plain_ms": cuda_ms(lambda: K.segment_reduce_plain(
            gid3, valid3, ns3, q3)),
        "library_ms": None,
        "bytes": reduce_bytes(valid3, q3, 4 * ns3, gid=True),
        "ops": 2 * int(valid3.sum()),
        "shape": "n=2^23, 2^21 segments, 1 float64 SUM lane (Q3)",
        "q1_ms": q1_ms,
        "sum_lane_only_scatter_reduce_ms": cuda_ms(lambda: torch.zeros(
            ns3 + 1, dtype=torch.float64, device=dev).scatter_reduce_(
                0, g_all, x3, "sum")),
        "skew90_ms": cuda_ms(lambda: K.segment_reduce(
            gid_sk, valid_sk, ns3, q3)),
        "skew90_plain_ms": cuda_ms(lambda: K.segment_reduce_plain(
            gid_sk, valid_sk, ns3, q3))}
    # present-segment compaction of the Q3 table (~1.43M of 2^21 present)
    tab3 = K.segment_reduce(gid3, valid3, ns3, q3)
    np3, _ = K.present_compact(tab3, ns3)
    ob3 = min(K.bucket(max(np3, 1)), ns3)
    rec["present_compact"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.present_compact(tab3, ns3)),
        "plain_ms": cuda_ms(lambda: K.present_compact_plain(tab3, ns3)),
        "library_ms": None,
        "bytes": 8 * ns3 + 8 * int(tab3.shape[0]) * np3
        + 8 * (1 + int(tab3.shape[0])) * ob3, "ops": ns3,
        "shape": f"2^21 segments, {np3} present, {int(tab3.shape[0])} rows"
                 " (Q3)"}
    # edge cases: all-NULL groups, empty input, int64 extremes, min/max
    for ns_e in (16, 64, 1024):
        gid_e = t(rng.integers(-1, ns_e + 1, ne), torch.int64)
        nul = rnd_null(ne, 0.2)
        nul = nul | (gid_e == 3)  # segment 3 is all-NULL in lane 0
        lanes_s = [(vf, nul, "sum"), (vi, None, "sum"), (vi, nul, "min"),
                   (vi, None, "max"), (vf, nul, "min"), (vf, None, "max"),
                   (None, nul, "count")]
        hk2_case(gid_e, t(rng.random(ne) < 0.7), ns_e, lanes_s,
                 f"segment_reduce edges ns={ns_e}")
        hk2_case(gid_e, t(np.zeros(ne, bool)), ns_e, lanes_s,
                 f"segment_reduce empty ns={ns_e}")

    # -- HK3 equi_join: Q3's joins ---------------------------------------
    def hk3_case(lk, ln, lv, rk, rn, rv, outer, what, mult=False):
        f = K.equi_join_mult if mult else K.equi_join_unique
        fp = K.equi_join_mult_plain if mult else K.equi_join_unique_plain
        a = f(lk, ln, lv, rk, rn, rv, outer=outer)
        b = f(lk, ln, lv, rk, rn, rv, outer=outer)
        same_bytes(a, b, what)
        c = fp(lk, ln, lv, rk, rn, rv, outer=outer)
        for x, y, nm in ((a[0], c[0], "li"), (a[1], c[1], "ri")):
            if x.shape != y.shape or not torch.equal(x, y):
                raise Mismatch(f"{what}: {nm} differs")
        return int(a[0].shape[0])

    # join 1: orders (2^20 bucket, ~729k valid) probe customer (2^15
    # bucket, ~30k BUILDING) on c_custkey = o_custkey
    nl, nr = 1 << 20, 1 << 15
    lk = t(rng.integers(1, 150_001, nl), torch.int64)
    lv = t(np.arange(nl) < 1_500_000) & t(rng.random(nl) < 0.486)
    rk = t(np.arange(1, nr + 1) * 5, torch.int64)
    rv = t(rng.random(nr) < 0.91)
    z_l, z_r = t(np.zeros(nl, bool)), t(np.zeros(nr, bool))
    n_out = hk3_case(lk, z_l, lv, rk, z_r, rv, False, "equi_join Q3 join1")
    rec["equi_join"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.equi_join_unique(lk, z_l, lv, rk, z_r, rv)),
        "plain_ms": cuda_ms(lambda: K.equi_join_unique_plain(
            lk, z_l, lv, rk, z_r, rv)),
        "library_ms": None,
        "bytes": nl * 10 + nr * 10 + n_out * 16, "ops": nl + nr,
        "shape": f"probe 2^20, build 2^15, {n_out} pairs (Q3 join 1)"}
    # join 2 shape: 2^18 probe against a 2^20 aggregate output
    lk2 = t(rng.integers(1, 1_500_001, 1 << 18), torch.int64)
    rk2 = t(np.arange(1 << 20) + 1, torch.int64)
    hk3_case(lk2, t(np.zeros(1 << 18, bool)), t(rng.random(1 << 18) < 0.55),
             rk2, t(rng.random(1 << 20) < 0.2), t(np.arange(1 << 20) < 827_499),
             False, "equi_join Q3 join2")
    # edges: int64 max/min keys (sentinel collision), R4 range at the top
    # of int64 (dense), a wide range (hash), outer, multiplicity, empties
    for lo, hi in ((I64_MAX - 5000, I64_MAX), (I64_MIN, I64_MIN + 5000),
                   (I64_MIN, I64_MAX), (-100, 100)):
        lke = t(rng.integers(lo, hi, ne, endpoint=True), torch.int64)
        rke = t(rng.integers(lo, hi, ne // 2, endpoint=True), torch.int64)
        lke[:3] = t([I64_MAX, I64_MIN, 0], torch.int64)
        rke[:2] = t([I64_MAX, I64_MIN], torch.int64)
        args = (lke, rnd_null(ne, 0.1), t(rng.random(ne) < 0.9), rke,
                rnd_null(ne // 2, 0.1), t(rng.random(ne // 2) < 0.9))
        for outer in (False, True):
            hk3_case(*args, outer, f"equi_join edges [{lo},{hi}] {outer}")
            hk3_case(*args, outer, f"equi_join mult [{lo},{hi}] {outer}",
                     mult=True)
    e16 = t(np.zeros(16, bool))
    k16 = t(np.arange(16), torch.int64)
    hk3_case(k16, e16, t(np.ones(16, bool)), k16, e16, e16, True,
             "equi_join empty build")
    hk3_case(k16, e16, e16, k16, e16, t(np.ones(16, bool)), False,
             "equi_join empty probe")

    # -- HK4 lex_order: Q3 top 10 of ~11k, Q1's full sort ----------------
    def hk4_case(lanes, nn, k, what):
        a = K.lex_order(lanes, nn, k)
        b = K.lex_order(lanes, nn, k)
        same_bytes(a, b, what)
        c = K.lex_order_plain(lanes, nn)[:a.shape[0]]
        if not torch.equal(a, c):
            raise Mismatch(f"{what}: order differs")

    nq = 1 << 14
    rev = t(np.round(rng.uniform(1e3, 5e5, nq), 2))
    rev[11423:] = 0.0
    date = t(rng.integers(0, 2406, nq), torch.int64)
    validq = t(np.arange(nq) < 11423)
    nul0 = t(np.zeros(nq, bool))
    lanes_q3 = K.sort_lanes([(rev, nul0), (date, nul0)], [True, False],
                            validq)
    hk4_case(lanes_q3, nq, 10, "lex_order Q3 top-10")
    key8 = K.sort_lanes([(t(rng.integers(0, 1 << 62, n), torch.int64),
                          t(np.zeros(n, bool)))], [False],
                        t(np.ones(n, bool)))
    hk4_case(key8, n, None, "lex_order full sort 2^23")
    rec["lex_order"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.lex_order(lanes_q3, nq, 10)),
        "plain_ms": cuda_ms(lambda: K.lex_order_plain(lanes_q3, nq)[:10]),
        "library_ms": None,
        "one_lane_topk_ms": cuda_ms(lambda: torch.topk(lanes_q3[1], 10,
                                                       largest=False)),
        "bytes": 4 * 8 * nq + 8 * 10, "ops": nq * 14,
        "shape": "4 lanes, n=2^14, k=10 (Q3 TopN)",
        "sort_2e23_ms": cuda_ms(lambda: K.lex_order(key8, n), reps=3,
                                warm=1),
        "one_lane_torch_sort_2e23_ms": cuda_ms(lambda: torch.sort(
            key8[1], stable=True), reps=3, warm=1)}
    # edges: NULLs first/last, DESC, int64 extremes, floats with NaN/-0.0,
    # ties (row index decides), invalid rows last, >8 lanes, k > n
    ints = t(rng.integers(-3, 3, ne), torch.int64)
    ints[:4] = t([I64_MAX, I64_MIN, I64_MAX, I64_MIN], torch.int64)
    flts = t(rng.integers(-2, 3, ne).astype(np.float64))
    flts[:4] = t([float("nan"), -0.0, 0.0, float("-inf")])
    for descs in ((False, False), (True, False), (True, True)):
        lanes_e = K.sort_lanes([(ints, rnd_null(ne, 0.2)),
                                (flts, rnd_null(ne, 0.2))], list(descs),
                               t(rng.random(ne) < 0.9))
        hk4_case(lanes_e, ne, None, f"lex_order edges {descs}")
        hk4_case(lanes_e, ne, 7, f"lex_order top-7 {descs}")
    five = [(t(rng.integers(0, 3, ne), torch.int64), rnd_null(ne, 0.1))
            for _ in range(5)]
    hk4_case(K.sort_lanes(five, [False, True, False, True, False],
                          t(np.ones(ne, bool))), ne, None,
             "lex_order 10 lanes")
    hk4_case(lanes_q3, nq, nq + 5, "lex_order k > n")
    # Q1's ORDER BY: 6 groups in a 16-row bucket, two string-code keys
    q1k = [(t(rng.integers(0, 3, 16), torch.int64), t(np.zeros(16, bool)))
           for _ in range(2)]
    lanes_q1 = K.sort_lanes(q1k, [False, False], t(np.arange(16) < 6))
    hk4_case(lanes_q1, 16, None, "lex_order Q1 sort")
    rec["lex_order"]["q1_ms"] = cuda_ms(lambda: K.lex_order(lanes_q1, 16))
    rec["lex_order"]["q1_device_ms"] = device_ms(
        lambda: K.lex_order(lanes_q1, 16))
    rec["lex_order"]["q1_plain_ms"] = cuda_ms(
        lambda: K.lex_order_plain(lanes_q1, 16))
    rec["lex_order"]["q1_bound_ms"] = (4 * 8 * 16 + 8 * 16) / MEM_BPS * 1e3
    # the pipeline's Q3 TopN: the first 16 of the 2^21-row join view,
    # ~11k of its rows valid
    np3 = 1 << 21
    validp = t(np.zeros(np3, bool))
    validp[t(rng.choice(np3, 11423, replace=False), torch.int64)] = True
    lanes_p3 = K.sort_lanes(
        [(t(np.round(rng.uniform(1e3, 5e5, np3), 2)), t(np.zeros(np3, bool))),
         (t(rng.integers(0, 2406, np3), torch.int64),
          t(np.zeros(np3, bool)))], [True, False], validp)
    hk4_case(lanes_p3, np3, 16, "lex_order pipeline Q3 top-16")
    rec["lex_order"]["pipe_q3_ms"] = cuda_ms(
        lambda: K.lex_order(lanes_p3, np3, 16))
    rec["lex_order"]["pipe_q3_device_ms"] = device_ms(
        lambda: K.lex_order(lanes_p3, np3, 16))
    rec["lex_order"]["pipe_q3_plain_ms"] = cuda_ms(
        lambda: K.lex_order_plain(lanes_p3, np3)[:16], reps=3, warm=1)
    rec["lex_order"]["pipe_q3_bound_ms"] = \
        (4 * 8 * np3 + 8 * 16) / MEM_BPS * 1e3

    # -- HK5 csr_reduce: the pipeline's GROUP BY over the group index ----
    def hk5_case(order, ends, valid, lanes, n_rows, ng, what):
        nbv = int(order.shape[0])
        k1 = K.csr_reduce(order, ends, valid, lanes, n_rows, ng)
        k2 = K.csr_reduce(order, ends, valid, lanes, n_rows, ng)
        same_bytes(k1, k2, what)
        p = K.csr_reduce_plain(order, ends, valid,
                               K._norm_lanes(lanes, nbv, dev, what),
                               n_rows, ng)
        return check_table(k1, p, lane_float_rows(lanes, 2), what,
                           lane_float_rows(lanes, 2, ("min", "max")))

    def hk5_bytes(lanes, n_rows, ng, ngb):
        """Bytes HK5 must move: order and valid over the live rows, each
        lane's values and NULL mask over them (a count lane has only its
        mask), ends over the real groups, the whole table written."""
        per_row = 8 + 1 + sum((0 if v is None else v.element_size())
                              + (m is not None) for v, m, _op in lanes)
        return n_rows * per_row + 8 * ng + 8 * (2 + 2 * len(lanes)) * ngb

    def index_of(keys_np, nbv):
        order = np.argsort(keys_np, kind="stable")
        sk = keys_np[order]
        ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0]
        ngb_ = K.bucket(len(ends))
        return (t(K.pad1(order.astype(np.int64), nbv), torch.int64),
                t(K.pad1(ends.astype(np.int64), ngb_,
                         fill=len(keys_np) - 1), torch.int64), len(ends))

    # Q3: lineitem (clustered by l_orderkey, 1-7 lines per order) grouped
    # by l_orderkey, ~54% of the rows pass l_shipdate, one revenue SUM
    lens = rng.integers(1, 8, 1_500_000)
    rows3 = int(lens.sum())
    order5 = t(K.pad1(np.arange(rows3, dtype=np.int64), n), torch.int64)
    ngb5 = 1 << 21
    ends5 = t(K.pad1(np.cumsum(lens) - 1, ngb5, fill=rows3 - 1),
              torch.int64)
    valid5 = t(K.pad1(rng.random(rows3) < 0.54, n))
    q3l = [(rnd_f(n), t(np.zeros(n, bool)), "sum")]
    err5 = hk5_case(order5, ends5, valid5, q3l, rows3, 1_500_000,
                    "csr_reduce Q3")
    tab5 = K.csr_reduce(order5, ends5, valid5, q3l, rows3, 1_500_000)
    present5 = int((tab5[0] > 0).sum())
    xs5 = q3l[0][0][:rows3].contiguous()
    lens5 = t(lens, torch.int64)
    # Q1: 6 groups over ~6M rows in row order, 7 float SUM lanes and 3
    # counts (count(*) is presence)
    key1 = rng.choice(6, rows3, p=[0.25, 0.007, 0.25, 0.24, 0.003, 0.25])
    order1, ends1, ng1 = index_of(key1, n)
    valid1q = t(K.pad1(rng.random(rows3) < 0.98, n))
    q1l = []
    for j in range(10):
        if j in (4, 6, 8):
            q1l.append((None, t(np.zeros(n, bool)), "count"))
        else:
            q1l.append((rnd_f(n), t(np.zeros(n, bool)), "sum"))
    hk5_case(order1, ends1, valid1q, q1l, rows3, ng1, "csr_reduce Q1")
    # skew: one group holds 90% of the rows
    keysk = np.where(rng.random(rows3) < 0.9, 0,
                     rng.integers(0, 1 << 21, rows3))
    ordersk, endssk, ngsk = index_of(keysk, n)
    hk5_case(ordersk, endssk, valid5, q3l, rows3, ngsk, "csr_reduce skew")
    # edges: NULL lanes, int64 extremes, NaN / -0.0 in min/max, invalid
    # and padding rows, runs around the long-run threshold, no groups
    ne5 = 1 << 16
    ke = rng.integers(0, 300, ne5)
    ke[:1025] = 7
    ke[1025:3000] = 9
    oe, ee, nge = index_of(ke[:60000], ne5)
    fe = t(rng.normal(size=ne5))
    fe[:6] = t([0.0, -0.0, float("nan"), 1e300, -0.0, float("-inf")])
    ie = t(rng.integers(-(1 << 62), 1 << 62, ne5), torch.int64)
    ie[:2] = t([I64_MAX, I64_MIN], torch.int64)
    nul5 = rnd_null(ne5, 0.2)
    lanes_e5 = [(fe, nul5, "sum"), (fe, nul5, "min"), (fe, None, "max"),
                (ie, None, "sum"), (ie, nul5, "min"), (ie, None, "max"),
                (None, nul5, "count")]
    for frac in (0.8, 0.0):
        hk5_case(oe, ee, t(rng.random(ne5) < frac), lanes_e5, 60000, nge,
                 f"csr_reduce edges valid={frac}")
    hk5_case(oe, ee, t(np.ones(ne5, bool)), lanes_e5, 60000, 0,
             "csr_reduce no groups")
    hk5_case(oe, ee, t(np.ones(ne5, bool)), [(fe, nul5, "sum")] * 16,
             60000, nge, "csr_reduce 16 lanes")
    rec["csr_reduce"] = {
        "max_abs_err": err5,
        **timed(lambda: K.csr_reduce(order5, ends5, valid5, q3l, rows3,
                                     1_500_000)),
        "plain_ms": cuda_ms(lambda: K.csr_reduce_plain(
            order5, ends5, valid5, q3l, rows3, 1_500_000)),
        "library_ms": None,
        "bytes": hk5_bytes(q3l, rows3, 1_500_000, ngb5),
        "ops": 2 * rows3,
        "shape": f"n=2^23 ({rows3} rows), 2^21-group bucket, "
                 f"{present5} present, 1 float64 SUM lane (Q3)",
        "sum_lane_presorted_segment_reduce_ms": cuda_ms(
            lambda: torch.segment_reduce(xs5, "sum", lengths=lens5)),
        "q1_ms": cuda_ms(lambda: K.csr_reduce(order1, ends1, valid1q, q1l,
                                              rows3, ng1)),
        "q1_device_ms": device_ms(lambda: K.csr_reduce(
            order1, ends1, valid1q, q1l, rows3, ng1)),
        "q1_plain_ms": cuda_ms(lambda: K.csr_reduce_plain(
            order1, ends1, valid1q, q1l, rows3, ng1)),
        "q1_bound_ms": hk5_bytes(q1l, rows3, ng1, int(ends1.shape[0]))
        / MEM_BPS * 1e3,
        "skew90_ms": cuda_ms(lambda: K.csr_reduce(
            ordersk, endssk, valid5, q3l, rows3, ngsk)),
        "skew90_plain_ms": cuda_ms(lambda: K.csr_reduce_plain(
            ordersk, endssk, valid5, q3l, rows3, ngsk))}

    # -- HK6 dense_probe: the pipeline's join probe ----------------------
    def hk6_case(args, mode, what):
        a = K.dense_probe(*args, mode)
        b = K.dense_probe(*args, mode)
        same_bytes([a[0]] + [x for vm in a[1] for x in vm],
                   [b[0]] + [x for vm in b[1] for x in vm], what)
        c = K.dense_probe_plain(*args, mode)
        if not torch.equal(a[0], c[0]) or len(a[1]) != len(c[1]):
            raise Mismatch(f"{what}: valid differs")
        for (x, xn), (y, yn) in zip(a[1], c[1]):
            if not torch.equal(xn, yn) or not torch.equal(
                    x.view(torch.uint8), y.view(torch.uint8)):
                raise Mismatch(f"{what}: gathered lane differs")
        return int(a[0].sum())

    # join 1: orders (2^21 bucket, ~48.6% pass o_orderdate) probe the
    # customer pk table (150,000 keys, ~20% BUILDING), 2 build lanes
    np1, nbb1 = 1 << 21, 1 << 18
    kp1 = t(rng.integers(1, 150_001, np1), torch.int64)
    pv1 = t((np.arange(np1) < 1_500_000) & (rng.random(np1) < 0.486))
    tbl1 = t(np.arange(150_000, dtype=np.int32))
    bv1 = t((np.arange(nbb1) < 150_000) & (rng.random(nbb1) < 0.2))
    bl1 = [(t(np.arange(1, nbb1 + 1), torch.int64), t(np.zeros(nbb1, bool))),
           (t(rng.integers(0, 5, nbb1), torch.int64),
            t(np.zeros(nbb1, bool)))]
    args1 = (kp1, t(np.zeros(np1, bool)), pv1, 1, 150_000, tbl1, bv1, bl1)
    out1 = hk6_case(args1, "inner", "dense_probe Q3 join1")
    # join 2: the join-1 view (2^21) probes the l_orderkey group index's
    # key -> group table (orderkeys up to 6M, 8 of every 32 used), build
    # = the aggregate's 2^21-group view (l_orderkey, revenue)
    okeys = np.sort(rng.choice(6_000_000, 1_500_000, replace=False)) + 1
    tbl2 = np.full(int(okeys[-1] - okeys[0] + 1), -1, np.int32)
    tbl2[okeys - okeys[0]] = np.arange(1_500_000, dtype=np.int32)
    kp2 = t(K.pad1(rng.permutation(okeys), np1), torch.int64)
    pv2 = pv1 & t(rng.random(np1) < 0.2)
    bv2 = t((np.arange(ngb5) < 1_500_000) & (rng.random(ngb5) < 0.955))
    bl2 = [(t(K.pad1(okeys, ngb5), torch.int64), t(np.zeros(ngb5, bool))),
           (rnd_f(ngb5), t(rng.random(ngb5) < 0.045))]
    args2 = (kp2, t(np.zeros(np1, bool)), pv2, int(okeys[0]),
             int(okeys[-1]), t(tbl2), bv2, bl2)
    hk6_case(args2, "inner", "dense_probe Q3 join2")
    # edges: NULL keys, keys outside [lo, hi], hi = int64 max and lo =
    # int64 min, dead build rows, 1/4/8-byte lanes, every mode
    ne6, m6 = 1 << 14, 300
    for lo in (-50, I64_MAX - 299, I64_MIN):
        hi = lo + 299
        keys6 = rng.choice(300, m6, replace=False)
        tb6 = np.full(300, -1, np.int32)
        tb6[keys6[:250]] = np.arange(250, dtype=np.int32)
        off = rng.integers(-20, 320, ne6)
        kp6 = np.array([min(max(lo + int(o), I64_MIN), I64_MAX)
                        for o in off], dtype=np.int64)
        kp6[:4] = [I64_MAX, I64_MIN, lo, hi]
        nbb6 = K.bucket(m6)
        bl6 = [(t(rng.normal(size=nbb6)), rnd_null(nbb6, 0.2)),
               (t(rng.integers(0, 9, nbb6), torch.int64), None),
               (t(rng.random(nbb6) < 0.5), rnd_null(nbb6, 0.2)),
               (t(rng.integers(0, 9, nbb6).astype(np.int32)), None)]
        args6 = (t(kp6), rnd_null(ne6, 0.1), t(rng.random(ne6) < 0.9), lo,
                 hi, t(tb6), t(rng.random(nbb6) < 0.8), bl6)
        for mode in ("inner", "left", "semi", "anti"):
            hk6_case(args6, mode, f"dense_probe edges lo={lo} {mode}")
    def probe_bytes(args):
        """Bytes HK6 must move on this data: key, NULL flag and validity
        read and the valid mask written for every probe row; the table
        entry of each distinct in-range key and the build row it names
        (validity, each lane's value and NULL flag) read once; each
        gathered lane's value and NULL flag written per probe row."""
        kp, kn, _pv, lo, hi, tbl, _bv, bl = args
        nbp = int(kp.shape[0])
        offs = torch.unique(kp[~kn & (kp >= lo) & (kp <= hi)] - lo)
        rows = int((tbl[offs] >= 0).sum())  # a unique key: one row each
        build = 1 + sum(v.element_size() + (m is not None) for v, m in bl)
        out = sum(v.element_size() + 1 for v, _m in bl)
        return nbp * (8 + 1 + 1 + 1 + out) + 4 * len(offs) + rows * build

    ps1 = torch.clamp(torch.where(
        (kp1 >= 1) & (kp1 <= 150_000), tbl1[torch.clamp(kp1 - 1, 0,
                                                         149_999)].long(),
        torch.full_like(kp1, -1)), 0, nbb1 - 1)
    rec["dense_probe"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.dense_probe(*args1, "inner")),
        "plain_ms": cuda_ms(lambda: K.dense_probe_plain(*args1, "inner")),
        "library_ms": None,
        "bytes": probe_bytes(args1),
        "ops": np1,
        "shape": f"probe 2^21 ({int(pv1.sum())} valid), table 150,000, "
                 f"build 2^18, 2 lanes, {out1} matches (Q3 join 1)",
        "one_lane_gather_ms": cuda_ms(lambda: bl1[0][0].index_select(
            0, ps1)),
        "join2_ms": cuda_ms(lambda: K.dense_probe(*args2, "inner")),
        "join2_device_ms": device_ms(lambda: K.dense_probe(*args2,
                                                           "inner")),
        "join2_plain_ms": cuda_ms(lambda: K.dense_probe_plain(*args2,
                                                              "inner")),
        "join2_bound_ms": probe_bytes(args2) / MEM_BPS * 1e3}
    q13 = phase_q13_kernels(K, dev, t, rng)
    rec["dense_probe"].update(q13.pop("dense_probe"))
    rec.update(q13)
    rec["expr_eval"], q6x = phase_hk7(K, dev, t, rng)
    rec.update(phase_k12(K, dev, t, rng, q6x))
    rec["semi_pick"] = phase_hk10(K, dev, t, rng)
    rec["offpath"] = offpath(K, dev, t, rng)
    return rec


# -- HK10 semi_pick: K8's ladder and compaction at NOT IN's SF=1 shape -------
SEMI_MODES = {"semi": (False, False), "anti": (True, False),
              "not in": (True, True)}


def hk10_bytes(lv, rv, n_kept: int) -> int:
    """What K8's ladder must move: the probe validity over every row and
    the membership and NULL bytes over the valid rows, the build validity
    over every row and its NULL bytes over the valid rows, the count and
    the kept rows written once."""
    return (int(lv.shape[0]) + 2 * int(lv.sum()) + int(rv.shape[0])
            + int(rv.sum()) + 8 * (1 + n_kept))


def phase_hk10(K, dev, t, rng) -> dict:
    """HK10 against semi_pick_plain byte for byte (the count and the kept
    rows; the output past the count is unwritten by contract), in every
    mode: NOT IN's SF=1 shape (1.5M orders probing ~3M lineitem keys),
    an empty build side, one NULL build key, NULL probe keys."""
    import numpy as np
    import torch

    def kept(out):
        return out[:1 + int(out[0])]

    def case(match, ln, lv, rn, rv, what):
        res = {}
        for mode, (anti, na) in SEMI_MODES.items():
            a = K.semi_pick(match, ln, lv, rn, rv, anti, na)
            b = K.semi_pick(match, ln, lv, rn, rv, anti, na)
            same_bytes(kept(a), kept(b), f"semi_pick {what} {mode}")
            c = K.semi_pick_plain(match, ln, lv, rn, rv, anti, na)
            if not torch.equal(kept(a), kept(c)):
                raise Mismatch(f"semi_pick {what} {mode}: differs from "
                               f"its plain version")
            res[mode] = int(a[0])
        print(f"[hk10] {what}: kept {res}", flush=True)
        return res

    # NOT IN: o_orderkey (1.5M, bucket 2^21) against l_orderkey of the
    # lineitems shipped after 1995-03-15 (~3M rows, bucket 2^22)
    n_ord = 1_500_000
    nl = K.bucket(n_ord)
    ok = np.arange(1, n_ord + 1)
    chosen = ok[rng.random(n_ord) < 0.5]
    bk = np.repeat(chosen, rng.integers(1, 8, len(chosen)))
    nr = K.bucket(len(bk))
    lk = t(K.pad1(ok, nl), torch.int64)
    lv = t(np.arange(nl) < n_ord)
    ln = t(np.zeros(nl, bool))
    rk = t(K.pad1(bk, nr), torch.int64)
    rv = t(np.arange(nr) < len(bk))
    rn = t(np.zeros(nr, bool))
    match = K.unique_match(lk, ln, lv, rk, rn, rv)
    got = case(match, ln, lv, rn, rv, f"NOT IN SF=1 {n_ord} x {len(bk)}")
    # edges at the same probe shape
    z16 = t(np.zeros(16, bool))
    case(K.unique_match(lk, ln, lv, t(np.zeros(16), torch.int64), z16,
                        z16), ln, lv, z16, z16, "empty build")
    rn1 = rn.clone()
    rn1[12345] = True
    case(K.unique_match(lk, ln, lv, rk, rn1, rv), ln, lv, rn1, rv,
         "one NULL build key")
    ln1 = t(rng.random(nl) < 0.01)
    case(K.unique_match(lk, ln1, lv, rk, rn, rv), ln1, lv, rn, rv,
         "NULL probe keys")
    anti, na = SEMI_MODES["not in"]
    keep = lv & ~ln & ~match  # the NOT IN keep mask of this input
    return {
        "max_abs_err": 0.0,
        **timed(lambda: K.semi_pick(match, ln, lv, rn, rv, anti, na)),
        "plain_ms": cuda_ms(lambda: K.semi_pick_plain(match, ln, lv, rn,
                                                      rv, anti, na)),
        "library_ms": None,
        "nonzero_ms": cuda_ms(lambda: torch.nonzero(keep)),
        "bytes": hk10_bytes(lv, rv, got["not in"]), "ops": nl + nr,
        "shape": f"probe 2^21 ({n_ord} valid), build 2^22 ({len(bk)} "
                 f"valid), NOT IN keeps {got['not in']}"}


# -- HK8 csr_expand, HK9 run_bounds, HK6's composite mode: Q13's shapes -----

def _lane_bytes(lanes, rows: int) -> int:
    return rows * sum(v.element_size() + (m is not None) for v, m in lanes)


def phase_q13_kernels(K, dev, t, rng) -> dict:
    """HK8 at Q13's join (150,000 customers probe 1,500,000 orders through
    the o_custkey group index, inner and LEFT), HK9 at its two GROUP BYs
    (2^21 sorted rows, ~150,000 runs, then ~40), and HK6's composite mode
    at 2^21 probe rows on two keys, each against its plain version."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.executor import devpipe
    rec = {}
    zeros = lambda n: t(np.zeros(n, bool))  # noqa: E731

    def same_pairs(a, b, what):
        if len(a) != len(b):
            raise Mismatch(f"{what}: {len(a)} vs {len(b)} lanes")
        for (x, xn), (y, yn) in zip(a, b):
            if not torch.equal(xn, yn) or not torch.equal(
                    x.view(torch.uint8), y.view(torch.uint8)):
                raise Mismatch(f"{what}: a gathered lane differs")

    def hk8_case(args, outer, ob, plns, blns, what):
        a = K.csr_expand(*args, outer, ob, plns, blns)
        b = K.csr_expand(*args, outer, ob, plns, blns)
        if not torch.equal(a[0], b[0]):
            raise Mismatch(f"{what}: two runs of the kernel differ")
        same_pairs(a[1] + a[2], b[1] + b[2], f"{what} (two runs)")
        c = K.csr_expand_plain(*args, outer, ob, plns, blns)
        if not torch.equal(a[0], c[0]):
            raise Mismatch(f"{what}: valid slots differ")
        same_pairs(a[1] + a[2], c[1] + c[2], what)
        return int(a[0].sum())

    def hk8_bytes(args, ob, total, plns, blns):
        """Bytes HK8 must move on this data: the build's order and
        validity over its rows, its group ends, the probe validity over
        its bucket, then the keys, one table entry and each probe lane
        over the valid probe rows, each build lane over the build rows,
        the bucket's valid flags over all ob slots and the gathered lanes
        over the ``total`` live ones."""
        (order, ends, ng, n_rows, _bv, _tbl, _lo, _hi, keys, _spec,
         pvalid) = args
        nbp = int(pvalid.shape[0])
        nvp = int(pvalid.sum())
        out = sum(v.element_size() + 1 for v, _m in plns + blns)
        return (n_rows * 9 + 8 * ng + nbp + nvp * 4 + _lane_bytes(keys, nvp)
                + _lane_bytes(plns, nvp) + _lane_bytes(blns, n_rows)
                + ob + total * out)

    # Q13: customer (150,000 rows, 2^18 bucket) LEFT JOIN orders (1.5M
    # rows, 2^21 bucket) on c_custkey = o_custkey, o_custkey uniform
    n_c, n_o = 150_000, 1_500_000
    nbp, nbb = K.bucket(n_c), K.bucket(n_o)
    o_cust = rng.integers(1, n_c + 1, n_o).astype(np.int64)
    gi = devpipe.GroupIndex([(o_cust, np.zeros(n_o, bool))])
    ngb = K.bucket(gi.n_groups)
    ob = 1 << 21
    ckey = t(K.pad1(np.arange(1, n_c + 1, dtype=np.int64), nbp))
    args13 = (t(K.pad1(gi.order, nbb)),
              t(K.pad1(gi.ends, ngb, fill=n_o - 1)), gi.n_groups, n_o,
              t(np.arange(nbb) < n_o), t(gi.pos_table()), gi.lo, gi.hi,
              [(ckey, zeros(nbp))], None, t(np.arange(nbp) < n_c))
    plns = [(ckey, zeros(nbp))]
    blns = [(t(K.pad1(np.arange(1, n_o + 1, dtype=np.int64) * 4, nbb)),
             zeros(nbb)), (t(K.pad1(o_cust, nbb)), zeros(nbb))]
    # the probe-row lane of the inner expansion alone, for the partial call
    rows_p = torch.arange(nbp, device=dev)
    per_p = t(K.pad1(np.bincount(o_cust, minlength=n_c + 1)[1:], nbp),
              torch.int64)
    pairs = {}
    for outer in (True, False):
        pairs[outer] = hk8_case(args13, outer, ob, plns, blns,
                                f"csr_expand Q13 outer={outer}")
    # edges: filtered build rows, NULL keys on both sides, keys out of the
    # table's range, a skewed group, a two- and a three-key composite
    # lane, a bucket larger than the output
    for nk in (1, 2, 3):
        ne = 5000
        if nk == 1:
            bk = rng.integers(1, 400, ne).astype(np.int64)
            bk[:2000] = 11
            gie = devpipe.GroupIndex([(bk, rng.random(ne) < 0.05)])
            keys = [(t(rng.integers(-5, 420, 8192), torch.int64),
                     t(rng.random(8192) < 0.05))]
            spec = None
        else:
            cols = [(rng.integers(1, 9, ne).astype(np.int64),
                     rng.random(ne) < 0.03) for _ in range(nk)]
            los, his, strides, comp, null_any, _ = \
                devpipe._composite_spec(cols)
            gie = devpipe.GroupIndex([(comp, null_any)])
            spec = list(zip(los, his, strides))
            keys = [(t(rng.integers(0, 11, 8192), torch.int64),
                     t(rng.random(8192) < 0.03)) for _ in range(nk)]
        nbe = K.bucket(ne)
        ngbe = K.bucket(max(gie.n_groups, 1))
        argse = (t(K.pad1(gie.order, nbe)),
                 t(K.pad1(gie.ends, ngbe, fill=ne - 1)), gie.n_groups, ne,
                 t(rng.random(nbe) < 0.7), t(gie.pos_table()), gie.lo,
                 gie.hi, keys, spec, t(rng.random(8192) < 0.9))
        obe = K.bucket(int(gie.raw_counts().max()) * 8192 + 8192)
        ple = [(t(rng.integers(0, 9, 8192).astype(np.int32)),
                t(rng.random(8192) < 0.1))]
        ble = [(t(rng.normal(size=nbe)), t(rng.random(nbe) < 0.1)),
               (t(rng.random(nbe) < 0.5), None)]
        for outer in (False, True):
            hk8_case(argse, outer, obe, ple, ble,
                     f"csr_expand edges nk={nk} outer={outer}")
    rec["csr_expand"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.csr_expand(*args13, True, ob, plns, blns)),
        "plain_ms": cuda_ms(lambda: K.csr_expand_plain(
            *args13, True, ob, plns, blns)),
        "library_ms": None,
        "bytes": hk8_bytes(args13, ob, pairs[True], plns, blns),
        "ops": pairs[True],
        "shape": f"probe 2^18 ({n_c} customers), build 2^21 ({n_o} "
                 f"orders, {gi.n_groups} groups), ob 2^21, 1 + 2 lanes, "
                 f"LEFT {pairs[True]} / inner {pairs[False]} pairs (Q13)",
        "inner_ms": cuda_ms(lambda: K.csr_expand(*args13, False, ob, plns,
                                                 blns)),
        "partial_repeat_interleave_ms": cuda_ms(
            lambda: torch.repeat_interleave(rows_p, per_p, output_size=n_o))}

    # HK9: Q13's first GROUP BY (the join's 2^21 bucket sorted by
    # c_custkey: 1.5M valid rows, ~150,000 runs), its second (c_count over
    # the 150,000 groups), and edges with NULLs and two lanes
    def hk9_case(perm, valid, keys, what):
        a = K.run_bounds(perm, valid, keys, want_gid=True)
        b = K.run_bounds(perm, valid, keys, want_gid=True)
        same_bytes(list(a), list(b), what)
        c = K.run_bounds_plain(perm, valid, keys, want_gid=True)
        for x, y, nm in zip(a, c, ("count", "lead", "ends", "gid")):
            if not torch.equal(x, y):
                raise Mismatch(f"{what}: {nm} differs")
        return int(a[0][0])

    def hk9_bytes(n, n_valid, n_groups, keys):
        """perm and validity read at every position, the key lanes (value
        and NULL flag) over the valid rows; the count, the leaders of the
        groups and the padded ends (HK5 reads all n) written once."""
        return n * (8 + 1) + _lane_bytes(keys, n_valid) + 8 * n_groups \
            + 8 * n + 8

    n9 = 1 << 21
    valid9 = t(np.arange(n9) < n_o)
    k9 = [(t(K.pad1(rng.integers(1, n_c + 1, n_o), n9), torch.int64),
           zeros(n9))]
    perm9 = K.lex_order(K.sort_lanes(k9, [False], valid9), n9)
    runs9 = hk9_case(perm9, valid9, k9, "run_bounds Q13 c_custkey")
    sorted9 = k9[0][0][perm9][:n_o].contiguous()
    cnt9 = t(K.pad1(np.bincount(o_cust, minlength=n_c + 1)[1:], n9),
             torch.int64)
    validc = t(np.arange(n9) < n_c)
    kc = [(cnt9, zeros(n9))]
    permc = K.lex_order(K.sort_lanes(kc, [False], validc), n9)
    runsc = hk9_case(permc, validc, kc, "run_bounds Q13 c_count")
    f9 = t(rng.integers(-3, 4, n9).astype(np.float64))
    f9[:4] = t([float("nan"), -0.0, 0.0, float("nan")])
    k2 = [(t(rng.integers(0, 500, n9), torch.int64), t(rng.random(n9) < 0.1)),
          (f9, t(rng.random(n9) < 0.1))]
    for frac in (0.9, 0.0):
        v2 = t(rng.random(n9) < frac)
        p2 = K.lex_order(K.sort_lanes(k2, [False, False], v2), n9)
        hk9_case(p2, v2, k2, f"run_bounds two keys valid={frac}")
        hk9_case(p2, v2, k2[:1], f"run_bounds one key valid={frac}")
    rec["run_bounds"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.run_bounds(perm9, valid9, k9)),
        "plain_ms": cuda_ms(lambda: K.run_bounds_plain(perm9, valid9, k9)),
        "library_ms": None,
        "bytes": hk9_bytes(n9, n_o, runs9, k9), "ops": n9,
        "shape": f"2^21 sorted rows ({n_o} valid), 1 int64 key, {runs9} "
                 f"runs (Q13 GROUP BY c_custkey); c_count: {runsc} runs",
        "c_count_ms": cuda_ms(lambda: K.run_bounds(permc, validc, kc)),
        "partial_unique_consecutive_ms": cuda_ms(
            lambda: torch.unique_consecutive(sorted9, return_counts=True))}

    # HK6's composite mode: 2^21 probe rows on two keys (k1 in 1..4000,
    # k2 in 1..500; 5% beyond either range, 5% NULL) through a 2*10^6-entry
    # composite table of 2^20 unique build rows, 2 build lanes
    np6 = 1 << 21
    spec6 = [(1, 4000, 500), (1, 500, 1)]
    nbb6 = 1 << 20
    comp6 = rng.choice(4000 * 500, nbb6, replace=False)
    tbl6 = np.full(4000 * 500, -1, np.int32)
    tbl6[comp6] = np.arange(nbb6, dtype=np.int32)
    keys6 = [(t(rng.integers(1, 4211, np6), torch.int64),
              t(rng.random(np6) < 0.05)),
             (t(rng.integers(1, 526, np6), torch.int64), None)]
    bl6 = [(t(rng.integers(0, 1 << 40, nbb6), torch.int64), zeros(nbb6)),
           (t(rng.normal(size=nbb6)), t(rng.random(nbb6) < 0.1))]
    args6 = (keys6, spec6, t(rng.random(np6) < 0.9), t(tbl6),
             t(rng.random(nbb6) < 0.8), bl6)
    for mode in ("inner", "left"):
        a = K.dense_probe_multi(*args6, mode)
        b = K.dense_probe_multi(*args6, mode)
        same_pairs([(a[0], a[0])] + a[1], [(b[0], b[0])] + b[1],
                   f"dense_probe composite {mode} (two runs)")
        c = K.dense_probe_multi_plain(*args6, mode)
        if not torch.equal(a[0], c[0]):
            raise Mismatch(f"dense_probe composite {mode}: valid differs")
        same_pairs(a[1], c[1], f"dense_probe composite {mode}")
    # bound: each probe row's keys, NULL flags and validity read and its
    # valid flag and gathered lanes written; the table entry of each
    # distinct in-range composite key and the build row it names read once
    comp_k, ok = K.probe_keys_plain(keys6, spec6)
    distinct = torch.unique(comp_k[ok])
    hits = int((t(tbl6)[distinct] >= 0).sum())
    out6 = sum(v.element_size() + 1 for v, _m in bl6)
    bytes6 = (_lane_bytes(keys6, np6) + np6 * (1 + 1 + out6)
              + 4 * int(distinct.shape[0]) + hits * (1 + out6))
    rec["dense_probe"] = {
        "composite_ms": cuda_ms(lambda: K.dense_probe_multi(*args6,
                                                            "inner")),
        "composite_device_ms": device_ms(lambda: K.dense_probe_multi(
            *args6, "inner")),
        "composite_plain_ms": cuda_ms(lambda: K.dense_probe_multi_plain(
            *args6, "inner")),
        "composite_bound_ms": bytes6 / MEM_BPS * 1e3,
        "composite_shape": f"probe 2^21, 2 keys, table 2*10^6, build 2^20, "
                           f"2 lanes, {int(distinct.shape[0])} distinct "
                           f"in-range keys"}
    return rec


# -- HK7 expr_eval -----------------------------------------------------------

def expr_bytes(prog, cols, n_live: int) -> int:
    """Bytes an expression program must move over its live rows: each
    input lane's values (8 B, or 1 B for a bool lane) and NULL mask read
    once, the mask and each output lane (values and NULL mask) written
    once."""
    per_row = 0
    for slot, kind in prog.inputs:
        v, m = cols[slot]
        per_row += (0 if kind == "n" else v.element_size()) + \
            (m is not None)
    per_row += int(prog.has_mask)
    per_row += sum(1 + (0 if dt == "n" else 8) for dt in prog.outputs)
    return n_live * per_row


def same_expr(a, b, what: str, float_ulps: int = 0) -> int:
    """HK7 against its plain version: the mask and every lane byte for
    byte, float lanes within ``float_ulps``.  Returns the largest float
    distance seen, in ulps."""
    import torch
    (ma, oa), (mb, ob) = a, b
    if (ma is None) != (mb is None) or (
            ma is not None and not torch.equal(ma, mb)):
        raise Mismatch(f"{what}: mask differs")
    worst = 0
    for j, ((va, na), (vb, nb)) in enumerate(zip(oa, ob)):
        if not torch.equal(na, nb):
            raise Mismatch(f"{what}: NULL lane {j} differs")
        if va is None and vb is None:
            continue
        ia, ib = va.view(torch.int64), vb.view(torch.int64)
        if torch.equal(ia, ib):
            continue
        if va.dtype != torch.float64:
            bad = int((ia != ib).nonzero()[0])
            raise Mismatch(f"{what}: lane {j} differs at {bad}: "
                           f"{int(ia[bad])} vs {int(ib[bad])}")
        nan2 = torch.isnan(va) & torch.isnan(vb)
        d = torch.where(nan2 | (ia == ib), torch.zeros_like(ia),
                        (ia - ib).abs())
        worst = max(worst, int(d.max()))
        if worst > float_ulps:
            raise Mismatch(f"{what}: float lane {j} {worst} ulps apart")
    return worst


def hk7_case(K, prog, cols, pr, n, what, float_ulps=0, **kw):
    a = K.expr_eval(prog, cols, pr, n, **kw)
    b = K.expr_eval(prog, cols, pr, n, **kw)
    same_expr(a, b, f"{what} (two runs)")
    return same_expr(a, K.expr_eval_plain(prog, cols, pr, n, **kw), what,
                     float_ulps)


def phase_hk7(K, dev, t, rng) -> dict:
    """HK7 at the main path's shapes (Q6's mask and revenue lane, Q1's
    argument lanes, Q3's leaf masks) and over the expression battery."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.bench import exprcases as EC
    from tinysql_tpu_torch.expression import Column, Constant, new_function
    from tinysql_tpu_torch.mytypes import new_real_type
    from tinysql_tpu_torch.ops import exprjit as X

    def real(i):
        return Column(new_real_type(), index=i)

    def const(v):
        return Constant(v, new_real_type())

    def padded(a, nb):
        return t(K.pad1(a, nb))

    # lineitem at SF=1: 5,999,820 live rows of a 2^23 bucket; l_shipdate
    # as codes of its 2526 distinct dates
    n, live = 1 << 23, 5_999_820
    ship = padded(rng.integers(0, 2526, live).astype(np.int64), n)
    nul = t(np.zeros(n, bool))
    disc = padded(np.round(rng.integers(0, 11, live) * 0.01, 2), n)
    qty = padded(rng.integers(1, 51, live).astype(np.float64), n)
    price = padded(np.round(rng.uniform(900.0, 105000.0, live), 2), n)
    tax = padded(np.round(rng.integers(0, 9, live) * 0.01, 2), n)
    cols = [(ship, nul), (disc, nul), (qty, nul), (price, nul), (tax, nul)]
    # Q6: 1994-01-01 <= l_shipdate < 1995-01-01 (codes 731 .. 1095),
    # l_discount between 0.05 and 0.07, l_quantity < 24; revenue lane
    pt6 = X.ParamTable()
    q6 = X.compile_program(
        [("codecmp", 0, ">=", 731, 732, 2526),
         ("codecmp", 0, "<", 1096, 1097, 2526),
         new_function(">=", [real(1), const(0.05)]),
         new_function("<=", [real(1), const(0.07)]),
         new_function("<", [real(2), const(24.0)])],
        [new_function("*", [real(3), real(1)])], pt6, mask=True)
    pr6 = K._params_dev(pt6.arrays())
    hk7_case(K, q6, cols, pr6, n, "expr_eval Q6", n_rows=live)
    m6 = K.expr_eval(q6, cols, pr6, n, n_rows=live)[0]
    # Q1: l_shipdate <= 1998-09-02 (code 2436); the seven argument lanes
    # and the NULL masks of its three AVG counts
    one = const(1.0)
    dprice = new_function("*", [real(3), new_function("-", [one, real(1)])])
    charge = new_function("*", [dprice, new_function("+", [one, real(4)])])
    pt1 = X.ParamTable()
    q1 = X.compile_program(
        [("codecmp", 0, "<=", 2436, 2437, 2526)],
        [real(2), real(3), dprice, charge, real(2), ("null", real(2)),
         real(3), ("null", real(3)), real(1), ("null", real(1))], pt1,
        mask=True)
    pr1 = K._params_dev(pt1.arrays())
    hk7_case(K, q1, cols, pr1, n, "expr_eval Q1", n_rows=live)
    # Q3's three leaf masks: customer (150,000 of 2^18, c_mktsegment =
    # 'BUILDING' on 5 codes), orders (1,500,000 of 2^21, o_orderdate <
    # 1995-03-15), lineitem (l_shipdate > 1995-03-15)
    q3 = []
    for nb3, live3, card, op, lo in ((1 << 18, 150_000, 5, "=", 1),
                                     (1 << 21, 1_500_000, 2406, "<", 1169),
                                     (n, live, 2526, ">", 1169)):
        c3 = [(padded(rng.integers(0, card, live3).astype(np.int64), nb3),
               t(np.zeros(nb3, bool)))]
        pt3 = X.ParamTable()
        p3 = X.compile_program([("codecmp", 0, op, lo, lo + 1, card)], (),
                               pt3, mask=True)
        pr3 = K._params_dev(pt3.arrays())
        hk7_case(K, p3, c3, pr3, nb3, f"expr_eval Q3 leaf {op}",
                 n_rows=live3)
        q3.append((p3, c3, pr3, nb3, live3))
    # the battery: every SQL function over columns with NULLs, extremes
    # and zeros, the programs split past the limits, K14 and K15
    nbat = 1 << 16
    vals, nulls = EC.columns(SEED, nbat)
    bcols = [(t(v), t(m)) for v, m in zip(vals, nulls)]
    keep = t(rng.random(nbat) < 0.8)
    mod_ulps = 0
    split_segments = {}
    specs = [(nm, s) for nm, ss in EC.CASES.items() for s in ss]
    specs += list(EC.SPLIT_CASES.items())
    for nm, spec in specs:
        e = EC.build(spec)
        pt = X.ParamTable()
        prog = X.compile_program([e], [e, ("null", e)], pt)
        if nm in EC.SPLIT_CASES:
            split_segments[nm] = len(prog.segments())
        pr = K._params_dev(pt.arrays())
        for kw in ({}, {"n_rows": nbat - 77, "mask_in": keep}):
            u = hk7_case(K, prog, bcols, pr, nbat, f"expr_eval {nm} {spec}",
                         1 if nm == "%" else 0, **kw)
            if nm == "%":
                mod_ulps = max(mod_ulps, u)
    codes, cnull = EC.code_column(SEED, nbat)
    ccols = [(t(codes), t(cnull))]
    for op in EC.CODE_CMP_OPS:
        pt = X.ParamTable()
        prog = X.ExprProgram()
        r = prog.code_cmp(0, op, EC.CODE_LO, EC.CODE_HI, EC.CODE_CARD, pt)
        prog.cond(r)
        prog.store(r)
        hk7_case(K, prog, ccols, K._params_dev(pt.arrays()), nbat,
                 f"expr_eval code {op}", n_rows=nbat - 5)
    ids = t(rng.integers(0, 7 * 14 + 1, nbat).astype(np.int64))
    lcols = [(ids, None), (ids < 7 * 14, None),
             (t(rng.normal(size=nbat)), t(rng.random(nbat) < 0.1)),
             (t(rng.integers(0, 4, nbat).astype(np.int64)), None)]
    pt = X.ParamTable()
    prog = X.ExprProgram()
    for stride, card, base in ((14, 6, -3), (1, 13, 1 << 40)):
        prog.store(prog.key_decode(prog.load(0, "i"), prog.load(1, "b"),
                                   stride, card, base, pt))
    prog.store(prog.avg(prog.load(2, "f"), prog.load(3, "i")))
    prog.store(prog.to_real(prog.load(3, "i")))
    hk7_case(K, prog, lcols, K._params_dev(pt.arrays()), nbat,
             "expr_eval K15 layout")
    p3, c3, pr3, nb3, live3 = q3[2]
    q6x = {"cols": cols, "prog": q6, "params": pt6.arrays(), "n": n,
           "live": live}
    return {
        "max_abs_err": 0.0,
        **timed(lambda: K.expr_eval(q6, cols, pr6, n, n_rows=live)),
        "plain_ms": cuda_ms(lambda: K.expr_eval_plain(q6, cols, pr6, n,
                                                      n_rows=live)),
        "library_ms": None,
        "bytes": expr_bytes(q6, cols, live),
        "ops": len(q6.ins) * live,
        "shape": f"n=2^23 ({live} live, {int(m6.sum())} pass), 5 "
                 f"conditions + 1 f64 lane, {len(q6.ins)} instructions "
                 "(Q6)",
        "float_mod_max_ulps": mod_ulps,
        "split_segments": split_segments,
        "q1_ms": cuda_ms(lambda: K.expr_eval(q1, cols, pr1, n,
                                             n_rows=live)),
        "q1_device_ms": device_ms(lambda: K.expr_eval(q1, cols, pr1, n,
                                                      n_rows=live)),
        "q1_plain_ms": cuda_ms(lambda: K.expr_eval_plain(q1, cols, pr1, n,
                                                         n_rows=live)),
        "q1_bound_ms": expr_bytes(q1, cols, live) / MEM_BPS * 1e3,
        "q1_instructions": len(q1.ins),
        "q3_lineitem_mask_ms": cuda_ms(lambda: K.expr_eval(
            p3, c3, pr3, nb3, n_rows=live3)),
        "q3_lineitem_mask_bound_ms": expr_bytes(p3, c3, live3) / MEM_BPS
        * 1e3}, q6x


# -- K12: the batched entry points of a stacked round (HK7b, HK1b, HK2b) ----

def expr_bytes_batched(prog, cols, n_live: int, nmem: int,
                       n_params: int) -> int:
    """Bytes a stacked round's expression program must move: the shared
    input lanes read once over the live rows, then per member its
    parameter row read and its mask and output lanes written once."""
    per_in = sum((0 if kind == "n" else cols[slot][0].element_size())
                 + (cols[slot][1] is not None) for slot, kind in prog.inputs)
    per_out = int(prog.has_mask) + sum(1 + (0 if dt == "n" else 8)
                                       for dt in prog.outputs)
    return n_live * per_in + nmem * (n_live * per_out + 8 * n_params)


def _member_expr(got, b):
    mask, outs = got
    return (None if mask is None else mask[b],
            [(None if v is None else v[b], m[b]) for v, m in outs])


def phase_k12(K, dev, t, rng, q6x) -> dict:
    """The three batched entry points of K12's stacked round, each held
    byte for byte against B solo launches with each member's inputs and
    against its plain version: HK7b and HK1b at Q6's SF=1 program (2^23
    rows) at B = 2, 3 (run as the B = 4 launch with an inert padding
    row), 8 and 16; HK2b at Q1's 16-segment shape and at a sort-regime
    shape (2^21 segments), both at B = 4.  Times: CUDA events and
    torch.profiler device time of one batched call, the B solo calls,
    the plain version, and the bound counted with the shared columns
    once."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.bench import exprcases as EC
    from tinysql_tpu_torch.ops.exprjit import ParamTable
    cols, q6, (pi, pf) = q6x["cols"], q6x["prog"], q6x["params"]
    n, live = q6x["n"], q6x["live"]
    n_params = len(pi) + len(pf)
    out = {}
    ee, mr = {}, {}
    for occ in (8, 2, 3, 16):
        b = K.occupancy_bucket(occ)
        members = [EC.member_params(pi, pf, i) for i in range(occ)]
        prs = K._params_dev(ParamTable.stack(members, b))
        got = K.expr_eval_batched(q6, cols, prs, n, n_rows=live)
        same_expr(got, K.expr_eval_batched(q6, cols, prs, n, n_rows=live),
                  f"expr_eval_batched Q6 B={b} (two runs)")
        same_expr(got, K.expr_eval_batched_plain(q6, cols, prs, n,
                                                 n_rows=live),
                  f"expr_eval_batched Q6 B={b} vs plain")
        for i in range(occ):  # the padding row's outputs are dropped
            solo = K.expr_eval(q6, cols, (prs[0][i], prs[1][i]), n,
                               n_rows=live)
            same_expr(_member_expr(got, i), solo,
                      f"expr_eval_batched Q6 B={b} member {i} vs solo")
        valid, (rev,) = got[0], got[1]
        lanes = [(rev[0], rev[1], "sum")]
        r1 = K.masked_reduce_batched(valid, lanes)
        same_bytes(r1, K.masked_reduce_batched(valid, lanes),
                   f"masked_reduce_batched Q6 B={b}")
        err = check_table(
            r1.T.contiguous(), K.masked_reduce_batched_plain(
                valid, K._norm_lanes(lanes, n, dev, "k12", b)).T
            .contiguous(), {2}, f"masked_reduce_batched Q6 B={b}")
        for i in range(occ):
            same_bytes(r1[i], K.masked_reduce(valid[i],
                                              K._member_lanes(lanes, i)),
                       f"masked_reduce_batched Q6 B={b} member {i} vs solo")
        key = f"b{occ}"
        ee[key + "_ms"] = cuda_ms(lambda: K.expr_eval_batched(
            q6, cols, prs, n, n_rows=live), reps=5)
        ee[key + "_solo_ms"] = cuda_ms(lambda: [K.expr_eval(
            q6, cols, (prs[0][i], prs[1][i]), n, n_rows=live)
            for i in range(b)], reps=5)
        ee[key + "_bound_ms"] = expr_bytes_batched(
            q6, cols, live, b, n_params) / MEM_BPS * 1e3
        mr[key + "_ms"] = cuda_ms(lambda: K.masked_reduce_batched(
            valid, lanes), reps=5)
        mr[key + "_solo_ms"] = cuda_ms(lambda: [K.masked_reduce(
            valid[i], K._member_lanes(lanes, i)) for i in range(b)], reps=5)
        mr[key + "_bound_ms"] = reduce_bytes(valid, lanes, 4) / MEM_BPS \
            * 1e3
        mr[key + "_max_abs_err"] = err
        if occ == 8:  # the Q6 stream's round: the records' main shape
            out["expr_eval_batched"] = {
                "max_abs_err": 0.0,
                **timed(lambda: K.expr_eval_batched(q6, cols, prs, n,
                                                    n_rows=live)),
                "plain_ms": cuda_ms(lambda: K.expr_eval_batched_plain(
                    q6, cols, prs, n, n_rows=live), reps=3, warm=1),
                "library_ms": None,
                "bytes": expr_bytes_batched(q6, cols, live, b, n_params),
                "ops": len(q6.ins) * live * b,
                "shape": f"B=8 members, n=2^23 ({live} live), Q6's "
                         f"program ({len(q6.ins)} instructions)"}
            out["masked_reduce_batched"] = {
                "max_abs_err": err,
                **timed(lambda: K.masked_reduce_batched(valid, lanes)),
                "plain_ms": cuda_ms(lambda: K.masked_reduce_batched_plain(
                    valid, lanes), reps=3, warm=1),
                "library_ms": None,
                "bytes": reduce_bytes(valid, lanes, 4),
                "ops": 2 * int(valid.sum()),
                "shape": "B=8 members, n=2^23, 1 float64 SUM lane (Q6)"}
        del got, valid, rev, lanes, r1
    out["expr_eval_batched"].update(ee)
    out["masked_reduce_batched"].update(mr)

    # HK2b: Q1's shape (16 segments, 6 used, 10 lanes) and the sort regime
    def per_member_f(nmem):
        return t(np.round(rng.uniform(900.0, 105000.0, (nmem, n)), 2))

    def hk2b_case(gid, valid, ns, lanes, what):
        nmem = int(valid.shape[0])
        k1 = K.segment_reduce_batched(gid, valid, ns, lanes)
        same_bytes(k1, K.segment_reduce_batched(gid, valid, ns, lanes),
                   what)
        p = K.segment_reduce_batched_plain(
            gid, valid, ns, K._norm_lanes(lanes, n, dev, what, nmem))
        err = 0.0
        for i in range(nmem):
            same_bytes(k1[i], K.segment_reduce(gid, valid[i], ns,
                                               K._member_lanes(lanes, i)),
                       f"{what} member {i} vs solo")
            err = max(err, check_table(k1[i], p[i],
                                       lane_float_rows(lanes, 2),
                                       f"{what} member {i}"))
        return err

    nmem = 4
    gid1 = t(rng.choice(6, n, p=[0.25, 0.007, 0.25, 0.24, 0.003, 0.25])
             .astype(np.int64))
    valid1 = t(rng.random((nmem, n)) < 0.98)
    q1 = []
    for j in range(10):
        if j in (5, 7, 9):
            q1.append((None, t(np.zeros(n, bool)), "count"))
        else:
            q1.append((per_member_f(nmem), t(np.zeros(n, bool)), "sum"))
    err = hk2b_case(gid1, valid1, 16, q1, "segment_reduce_batched Q1 B=4")
    out["segment_reduce_batched"] = {
        "max_abs_err": err,
        **timed(lambda: K.segment_reduce_batched(gid1, valid1, 16, q1)),
        "plain_ms": cuda_ms(lambda: K.segment_reduce_batched_plain(
            gid1, valid1, 16, q1), reps=3, warm=1),
        "library_ms": None,
        "bytes": reduce_bytes(valid1, q1, (2 + 2 * len(q1)) * 16, gid=True),
        "ops": 2 * int(valid1.sum()) * len(q1),
        "shape": "B=4 members, n=2^23, 16 segments (6 used), 7 float64 "
                 "SUM + 3 count lanes (Q1)",
        "solo_x4_ms": cuda_ms(lambda: [K.segment_reduce(
            gid1, valid1[i], 16, K._member_lanes(q1, i))
            for i in range(nmem)], reps=5)}
    del q1, valid1
    # Q3's lineitem grouped by order: 1.5M groups of 4 rows at SF=1
    live3 = min(6_000_000, 3 * n // 4)
    ns3 = K.bucket(live3 // 4)
    gid3 = t(np.concatenate([np.repeat(np.arange(live3 // 4), 4),
                             np.zeros(n - live3 // 4 * 4, np.int64)]))
    valid3 = t(np.concatenate(
        [rng.random((nmem, live3 // 4 * 4)) < 0.54,
         np.zeros((nmem, n - live3 // 4 * 4), bool)], axis=1))
    q3 = [(per_member_f(nmem), t(np.zeros(n, bool)), "sum")]
    hk2b_case(gid3, valid3, ns3, q3, "segment_reduce_batched sort B=4")
    out["segment_reduce_batched"].update({
        "sort_regime_ms": cuda_ms(lambda: K.segment_reduce_batched(
            gid3, valid3, ns3, q3), reps=5),
        "sort_regime_device_ms": device_ms(lambda: K.segment_reduce_batched(
            gid3, valid3, ns3, q3), reps=3),
        "sort_regime_solo_x4_ms": cuda_ms(lambda: [K.segment_reduce(
            gid3, valid3[i], ns3, K._member_lanes(q3, i))
            for i in range(nmem)], reps=3),
        "sort_regime_bound_ms": reduce_bytes(
            valid3, q3, (2 + 2 * len(q3)) * ns3, gid=True) / MEM_BPS * 1e3,
        "sort_regime_shape": "B=4 members, n=2^23, 2^21 segments, 1 "
                             "float64 SUM lane"})
    return out


def offpath(K, dev, t, rng) -> dict:
    """Families off the main path that an existing kernel serves, timed
    at a stated shape with their bounds (median CUDA events)."""
    import numpy as np
    import torch
    n, ns = 1 << 20, 1 << 16
    gid = t(rng.integers(0, ns, n), torch.int64)
    valid = t(rng.random(n) < 0.9)
    lanes = [(t(rng.random(n)), t(np.zeros(n, bool)), "sum"),
             (None, t(np.zeros(n, bool)), "count")]
    key = [(t(rng.integers(0, ns, n), torch.int64), t(np.zeros(n, bool)))]
    lk = t(rng.integers(0, 1 << 15, n), torch.int64)
    rk = t(rng.integers(0, 1 << 15, 1 << 15), torch.int64)
    zl, zr = t(np.zeros(n, bool)), t(np.zeros(1 << 15, bool))
    ol, orr = t(np.ones(n, bool)), t(np.ones(1 << 15, bool))

    def k4(plain=False):
        # group_aggregate's three kernels: the key sort, the runs of equal
        # keys, the segment reduction at as many segments as rows
        sl = K.sort_lanes(key, [False], valid, zero_nulls=False)
        if plain:
            perm = K.lex_order_plain(sl, n)
            gid = K.run_bounds_plain(perm, valid, key, want_gid=True)[3]
            return K.segment_reduce_plain(gid, valid, n, lanes)
        perm = K.lex_order(sl, n)
        gid = K.run_bounds(perm, valid, key, want_gid=True)[3]
        return K.segment_reduce(gid, valid, n, lanes)
    mult_pairs = int(K.equi_join_mult(lk, zl, ol, rk, zr, orr)[0].shape[0])
    out = {
        "K3 segment_reduce n=2^20 ns=2^16 2 lanes": (
            lambda: K.segment_reduce(gid, valid, ns, lanes),
            lambda: K.segment_reduce_plain(gid, valid, ns, lanes),
            n * (8 + 1 + 8 + 1 + 1) + 6 * 8 * ns),
        "K4 lex_order + run_bounds + segment_reduce n=2^20 1 key 2 lanes": (
            k4, lambda: k4(plain=True),
            n * (8 + 1 + 1 + 8 + 1 + 1) + 6 * 8 * n),
        "K5 masked_reduce n=2^20 2 lanes": (
            lambda: K.masked_reduce(valid, lanes),
            lambda: K.masked_reduce_plain(valid, lanes),
            n * (1 + 8 + 1 + 1) + 8 * 6),
        f"K7 equi_join_mult probe 2^20 build 2^15 ({mult_pairs} pairs)": (
            lambda: K.equi_join_mult(lk, zl, ol, rk, zr, orr),
            lambda: K.equi_join_mult_plain(lk, zl, ol, rk, zr, orr),
            n * 10 + (1 << 15) * 10 + 16 * mult_pairs),
    }
    return {name: {**timed(fn), "plain_ms": cuda_ms(fp, reps=3, warm=1),
                   "bound_ms": b / MEM_BPS * 1e3}
            for name, (fn, fp, b) in out.items()}


# ---- phase 3 -------------------------------------------------------------

def _sync(torch) -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def warm_profile(sess, sql: str, torch) -> dict:
    """One more warm run under torch.profiler: the CUDA kernels and the
    copies / memsets it launched and their device time.  A trace that
    comes back without device events is taken again, up to three times
    in all (None when none had any)."""
    from torch.profiler import ProfilerActivity, profile
    from tinysql_tpu_torch.bench.trace_tpch import device_us
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sess.query(sql)
            torch.cuda.synchronize()
        kern = copies = 0
        us = 0.0
        for e in prof.key_averages():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            us += device_us(e)
            if e.key.startswith(("Memcpy", "Memset")):
                copies += e.count
            else:
                kern += e.count
        if kern + copies:
            return {"kernels": kern, "copies": copies,
                    "device_ms": us / 1e3}
    return {"kernels": None, "copies": None, "device_ms": None}


def run_tier(K, sess, tier: str, queries: dict, torch) -> tuple:
    """``queries`` on one device tier: rows, per-query launches and the
    run's launch counts (set to 0 just before, read just after)."""
    from tinysql_tpu_torch.bench import tpch
    from tinysql_tpu_torch.executor import devpipe
    sess.execute(f"set tidb_devpipe = {TIERS[tier]}")
    K.reset_kernel_counts()
    rows = {}
    for q, sql in queries.items():
        before = K.kernel_counts()["launches"]
        devpipe.COMPILED_NODE_KEYS.clear()
        t1 = time.perf_counter()
        rows[q] = sess.query(sql).rows
        _sync(torch)
        first_s = time.perf_counter() - t1
        kinds = {k[0] for k in devpipe.COMPILED_NODE_KEYS}
        want = PIPE_KINDS.get(q, set()) if tier == "pipeline" else set()
        if kinds != want:
            raise Mismatch(f"{tier} {q}: pipeline node kinds {kinds}, "
                           f"want {want}")
        d2h = int(sess.last_query_stats.device_totals().get(
            "d2h_transfers", 0))
        if tier == "pipeline" and q in ONE_D2H and d2h != 1:
            raise Mismatch(f"pipeline {q}: {d2h} device->host copies, "
                           f"want 1")
        reps = TRIO_PER_OP_WARM if (tier == "per_op"
                                    and q in tpch.WORKLOAD) else WARM
        warm = []
        for _ in range(reps):
            t1 = time.perf_counter()
            again = sess.query(sql).rows
            _sync(torch)
            warm.append(time.perf_counter() - t1)
            if tpch.canon_rows(again) != tpch.canon_rows(rows[q]):
                raise Mismatch(f"{tier} {q}: warm run rows differ from "
                               f"the first")
        prof = warm_profile(sess, sql, torch)
        after = K.kernel_counts()["launches"]
        used = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        for k in USES[tier][q]:
            if k not in used:
                raise Mismatch(f"{tier} {q}: kernel {k} was not launched")
        print(f"[main] {tier} {q}: {len(rows[q])} rows, first run "
              f"{first_s:.4f} s, warm best of {reps} {min(warm):.4f} s, "
              f"one warm run: {prof['kernels']} CUDA kernels + "
              f"{prof['copies']} copies, device {prof['device_ms']} ms; "
              f"node kinds {sorted(kinds)}, {d2h} D2H, launches {used}",
              flush=True)
        # Q6 runs the per-operator executors on both tiers (no join, no
        # grouped aggregate); torch.profiler sometimes returns no device
        # event for it, so the bound is held wherever a trace has them
        if q == "Q6" and prof["kernels"] is not None \
                and prof["kernels"] > Q6_PER_OP_MAX_KERNELS:
            raise Mismatch(f"{tier} Q6: {prof} in one warm run, want at "
                           f"most {Q6_PER_OP_MAX_KERNELS} CUDA kernels")
    counts = K.kernel_counts()
    if any(counts["plain_calls"].values()):
        raise Mismatch(f"plain versions ran on the {tier} tier: "
                       f"{counts['plain_calls']}")
    return rows, counts["launches"]


def same_rel(a, b, what: str) -> None:
    """Rows equal in order: integers, strings and NULLs exactly, floats
    within FLOAT_RTOL relative (blocks reorder a float sum)."""
    import math
    if len(a) != len(b):
        raise Mismatch(f"{what}: {len(a)} rows vs {len(b)}")
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                ok = math.isclose(x, y, rel_tol=FLOAT_RTOL, abs_tol=1e-9)
            else:
                ok = x == y
            if not ok or len(ra) != len(rb):
                raise Mismatch(f"{what}: {ra} vs {rb}")


def run_blockwise(K, sess, tier: str, unblocked: dict, torch) -> dict:
    """BLOCK_QUERIES on one device tier under tidb_device_block_rows =
    BLOCK_ROWS: rows equal to the same tier's unblocked run (floats within
    1e-6 relative), blocks streamed where the reference streams them, no
    plain version; the warm runs alternate the BLOCK_DEPTHS staging depths
    (rows byte-equal to the first run's) and print each one's wall and the
    block pipelines' own wall (``pipe_wall_s``); returns the run's launch
    counts (set to 0 just before, read just after)."""
    from tinysql_tpu_torch.bench import tpch
    queries = {**tpch.QUERIES, **tpch.K8_QUERIES}
    sess.execute(f"set tidb_devpipe = {TIERS[tier]}")
    sess.execute(f"set tidb_device_block_rows = {BLOCK_ROWS}")
    K.reset_kernel_counts()
    try:
        for q in BLOCK_QUERIES:
            sql = queries[q]
            snap = K.stats_snapshot()
            t1 = time.perf_counter()
            rows = sess.query(sql).rows
            _sync(torch)
            first_s = time.perf_counter() - t1
            d = K.stats_delta(snap)
            warm = {depth: [] for depth in BLOCK_DEPTHS}
            for _ in range(BLOCK_WARM):
                for depth in BLOCK_DEPTHS:
                    sess.execute(f"set tidb_pipeline_depth = {depth}")
                    snap = K.stats_snapshot()
                    t1 = time.perf_counter()
                    again = sess.query(sql).rows
                    _sync(torch)
                    wall = time.perf_counter() - t1
                    pipe = K.stats_delta(snap)["pipe_wall_s"]
                    warm[depth].append(f"{wall:.4f} (pipe {pipe:.4f})")
                    if repr(again) != repr(rows):
                        raise Mismatch(f"block-wise {tier} {q}: a warm run "
                                       f"at depth {depth} differs from "
                                       f"the first")
            same_rel(rows, unblocked[q], f"block-wise {tier} {q} vs "
                                         f"unblocked")
            blocks = int(d["pipe_blocks"])
            if q in BLOCK_STREAMS and blocks <= 0:
                raise Mismatch(f"block-wise {tier} {q}: no block streamed")
            print(f"[block] {tier} {q}: {len(rows)} rows equal to the "
                  f"unblocked run, {blocks} blocks of <= {BLOCK_ROWS} rows,"
                  f" first run {first_s:.4f} s, warm s at depth "
                  + "; ".join(f"{depth}: {', '.join(w)}"
                              for depth, w in warm.items())
                  + f", {int(d['h2d_transfers'])} H2D, "
                  f"{int(d['d2h_transfers'])} D2H", flush=True)
    finally:
        sess.execute("set tidb_device_block_rows = 0")
        sess.execute(f"set tidb_pipeline_depth = {BLOCK_DEPTHS[0]}")
    counts = K.kernel_counts()
    if any(counts["plain_calls"].values()):
        raise Mismatch(f"plain versions ran block-wise on the {tier} tier: "
                       f"{counts['plain_calls']}")
    return counts["launches"]


def check_rows(rows, what: str, expect: int = None,
               empty_ok: bool = False) -> None:
    import math
    if (not rows and not empty_ok) or (expect is not None
                                       and len(rows) != expect):
        raise Mismatch(f"{what}: {len(rows)} rows")
    for r in rows:
        for v in r:
            if isinstance(v, float) and not math.isfinite(v):
                raise Mismatch(f"{what}: non-finite value {v}")


def phase_main_path(K, kinfo, device=None):
    import torch
    from tinysql_tpu_torch.bench import tpch
    from tinysql_tpu_torch.session import new_session
    t0 = time.perf_counter()
    sess = new_session(device=device)
    if device is None and sess.device.type != "cuda":
        raise Mismatch(f"new_session() chose {sess.device}")
    data = tpch.generate(SF, SEED)
    counts = tpch.load(sess, sf=SF, seed=SEED, data=data)
    numpy_rows = {q: getattr(tpch, fn)(data) for q, fn in NUMPY_ROWS.items()}
    del data
    print(f"[main] tpch.load sf={SF} seed={SEED}: {counts} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sess.execute("set tidb_use_tpu=1")
    if int(sess.get_sysvar("tidb_devpipe")) != TIERS["pipeline"]:
        raise Mismatch("the pipeline tier is not the default")
    # Q1, Q3, Q6 and Q13 on both tiers before the trio: after Q5's run,
    # torch.profiler loses some kernel events of later traces
    tier_rows = {tier: {} for tier in TIERS}
    plan = [r[3] for r in sess.query("explain " + tpch.NOT_IN).rows
            if "Join" in r[0]]
    if not plan or "anti join" not in plan[0] \
            or "null-aware" not in plan[0]:
        raise Mismatch(f"NOT IN plans no null-aware anti join: {plan}")
    print(f"[main] NOT IN plans {plan[0]}", flush=True)

    def add_launches(launches, tier):
        for k, v in launches.items():
            kinfo[k]["launches"] += v
            by_tier = kinfo[k].setdefault("launches_by_tier", {})
            by_tier[tier] = by_tier.get(tier, 0) + v
    for queries in (tpch.QUERIES, {"Q13": tpch.Q13}, tpch.K8_QUERIES,
                    "blockwise", tpch.WORKLOAD):
        if queries == "blockwise":
            for tier in TIERS:
                add_launches(run_blockwise(K, sess, tier, tier_rows[tier],
                                           torch), tier + " block-wise")
            continue
        for tier in TIERS:
            rows, launches = run_tier(K, sess, tier, queries, torch)
            tier_rows[tier].update(rows)
            add_launches(launches, tier)
    for k, info in kinfo.items():
        # the batched entry points launch on the serve phase's path
        if info["launches"] <= 0 and not k.endswith("_batched"):
            raise Mismatch(f"kernel {k} never launched on the main path")
    # Q13 and Q5: numpy's answers from the generated columns, both tiers
    for q, want in numpy_rows.items():
        for tier, rows in tier_rows.items():
            if tpch.canon_rows(rows[q]) != tpch.canon_rows(want):
                raise Mismatch(f"{tier} {q} differs from numpy:\n"
                               f"gpu {rows[q][:3]}\nnumpy {want[:3]}")
            check_rows(rows[q], f"{tier} {q}")
        print(f"[main] {q}: both tiers equal to numpy's {q}, "
              f"{len(want)} rows", flush=True)
    # the port's own CPU tier is the reference for the rows of the others
    sess.execute("set tidb_use_tpu=0")
    expect_rows = {"Q1": 6, "Q3": 10, "Q6": 1, "Q5": 5, "Q10": 20,
                   "NOT_IN": 1, "NOT_EXISTS": 1}
    cpu_queries = {**tpch.ALL_QUERIES, **tpch.K8_QUERIES}
    for q, sql in cpu_queries.items():
        if q in numpy_rows:
            continue
        t1 = time.perf_counter()
        cpu_rows = sess.query(sql).rows
        cpu_s = time.perf_counter() - t1
        for tier, rows in tier_rows.items():
            if tpch.canon_rows(cpu_rows) != tpch.canon_rows(rows[q]):
                raise Mismatch(f"{tier} {q}: GPU rows differ from the CPU "
                               f"tier:\ngpu {rows[q][:3]}\n"
                               f"cpu {cpu_rows[:3]}")
        print(f"[main] {q}: both tiers equal to the CPU tier, "
              f"{len(cpu_rows)} rows ({cpu_s:.3f} s there)", flush=True)
    for tier, rows in tier_rows.items():
        for q in cpu_queries:
            check_rows(rows[q], f"{tier} {q}", expect_rows.get(q),
                       empty_ok=q in EMPTY_OK)
            if q in NONZERO_COUNT:
                if not rows[q][0][0]:
                    raise Mismatch(f"{tier} {q}: a count of 0 ({rows[q]})")
                print(f"[main] {tier} {q}: {rows[q][0]}", flush=True)
    sess.execute("set tidb_use_tpu=1")
    return sess.storage


# ---- serve phase ----------------------------------------------------------

class WireClient:
    """A minimal MySQL client over the port's packet layer
    (tinysql_tpu_torch/server/packetio.py): the protocol-41 handshake as
    root with no password, then COM_QUERY over the text protocol."""

    def __init__(self, port: int, db: str = ""):
        import socket
        import struct
        from tinysql_tpu_torch.server.packetio import PacketIO
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=120)
        self.io = PacketIO(self.sock)
        if self.io.read_packet()[0] != 10:
            raise Mismatch("wire: no protocol v10 greeting")
        caps = 0x0200 | 0x8000 | (0x0008 if db else 0)
        payload = struct.pack("<IIB", caps, 1 << 24, 0x21) + b"\0" * 23
        payload += b"root\0" + b"\0"  # user, empty auth response
        if db:
            payload += db.encode() + b"\0"
        self.io.write_packet(payload)
        if self.io.read_packet()[0] != 0x00:
            raise Mismatch("wire: handshake refused")

    def query(self, sql: str):
        """The row packets of a resultset (raw text-protocol payloads), or
        None for an OK packet."""
        import struct
        from tinysql_tpu_torch.server.packetio import read_lenenc_int
        self.io.reset_sequence()
        self.io.write_packet(b"\x03" + sql.encode())
        first = self.io.read_packet()
        if first[0] == 0x00:
            return None
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            raise Mismatch(f"wire: server error {code}: "
                           f"{first[9:].decode(errors='replace')}")
        ncols, _ = read_lenenc_int(first, 0)
        for _ in range(ncols + 1):  # column definitions, EOF
            self.io.read_packet()
        rows = []
        while True:
            d = self.io.read_packet()
            if d[0] == 0xFE and len(d) < 9:
                return rows
            rows.append(bytes(d))

    def close(self) -> None:
        try:
            self.io.write_packet(b"\x01")
        except OSError:
            pass
        self.sock.close()


def storm(port: int, sqls) -> tuple:
    """One statement per connection, all sent together (the clients
    connect first, then a barrier releases them): (each statement's row
    packets, the wall from the release to the last response)."""
    import threading
    clients = [WireClient(port, "tpch") for _ in sqls]
    gate = threading.Barrier(len(sqls) + 1)
    got, errors = [None] * len(sqls), []

    def run(i):
        gate.wait()
        try:
            got[i] = clients[i].query(sqls[i])
        except Exception as e:  # reported below, after every join
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(sqls))]
    for th in threads:
        th.start()
    gate.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t0
    for c in clients:
        c.close()
    if errors or any(th.is_alive() for th in threads):
        raise Mismatch(f"wire storm failed: {errors}")
    return got, wall


#: the serve phase's statement pool: one worker, a 50 ms batch window, so
#: the worker collects a whole storm (8 Q6 or 4 Q1 connections) into one
#: same-digest round.  With the server's default of 4 workers each idle
#: worker dequeues a statement of the storm and leads a round of its own
#: (server/pool.py, _worker_loop / _form_group), so a storm splits: one
#: storm per stream also runs at the default pool size, and its rounds
#: and occupancy are printed beside the others
SERVE_POOL_SIZE = 1
SERVE_WINDOW_MS = 50
SERVE_STREAMS = (("Q6", 8, "masked_reduce_batched"),
                 ("Q1", 4, "segment_reduce_batched"))
#: (tidb_batch_stack_max, the host profilers) per storm: an unmeasured
#: first storm, then stacked / legacy / legacy / stacked with the
#: server's default host profilers on (tidb_memprof_rate = 1: tracemalloc;
#: tidb_conprof_rate = 10 Hz stack samples), and again with them off
SERVE_STORMS = ((16, "on"),) + tuple(
    (m, prof) for prof in ("on", "off") for m in (16, 0, 0, 16))


def set_profilers(admin, prof: str) -> None:
    """The server's host profilers on (their defaults) or off; waits until
    tracemalloc follows (the memprof sampler applies the rate on its
    next tick)."""
    import tracemalloc
    on = prof == "on"
    admin.query(f"set global tidb_memprof_rate = {1 if on else 0}")
    admin.query(f"set global tidb_conprof_rate = {10 if on else 0}")
    deadline = time.monotonic() + 10
    while tracemalloc.is_tracing() != on and time.monotonic() < deadline:
        time.sleep(0.05)


def checked_storm(K, port: int, name: str, sqls, solo,
                  on_card: bool) -> tuple:
    """One storm whose every member's row packets must equal its solo
    rows, with no plain version run and no stack fallback: (wall, the
    batching counters' change, the launches)."""
    from tinysql_tpu_torch.ops import batching
    K.reset_kernel_counts()
    st0 = batching.stats_snapshot()
    got, wall = storm(port, sqls)
    counts = K.kernel_counts()
    st1 = batching.stats_snapshot()
    for i, (g, want) in enumerate(zip(got, solo)):
        if g != want:
            raise Mismatch(f"serve {name} member {i}: wire rows "
                           f"{g[:2]} differ from solo {want[:2]}")
    if on_card and any(counts["plain_calls"].values()):
        raise Mismatch(f"serve {name}: plain versions ran: "
                       f"{counts['plain_calls']}")
    d = {k: st1[k] - st0[k] for k in st1}
    if d["stack_fallbacks"]:
        raise Mismatch(f"serve {name}: {d['stack_fallbacks']} "
                       "stack fallbacks")
    # (a rehearsal on the CPU counts the plain versions' calls)
    return wall, d, counts["launches" if on_card else "plain_calls"]


def phase_serve(K, storage, kinfo, device=None) -> dict:
    """The port's MySQL wire server on the card over phase 3's SF=1
    storage: a Q6 substitution stream (8 connections, TPC-H Clause
    2.4.6.3) and a Q1 stream (4 connections, DELTA per Clause 2.4.1.3,
    under tidb_devpipe = 0) sent concurrently.  Each stream warms its
    digest family with one solo statement over the wire and runs one
    unmeasured storm, then storms with tidb_batch_stack_max = 16, 0, 0,
    16 (stacked, legacy back-to-back, ...).  Every member's row packets
    must equal, byte for byte, its statement run solo in a Session on the
    card; a stacked storm must form a stacked round of occupancy >= 4,
    launch the batched HK7b and HK1b / HK2b once per stacked round, take
    the legacy leg for no group (stack_fallbacks 0); no plain version
    may run.  Launch counts are set to 0 before each storm and read after
    it.  Then one stacked storm per stream at the default pool size (its
    rounds and occupancy printed, not required)."""
    import math
    import numpy as np
    from tinysql_tpu_torch.bench import tpch
    from tinysql_tpu_torch.obs.stmtsummary import normalize
    from tinysql_tpu_torch.ops import batching
    from tinysql_tpu_torch.server import protocol
    from tinysql_tpu_torch.server.server import Server
    from tinysql_tpu_torch.session.session import DEFAULT_SYSVARS, Session
    t_start = time.perf_counter()
    srv = Server(storage, port=0, device=device)
    if device is None and srv.device.type != "cuda":
        raise Mismatch(f"Server() chose {srv.device}")
    srv.start()
    on_card = srv.device.type == "cuda"
    rng = np.random.default_rng(SEED)
    out = {}
    try:
        admin = WireClient(srv.port)
        for v in ("tidb_auto_prewarm = 0",
                  f"tidb_stmt_pool_size = {SERVE_POOL_SIZE}",
                  f"tidb_batch_window_ms = {SERVE_WINDOW_MS}"):
            admin.query(f"set global {v}")
        for name, width, red in SERVE_STREAMS:
            devpipe = 0 if name == "Q1" else -1
            admin.query(f"set global tidb_devpipe = {devpipe}")
            sqls = (tpch.q6_stream if name == "Q6" else tpch.q1_stream)(
                rng, width)
            c = WireClient(srv.port, "tpch")
            c.query(sqls[0])  # the family's one solo statement
            c.close()
            if not batching.family_batchable(normalize(sqls[0])[0]):
                raise Mismatch(f"serve {name}: digest family not batchable")
            sess = Session(storage)
            sess.device = srv.device
            sess.execute("use tpch")
            sess.execute(f"set tidb_devpipe = {devpipe}")
            solo = [[protocol.text_row(r) for r in sess.query(q).rows]
                    for q in sqls]
            walls = {}
            for stack_max, prof in SERVE_STORMS:
                set_profilers(admin, prof)
                admin.query(f"set global tidb_batch_stack_max = {stack_max}")
                wall, d, launches = checked_storm(K, srv.port, name, sqls,
                                                  solo, on_card)
                if "warm" not in walls:  # the unmeasured first storm
                    walls["warm"] = wall
                    continue
                rounds = d["stacked_rounds"]
                if stack_max >= 2:
                    if rounds < 1 or math.ceil(
                            d["stacked_occupancy_sum"] / rounds) < 4:
                        raise Mismatch(f"serve {name}: no stacked round of "
                                       f"occupancy >= 4: {d}")
                    for k in ("expr_eval_batched", red):
                        if launches[k] != rounds:
                            raise Mismatch(f"serve {name}: {k} launched "
                                           f"{launches[k]} times in "
                                           f"{rounds} stacked rounds")
                elif rounds or launches["expr_eval_batched"]:
                    raise Mismatch(f"serve {name}: a stacked round with "
                                   f"tidb_batch_stack_max = 0: {d}")
                for k, v in launches.items():
                    kinfo[k]["launches"] += v
                    by = kinfo[k].setdefault("launches_by_tier", {})
                    by["serve"] = by.get("serve", 0) + v
                walls.setdefault((stack_max, prof), []).append(wall)
                per_stmt = sum(launches.values()) / len(sqls)
                print(f"[serve] {name} x{len(sqls)} stack_max={stack_max} "
                      f"profilers {prof}: "
                      f"wall {wall:.4f} s, rounds {d['batches']} (stacked "
                      f"{rounds}, occupancy {d['stacked_occupancy_sum']}), "
                      f"{per_stmt:.2f} launches per statement "
                      f"{ {k: v for k, v in launches.items() if v} }",
                      flush=True)
            print(f"[serve] {name}: every member's wire rows equal its solo "
                  f"rows; storm walls (s) "
                  f"{ {f'{k[0]}/{k[1]}': v for k, v in walls.items() if k != 'warm'} }"
                  f", first storm {walls['warm']:.4f}", flush=True)
            # stacked, profilers off, at the default pool size
            pool_default = DEFAULT_SYSVARS["tidb_stmt_pool_size"]
            admin.query(f"set global tidb_stmt_pool_size = {pool_default}")
            wall, d, _ = checked_storm(K, srv.port, name, sqls, solo,
                                       on_card)
            admin.query(f"set global tidb_stmt_pool_size = {SERVE_POOL_SIZE}")
            pool4 = {"wall_s": wall, "stacked_rounds": d["stacked_rounds"],
                     "stacked_statements": d["stacked_statements"],
                     "alone": len(sqls) - d["stacked_statements"]}
            print(f"[serve] {name} x{len(sqls)} default pool size "
                  f"{pool_default}, window {SERVE_WINDOW_MS} ms: wall "
                  f"{wall:.4f} s, {d['stacked_rounds']} stacked rounds "
                  f"holding {d['stacked_statements']} statements (occupancy "
                  f"sum {d['stacked_occupancy_sum']}), {pool4['alone']} "
                  "statements outside a stacked round", flush=True)
            out[name] = {"walls": walls, "default_pool": pool4}
        set_profilers(admin, "on")
        admin.query("set global tidb_devpipe = -1")
        admin.close()
    finally:
        srv.close()
    print(f"[serve] phase {time.perf_counter() - t_start:.1f} s "
          f"(pool size {SERVE_POOL_SIZE}, window {SERVE_WINDOW_MS} ms)",
          flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tinysql_tpu_torch", "csrc")):
        print("chip_smoke: tinysql_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tinysql_tpu_torch.ops import _ext, kernels as K

    # phase 1
    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    _ext.build()
    for name in _ext.SOURCES:
        _ext.lib(name)
    print(f"[build] {len(_ext.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(_ext.NVCC_FLAGS)})", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())

    # phase 2
    with K.use_device(dev):
        rec = phase_kernels(K, dev)
    torch.cuda.synchronize()
    for name, r in rec.pop("offpath").items():
        print(f"[offpath] {name}: ms {r['ms']:.4f}, device "
              f"{r['device_ms']}, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} ms (bytes)", flush=True)
    kinfo = {}
    for name, r in rec.items():
        bound_s = max(r["bytes"] / MEM_BPS, r["ops"] / OPS_PS)
        by = "bytes" if r["bytes"] / MEM_BPS >= r["ops"] / OPS_PS \
            else "operations"
        src, repl = KERNELS[name]
        kinfo[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_s * 1e3,
            "bound_by": by, "library_ms": r["library_ms"],
            "device_ms": r["device_ms"]}
        extra = {k: v for k, v in r.items()
                 if k not in ("max_abs_err", "ms", "device_ms", "plain_ms",
                              "library_ms")}
        print(f"[kernel] {name}: ms {r['ms']:.4f}, device {r['device_ms']},"
              f" plain {r['plain_ms']:.4f},"
              f" library {r['library_ms']}, bound {bound_s * 1e3:.5f} ms "
              f"({by}), max_abs_err {r['max_abs_err']:.3g}, {extra}",
              flush=True)
    # phase 3
    storage = phase_main_path(K, kinfo)

    # the serve phase: the wire server over phase 3's storage
    phase_serve(K, storage, kinfo)
    for k, info in kinfo.items():
        if info["launches"] <= 0:
            raise Mismatch(f"kernel {k} never launched on its path")

    # phase 4
    print(json.dumps({"kernels": list(kinfo.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
