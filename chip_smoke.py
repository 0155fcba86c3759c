#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tinysql_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any mismatch raises, and the script exits nonzero without a
result line):

1. the card's name and power limit (nvidia-smi) and the build of the
   fourteen hand-written kernel sources (HK1-HK14; K12's batched entry
   points live in HK7's, HK1's and HK2's) from tinysql_tpu_torch/csrc;
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
   distance printed), then its tiles at their edges over 2^20 + 5
   NULL-heavy rows with n_rows < n (the program at its limits: 16 live
   registers and 64 instructions; nested sums split into launches of 16
   registers; a bool lane; HK7b at B = 1, 3 and 16 against solo
   launches; [expr] lines); HK8 (csr_expand) runs Q13's join (150,000
   customers LEFT JOIN 1.5M orders), HK9 (run_bounds) its two GROUP BYs
   and the tile edges of tinysql_tpu_torch/bench/compactcases.py (runs
   across tiles, a run at a tile's first position, all-invalid tiles,
   n = 1, one past a tile; NaN and +-0.0 float keys, NULLs, two lanes)
   against its plain version and the numpy tile model ([hk9] line);
   HK2's present-segment compaction at Q3's table beside
   table[:, table[0] > 0] (a partial call: no ids row, no padding) and
   at the edge tables of compactcases (0, 1, PRESENT_HEAD, PRESENT_HEAD
   + 1, most and all present, ns one past a tile: present_compact byte
   for byte against its plain version, present_rows and the per-operator
   extraction against numpy; [compact] line);
   HK6's composite mode a two-key probe of 2^21 rows; HK4 in each
   regime of the sort core (csrc/lex_sort.cuh: ties in 0..3 at 2^23,
   all keys equal at 2^20, n = 1,025 and 2^20 + 3, a float64 key with
   NaN, +-inf, -0.0 and +0.0 at 2^22 both ways, 10 lanes at 2^20, K21
   mesh's five lanes at 2^21; [sort] lines) and HK2's sort stage at
   Q3's shape beside torch.argsort(stable=True) of the same clamped
   ids (a partial call); K12's batched
   entry points (a stacked round's one launch for B members) byte for
   byte against B solo launches and their plain versions: HK7b
   (expr_eval_batched) and HK1b (masked_reduce_batched) at Q6's SF=1
   program for B = 2, 3 (the B = 4 launch with an inert padding row), 8
   and 16, HK2b (segment_reduce_batched) at Q1's 16 segments and at a
   2^21-segment sort regime for B = 4, each beside the time of B solo
   calls and a bound that counts the shared columns once, and at Q1's
   lanes for B = 1, 3, 16 and 17 over 2^20 + 5 rows; the few-segment
   regime shared by HK2, HK2b and HK5 (csrc/few_reduce.cuh) also at
   TPC-H Q1's 4 groups at their SF=1 frequencies (HK2 over 2^23 rows,
   HK5 over lineitem's ~6M through a group index), at ns = 1, 64 and 65
   (the sort regime) over a row count that is not a multiple of the
   tile, for HK5 at 64 and 65 groups and with an index whose order
   leaves rows out, beside index_add_ of the SUM lanes over the ids (a
   partial call); HK10
   (semi_pick, K8's ladder and compaction over HK3's membership) in the
   semi, anti and NOT IN modes at NOT IN's SF=1 shape (1.5M orders
   probing ~3M lineitem keys), with an empty build side, one NULL build
   key and NULL probe keys, byte for byte against its plain version,
   beside torch.nonzero over the same keep mask (a partial call), then at
   the tile edges of tinysql_tpu_torch/bench/probecases.py (n = 1, a
   tile - 1, a tile, a tile + 1, three tiles + 5; kept runs across the
   edges, none and all kept, PRESENT_HEAD and PRESENT_HEAD + 1 kept) in
   every mode against its plain version and the numpy tile model ([hk10]
   line); HK6 (dense_probe) at pipeline Q3's two joins, in every mode at
   the edges of probecases (probe counts around a thread's rows, lanes
   of 1, 2, 4 and 8 bytes, 17 lanes, keys at both ends of int64, the row
   path and records each forced) against its plain version and the contract
   in numpy ([hk6] line);
   HK1 as one launch also at n = 0, 1 and one past a block's range, and
   at Q6's shape bit-equal to the numpy model of its order
   (tinysql_tpu_torch/bench/hk1model.py), beside a masked torch.sum (a
   partial call); HK1b at B = 1, 3, 8 and 17 over 2^20 + 5 rows, each
   member byte-equal to its solo call; HK3's packed unique probe
   (equi_join_unique_packed: [count, li_0, ri_0, ...], no host pull)
   against the plain pairs, the device header's table kind on both sides
   of dense_ok (n_live 30,000 and 2^21), each case's pairs, membership
   and multiplicity mode against the plain versions, beside
   torch.searchsorted of the probe keys (a partial call); then a
   [pulls] line: the host syncs of one unique_join_match (inner and
   outer), join_match and semi_join_match call at Q3 join 1's shape
   (torch.cuda.set_sync_debug_mode, the uploads' own syncs left out)
   against the counted pulls (d2h_transfers), which must be equal and
   at most 2, 1, 2 and 2;
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
   it, and no plain version may run.  Two more warm runs of each query
   under torch.profiler (trace_tpch.device_trace: a pause at both ends
   of the trace; whole when every record came twice) count the CUDA
   kernels and copies a run launches and its device time, and say
   whether the trace was whole (a warm Q6, which runs the per-operator
   executors on both tiers, may launch at most six kernels);
   then the mesh phase: with TINYSQL_MESH_SHARDS=8 set in this process
   for the phase only, over phase 3's tables under tidb_mesh_parallel =
   1 (8 virtual shards on the card), on both tiers Q1, Q3, Q6, Q18, NOT
   IN, Q22, NOT EXISTS, a single-key ORDER BY over orders and its TopN
   (limit 10), and on the pipeline tier Q10 and Q13: rows equal to the
   same tier's mesh-off rows (floats within 1e-6 relative, same order),
   warm runs byte-equal to the first, shard counters, the mesh path's
   kernels launched as MESH_USES says in one run (HK11 shard_merge after
   HK2 / HK1 per shard for K11 and K25's scalar aggregate, HK12
   shard_probe after HK4 for K25's unique join, HK4 twice for K21 mesh,
   HK6 for the broadcast joins, HK13 shard_exchange for Q10's shuffle
   join, HK8's shard mode for Q13, HK12's member mode for K25 member
   under Q18, NOT IN, Q22 and NOT EXISTS, HK13's partition mode for
   every K25 join and member round, HK14 shard_rank after HK4 for
   K25 sort and top-k), no plain version; pipeline Q10 runs again under
   tidb_broadcast_build_max_rows = 0 only when the default budget does
   not shuffle it (the [mesh] line says which); [mesh] lines print mesh
   and mesh-off warm walls and device time; then K26's step
   (dist.distributed_query_step: lineitem's l_orderkey, 8 x 2^20 rows,
   probing the 1.5M sorted o_orderkey, l_extendedprice summed into 64
   buckets) against a numpy oracle; then every mesh kernel and mode
   against its plain version, byte for byte, on the tensors those runs
   handed it, timed beside its bound ([mesh-kernel] lines; partial
   calls printed as partial, torch.sort(stable=True) of the score lane
   as K25 sort's library call), and HK14 at the edge shapes of
   tinysql_tpu_torch/bench/rankcases.py (ties, all keys equal, 1 to 3
   runs, ragged tiles, k_out < n * run, stride > run);
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
#: sources whose kernels' registers, stack and spills (ptxas -v) the run
#: prints after the build
PTXAS_SOURCES = ("shard_exchange",)

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
    # the mesh tier: K11's and K25's psum / pmin / pmax, K25's
    # per-partition probe (the mesh phase's path)
    "shard_merge": ("tinysql_tpu_torch/csrc/shard_merge.cu",
                    "tinysql_tpu/ops/kernels.py:1474"),
    "shard_probe": ("tinysql_tpu_torch/csrc/shard_join.cu",
                    "tinysql_tpu/ops/shardops.py:271"),
    # the rest of the mesh tier: K25 member (HK12's member mode), K26's
    # broadcast join counts (its count mode), K18 mult on the mesh (HK8's
    # shard mode), K18 shuffle / K26's exchange (HK13), K25 sort and
    # top-k (HK14)
    "shard_member": ("tinysql_tpu_torch/csrc/shard_join.cu",
                     "tinysql_tpu/ops/shardops.py:380"),
    "shard_count": ("tinysql_tpu_torch/csrc/shard_join.cu",
                    "tinysql_tpu/parallel/dist.py:197"),
    "csr_expand_shard": ("tinysql_tpu_torch/csrc/csr_expand.cu",
                         "tinysql_tpu/executor/devpipe.py:1539"),
    "shard_exchange": ("tinysql_tpu_torch/csrc/shard_exchange.cu",
                       "tinysql_tpu/parallel/dist.py:270"),
    # HK13's partition mode: K25's host partition scatter (_Partitioned)
    "shard_partition": ("tinysql_tpu_torch/csrc/shard_exchange.cu",
                        "tinysql_tpu/ops/shardops.py:204"),
    "shard_rank": ("tinysql_tpu_torch/csrc/shard_rank.cu",
                   "tinysql_tpu/ops/shardops.py:618"),
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
#: warm repeats per query; the workload trio takes one on both tiers
#: (Q5's host joins take seconds a run at SF=1, and the script must stay
#: well inside its time limit)
WARM = 3
TRIO_WARM = 1
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
#: the mesh phase: virtual shards (TINYSQL_MESH_SHARDS, set for that
#: phase only), and per device tier the launches one mesh run of each
#: query must make of the mesh path's kernels ("at least" where a count
#: depends on the plan's other operators).  Q1 under the pipeline tier
#: is aggregate-only and goes to the per-operator tier's K11, as in the
#: reference; pipeline Q3 runs its two unique joins in the broadcast
#: mode (HK6) and its TopN as K21 mesh (HK4 twice)
MESH_SHARDS = 8
#: the single-key ORDER BY and TopN of the mesh phase (K25 sort, top-k)
MESH_SORTS = {"ORDER_BY": "select o_orderkey, o_totalprice from orders "
                          "order by o_totalprice desc",
              "TOPN": "select o_orderkey, o_totalprice from orders "
                      "order by o_totalprice desc limit 10"}
#: the queries of the mesh phase per tier: Q1, Q3, Q6, then the
#: shuffle join (Q10), the CSR join's mesh mode (Q13), K25 member (Q18's
#: IN subquery, NOT IN, Q22, NOT EXISTS) and K25 sort / top-k
MESH_QUERIES = {
    "pipeline": ("Q1", "Q3", "Q6", "Q10", "Q13", "Q18", "NOT_IN", "Q22",
                 "NOT_EXISTS", "ORDER_BY", "TOPN"),
    "per_op": ("Q1", "Q3", "Q6", "Q18", "NOT_IN", "Q22", "NOT_EXISTS",
               "ORDER_BY", "TOPN"),
}
MESH_USES = {
    "pipeline": {"Q1": {"segment_reduce": 8, "shard_merge": 1},
                 "Q3": {"dense_probe": 2, "lex_order": (2,),
                        "csr_reduce": 1},
                 "Q6": {"masked_reduce": 8, "shard_merge": 1},
                 "Q10": {},
                 "Q10_SHUFFLE": {"shard_exchange": (2,),
                                 "shard_probe": (1,)},
                 "Q13": {"csr_expand_shard": 1},
                 "Q18": {"shard_probe": (1,), "shard_partition": (4,)}},
    "per_op": {"Q1": {"segment_reduce": 8, "shard_merge": 1},
               "Q3": {"shard_probe": 2, "lex_order": (3,),
                      "segment_reduce": 8, "shard_merge": 1,
                      "shard_partition": 8},
               "Q6": {"masked_reduce": 8, "shard_merge": 1},
               "Q18": {"shard_member": (1,), "shard_partition": (4,)}},
}
# a K25 join or member round: HK13's count call and scatter call for
# each side (shard_partition counts both)
for _tier in MESH_USES:
    for _q in ("NOT_IN", "Q22", "NOT_EXISTS"):
        MESH_USES[_tier][_q] = {"shard_member": (1,),
                                "shard_partition": (4,)}
    for _q in MESH_SORTS:
        MESH_USES[_tier][_q] = {"shard_rank": (1,)}
MESH_KINDS = {"Q3": {"leaf", "join", "aggindex", "order_mesh"}}
#: warm repeats of Q1, Q3 and Q6 under the mesh, and of the others (whose
#: runs take seconds: NOT IN's build side, 1.5M sorted rows to the host)
MESH_WARM = 3
MESH_WARM_NEW = 1
#: K26's step at 8 x 2^20 rows: lineitem's l_orderkey probing the sorted
#: o_orderkey, l_extendedprice summed into 64 buckets of l_orderkey
K26_ROWS = 1 << 23
K26_BUCKETS = 64


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


def device_of(fn, reps: int = 10, tries: int = 3) -> dict:
    """Device-only time of one call of fn: the self device time of every
    kernel, copy and memset it enqueues, from a whole torch.profiler trace
    of reps calls (trace_tpch.device_trace), and that time and the
    launches of one call by kernel name ({name: [device ms, launches]}).
    Unlike cuda_ms it leaves out the host work between the launches.  None
    and {} when none of ``tries`` traces was whole."""
    from tinysql_tpu_torch.bench.trace_tpch import device_trace
    fn()
    evts, _wall, whole = device_trace(fn, reps, tries=tries)
    if not whole:
        return {"device_ms": None, "by_kernel": {}}
    return {"device_ms": sum(us for _k, us, _c in evts) / 1e3,
            "by_kernel": {k[:48]: [round(us / 1e3, 5), c]
                          for k, us, c in evts}}


def device_ms(fn, reps: int = 10, tries: int = 3) -> float | None:
    return device_of(fn, reps, tries)["device_ms"]


def timed(fn, tries: int = 3) -> dict:
    """The kernel's median CUDA-event time (host work between its launches
    included) and device_of's device time and launches by kernel name."""
    return {"ms": cuda_ms(fn), **device_of(fn, tries=tries)}


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

#: TPC-H Q1's groups (l_returnflag, l_linestatus) at SF=1, as the
#: query's answer counts them: A|F, N|F, N|O, R|F
Q1_GROUPS = (1_478_493, 38_854, 2_920_374, 1_478_870)


def partial_sum_lanes(gid, valid, lanes):
    """One PyTorch call beside a few-segment reduction: index_add_ of the
    stacked float SUM lanes over the live rows' group ids (a partial
    call: the sums only, not the table).  valid [n] or [B, n] with the
    lanes' values [B, n]: member b's ids offset by b * ns."""
    import torch
    sums = [v for v, _m, op in lanes if op == "sum"]
    vals = torch.stack(sums, dim=-1)  # [n, k] or [B, n, k]
    ns = int(gid.max()) + 1
    if valid.dim() == 2:
        ids = (gid[None, :] + ns * torch.arange(
            valid.shape[0], device=gid.device)[:, None])[valid]
    else:
        ids = gid[valid]
    live = vals[valid]
    rows = ns * (valid.shape[0] if valid.dim() == 2 else 1)

    def call():
        return torch.zeros((rows, vals.shape[-1]), dtype=vals.dtype,
                           device=vals.device).index_add_(0, ids, live)
    return call


def few_segment_cases(K, t, rng, hk2_case, gid1, valid1, q1) -> dict:
    """HK2's few-segment regime (csrc/few_reduce.cuh) beyond the uniform
    Q1 case: the device time at Q1's shape, TPC-H Q1's 4 groups at their
    SF=1 frequencies, ns = 1 and both sides of kSmallSeg (64: the last
    few-segment width, 65: the sort regime) over a row count that is not
    a multiple of the 4,096-row tile, each held to the plain version and
    to a second launch, beside the partial index_add_ call."""
    import numpy as np
    import torch
    n = int(valid1.shape[0])
    p = np.array(Q1_GROUPS) / sum(Q1_GROUPS)
    gid4 = t(rng.choice(4, n, p=p).astype(np.int64))
    hk2_case(gid4, valid1, 16, q1, "segment_reduce Q1 4 groups")
    out = {"q1_device_ms": device_ms(lambda: K.segment_reduce(
               gid1, valid1, 16, q1)),
           "q1_partial_index_add_ms": cuda_ms(partial_sum_lanes(
               gid1, valid1, q1)),
           "q1_4groups_ms": cuda_ms(lambda: K.segment_reduce(
               gid4, valid1, 16, q1)),
           "q1_4groups_device_ms": device_ms(lambda: K.segment_reduce(
               gid4, valid1, 16, q1)),
           "q1_4groups_partial_index_add_ms": cuda_ms(partial_sum_lanes(
               gid4, valid1, q1))}
    m = 3 * 4096 * 64 + 5  # ~786K rows, not a multiple of the tile
    lm = [(None if v is None else v[:m], x[:m], op) for v, x, op in q1]
    for ns in (1, 64, 65):
        gid = t(rng.integers(0, ns, m), torch.int64)
        hk2_case(gid, valid1[:m], ns, lm, f"segment_reduce n={m} ns={ns}")
        out[f"ns{ns}_n{m}_ms"] = cuda_ms(lambda: K.segment_reduce(
            gid, valid1[:m], ns, lm))
    return out


def few_group_cases(K, t, rng, hk5_case, hk5_bytes, index_of, rows,
                    valid, q1l) -> dict:
    """HK5's few-group route (a row -> group map, then the few-segment
    body in row order): TPC-H Q1's 4 groups over lineitem's rows, ng on
    both sides of kSmallSeg, and a 4-group index whose order leaves a
    tenth of the rows out (they belong to no group), each held to the
    plain version and to a second launch."""
    import numpy as np
    nb = int(valid.shape[0])
    p = np.array(Q1_GROUPS) / sum(Q1_GROUPS)
    key = rng.choice(4, rows, p=p)
    order4, ends4, ng4 = index_of(key, nb)
    hk5_case(order4, ends4, valid, q1l, rows, ng4, "csr_reduce Q1 4 groups")
    gid4 = t(K.pad1(key.astype(np.int64), nb, fill=4))
    out = {"q1_4groups_ms": cuda_ms(lambda: K.csr_reduce(
               order4, ends4, valid, q1l, rows, ng4)),
           "q1_4groups_device_ms": device_ms(lambda: K.csr_reduce(
               order4, ends4, valid, q1l, rows, ng4)),
           "q1_4groups_bound_ms": hk5_bytes(q1l, rows, ng4,
                                            int(ends4.shape[0]))
           / MEM_BPS * 1e3,
           "q1_4groups_partial_index_add_ms": cuda_ms(partial_sum_lanes(
               gid4[:rows], valid[:rows],
               [(v[:rows], m, op) for v, m, op in q1l if op == "sum"]))}
    m = 3 * 4096 * 64 + 5
    lm = [(None if v is None else v[:m], x[:m], op) for v, x, op in q1l]
    for ng in (64, 65):
        order, ends, got = index_of(rng.integers(0, ng, m), m)
        hk5_case(order, ends, valid[:m], lm, m, got, f"csr_reduce ng={got}")
        out[f"ng{got}_n{m}_ms"] = cuda_ms(lambda: K.csr_reduce(
            order, ends, valid[:m], lm, m, got))
    keep = np.sort(rng.choice(m, m - m // 10, replace=False))
    kk = rng.integers(0, 4, m)
    order = np.argsort(kk, kind="stable")
    order = order[np.isin(order, keep)]
    sk = kk[order]
    ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0]
    hk5_case(t(K.pad1(order.astype(np.int64), m)),
             t(K.pad1(ends.astype(np.int64), 16, fill=len(order) - 1)),
             valid[:m], lm, m, len(ends), "csr_reduce rows left out")
    return out



def _host_lanes(lanes):
    return [(None if v is None else v.cpu().numpy(),
             None if m is None else m.cpu().numpy(), op)
            for v, m, op in lanes]


def compact_edge_cases(K, t) -> dict:
    """HK2's one-pass compaction at the edge tables of
    bench/compactcases.py (0, 1, PRESENT_HEAD, PRESENT_HEAD + 1, most and
    all segments present, ns one past a tile): present_compact byte for
    byte against its plain version and against a second launch, the
    present columns the host pulls (present_rows, the per-operator
    extraction's) against numpy."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.bench import compactcases as CC
    for case in CC.COMPACT_CASES:
        tab = CC.compact_table(case)
        ns = tab.shape[1]
        td = t(tab, torch.int64)
        a, b = K.present_compact(td, ns), K.present_compact(td, ns)
        p = K.present_compact_plain(td, ns)
        what = f"present_compact {case}"
        if not a[0] == b[0] == p[0]:
            raise Mismatch(f"{what}: count {a[0]} / {b[0]} vs {p[0]}")
        same_bytes(a[1], b[1], what)
        if not torch.equal(a[1], p[1]):
            raise Mismatch(f"{what}: differs from the plain version")
        if not np.array_equal(K.present_rows(td, ns),
                              CC.compact_plain(tab, 1, False)):
            raise Mismatch(f"present_rows {case}: differs from numpy")
        if not np.array_equal(K._pull_present(td, ns, 0, True),
                              CC.compact_plain(tab)):
            raise Mismatch(f"present extraction {case}: differs")
    print(f"[compact] {len(CC.COMPACT_CASES)} edge tables equal to the "
          f"plain version", flush=True)
    return {"edge_cases": len(CC.COMPACT_CASES)}


def hk9_edge_cases(K, t, hk9_case) -> int:
    """HK9 at the tile edges of bench/compactcases.py (runs across tiles,
    a run at a tile's first position, all-invalid tiles, n = 1, one past a
    tile, NaN and +-0.0 float keys, NULLs, two lanes): equal to its plain
    version and to the numpy tile model, two launches byte-equal."""
    import numpy as np
    from tinysql_tpu_torch.bench import compactcases as CC
    for case in CC.HK9_CASES:
        perm, valid, keys = CC.hk9_case(case)
        tk = [(t(v), t(m)) for v, m in keys]
        count = hk9_case(t(perm), t(valid), tk, f"run_bounds {case}")
        model = CC.hk9_model(perm, valid, keys)
        got = K.run_bounds(t(perm), t(valid), tk, want_gid=True)
        if count != model[0] or not all(
                np.array_equal(x.cpu().numpy(), m)
                for x, m in zip(got[1:], model[1:])):
            raise Mismatch(f"run_bounds {case}: differs from the tile model")
    print(f"[hk9] {len(CC.HK9_CASES)} edge cases equal to the plain "
          f"version and the tile model", flush=True)
    return len(CC.HK9_CASES)


def hk10_edge_cases(K, t) -> int:
    """HK10 at the tile edges of bench/probecases.py (n = 1, a tile - 1, a
    tile, a tile + 1, three tiles + 5; kept runs across the edges, a tile
    keeping nothing or everything, PRESENT_HEAD and PRESENT_HEAD + 1
    kept), in every mode, with the build side as drawn, empty and with
    one NULL key: the count and kept rows equal to the plain version's
    and to the numpy tile model's, two launches byte-equal."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.bench import probecases as PC
    n = 0
    for case in PC.HK10_CASES:
        match, ln, lv, rn, rv = PC.hk10_case(case)
        seven = np.arange(len(rn)) == 7
        probe = [t(a) for a in (match, ln, lv)]
        for bn, bv in ((rn, rv), (rn[:0], rv[:0]), (rn | seven, rv | seven)):
            for mode, (anti, na) in PC.SEMI_MODES.items():
                what = f"semi_pick {case} {mode} build {len(bv)}"
                a = K.semi_pick(*probe, t(bn), t(bv), anti, na)
                b = K.semi_pick(*probe, t(bn), t(bv), anti, na)
                p = K.semi_pick_plain(*probe, t(bn), t(bv), anti, na)
                k = int(a[0])
                same_bytes(a[:1 + k], b[:1 + k], what)
                if k != int(p[0]) or not torch.equal(a[:1 + k], p[:1 + k]):
                    raise Mismatch(f"{what}: differs from the plain version")
                count, rows = PC.hk10_model(match, ln, lv, bn, bv, anti, na)
                if k != count or not np.array_equal(
                        a[1:1 + k].cpu().numpy(), rows):
                    raise Mismatch(f"{what}: differs from the tile model")
                n += 1
    print(f"[hk10] {n} edge cases (tile {PC.SP_TILE}) equal to the plain "
          f"version and the tile model", flush=True)
    return n


def hk6_edge_cases(K, t) -> int:
    """HK6 at probe counts around a thread's rows (bench/probecases.py),
    with 5 lanes of 1, 2, 4, 8 and 1 bytes and with 17 (two launches),
    probe keys at both ends of int64, NULL and outside the table's range,
    in every mode, on the row path and on records (each forced): the
    valid mask and
    every gathered byte (unmatched slots included) equal to the plain
    version's and to the contract in numpy."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.bench import probecases as PC
    n = 0
    for kind in PC.RECORD_KINDS:
        with PC.records(K, kind):
            for nb in PC.DP_SIZES:
                for lanes in (5, 17):
                    for lo in (-50, K.I64_MAX - 299, K.I64_MIN):
                        args = PC.hk6_case(nb, lanes, lo)
                        kp, kn, pv, lo_, hi, tb, bv, bl = args
                        targs = (t(kp), t(kn), t(pv), lo_, hi, t(tb), t(bv),
                                 [(t(v), None if m is None else t(m))
                                  for v, m in bl])
                        for mode in ("inner", "left", "semi", "anti"):
                            what = (f"dense_probe nb={nb} {lanes} lanes "
                                    f"lo={lo} {mode} {kind}")
                            a = K.dense_probe(*targs, mode)
                            p = K.dense_probe_plain(*targs, mode)
                            want = PC.hk6_plain(*args, mode)
                            ok = torch.equal(a[0], p[0]) and np.array_equal(
                                a[0].cpu().numpy(), want[0])
                            for (x, xn), (y, yn), (wv, wm) in zip(
                                    a[1], p[1], want[1]):
                                ok = ok and torch.equal(
                                    x.view(torch.uint8), y.view(torch.uint8))
                                ok = ok and torch.equal(xn, yn)
                                ok = ok and np.array_equal(
                                    x.cpu().numpy(), wv) and np.array_equal(
                                    xn.cpu().numpy(), wm)
                            if not ok or len(a[1]) != len(want[1]):
                                raise Mismatch(f"{what}: differs")
                            n += 1
    print(f"[hk6] {n} edge cases ({PC.DP_ROWS} rows a thread) equal to "
          f"the plain version and the contract", flush=True)
    return n


def hk1_one_launch_cases(K, t, valid, q6, hk1_case) -> dict:
    """HK1 as one launch: n = 0, 1 and one past a block's range
    (4,097 rows) against the plain version and a second launch; at Q6's
    shape bit-equal to the numpy model of its order (bench/hk1model.py);
    beside it a masked torch.sum of the lane (a partial call: the sum
    only, no counts or first row)."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.bench import hk1model as M
    rng = np.random.default_rng(SEED + 12)
    for nn in (0, 1, 4097):
        lanes = [(t(np.round(rng.uniform(900.0, 105000.0, nn), 2)),
                  t(rng.random(nn) < 0.2), "sum"),
                 (t(rng.integers(-9, 9, nn), torch.int64), None, "max"),
                 (None, None, "count")]
        hk1_case(nn, lanes, t(rng.random(nn) < 0.6), f"masked_reduce n={nn}")
    got = K.masked_reduce(valid, q6).cpu().numpy()
    want = M.masked_reduce(valid.cpu().numpy(), _host_lanes(q6))
    if got.tobytes() != want.tobytes():
        raise Mismatch("masked_reduce Q6: not the model's order of work")
    x = q6[0][0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"model_bit_equal": True,
            "partial_masked_sum_ms": cuda_ms(
                lambda: torch.where(valid, x, zero).sum())}


def hk3_unique_cases(K, t, join1, hk3_case) -> dict:
    """HK3's unique probe without host pulls: the packed buffer
    against the plain pairs and a second launch at Q3 join 1; the
    header's table kind on both sides of dense_ok (live keys spanning
    card = max(2^22, 4 * n_live), dense, or one more, hash) at n_live =
    30,000 and 2^21, each case's pairs, membership and multiplicity mode
    against the plain versions; beside them torch.searchsorted of the
    probe keys into the sorted live build keys (a partial call: the probe
    only, the build sorted for it) and equi_join_unique, which adds the
    count's pull to the packed call."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 13)
    lk, z_l, lv, rk, z_r, rv = join1
    a = K.equi_join_unique_packed(*join1)
    n = int(a[0])  # words past 1 + 2 * n are not written
    same_bytes(a[:1 + 2 * n], K.equi_join_unique_packed(*join1)[:1 + 2 * n],
               "equi_join packed")
    li, ri = K.equi_join_unique_plain(*join1)
    if n != li.numel() or not torch.equal(a[1:1 + 2 * n:2], li) \
            or not torch.equal(a[2:2 + 2 * n:2], ri):
        raise Mismatch("equi_join packed: pairs differ from the plain ones")
    kinds = {}
    for n_live in (30_000, 1 << 21):
        for above in (0, 1):
            card = max(1 << 22, 4 * n_live) + above
            bk = rng.choice(card, n_live, replace=False).astype(np.int64)
            bk[:2] = [0, card - 1]
            pk = rng.integers(-5, card + 5, 1 << 20).astype(np.int64)
            pk[:n_live // 2] = rng.choice(bk, n_live // 2)
            args = (t(pk), t(np.zeros(1 << 20, bool)),
                    t(rng.random(1 << 20) < 0.9), t(bk),
                    t(np.zeros(n_live, bool)), t(np.ones(n_live, bool)))
            hdr = K.equi_join_header(*args[3:])[:5].tolist()
            if hdr[3] != int(K.dense_ok(card, n_live)) or \
                    hdr[3] != 1 - above or hdr[:3] != [n_live, 0, card - 1]:
                raise Mismatch(f"equi_join header {hdr} at card {card}, "
                               f"n_live {n_live}")
            what = f"equi_join n_live={n_live} card={card}"
            for outer in (False, True):
                hk3_case(*args, outer, what)
                hk3_case(*args, outer, what + " mult", mult=True)
            if not torch.equal(K.unique_match(*args),
                               K._unique_probe_plain(*args)[0]):
                raise Mismatch(what + ": membership differs")
            kinds[f"n_live{n_live}_card{card}"] = "dense" if hdr[3] \
                else "hash"
    live = rv & ~z_r
    sk = torch.sort(rk[live]).values
    return {"table_kinds": kinds,
            "device_ms_unique_with_count_pull": device_ms(
                lambda: K.equi_join_unique(*join1)),
            "unique_with_count_pull_ms": cuda_ms(
                lambda: K.equi_join_unique(*join1)),
            "partial_searchsorted_ms": cuda_ms(
                lambda: torch.searchsorted(sk, lk))}


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
    rec["masked_reduce"].update(hk1_one_launch_cases(K, t, valid, q6,
                                                     hk1_case))

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
    few2 = few_segment_cases(K, t, rng, hk2_case, gid1, valid1, q1)
    ns3 = 1 << 21
    gid3 = t(np.concatenate([np.repeat(np.arange(1_500_000), 4),
                             np.zeros(n - 6_000_000, np.int64)]),
             torch.int64)
    valid3 = t(np.concatenate([rng.random(6_000_000) < 0.54,
                               np.zeros(n - 6_000_000, bool)]))
    q3 = [(rnd_f(n), t(np.zeros(n, bool)), "sum")]
    err = hk2_case(gid3, valid3, ns3, q3, "segment_reduce Q3")
    # the sort stage alone: the sort core over HK2's clamped ids (HK4's
    # wrapper), beside one PyTorch call that sorts the same ids (a partial
    # call: the stage, not HK2's function)
    keys3 = torch.where((gid3 < 0) | (gid3 >= ns3),
                        torch.full_like(gid3, ns3), gid3)
    if not torch.equal(K.lex_order([keys3], n),
                       torch.argsort(keys3, stable=True)):
        raise Mismatch("segment_reduce Q3 sort stage: differs from argsort")
    sort_stage = {
        "sort_stage_ms": cuda_ms(lambda: K.lex_order([keys3], n), reps=5),
        "sort_stage_bound_ms": 16 * n / MEM_BPS * 1e3,
        "sort_stage_partial_argsort_ms": cuda_ms(
            lambda: torch.argsort(keys3, stable=True), reps=5)}
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
        "q1_bound_ms": reduce_bytes(valid1, q1, (2 + 2 * len(q1)) * 16,
                                    gid=True) / MEM_BPS * 1e3,
        **few2,
        "sum_lane_only_scatter_reduce_ms": cuda_ms(lambda: torch.zeros(
            ns3 + 1, dtype=torch.float64, device=dev).scatter_reduce_(
                0, g_all, x3, "sum")),
        "skew90_ms": cuda_ms(lambda: K.segment_reduce(
            gid_sk, valid_sk, ns3, q3)),
        "skew90_plain_ms": cuda_ms(lambda: K.segment_reduce_plain(
            gid_sk, valid_sk, ns3, q3)),
        **sort_stage}
    # present-segment compaction of the Q3 table (~1.43M of 2^21 present):
    # the presence row read once, the other rows at the present ids, the
    # bucket [1 + rows, ob] written once
    tab3 = K.segment_reduce(gid3, valid3, ns3, q3)
    np3, _ = K.present_compact(tab3, ns3)
    ob3 = min(K.bucket(max(np3, 1)), ns3)
    rows3 = int(tab3.shape[0])
    head3 = tab3.clone()
    head3[0, torch.nonzero(head3[0] > 0)[K.PRESENT_HEAD:, 0]] = 0
    rec["present_compact"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.present_compact(tab3, ns3)),
        "plain_ms": cuda_ms(lambda: K.present_compact_plain(tab3, ns3)),
        "library_ms": None,
        "bytes": 8 * ns3 + 8 * (rows3 - 1) * np3 + 8 * (1 + rows3) * ob3,
        "ops": ns3,
        "shape": f"2^21 segments, {np3} present, {rows3} rows (Q3)",
        "partial_mask_select_ms": cuda_ms(lambda: tab3[:, tab3[0] > 0]),
        "present_rows_head_ms": cuda_ms(lambda: K.present_rows(head3, ns3)),
        **compact_edge_cases(K, t)}
    del head3
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
    # the packed call is what unique_join_match launches (no host pull)
    rec["equi_join"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.equi_join_unique_packed(lk, z_l, lv, rk, z_r,
                                                  rv)),
        "plain_ms": cuda_ms(lambda: K.equi_join_unique_plain(
            lk, z_l, lv, rk, z_r, rv)),
        "library_ms": None,
        "bytes": nl * 10 + nr * 10 + n_out * 16, "ops": nl + nr,
        "shape": f"probe 2^20, build 2^15, {n_out} pairs (Q3 join 1)",
        **hk3_unique_cases(K, t, (lk, z_l, lv, rk, z_r, rv), hk3_case)}
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
    v8 = t(rng.integers(0, 1 << 62, n), torch.int64)
    key8 = K.sort_lanes([(v8, t(np.zeros(n, bool)))], [False],
                        t(np.ones(n, bool)))
    hk4_case(key8, n, None, "lex_order full sort 2^23")
    # one NULL-free int64 key, all rows valid: HK4 over its order lane
    # computes what torch.argsort(stable=True) does (the K9 / K21 mesh /
    # K25 build-sort yardstick)
    if not torch.equal(K.lex_order([key8[1]], n),
                       torch.argsort(v8, stable=True)):
        raise Mismatch("lex_order one key 2^23: differs from argsort")
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
            key8[1], stable=True), reps=3, warm=1),
        "one_key_2e23_ms": cuda_ms(lambda: K.lex_order([key8[1]], n),
                                   reps=3, warm=1),
        "one_key_2e23_library_argsort_ms": cuda_ms(
            lambda: torch.argsort(v8, stable=True), reps=3, warm=1)}
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
    # a partial call: the top 16 of one of its lanes (no tie rule)
    rec["lex_order"]["pipe_q3_partial_topk_ms"] = cuda_ms(
        lambda: torch.topk(lanes_p3[1], 16, largest=False))
    rec["lex_order"]["sort_cases"] = sort_core_cases(K, dev, hk4_case)

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
    few5 = few_group_cases(K, t, rng, hk5_case, hk5_bytes, index_of, rows3,
                           valid1q, q1l)
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
        **few5,
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
    edges6 = hk6_edge_cases(K, t)
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
        "edge_cases": edges6,
        "join1_record_words": K._probe_plan(
            np1, nbb1, int(tbl1.shape[0]), bl1)[1][0],
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
    edges = hk10_edge_cases(K, t)
    anti, na = SEMI_MODES["not in"]
    keep = lv & ~ln & ~match  # the NOT IN keep mask of this input
    return {
        "max_abs_err": 0.0,
        "edge_cases": edges,
        # late in phase 2, three traces of its memset and two kernels in
        # a row have come back with records lost on an H100
        **timed(lambda: K.semi_pick(match, ln, lv, rn, rv, anti, na),
                tries=8),
        "plain_ms": cuda_ms(lambda: K.semi_pick_plain(match, ln, lv, rn,
                                                      rv, anti, na)),
        "library_ms": None,
        "nonzero_ms": cuda_ms(lambda: torch.nonzero(keep)),
        "bytes": hk10_bytes(lv, rv, got["not in"]), "ops": nl + nr,
        "shape": f"probe 2^21 ({n_ord} valid), build 2^22 ({len(bk)} "
                 f"valid), NOT IN keeps {got['not in']}"}


# -- HK8 csr_expand, HK9 run_bounds, HK6's composite mode: Q13's shapes -----

def hk8_bytes(args, ob: int, total: int, plns, blns, shards: int = 1) -> int:
    """Bytes HK8 must move on this data: the build's order and validity
    over its rows, its group ends, the probe validity over its bucket,
    then the keys, one table entry and each probe lane over the valid
    probe rows, each build lane over the build rows, the bucket's valid
    flags over all shards * ob slots and the gathered lanes over the
    ``total`` live ones."""
    (_order, _ends, ng, n_rows, _bv, _tbl, _lo, _hi, keys, _spec,
     pvalid) = args
    nbp, nvp = int(pvalid.shape[0]), int(pvalid.sum())
    out = sum(v.element_size() + 1 for v, _m in plns + blns)
    return (n_rows * 9 + 8 * ng + nbp + nvp * 4 + _lane_bytes(keys, nvp)
            + _lane_bytes(plns, nvp) + _lane_bytes(blns, n_rows)
            + ob * shards + total * out)


def hk8_edge_cases(K, t) -> dict:
    """HK8 at the edges of bench/meshjoincases.py (a probe row over
    several fill tiles, unmatched rows on tile edges, no pairs, a full
    bucket, LEFT with absent keys, a fill tile staging its rows twice, a
    shard without pairs, groups ending on build tile edges; inner, LEFT
    and shard mode): byte for byte against its plain version, a second
    launch and the numpy model of its passes, each timed beside its bound
    with its launches by kernel name ([hk8-edge] lines)."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.bench import meshjoincases as MJ
    out = {}
    for case in MJ.CSR_CASES:
        (order, ends, ng, n_rows, bvalid, tbl, lo, hi, key, knull, pv,
         outer, ob, plns, blns, shards) = MJ.csr_case(case)
        args = (t(order), t(ends), ng, n_rows, t(bvalid), t(tbl), lo, hi,
                [(t(key), t(knull))], None, t(pv))
        pl = [(t(v), None if m is None else t(m)) for v, m in plns]
        bl = [(t(v), None if m is None else t(m)) for v, m in blns]

        def fn():
            return K.csr_expand(*args, outer, ob, pl, bl, shards=shards)
        what = f"csr_expand edge {case}"
        a, b = fn(), fn()
        p = K.csr_expand_plain(*args, outer, ob, pl, bl, shards=shards)
        valid, prow, brow, matched, _chunked = MJ.csr_model(
            order, ends, ng, n_rows, bvalid, tbl, lo, hi, key, ~knull, pv,
            outer, ob, shards)
        m = MJ.gather_model(valid, prow, brow, matched, plns, blns)
        def flat(x):
            return [u.cpu() if isinstance(u, torch.Tensor)
                    else torch.as_tensor(np.asarray(u))
                    for u in [x[0]] + [w for pr in x[1] + x[2] for w in pr]]
        for x, what2 in ((b, f"{what} (two runs)"), (p, f"{what} vs plain"),
                         (m, f"{what} vs the model")):
            for y, z in zip(flat(a), flat(x)):
                if y.shape != z.shape or not torch.equal(
                        y.contiguous().view(torch.uint8),
                        z.contiguous().view(torch.uint8)):
                    raise Mismatch(f"{what2}: differs")
        total = int(a[0].sum())
        r = {"max_abs_err": 0.0, **timed(fn),
             "bytes": hk8_bytes(args, ob, total, pl, bl, shards),
             "ops": total,
             "shape": f"{shards} shard(s), probe {len(pv)}, build "
                      f"{len(order)} ({n_rows} rows, {ng} groups), ob {ob}"
                      f" a shard, {total} slots, outer={outer}"}
        print(f"[hk8-edge] {case}: {_bounded(r)}", flush=True)
        out[case] = {k: r[k] for k in ("ms", "device_ms")}
    return out



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
        "edge_cases": hk8_edge_cases(K, t),
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

    def hk9_bytes(n, n_valid, keys):
        """perm and validity read at every position, the key lanes (value
        and NULL flag) over the valid rows; the count, and lead and ends
        at every position (past the count too: 0 and the last end, which
        the pipeline reads) written once."""
        return n * (8 + 1) + _lane_bytes(keys, n_valid) + 16 * n + 8

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
    edges9 = hk9_edge_cases(K, t, hk9_case)
    rec["run_bounds"] = {
        "max_abs_err": 0.0,
        **timed(lambda: K.run_bounds(perm9, valid9, k9)),
        "plain_ms": cuda_ms(lambda: K.run_bounds_plain(perm9, valid9, k9)),
        "library_ms": None,
        "bytes": hk9_bytes(n9, n_o, k9), "ops": n9, "edge_cases": edges9,
        "shape": f"2^21 sorted rows ({n_o} valid), 1 int64 key, {runs9} "
                 f"runs (Q13 GROUP BY c_custkey); c_count: {runsc} runs",
        "c_count_ms": cuda_ms(lambda: K.run_bounds(permc, validc, kc)),
        "c_count_device_ms": device_ms(
            lambda: K.run_bounds(permc, validc, kc)),
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
    edges = hk7_edge_cases(K, t, rng)
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
        * 1e3,
        "edge_cases": edges}, q6x


def hk7_edge_cases(K, t, rng) -> dict:
    """HK7's tiles at their edges, n = 2^20 + 5 rows (not a multiple of a
    tile) with n_rows = n - 1029 (the guard rows) and an incoming mask,
    over NULL-heavy columns (90% NULL): the program at the kernel's
    limits (16 live registers and 64 instructions in one launch), nested
    sums that compile_program splits into several launches of 16
    registers, a bool lane read as the mask and as K15's live lane, and
    HK7b at B = 1, 3 and 16 against B solo launches.  Each byte for byte
    against its plain version and a second launch, timed beside its
    bound ([expr] lines)."""
    import numpy as np
    from tinysql_tpu_torch.bench import exprcases as EC
    from tinysql_tpu_torch.ops import exprjit as X
    n = (1 << 20) + 5
    n_rows = n - 1029
    vals, _ = EC.columns(SEED, n)
    cols = [(t(v), t(rng.random(n) < 0.9)) for v in vals]
    keep = t(rng.random(n) < 0.7)
    kw = {"n_rows": n_rows, "mask_in": keep}
    cases = {}
    for name in ("regs16", "nest20", "nest30_real"):
        spec = EC.LIMIT_CASES.get(name) or EC.SPLIT_CASES[name]
        e = EC.build(spec)
        pt = X.ParamTable()
        conds = [] if name in EC.LIMIT_CASES else [e]
        prog = X.compile_program(conds, [e, ("null", e)], pt)
        segs = [(sg.n_regs, int(sg.code.shape[0])) for sg in prog.segments()]
        if name in EC.LIMIT_CASES and segs != [(X.MAX_REGS, X.MAX_PROG)]:
            raise Mismatch(f"expr_eval {name}: segments {segs}, want one "
                           "of 16 registers and 64 instructions")
        cases[name] = (prog, cols, pt, segs)
    live = t(rng.random(n) < 0.6)
    ids = t(rng.integers(0, 7 * 14 + 1, n).astype(np.int64))
    pt = X.ParamTable()
    prog = X.ExprProgram()
    prog.cond(prog.load(0, "b"))
    prog.store(prog.key_decode(prog.load(1, "i"), prog.load(0, "b"), 14, 6,
                               -3, pt))
    cases["bool lane"] = (prog, [(live, t(rng.random(n) < 0.5)), (ids, None)],
                          pt, [(sg.n_regs, int(sg.code.shape[0]))
                               for sg in prog.segments()])
    out = {}
    for name, (prog, pc, pt, segs) in cases.items():
        pr = K._params_dev(pt.arrays())
        hk7_case(K, prog, pc, pr, n, f"expr_eval edge {name}", **kw)
        r = {**timed(lambda: K.expr_eval(prog, pc, pr, n, **kw)),
             "bound_ms": expr_bytes(prog, pc, n_rows) / MEM_BPS * 1e3,
             "segments": segs}
        print(f"[expr] expr_eval edge {name}: {r}", flush=True)
        out[name] = r
    prog, pc, pt, _segs = cases["regs16"]
    pi, pf = pt.arrays()
    for nmem in (1, 3, 16):
        prs = K._params_dev(EC.stacked_params(pi, pf, nmem))
        what = f"expr_eval_batched edge regs16 B={nmem}"
        got = K.expr_eval_batched(prog, pc, prs, n, **kw)
        same_expr(got, K.expr_eval_batched(prog, pc, prs, n, **kw),
                  f"{what} (two runs)")
        same_expr(got, K.expr_eval_batched_plain(prog, pc, prs, n, **kw),
                  f"{what} vs plain")
        for b in range(nmem):
            same_expr(_member_expr(got, b),
                      K.expr_eval(prog, pc, (prs[0][b], prs[1][b]), n, **kw),
                      f"{what} member {b} vs solo")
        r = {**timed(lambda: K.expr_eval_batched(prog, pc, prs, n, **kw)),
             "solo_ms": cuda_ms(lambda: [K.expr_eval(
                 prog, pc, (prs[0][b], prs[1][b]), n, **kw)
                 for b in range(nmem)], reps=5),
             "bound_ms": expr_bytes_batched(prog, pc, n_rows, nmem,
                                            len(pi) + len(pf))
             / MEM_BPS * 1e3}
        print(f"[expr] {what}: {r}", flush=True)
        out[f"batched B={nmem}"] = r
    return out


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
    # HK1b as one launch: B = 1, 3, 8, 17 members over 2^20 + 5
    # rows (member b's mask starts at any byte), each row byte-equal to a
    # solo call and agreeing with the plain version, and a second launch
    rb = np.random.default_rng(SEED + 14)
    m = (1 << 20) + 5
    for members in (1, 3, 8, 17):
        vb = t(rb.random((members, m)) < 0.02)
        lb = [(t(np.round(rb.uniform(900.0, 105000.0, (members, m)), 2)),
               t(np.zeros(m, bool)), "sum")]
        r1 = K.masked_reduce_batched(vb, lb)
        what = f"masked_reduce_batched B={members} n={m}"
        same_bytes(r1, K.masked_reduce_batched(vb, lb), what)
        check_table(r1.T.contiguous(), K.masked_reduce_batched_plain(
            vb, lb).T.contiguous(), {2}, what)
        for i in range(members):
            same_bytes(r1[i], K.masked_reduce(vb[i], K._member_lanes(lb, i)),
                       f"{what} member {i} vs solo")
        out["masked_reduce_batched"][f"b{members}_n{m}_ms"] = cuda_ms(
            lambda: K.masked_reduce_batched(vb, lb), reps=5)
        del vb, lb, r1

    # HK2b: Q1's shape (16 segments, 6 used, 10 lanes) and the sort regime
    def per_member_f(nmem):
        return t(np.round(rng.uniform(900.0, 105000.0, (nmem, n)), 2))

    def hk2b_case(gid, valid, ns, lanes, what):
        nmem = int(valid.shape[0])
        k1 = K.segment_reduce_batched(gid, valid, ns, lanes)
        same_bytes(k1, K.segment_reduce_batched(gid, valid, ns, lanes),
                   what)
        p = K.segment_reduce_batched_plain(
            gid, valid, ns, K._norm_lanes(lanes, int(valid.shape[1]), dev,
                                          what, nmem))
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
            for i in range(nmem)], reps=5),
        "partial_index_add_ms": cuda_ms(partial_sum_lanes(gid1, valid1,
                                                          q1), reps=5)}
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
    del q3, valid3
    torch.cuda.empty_cache()
    # the members run inside a tile's block, kFMem (16) valid masks at a
    # time: B = 1, 3, 16 and 17 over a row count that is not a multiple of
    # the tile, each member byte-equal to its solo launch
    m = (1 << 20) + 5
    gidm = gid1[:m].contiguous()
    for members in (1, 3, 16, 17):
        validm = t(rng.random((members, m)) < 0.98)
        lm = [(None if j in (5, 7, 9) else
               t(np.round(rng.uniform(900.0, 105000.0, (members, m)), 2)),
               t(np.zeros(m, bool)), "count" if j in (5, 7, 9) else "sum")
              for j in range(10)]
        hk2b_case(gidm, validm, 16, lm,
                  f"segment_reduce_batched Q1 B={members} n={m}")
        out["segment_reduce_batched"][f"b{members}_n{m}_ms"] = cuda_ms(
            lambda: K.segment_reduce_batched(gidm, validm, 16, lm), reps=5)
        del validm, lm
    torch.cuda.empty_cache()
    return out


def sort_core_cases(K, dev, hk4_case) -> dict:
    """HK4 in the sort core's regimes (csrc/lex_sort.cuh) at the main
    path's sizes: heavy ties across tiles, all keys equal, sizes just past
    a tile and past the radix crossover, float specials both ways, more
    than eight lanes, K21 mesh's five lanes.  Each case is byte-equal to
    the plain version and to a second launch, and is timed beside its
    bound (the lanes read once, the permutation written once)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 9)
    i64 = torch.int64

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    def one_key(v, n, desc=False):
        return K.sort_lanes([(v, t(np.zeros(n, bool)))], [desc],
                            t(np.ones(n, bool)))
    cases = {}
    n23, n20, n21, n22 = 1 << 23, 1 << 20, 1 << 21, 1 << 22
    cases["ties 0..3, n=2^23"] = (
        one_key(t(rng.integers(0, 4, n23), i64), n23), n23)
    cases["all keys equal, n=2^20"] = (
        one_key(t(np.full(n20, 42), i64), n20), n20)
    for nn in (1025, n20 + 3):
        cases[f"random 64-bit, n={nn}"] = (
            [t(rng.integers(-(1 << 63), (1 << 63) - 1, nn, endpoint=True),
               i64)], nn)
    f = t(np.round(rng.uniform(-1e6, 1e6, n22), 2))
    at = t(rng.integers(0, n22, 4096), i64)
    f[at] = t(rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0], 4096))
    for desc in (False, True):
        cases[f"f64 NaN/inf/-0.0, n=2^22, {'desc' if desc else 'asc'}"] = (
            one_key(f, n22, desc), n22)
    five = [(t(rng.integers(0, 3, n20), i64), t(rng.random(n20) < 0.1))
            for _ in range(5)]
    cases["10 lanes, n=2^20"] = (
        K.sort_lanes(five, [False, True, False, True, False],
                     t(np.ones(n20, bool))), n20)
    valid = t(rng.random(n21) < 0.7)
    q3 = K.sort_lanes(
        [(t(np.round(rng.uniform(1e3, 5e5, n21), 2)), t(np.zeros(n21, bool))),
         (t(rng.integers(0, 2406, n21), i64), t(np.zeros(n21, bool)))],
        [True, False], valid)
    cases["K21 mesh: shard + Q3's two keys, 5 lanes, n=2^21"] = (
        [K.shard_lane(MESH_SHARDS, n21 // MESH_SHARDS)] + q3, n21)
    out = {}
    for what, (lanes, nn) in cases.items():
        hk4_case(lanes, nn, None, f"lex_order {what}")
        r = {"ms": cuda_ms(lambda: K.lex_order(lanes, nn), reps=5, warm=1),
             "bound_ms": (8 * len(lanes) * nn + 8 * nn) / MEM_BPS * 1e3}
        print(f"[sort] lex_order {what}: {r}", flush=True)
        out[what] = r
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


def pull_counts(K) -> dict:
    """Host syncs per call of the per-operator joins at Q3 join 1's shape
    (orders probe customer: 2^20 probe rows, 2^15 build rows): every
    synchronizing CUDA call, seen by torch.cuda.set_sync_debug_mode
    ("warn"), less those inside the inputs' uploads (kernels.h2d),
    against the counted pulls (STATS["d2h_transfers"]).
    An uncounted sync fails the run, as does a count above the one the
    call should make: unique_join_match 2 (inner, more pairs than
    PRESENT_HEAD) or 1 (outer), join_match 2, semi_join_match 1 or 2."""
    import warnings
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    nl, nr = 1 << 20, 1 << 15
    lk = rng.integers(1, 150_001, nl).astype(np.int64)
    lv = (np.arange(nl) < 1_500_000) & (rng.random(nl) < 0.486)
    rk = (np.arange(1, nr + 1) * 5).astype(np.int64)
    rv = rng.random(nr) < 0.91
    zl, zr = np.zeros(nl, bool), np.zeros(nr, bool)
    calls = {
        "unique_join_match": (lambda: K.unique_join_match(
            (lk, zl), nl, (rk, zr), nr, lvalid=lv, rvalid=rv), 2),
        "unique_join_match_outer": (lambda: K.unique_join_match(
            (lk, zl), nl, (rk, zr), nr, outer=True, lvalid=lv,
            rvalid=rv), 1),
        "join_match": (lambda: K.join_match(
            (lk, zl), nl, (rk, zr), nr, lvalid=lv, rvalid=rv), 2),
        "semi_join_match": (lambda: K.semi_join_match(
            (lk, zl), nl, (rk, zr), nr, anti=True, null_aware=True,
            lvalid=lv, rvalid=rv), 2),
    }
    up = {"syncs": 0}
    h2d = K.h2d
    out = {}
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")

            def counted_h2d(a, _h2d=h2d):
                before = len(seen)
                r = _h2d(a)
                up["syncs"] += len(seen) - before
                return r
            K.h2d = counted_h2d
            for name, (fn, want) in calls.items():
                for rep in range(2):  # the first run's may be one-off
                    torch.cuda.synchronize()
                    up["syncs"] = 0
                    before = K.stats_snapshot()["d2h_transfers"]
                    del seen[:]
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        res = fn()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                syncs = sum("synchroniz" in str(w.message) for w in seen) \
                    - up["syncs"]
                d2h = K.stats_snapshot()["d2h_transfers"] - before
                rows = len(res[0]) if isinstance(res, tuple) else len(res)
                out[name] = {"syncs": syncs, "d2h": d2h, "rows": rows}
                if syncs != d2h or d2h > want:
                    raise Mismatch(f"{name}: {syncs} syncs, {d2h} counted "
                                   f"pulls (at most {want})")
    finally:
        K.h2d = h2d
    print(f"[pulls] {json.dumps(out)}", flush=True)
    return out


# ---- phase 3 -------------------------------------------------------------

def _sync(torch) -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def warm_profile(sess, sql: str) -> dict:
    """Two more warm runs under torch.profiler (trace_tpch.device_trace):
    the CUDA kernels and the copies / memsets one run launched, their
    device time, and whether the trace was whole (every record came
    twice; one that is not lost records and reads low); None each when
    the trace held no device record."""
    from tinysql_tpu_torch.bench.trace_tpch import device_trace
    evts, _wall, whole = device_trace(lambda: sess.query(sql))
    if not evts:
        return {"kernels": None, "copies": None, "device_ms": None,
                "whole": False}
    copies = sum(c for k, _us, c in evts
                 if k.startswith(("Memcpy", "Memset")))
    return {"kernels": sum(c for _k, _us, c in evts) - copies,
            "copies": copies,
            "device_ms": sum(us for _k, us, _c in evts) / 1e3,
            "whole": whole}


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
        reps = TRIO_WARM if q in tpch.WORKLOAD else WARM
        warm = []
        for _ in range(reps):
            t1 = time.perf_counter()
            again = sess.query(sql).rows
            _sync(torch)
            warm.append(time.perf_counter() - t1)
            if tpch.canon_rows(again) != tpch.canon_rows(rows[q]):
                raise Mismatch(f"{tier} {q}: warm run rows differ from "
                               f"the first")
        prof = warm_profile(sess, sql)
        after = K.kernel_counts()["launches"]
        used = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        for k in USES[tier][q]:
            if k not in used:
                raise Mismatch(f"{tier} {q}: kernel {k} was not launched")
        print(f"[main] {tier} {q}: {len(rows[q])} rows, first run "
              f"{first_s:.4f} s, warm best of {reps} {min(warm):.4f} s, "
              f"one warm run: {prof['kernels']} CUDA kernels + "
              f"{prof['copies']} copies, device {prof['device_ms']} ms "
              f"(trace whole: {prof['whole']}); "
              f"node kinds {sorted(kinds)}, {d2h} D2H, launches {used}",
              flush=True)
        # Q6 runs the per-operator executors on both tiers (no join, no
        # grouped aggregate); the bound is held wherever a trace has
        # device records
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
            if k not in kinfo:  # the mesh kernels: the mesh phase's
                if v:
                    raise Mismatch(f"{tier}: {k} launched {v} times "
                                   f"without a mesh")
                continue
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
        # the batched entry points launch on the serve phase's path, the
        # mesh kernels on the mesh phase's
        if info["launches"] <= 0 and not k.endswith("_batched") \
                and k not in K.MESH_LAUNCHES:
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


# ---- the mesh phase -------------------------------------------------------

def count_regimes(K) -> dict:
    """HK2's and HK2b's card launches split by regime (the few-segment
    regime up to kSmallSeg segments, the sort regime past it), counted
    from here on: each wrapper is wrapped by a counter (a launch per 16
    lanes, as LAUNCHES counts them)."""
    import re
    import threading
    src = open(os.path.join(ROOT, "tinysql_tpu_torch", "csrc",
                            "few_reduce.cuh")).read()
    small = int(re.search(r"constexpr int kSmallSeg = (\d+);", src).group(1))
    tally = {name: {"few": 0, "sort": 0}
             for name in ("segment_reduce", "segment_reduce_batched")}
    mu = threading.Lock()
    for name in tally:
        def counted(gid, valid, ns, lanes, *a, _fn=getattr(K, name),
                    _name=name, **kw):
            if valid.device.type == "cuda":
                with mu:
                    tally[_name]["few" if ns <= small else "sort"] += \
                        max(1, -(-len(lanes) // K._MAX_LANES))
            return _fn(gid, valid, ns, lanes, *a, **kw)
        setattr(K, name, counted)
    return tally


def kernel_entry(name: str, r: dict) -> dict:
    """The kernels JSON line's entry for one kernel record (launches 0:
    the main path's run adds them)."""
    bound_s = max(r["bytes"] / MEM_BPS, r["ops"] / OPS_PS)
    by = "bytes" if r["bytes"] / MEM_BPS >= r["ops"] / OPS_PS \
        else "operations"
    src, repl = KERNELS[name]
    extra = {k: v for k, v in r.items()
             if k not in ("max_abs_err", "ms", "device_ms", "plain_ms",
                          "library_ms")}
    print(f"[kernel] {name}: ms {r['ms']:.4f}, device {r['device_ms']},"
          f" plain {r['plain_ms']:.4f},"
          f" library {r['library_ms']}, bound {bound_s * 1e3:.5f} ms "
          f"({by}), max_abs_err {r['max_abs_err']:.3g}, {extra}",
          flush=True)
    return {"name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_s * 1e3,
            "bound_by": by, "library_ms": r["library_ms"],
            "device_ms": r["device_ms"]}


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] > before[k]}


def _check_mesh_uses(tier: str, q: str, used: dict) -> None:
    for k, want in MESH_USES[tier][q].items():
        got = used.get(k, 0)
        if (got < want[0]) if isinstance(want, tuple) else (got != want):
            raise Mismatch(f"mesh {tier} {q}: {k} launched {got} times in "
                           f"one run, want {want}")


def _same_lanes(a, b, what: str) -> None:
    import torch
    if len(a) != len(b):
        raise Mismatch(f"{what}: {len(a)} vs {len(b)} lanes")
    for x, y in zip(a, b):
        if x.shape != y.shape or not torch.equal(
                x.contiguous().view(torch.uint8),
                y.contiguous().view(torch.uint8)):
            raise Mismatch(f"{what}: a lane differs")


def _keep_largest(best: dict, name: str, size: int, r: dict) -> None:
    if size > best.get(name, (-1,))[0]:
        best[name] = (size, r)


def _bounded(r: dict) -> dict:
    """A [mesh-kernel] record with its bound (ms) beside its times."""
    return {**r, "bound_ms": max(r["bytes"] / MEM_BPS,
                                 r["ops"] / OPS_PS) * 1e3}


def rank_ops(n: int, run: int) -> int:
    """HK14's compares: one an element in each of its ceil(log2 n)
    merge rounds."""
    return n * run * (n - 1).bit_length()


def rank_edge_cases(K) -> dict:
    """HK14 at the edge shapes of tinysql_tpu_torch/bench/rankcases.py
    (keys tied in 0..3, all equal, n = 1, 2 and 3 runs, a run length that
    is not a multiple of the tile, k_out < n * run, stride > run, the
    top-k's layout, 2^18 keys across the sign bit): each byte for byte
    against its plain version and a second launch, timed beside its
    bound."""
    import torch
    from tinysql_tpu_torch.bench import rankcases as RC
    dev = K.device()
    out = {}
    for name in RC.CASES:
        keys, ids, stride, run, n, k_out = RC.case(name, SEED)
        keys = torch.as_tensor(keys).to(dev)
        ids = torch.as_tensor(ids).to(dev)
        what = f"shard_rank edge {name}"
        k1 = K.shard_rank(keys, ids, stride, run, n, k_out)
        same_bytes(k1, K.shard_rank(keys, ids, stride, run, n, k_out), what)
        same_bytes(k1, K.shard_rank_plain(keys, ids, stride, run, n, k_out),
                   f"{what} vs plain")
        r = {**timed(lambda: K.shard_rank(keys, ids, stride, run, n,
                                          k_out)),
             # n = 1 copies the first k_out ids and reads no key
             "bytes": 16 * k_out if n == 1 else n * run * 16 + k_out * 8,
             "ops": rank_ops(n, run),
             "shape": f"{n} runs of {run}, stride {stride}, {k_out} out"}
        print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
        out[name] = {k: r[k] for k in ("ms", "device_ms")}
    return out


def hk12_bytes(npb: int, nbb: int, member: bool, hits: int) -> int:
    """Bytes HK12's probe and member modes must move: each probe slot's
    key and id read and its hit flag written (and brow, probe mode), the
    build run's order keys and permutation read once, and bid read at the
    hit slots, each once (probe mode; member mode needs it only for a key
    at the sentinel, not counted)."""
    if member:
        return npb * (8 + 8 + 1) + nbb * 16
    return npb * (8 + 8 + 1 + 8) + nbb * 16 + min(hits, nbb) * 8


def shard_edge_cases(K) -> dict:
    """HK12 at the edges of bench/meshjoincases.py: its staged search (the
    whole run and sampled runs, an index at its cap, equal keys across
    sample points, a shard without a live slot, int64 ends, -0.0 / +0.0 /
    +inf, NaN keys, padding slots) in probe and member modes, and its
    count mode's gallop (absent keys, one key over 10^5 slots, a run
    inside the index, an empty run): each byte for byte against its plain
    version, a second launch and the numpy model, timed beside its bound
    with its launches by kernel name ([mesh-kernel] lines)."""
    import torch
    from tinysql_tpu_torch.bench import meshjoincases as MJ
    from tinysql_tpu_torch.ops import shardops
    dev = K.device()
    out = {"shard_probe": {}, "shard_member": {}, "shard_count": {}}

    def check(got, want, what):
        for x, y in zip(got, want):
            y = torch.as_tensor(y).to(x.device)
            if x.shape != y.shape or not torch.equal(x, y.to(x.dtype)):
                raise Mismatch(f"{what}: differs")
    for case in MJ.PROBE_CASES:
        n, pk, pid, bk, bid = MJ.probe_case(case)
        tp = [torch.as_tensor(x).to(dev) for x in (pk, pid, bk, bid)]
        bord, perm = shardops._build_order(n, tp[2], tp[3])
        model = {m: MJ.staged_probe_model(pk, pid, bord.cpu().numpy(), bid,
                                          perm.cpu().numpy(), n, m)
                 for m in (False, True)}
        npb, nbb = len(pk), len(bk)
        for member in (False, True):
            mode = "shard_member" if member else "shard_probe"
            what = f"{mode} edge {case}"

            def fn():
                return K.shard_probe(tp[0], tp[1], bord, tp[3], perm, n,
                                     member=member)

            def flat(x):
                return [x] if member else list(x)
            a = flat(fn())
            check(a, flat(fn()), f"{what} (two runs)")
            check(a, flat(K.shard_probe_plain(tp[0], tp[1], bord, tp[3],
                                              perm, n, member)),
                  f"{what} vs plain")
            check(a, flat(model[member]), f"{what} vs the model")
            hits = int(a[0].sum())
            r = {"max_abs_err": 0.0, **timed(fn),
                 "bytes": hk12_bytes(npb, nbb, member, hits),
                 "ops": npb * max(1, (nbb // n - 1).bit_length()),
                 "hits": hits,
                 "shape": f"{n} shards, probe {npb} (cap {npb // n}), "
                          f"build {nbb} (cap {nbb // n}), {pk.dtype}, "
                          f"stride {MJ.index_stride(nbb // n, npb // n, n)}"}
            print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
            out[mode][case] = {k: r[k] for k in ("ms", "device_ms")}
    for case in MJ.COUNT_CASES:
        n, lk, lv, rs = MJ.count_case(case)
        tl = [torch.as_tensor(x).to(dev) for x in (lk, lv, rs)]
        what = f"shard_count edge {case}"

        def fn():
            return K.shard_count(tl[0], tl[1], tl[2], n)
        a = list(fn())
        check(a, list(fn()), f"{what} (two runs)")
        check(a, list(K.shard_count_plain(tl[0], tl[1], tl[2], n)),
              f"{what} vs plain")
        counts, partial, _loads = MJ.gallop_count_model(lk, lv, rs, n)
        check(a, [counts, partial], f"{what} vs the model")
        nl, nr = len(lk), len(rs)
        r = {"max_abs_err": 0.0, **timed(fn),
             "bytes": nl * 17 + nr * 8 + n * 8,
             "ops": nl * 2 * max(1, (nr - 1).bit_length()),
             "matches": int(a[0].sum()),
             "shape": f"{n} shards x {nl // n} probe rows, {nr} sorted "
                      f"build keys"}
        print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
        out["shard_count"][case] = {k: r[k] for k in ("ms", "device_ms")}
    return out


def mesh_kernel_checks(K, cap: dict) -> dict:
    """The mesh kernels on the tensors the mesh run handed them (captured
    at their calls, per query): each byte for byte against its plain
    version and a second launch, timed beside its bound.  The record of
    each is its largest call; every call prints a [mesh-kernel] line, and
    so do K21 mesh's two HK4 calls of pipeline Q3 (the shard-led order of
    every row, then the merge of the candidates), against HK4's plain
    version."""
    import torch
    best = {}
    for j, (lanes, n, k) in enumerate(cap["sorts"]):
        a = K.lex_order(lanes, n, k)
        same_bytes(a, K.lex_order(lanes, n, k), f"K21 mesh sort {j + 1}")
        want = n if k is None else min(k, n)
        same_bytes(a, K.lex_order_plain(lanes, n)[:want],
                   f"K21 mesh sort {j + 1} vs plain")
        r = {**timed(lambda: K.lex_order(lanes, n, k)),
             "plain_ms": cuda_ms(lambda: K.lex_order_plain(lanes, n)),
             "bound_ms": (8 * len(lanes) * n + 8 * want) / MEM_BPS * 1e3,
             "shape": f"{len(lanes)} lanes, n={n}, k={k}"}
        print(f"[mesh-kernel] lex_order K21 mesh sort {j + 1}: {r}",
              flush=True)
    for label, (parts, ops, m, nb) in cap["merges"].items():
        k1 = K.shard_merge(parts, ops, m, nb)
        same_bytes(k1, K.shard_merge(parts, ops, m, nb),
                   f"shard_merge {label}")
        same_bytes(k1, K.shard_merge_plain(parts, ops, m, nb),
                   f"shard_merge {label} vs plain")
        n, rows, width = (int(x) for x in parts.shape)
        r = {"max_abs_err": 0.0,
             **timed(lambda: K.shard_merge(parts, ops, m, nb)),
             "plain_ms": cuda_ms(lambda: K.shard_merge_plain(
                 parts, ops, m, nb), reps=3, warm=1),
             "library_ms": None,
             "partial_int64_sum_dim0_ms": cuda_ms(
                 lambda: torch.sum(parts, dim=0)),
             "bytes": 8 * (n + 1) * rows * width, "ops": n * rows * width,
             "shape": f"{n} shards x {rows} rows x {width} ({label})"}
        print(f"[mesh-kernel] shard_merge {label}: {_bounded(r)}",
              flush=True)
        _keep_largest(best, "shard_merge", parts.numel(), r)
    for mode, calls in (("shard_probe", cap["probes"]),
                        ("shard_member", cap["members"])):
        member = mode == "shard_member"
        for label, per in calls.items():
            for j, (n, pk, pid, bk, bid) in enumerate(per):
                from tinysql_tpu_torch.ops import shardops
                bord, perm = shardops._build_order(n, bk, bid)
                nbb, npb = int(bk.shape[0]), int(pk.shape[0])
                what = f"{mode} {label} join {j + 1}"

                def probe():
                    return K.shard_probe(pk, pid, bord, bid, perm, n,
                                         member=member)

                def as_list(x):
                    x = [x] if member else list(x)
                    return [x[0].to(torch.int64)] + x[1:]
                k1 = as_list(probe())
                same_bytes(k1, as_list(probe()), what)
                same_bytes(k1, as_list(K.shard_probe_plain(
                    pk, pid, bord, bid, perm, n, member)), f"{what} vs "
                    f"plain")
                run = perm.reshape(n, nbb // n)
                sk = (bord ^ K.I64_MIN)[run]
                pv = K._probe_order(pk).reshape(n, npb // n).contiguous()
                steps = max(1, (nbb // n - 1).bit_length())
                hits = int(k1[0].sum())
                r = {"max_abs_err": 0.0, **timed(probe),
                     "plain_ms": cuda_ms(lambda: K.shard_probe_plain(
                         pk, pid, bord, bid, perm, n, member)),
                     "library_ms": None,
                     "partial_batched_searchsorted_ms": cuda_ms(
                         lambda: torch.searchsorted(sk, pv)),
                     "bytes": hk12_bytes(npb, nbb, member, hits),
                     "ops": npb * steps,
                     "hits": hits,
                     "shape": f"{n} shards, probe {npb} slots (cap "
                              f"{npb // n}), build {nbb} (cap {nbb // n}),"
                              f" {pk.dtype} keys ({label} join {j + 1})"}
                if member:
                    live = bk[bid >= 0]
                    r["partial_isin_live_keys_ms"] = cuda_ms(
                        lambda: torch.isin(pk, live))
                print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
                _keep_largest(best, mode, npb, r)
    for label, per in cap["exchanges"].items():
        for j, (keys, n_rows, lanes, c, n) in enumerate(per):
            what = f"shard_exchange {label} side {j + 1}"
            k1 = K.shard_exchange(keys, n_rows, lanes, c, n)
            _same_lanes(k1, K.shard_exchange(keys, n_rows, lanes, c, n),
                        what)
            _same_lanes(k1, K.shard_exchange_plain(keys, n_rows, lanes, c,
                                                   n), f"{what} vs plain")
            nb = int(keys.shape[0])
            width = sum(v.element_size() for v, _ in lanes)
            r = {"max_abs_err": 0.0,
                 **timed(lambda: K.shard_exchange(keys, n_rows, lanes, c,
                                                  n)),
                 "plain_ms": cuda_ms(lambda: K.shard_exchange_plain(
                     keys, n_rows, lanes, c, n), reps=3, warm=1),
                 "library_ms": None,
                 "bytes": nb * (8 + width) + n * n * c * width,
                 "ops": nb,
                 "shape": f"{n} shards, {nb} rows ({n_rows} live), cap "
                          f"{c}, {len(lanes)} lanes of {width} B a row "
                          f"({label} side {j + 1})"}
            print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
            _keep_largest(best, "shard_exchange", nb * len(lanes), r)
    for label, per in cap["partitions"].items():
        for j, (keys, live, n, c) in enumerate(per):
            what = f"shard_partition {label} side {j + 1}"

            def partition():
                return K.shard_partition_scatter(
                    K.shard_partition(keys, live, n), c)
            part = K.shard_partition(keys, live, n)
            plain = K.shard_partition_plain(keys, live, n)
            same_bytes(part.counts, plain.counts, f"{what} counts vs plain")
            k1 = K.shard_partition_scatter(part, c)
            _same_lanes(k1, partition(), what)
            _same_lanes(k1, K.shard_partition_scatter_plain(plain, c),
                        f"{what} vs plain")
            n_in = int(keys.shape[0])
            r = {"max_abs_err": 0.0, **timed(partition),
                 "plain_ms": cuda_ms(lambda: K.shard_partition_scatter_plain(
                     K.shard_partition_plain(keys, live, n), c), reps=3,
                     warm=1),
                 "library_ms": None,
                 "bytes": n_in * (8 + 1) + n * c * 16,
                 "ops": n_in,
                 "shape": f"{n} shards, {n_in} rows ({int(live.sum())} "
                          f"live), {keys.dtype} keys, cap {c} ({label} "
                          f"side {j + 1}: the count and scatter calls)"}
            print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
            _keep_largest(best, "shard_partition", n_in, r)
    for label, per in cap["ranks"].items():
        for j, (ordl, ids, stride, run, n, k_out) in enumerate(per):
            what = f"shard_rank {label} call {j + 1}"
            k1 = K.shard_rank(ordl, ids, stride, run, n, k_out)
            same_bytes(k1, K.shard_rank(ordl, ids, stride, run, n, k_out),
                       what)
            same_bytes(k1, K.shard_rank_plain(ordl, ids, stride, run, n,
                                              k_out), f"{what} vs plain")
            total = n * run
            r = {"max_abs_err": 0.0,
                 **timed(lambda: K.shard_rank(ordl, ids, stride, run, n,
                                              k_out)),
                 "plain_ms": cuda_ms(lambda: K.shard_rank_plain(
                     ordl, ids, stride, run, n, k_out), reps=3, warm=1),
                 "library_ms": None,
                 "bytes": total * 16 + k_out * 8,
                 "ops": rank_ops(n, run),
                 "shape": f"{n} runs of {run}, {k_out} out ({label})"}
            if k_out == total:  # K25 sort: the whole route and one sort
                r["route_ms"] = cuda_ms(lambda: K.shard_rank(
                    ordl, K.lex_order([K.shard_lane(n, run), ordl],
                                      total), run, run, n, total))
                r["library_ms"] = cuda_ms(
                    lambda: torch.sort(ordl ^ K.I64_MIN, stable=True))
            else:  # K25 top-k: ties are not lowest-index there
                r["partial_topk_ms"] = cuda_ms(lambda: torch.topk(
                    ordl ^ K.I64_MIN, k_out, largest=False))
            print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
            _keep_largest(best, "shard_rank", total, r)
    best["shard_rank"][1]["edge_cases"] = rank_edge_cases(K)
    for label, (a, kw) in cap["expands"].items():
        what = f"csr_expand_shard {label}"
        k1 = K.csr_expand(*a, **kw)
        k2 = K.csr_expand(*a, **kw)
        p1 = K.csr_expand_plain(*a, **kw)
        for x, what2 in ((k2, what), (p1, f"{what} vs plain")):
            same_bytes(k1[0], x[0], what2)
            _same_lanes([v for pr in k1[1] + k1[2] for v in pr],
                        [v for pr in x[1] + x[2] for v in pr], what2)
        order, pvalid, ob, plns, blns = a[0], a[10], a[12], a[13], a[14]
        nbp = int(pvalid.shape[0])
        total = int(k1[0].sum())
        r = {"max_abs_err": 0.0,
             **timed(lambda: K.csr_expand(*a, **kw)),
             "plain_ms": cuda_ms(lambda: K.csr_expand_plain(*a, **kw),
                                 reps=3, warm=1),
             "library_ms": None,
             "bytes": hk8_bytes(a[:11], ob, total, plns, blns,
                                kw["shards"]),
             "ops": total,
             "shape": f"{kw['shards']} shards, probe {nbp}, build "
                      f"{int(order.shape[0])}, ob {ob} a shard, {total} "
                      f"pairs ({label})"}
        print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
        _keep_largest(best, "csr_expand_shard", nbp, r)
    counts, rkeys = cap["count"]
    lk, lv = counts
    what = "shard_count K26"
    k1 = K.shard_count(lk, lv, rkeys, MESH_SHARDS)
    same_bytes(list(k1), list(K.shard_count(lk, lv, rkeys, MESH_SHARDS)),
               what)
    same_bytes(list(k1), list(K.shard_count_plain(lk, lv, rkeys,
                                                  MESH_SHARDS)),
               f"{what} vs plain")
    nl, nr = int(lk.shape[0]), int(rkeys.shape[0])
    r = {"max_abs_err": 0.0,
         **timed(lambda: K.shard_count(lk, lv, rkeys, MESH_SHARDS)),
         "plain_ms": cuda_ms(lambda: K.shard_count_plain(
             lk, lv, rkeys, MESH_SHARDS)),
         "library_ms": None,
         "partial_two_searchsorted_ms": cuda_ms(lambda: (
             torch.searchsorted(rkeys, lk),
             torch.searchsorted(rkeys, lk, right=True))),
         "bytes": nl * 17 + nr * 8 + MESH_SHARDS * 8,
         "ops": nl * 2 * max(1, (nr - 1).bit_length()),
         "shape": f"{MESH_SHARDS} shards x {nl // MESH_SHARDS} probe rows, "
                  f"{nr} sorted build keys (K26 step)"}
    print(f"[mesh-kernel] {what}: {_bounded(r)}", flush=True)
    best["shard_count"] = (nl, r)
    for mode, edges in shard_edge_cases(K).items():
        best[mode][1]["edge_cases"] = edges
    rec = {}
    for name in K.MESH_LAUNCHES:
        if name not in best:
            raise Mismatch(f"the mesh run never called {name}")
        rec[name] = best[name][1]
    return rec


def _mesh_sql(q: str) -> str:
    from tinysql_tpu_torch.bench import tpch
    if q == "Q13":
        return tpch.Q13
    for table in (tpch.QUERIES, tpch.WORKLOAD, tpch.K8_QUERIES, MESH_SORTS):
        if q in table:
            return table[q]
    raise KeyError(q)


def _warm_runs(sess, sql: str, reps: int, torch, first=None) -> tuple:
    """``reps`` warm runs: their best wall, each one's rows byte-equal
    (by repr) to ``first`` where given."""
    walls = []
    for _ in range(reps):
        t1 = time.perf_counter()
        again = sess.query(sql).rows
        _sync(torch)
        walls.append(time.perf_counter() - t1)
        if first is not None and repr(again) != repr(first):
            raise Mismatch("a warm run differs from the first")
    return min(walls)


def mesh_query(K, sess, tier: str, q: str, sql: str, off: tuple, state,
               torch) -> dict:
    """One query under the mesh: its first run (its launches, node kinds
    and shard rounds), warm runs byte-equal to it, a profiled run, rows
    equal to the mesh-off run; prints its [mesh] line and returns its
    launches."""
    from tinysql_tpu_torch.executor import devpipe
    from tinysql_tpu_torch.ops import shardops
    st0 = shardops.stats_snapshot()
    before = K.kernel_counts()["launches"]
    devpipe.COMPILED_NODE_KEYS.clear()
    state["label"] = f"{tier} {q}"
    t1 = time.perf_counter()
    rows = sess.query(sql).rows
    _sync(torch)
    first_s = time.perf_counter() - t1
    state["label"] = None
    used = _launch_delta(before, K.kernel_counts()["launches"])
    _check_mesh_uses(tier, q, used)
    keys = {(k[0], k[-1]) for k in devpipe.COMPILED_NODE_KEYS}
    kinds = {k for k, _ in keys}
    want = MESH_KINDS.get(q) if tier == "pipeline" else None
    if want is not None and kinds != want:
        raise Mismatch(f"mesh {tier} {q}: pipeline node kinds {kinds}, "
                       f"want {want}")
    st = shardops.stats_snapshot()
    delta = {k: st[k] - st0[k] for k in ("shard_rounds",
                                         "shard_exchange_bytes",
                                         "shard_skew_retries")}
    reps = MESH_WARM if q in ("Q1", "Q3", "Q6") else MESH_WARM_NEW
    try:
        warm = _warm_runs(sess, sql, reps, torch, first=rows)
    except Mismatch as e:
        raise Mismatch(f"mesh {tier} {q}: {e}") from None
    prof = warm_profile(sess, sql)
    rows_off, wall_off, prof_off = off
    same_rel(rows, rows_off, f"mesh {tier} {q} vs mesh-off")
    check_rows(rows, f"mesh {tier} {q}", empty_ok=q in EMPTY_OK)
    if q in NONZERO_COUNT and not rows[0][0]:
        raise Mismatch(f"mesh {tier} {q}: a count of 0 ({rows})")
    joins = sorted(k for k in keys if k[0] in ("join", "joinshuf", "joinm"))
    print(f"[mesh] {tier} {q}: {len(rows)} rows equal to the mesh-off run, "
          f"first run {first_s:.4f} s, warm best of {reps} {warm:.4f} s "
          f"(mesh-off {wall_off:.4f} s), one warm run: {prof['kernels']} "
          f"CUDA kernels + {prof['copies']} copies, device "
          f"{prof['device_ms']} ms (mesh-off {prof_off['kernels']} + "
          f"{prof_off['copies']}, {prof_off['device_ms']} ms); shard "
          f"counters {delta}, node kinds {sorted(kinds)}, joins (kind, "
          f"mesh) {joins}, launches of the first run {used}", flush=True)
    return {"kinds": kinds}


def phase_k26(K, storage, dev, cap) -> dict:
    """K26's step (dist.distributed_query_step) at 8 x 2^20 rows over
    phase 3's lineitem and orders, against a numpy oracle on the pulled
    inputs; returns its launches (counts set to 0 just before it)."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.columnar.store import store_of
    from tinysql_tpu_torch.parallel import dist
    from tinysql_tpu_torch.session import new_session
    sess = new_session(storage, "tpch", device=dev)

    def column(table, name):
        info = sess.infoschema().table_by_name("tpch", table)
        cid = {c.name: c.id for c in info.public_columns()}[name]
        return np.asarray(store_of(storage).get(info.id).columns[cid][0])
    lk_h = column("lineitem", "l_orderkey")
    price_h = column("lineitem", "l_extendedprice")
    ok_h = np.sort(column("orders", "o_orderkey"))
    n = len(lk_h)
    if n > K26_ROWS:
        raise Mismatch(f"K26: {n} lineitem rows above {K26_ROWS}")
    shape = (MESH_SHARDS, K26_ROWS // MESH_SHARDS)
    keys = torch.from_numpy(K.pad1(lk_h, K26_ROWS)).to(dev)
    vals = torch.from_numpy(K.pad1(price_h, K26_ROWS)).to(dev)
    valid = torch.arange(K26_ROWS, device=dev) < n
    rkeys = torch.from_numpy(ok_h).to(dev)
    ins = (keys.reshape(shape) & (K26_BUCKETS - 1), vals.reshape(shape),
           valid.reshape(shape), keys.reshape(shape), valid.reshape(shape),
           rkeys)
    step = dist.distributed_query_step(dist.Mesh(MESH_SHARDS, dev),
                                       K26_BUCKETS)
    K.reset_kernel_counts()
    t1 = time.perf_counter()
    sums, cnts, counts, total = step(*ins)
    _sync(torch)
    first_s = time.perf_counter() - t1
    got = K.kernel_counts()
    if any(got["plain_calls"].values()):
        raise Mismatch(f"K26: plain versions ran: {got['plain_calls']}")
    launches = got["launches"]
    want = {"segment_reduce": MESH_SHARDS, "shard_merge": 2,
            "shard_count": 1}
    if {k: launches[k] for k in want} != want:
        raise Mismatch(f"K26: launches {launches}, want {want}")
    b = lk_h & (K26_BUCKETS - 1)
    w_sums = np.bincount(b, weights=price_h, minlength=K26_BUCKETS)
    w_cnts = np.bincount(b, minlength=K26_BUCKETS)
    w_counts = np.searchsorted(ok_h, lk_h, "right") \
        - np.searchsorted(ok_h, lk_h, "left")
    got_counts = counts.reshape(-1).cpu().numpy()
    if not np.allclose(sums.cpu().numpy(), w_sums, rtol=1e-9, atol=0) \
            or not (cnts.cpu().numpy() == w_cnts).all() \
            or not (got_counts[:n] == w_counts).all() \
            or got_counts[n:].any() or int(total) != int(w_counts.sum()):
        raise Mismatch("K26: the step differs from the numpy oracle")
    t = timed(lambda: step(*ins))
    cap["count"] = ((keys, valid), rkeys)
    print(f"[mesh] K26 distributed_query_step: {MESH_SHARDS} x "
          f"{K26_ROWS // MESH_SHARDS} rows, {K26_BUCKETS} buckets, "
          f"{len(ok_h)} sorted build keys: equal to numpy (sums 1e-9 rel, "
          f"counts exact, total {int(total)}), first run {first_s:.4f} s, "
          f"warm {t['ms']:.4f} ms by events, device {t['device_ms']} ms; "
          f"launches {_launch_delta(dict.fromkeys(launches, 0), launches)}",
          flush=True)
    return launches


def phase_mesh(K, storage, kinfo, device=None) -> None:
    """The mesh tier at SF=1 with MESH_SHARDS virtual shards on the card
    (TINYSQL_MESH_SHARDS, set for this phase only), on both device tiers
    over phase 3's storage: MESH_QUERIES under tidb_mesh_parallel = 1.
    Per tier: the mesh-off runs (rows, warm walls, device time), then,
    with the launch counters set to 0 just before and read just after,
    the mesh runs: rows equal to the mesh-off rows (floats within 1e-6
    relative), warm runs byte-equal to the first, shard counters, the
    mesh kernels launched as MESH_USES says, no plain version.  Pipeline
    Q10 runs its shuffle join under the default broadcast budget where
    the planner picks it, and again under tidb_broadcast_build_max_rows
    = 0 where it does not (Q10_SHUFFLE).  Then K26's step, and every
    mesh kernel against its plain version on the tensors the runs gave
    it."""
    import torch
    from tinysql_tpu_torch.ops import shardops
    from tinysql_tpu_torch.session import new_session
    print(f"[mesh] {MESH_SHARDS} virtual shards on {card_line()}",
          flush=True)
    old_env = os.environ.get("TINYSQL_MESH_SHARDS")
    os.environ["TINYSQL_MESH_SHARDS"] = str(MESH_SHARDS)
    cap = {"merges": {}, "probes": {}, "members": {}, "sorts": [],
           "exchanges": {}, "partitions": {}, "ranks": {}, "expands": {}}
    state = {"label": None}
    orig = {"shard_merge": K.shard_merge, "lex_order": K.lex_order,
            "shard_exchange": K.shard_exchange, "shard_rank": K.shard_rank,
            "csr_expand": K.csr_expand,
            "shard_partition_scatter": K.shard_partition_scatter}
    orig_join, orig_member = (shardops._local_unique_join,
                              shardops._local_member)

    def cap_order(lanes, n, k=None):
        if state["label"] == "pipeline Q3":
            cap["sorts"].append(([t.clone() for t in lanes], n, k))
        return orig["lex_order"](lanes, n, k)

    def cap_merge(parts, ops, m, nb):
        if state["label"] is not None:
            cap["merges"].setdefault(state["label"],
                                     (parts, list(ops), m, nb))
        return orig["shard_merge"](parts, ops, m, nb)

    def cap_join(n, pk, pid, bk, bid):
        if state["label"] is not None:
            cap["probes"].setdefault(state["label"], []).append(
                (n, pk, pid, bk, bid))
        return orig_join(n, pk, pid, bk, bid)

    def cap_member(n, pk, pid, bk, bid):
        if state["label"] is not None:
            cap["members"].setdefault(state["label"], []).append(
                (n, pk, pid, bk, bid))
        return orig_member(n, pk, pid, bk, bid)

    def cap_exchange(keys, n_rows, lanes, c, n):
        if state["label"] is not None:
            cap["exchanges"].setdefault(state["label"], []).append(
                (keys, n_rows, list(lanes), c, n))
        return orig["shard_exchange"](keys, n_rows, lanes, c, n)

    def cap_partition(part, c):
        if state["label"] is not None:
            cap["partitions"].setdefault(state["label"], []).append(
                (part.keys, part.live, part.n, c))
        return orig["shard_partition_scatter"](part, c)

    def cap_rank(ordl, ids, stride, run, n, k_out):
        if state["label"] is not None:
            cap["ranks"].setdefault(state["label"], []).append(
                (ordl, ids, stride, run, n, k_out))
        return orig["shard_rank"](ordl, ids, stride, run, n, k_out)

    def cap_expand(*a, shards=1):
        if state["label"] is not None and shards > 1:
            cap["expands"].setdefault(state["label"],
                                      (a, {"shards": shards}))
        return orig["csr_expand"](*a, shards=shards)
    K.shard_merge, K.lex_order = cap_merge, cap_order
    K.shard_exchange, K.shard_rank, K.csr_expand = (cap_exchange, cap_rank,
                                                     cap_expand)
    K.shard_partition_scatter = cap_partition
    shardops._local_unique_join, shardops._local_member = (cap_join,
                                                           cap_member)
    launches = {}
    try:
        for tier in TIERS:
            sess = new_session(storage, "tpch", device=device)
            sess.execute("set tidb_use_tpu = 1")
            sess.execute(f"set tidb_devpipe = {TIERS[tier]}")
            off = {}
            for q in MESH_QUERIES[tier]:
                sql = _mesh_sql(q)
                rows = sess.query(sql).rows
                reps = MESH_WARM if q in ("Q1", "Q3", "Q6") \
                    else MESH_WARM_NEW
                off[q] = (rows, _warm_runs(sess, sql, reps, torch),
                          warm_profile(sess, sql))
            sess.execute("set tidb_mesh_parallel = 1")
            K.reset_kernel_counts()
            shardops.reset_stats()
            for q in MESH_QUERIES[tier]:
                got = mesh_query(K, sess, tier, q, _mesh_sql(q), off[q],
                                 state, torch)
                if q == "Q10":
                    shuffled = "joinshuf" in got["kinds"]
                    print(f"[mesh] pipeline Q10 under the default "
                          f"tidb_broadcast_build_max_rows: "
                          f"{'compiles' if shuffled else 'no'} joinshuf",
                          flush=True)
                    if not shuffled:
                        sess.execute("set tidb_broadcast_build_max_rows "
                                     "= 0")
                        try:
                            got = mesh_query(K, sess, tier, "Q10_SHUFFLE",
                                             _mesh_sql("Q10"), off[q],
                                             state, torch)
                        finally:
                            sess.execute("set tidb_broadcast_build_max_"
                                         "rows = 1048576")
                    if "joinshuf" not in got["kinds"]:
                        raise Mismatch("pipeline Q10 never compiled "
                                       "joinshuf")
            st = shardops.stats_snapshot()
            if st["shard_rounds"] <= 0:
                raise Mismatch(f"mesh {tier}: no shard round ({st})")
            counts = K.kernel_counts()
            if any(counts["plain_calls"].values()):
                raise Mismatch(f"plain versions ran on the mesh {tier} "
                               f"tier: {counts['plain_calls']}")
            print(f"[mesh] {tier}: shard stats {st}", flush=True)
            for k, v in counts["launches"].items():
                launches[k] = launches.get(k, 0) + v
        for k, v in phase_k26(K, storage, device or K.device(), cap).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        K.shard_merge, K.lex_order = orig["shard_merge"], orig["lex_order"]
        K.shard_exchange, K.shard_rank, K.csr_expand = (
            orig["shard_exchange"], orig["shard_rank"], orig["csr_expand"])
        K.shard_partition_scatter = orig["shard_partition_scatter"]
        shardops._local_unique_join, shardops._local_member = (orig_join,
                                                               orig_member)
        if old_env is None:
            os.environ.pop("TINYSQL_MESH_SHARDS", None)
        else:
            os.environ["TINYSQL_MESH_SHARDS"] = old_env
    for name, r in mesh_kernel_checks(K, cap).items():
        kinfo[name] = kernel_entry(name, r)
    for k, v in launches.items():
        if k in kinfo:
            kinfo[k]["launches"] += v
            by_tier = kinfo[k].setdefault("launches_by_tier", {})
            by_tier["mesh"] = by_tier.get("mesh", 0) + v
    for k in K.MESH_LAUNCHES:
        if kinfo[k]["launches"] <= 0:
            raise Mismatch(f"kernel {k} never launched on the mesh path")


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
    from tinysql_tpu_torch.bench.expr_bench import ptxas
    ptxas(ROOT, lambda rec: print(f"[ptxas] {json.dumps(rec)}", flush=True),
          PTXAS_SOURCES)
    dev = torch.device("cuda", torch.cuda.current_device())

    # phase 2
    with K.use_device(dev):
        rec = phase_kernels(K, dev)
    torch.cuda.synchronize()
    for name, r in rec.pop("offpath").items():
        print(f"[offpath] {name}: ms {r['ms']:.4f}, device "
              f"{r['device_ms']}, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} ms (bytes)", flush=True)
    kinfo = {name: kernel_entry(name, r) for name, r in rec.items()}
    with K.use_device(dev):
        pull_counts(K)
    # phase 3
    regimes = count_regimes(K)
    storage = phase_main_path(K, kinfo)
    # the mesh phase, over phase 3's storage
    with K.use_device(dev):
        phase_mesh(K, storage, kinfo)

    # the serve phase: the wire server over phase 3's storage
    phase_serve(K, storage, kinfo)
    for name, split in regimes.items():
        print(f"[regimes] {name}: {split['few']} few-segment, "
              f"{split['sort']} sort-regime launches (kernels line: "
              f"{kinfo[name]['launches']})", flush=True)
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
