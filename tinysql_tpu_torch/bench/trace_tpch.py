"""Where the time of TPC-H Q1, Q3, Q6, Q13, K8's path (NOT IN, Q22), a
block-wise run and the workload trio Q5, Q10, Q18 goes on the card.

    python3 -m tinysql_tpu_torch.bench.trace_tpch [--out FILE]

Loads TPC-H at SF=1 (seed 7, the main path's data) into a session on the
current CUDA device, then for each device tier (the pipeline tier,
tidb_devpipe=-1, the default; the per-operator tier, tidb_devpipe=0) and
each query (Q1, Q3, Q6 on both tiers, then Q13, then tpch.K8_QUERIES,
then Q1, Q3, Q6 and NOT IN block-wise under tidb_device_block_rows =
2^20 — recorded under the tier names "pipeline_blockwise" and
"per_op_blockwise" —, then the trio): the first run's wall, the best of
three warm walls,
and one more warm run under torch.profiler (CPU + CUDA activities; taken
again, up to three times, when its trace holds no device event) giving
the device time summed over its kernels (one stream, so kernels do not
overlap), the device idle share of the wall, the number of CUDA kernels
and of copies it launched, the kernels by device time,
and the per-operator walls and device counters the session records
(obs/context.py).  Prints one JSON object per (tier, query) and, with
--out, writes them all to that file.  The tiers share the replica's
string dictionaries and column uploads, so the second tier's first run
does not pay them.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SF, SEED = 1.0, 7
#: tier -> tidb_devpipe
TIERS = {"pipeline": -1, "per_op": 0}
#: the block-wise run: tidb_device_block_rows and its queries
BLOCK_ROWS = 1 << 20
BLOCK_QUERIES = ("Q1", "Q3", "Q6", "NOT_IN")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "unknown"


def device_us(evt) -> float:
    """Device time of a device-side event (a kernel or a copy); 0 for a
    host op, whose self device time repeats its kernels' time."""
    if "CUDA" not in str(getattr(evt, "device_type", "")):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def trace_query(sess, sql: str, torch) -> dict:
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    sess.query(sql)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        sess.query(sql)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    for _ in range(3):  # a trace without device events is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.query(sql)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        evts = [e for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))]
        if evts:
            break
    stats = sess.last_query_stats.summary()
    n_copies = sum(e.count for e in evts
                   if e.key.startswith(("Memcpy", "Memset")))
    n_kernels = sum(e.count for e in evts) - n_copies
    kernels = [(e.key, device_us(e), e.count)
               for e in prof.key_averages() if device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    device_s = sum(k[1] for k in kernels) / 1e6
    return {
        "first_run_s": first_s, "warm_best_s": min(warm),
        "profiled_wall_s": wall_s,
        "device_s": device_s if kernels else None,
        "device_idle_share": (max(0.0, 1.0 - device_s / wall_s)
                              if kernels else None),
        "cuda_kernels": n_kernels if evts else None,
        "copies": n_copies if evts else None,
        "top_kernels": [{"name": n[:80], "device_ms": us / 1e3, "calls": c}
                        for n, us, c in kernels[:10]],
        "operators": [{k: op[k] for k in ("label", "time_ms", "act_rows",
                                          "device") if k in op}
                      for op in stats["operators"]],
        "query_device_counters": stats["device"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_tpch: no CUDA device", file=sys.stderr)
        return 2
    from ..bench import tpch
    from ..session import new_session
    sess = new_session()
    tpch.load(sess, sf=SF, seed=SEED)
    out = {"card": _card(), "sf": SF, "seed": SEED, "tiers": {}}
    named = {**tpch.QUERIES, **tpch.K8_QUERIES}
    blockwise = {q: named[q] for q in BLOCK_QUERIES}
    # Q1, Q3, Q6 and Q13 on both tiers before the trio: after Q5's run,
    # torch.profiler loses some kernel events of later traces
    for queries in (tpch.QUERIES, {"Q13": tpch.Q13}, tpch.K8_QUERIES,
                    blockwise, tpch.WORKLOAD):
        block = queries is blockwise
        for tier in TIERS:
            sess.execute(f"set tidb_devpipe = {TIERS[tier]}")
            sess.execute("set tidb_device_block_rows = "
                         f"{BLOCK_ROWS if block else 0}")
            name = tier + ("_blockwise" if block else "")
            for q, sql in queries.items():
                rec = trace_query(sess, sql, torch)
                out["tiers"].setdefault(name, {})[q] = rec
                print(json.dumps({"tier": name, "query": q, **rec},
                                 default=str), flush=True)
    sess.execute("set tidb_device_block_rows = 0")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
