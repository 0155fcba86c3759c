"""Where the time of TPC-H Q1, Q3, Q6, Q13, K8's path (NOT IN, Q22), a
block-wise run, a mesh run and the workload trio Q5, Q10, Q18 goes on
the card.

    python3 -m tinysql_tpu_torch.bench.trace_tpch [--out FILE]

Loads TPC-H at SF=1 (seed 7, the main path's data) into a session on the
current CUDA device, then for each device tier (the pipeline tier,
tidb_devpipe=-1, the default; the per-operator tier, tidb_devpipe=0) and
each query (Q1, Q3, Q6 on both tiers, then Q13, then tpch.K8_QUERIES,
then Q1, Q3, Q6 and NOT IN block-wise under tidb_device_block_rows =
2^20 — recorded under the tier names "pipeline_blockwise" and
"per_op_blockwise" —, then Q1, Q3, Q6 under tidb_mesh_parallel = 1
with 8 virtual shards — TINYSQL_MESH_SHARDS set for that run only, the
tiers "pipeline_mesh" and "per_op_mesh" —, then the trio): the first
run's wall, the best of
three warm walls,
and two more warm runs under torch.profiler (device_trace, taken up to
three times until whole) giving
a run's device time summed over its kernels (one stream, so kernels do
not overlap), the device idle share of its wall, whether the trace was
whole, the number of CUDA kernels and of copies it launched, the
kernels by device time,
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
#: the mesh run's virtual shards (TINYSQL_MESH_SHARDS)
MESH_SHARDS = 8
#: seconds a trace idles after it starts and before it stops: on the
#: H100 a trace that launched work at once lost, more often the older
#: the process, the device records of its first launches; with this
#: pause none did over 150 s (bench/trace_window.py), though query
#: traces late in a long process still lose some (device_trace)
TRACE_PAUSE_S = 0.1


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


def device_trace(fn, reps: int = 2, tries: int = 1):
    """fn run ``reps`` times under torch.profiler (CPU + CUDA activities):
    ``(records, wall_s, whole)``.  ``records`` lists (name, device us,
    count) per call of every kernel, copy and memset, ``wall_s`` is one
    call's mean wall (each call ends with a device sync).  The trace
    idles TRACE_PAUSE_S after it starts and before it stops, and is
    whole when every name's count is a multiple of ``reps`` (each call
    enqueues the same work); one that is not, or holds no device record,
    is taken again, up to ``tries`` times in all.  ``records`` is empty
    when no trace held a device record.  A trace that is not whole lost
    records (the pause does not keep them all late in a long process:
    PERF.md), so its sums read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    got = ([], 0.0, False)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(TRACE_PAUSE_S)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
            wall_s = (time.perf_counter() - t0) / reps
            time.sleep(TRACE_PAUSE_S)
        evts = [(e.key, device_us(e), e.count) for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))
                and e.count]
        whole = bool(evts) and all(c % reps == 0 for _k, _us, c in evts)
        if evts:
            got = ([(k, us / reps, c // reps if c % reps == 0 else c / reps)
                    for k, us, c in evts], wall_s, whole)
        if whole:
            break
    return got


def trace_query(sess, sql: str, torch) -> dict:
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
    evts, wall_s, whole = device_trace(lambda: sess.query(sql), tries=3)
    stats = sess.last_query_stats.summary()
    n_copies = sum(c for k, _us, c in evts
                   if k.startswith(("Memcpy", "Memset")))
    n_kernels = sum(c for _k, _us, c in evts) - n_copies
    kernels = sorted(((k, us, c) for k, us, c in evts if us > 0),
                     key=lambda k: -k[1])
    device_s = sum(k[1] for k in kernels) / 1e6
    return {
        "first_run_s": first_s, "warm_best_s": min(warm),
        "profiled_wall_s": wall_s,
        "device_s": device_s if kernels else None,
        "device_idle_share": (max(0.0, 1.0 - device_s / wall_s)
                              if kernels else None),
        "trace_whole": whole,
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
    mesh = dict(tpch.QUERIES)
    env_shards = os.environ.get("TINYSQL_MESH_SHARDS")
    for queries in (tpch.QUERIES, {"Q13": tpch.Q13}, tpch.K8_QUERIES,
                    blockwise, mesh, tpch.WORKLOAD):
        block = queries is blockwise
        on_mesh = queries is mesh
        if on_mesh:
            os.environ["TINYSQL_MESH_SHARDS"] = str(MESH_SHARDS)
        for tier in TIERS:
            sess.execute(f"set tidb_devpipe = {TIERS[tier]}")
            sess.execute("set tidb_device_block_rows = "
                         f"{BLOCK_ROWS if block else 0}")
            sess.execute(f"set tidb_mesh_parallel = {int(on_mesh)}")
            name = tier + ("_blockwise" if block else "") \
                + ("_mesh" if on_mesh else "")
            for q, sql in queries.items():
                rec = trace_query(sess, sql, torch)
                out["tiers"].setdefault(name, {})[q] = rec
                print(json.dumps({"tier": name, "query": q, **rec},
                                 default=str), flush=True)
        if on_mesh:
            if env_shards is None:
                os.environ.pop("TINYSQL_MESH_SHARDS", None)
            else:
                os.environ["TINYSQL_MESH_SHARDS"] = env_shards
    sess.execute("set tidb_device_block_rows = 0")
    sess.execute("set tidb_mesh_parallel = 0")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
