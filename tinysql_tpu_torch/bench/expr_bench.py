"""HK7 expr_eval and HK14 shard_rank on the card, at the main path's shapes.

    python3 tinysql_tpu_torch/bench/expr_bench.py [--root DIR] [--out FILE]
        [--ptxas]

Times (median of CUDA events around one wrapper call, after checking the
kernel's output against its plain version byte for byte):

- HK7 at TPC-H SF=1's shapes: Q6's five conditions and revenue lane, Q1's
  ten argument lanes, and Q3's lineitem mask (K14), over 2^23 rows of
  which 5,999,820 are live, each beside its bound (the bytes the program
  must move at 3.35 TB/s);
- HK14 at the mesh ORDER BY's shape (8 runs of 2^18: 1.5M o_totalprice
  scores padded to 2^21, descending): the merge alone, the K25 sort
  route (HK4 per shard, then HK14) and ``torch.sort(stable=True)`` of the
  same order lane; and the mesh TopN's merge (8 x 16 candidates).

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions of the kernels
are measured by the same script, in one call, on one card; run the
script as a file then, so that the package is not already imported from
here.  ``--ptxas`` compiles the root's ``expr_eval.cu`` and ``shard_rank.cu``
with ``-Xptxas -v`` and prints each kernel's registers, stack frame and
spill bytes, and the local-memory loads and stores (``LDL`` / ``STL``) of
its SASS.  Builds go to the root's ``tinysql_tpu_torch/_build/bench/``.
Prints one JSON object per measurement, the card's name and power limit
in each.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

# this checkout's trace helper, whatever --root imports the kernels from
if __package__:
    from .trace_tpch import device_trace
else:  # run as a file, as --root needs
    from trace_tpch import device_trace

SEED = 7
MEM_BPS = 3.35e12
ROWS, LIVE = 1 << 23, 5_999_820


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "unknown"


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
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


def device_ms(fn, reps: int = 10):
    """Device-only time of one call (the self device time of every
    kernel, copy and memset it enqueues, from a whole torch.profiler trace
    of reps calls: trace_tpch.device_trace) and that time by kernel name;
    (None, {}) when no trace of three was whole."""
    fn()
    evts, _wall, whole = device_trace(fn, reps, tries=3)
    if not whole:
        return None, {}
    by = {}
    for k, us, _c in evts:
        by[k[:48]] = by.get(k[:48], 0.0) + us / 1e3
    return sum(by.values()), by


def stream_ms(fn, calls: int = 20) -> float:
    """CUDA events around `calls` calls enqueued back to back, per call:
    the device time where it exceeds the host's work between launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / calls


def expr_bytes(prog, cols, n_live: int) -> int:
    """Each input lane's values and NULL mask read once over the live
    rows, the mask and each output lane written once."""
    per_row = 0
    for slot, kind in prog.inputs:
        v, m = cols[slot]
        per_row += (0 if kind == "n" else v.element_size()) + \
            (m is not None)
    per_row += int(prog.has_mask)
    per_row += sum(1 + (0 if dt == "n" else 8) for dt in prog.outputs)
    return n_live * per_row


def programs(K, dev):
    """(name, program, columns, params, rows, live rows) of Q6, Q1 and
    Q3's lineitem mask at SF=1 (lineitem: 5,999,820 live rows of a 2^23
    bucket; l_shipdate as codes of its 2,526 distinct dates)."""
    import numpy as np
    import torch
    from tinysql_tpu_torch.expression import Column, Constant, new_function
    from tinysql_tpu_torch.mytypes import new_real_type
    from tinysql_tpu_torch.ops import exprjit as X
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.as_tensor(K.pad1(a, ROWS)).to(dev)

    def real(i):
        return Column(new_real_type(), index=i)

    def const(v):
        return Constant(v, new_real_type())

    nul = torch.zeros(ROWS, dtype=torch.bool, device=dev)
    cols = [(t(rng.integers(0, 2526, LIVE).astype(np.int64)), nul),
            (t(np.round(rng.integers(0, 11, LIVE) * 0.01, 2)), nul),
            (t(rng.integers(1, 51, LIVE).astype(np.float64)), nul),
            (t(np.round(rng.uniform(900.0, 105000.0, LIVE), 2)), nul),
            (t(np.round(rng.integers(0, 9, LIVE) * 0.01, 2)), nul)]
    out = []
    pt = X.ParamTable()
    q6 = X.compile_program(
        [("codecmp", 0, ">=", 731, 732, 2526),
         ("codecmp", 0, "<", 1096, 1097, 2526),
         new_function(">=", [real(1), const(0.05)]),
         new_function("<=", [real(1), const(0.07)]),
         new_function("<", [real(2), const(24.0)])],
        [new_function("*", [real(3), real(1)])], pt, mask=True)
    out.append(("Q6", q6, cols, K._params_dev(pt.arrays())))
    one = const(1.0)
    dprice = new_function("*", [real(3), new_function("-", [one, real(1)])])
    charge = new_function("*", [dprice, new_function("+", [one, real(4)])])
    pt = X.ParamTable()
    q1 = X.compile_program(
        [("codecmp", 0, "<=", 2436, 2437, 2526)],
        [real(2), real(3), dprice, charge, real(2), ("null", real(2)),
         real(3), ("null", real(3)), real(1), ("null", real(1))], pt,
        mask=True)
    out.append(("Q1", q1, cols, K._params_dev(pt.arrays())))
    pt = X.ParamTable()
    k14 = X.compile_program([("codecmp", 0, ">", 1169, 1170, 2526)], (), pt,
                            mask=True)
    out.append(("K14 Q3 lineitem mask", k14, cols[:1],
                K._params_dev(pt.arrays())))
    return out


def same_expr(a, b, what: str) -> None:
    import torch
    (ma, oa), (mb, ob) = a, b
    if (ma is None) != (mb is None) or (
            ma is not None and not torch.equal(ma, mb)):
        raise SystemExit(f"{what}: mask differs")
    for (va, na), (vb, nb) in zip(oa, ob):
        if not torch.equal(na, nb) or (va is None) != (vb is None) or (
                va is not None and not torch.equal(va.view(torch.int64),
                                                   vb.view(torch.int64))):
            raise SystemExit(f"{what}: a lane differs")


def time_hk7(K, progs, emit) -> None:
    for name, prog, cols, pr in progs:
        def call():
            return K.expr_eval(prog, cols, pr, ROWS, n_rows=LIVE)
        got = call()
        same_expr(got, call(), f"{name} (two runs)")
        same_expr(got, K.expr_eval_plain(prog, cols, pr, ROWS, n_rows=LIVE),
                  name)
        dev_ms, by = device_ms(call)
        emit({"kernel": "expr_eval", "shape": name,
              "instructions": len(prog.ins),
              "registers": [s.n_regs for s in prog.segments()]
              if hasattr(prog.segments()[0], "n_regs") else None,
              "ms": cuda_ms(call), "device_ms": dev_ms, "by_kernel": by,
              "stream_ms": stream_ms(call),
              "bound_ms": expr_bytes(prog, cols, LIVE) / MEM_BPS * 1e3})


def time_hk14(K, dev, emit) -> None:
    import numpy as np
    import torch
    from tinysql_tpu_torch.ops import shardops as S
    rng = np.random.default_rng(SEED)
    n, nb, live = 8, 1 << 21, 1_500_000
    price = np.round(rng.uniform(900.0, 555000.0, live), 2)
    ordl = S._score_order([(price, np.zeros(live, bool))], [True], live, nb)
    m = nb // n
    ids = K.lex_order([K.shard_lane(n, m), ordl], nb)
    got = K.shard_rank(ordl, ids, m, m, n, nb)
    if not (torch.equal(got, K.shard_rank(ordl, ids, m, m, n, nb))
            and torch.equal(got, K.shard_rank_plain(ordl, ids, m, m, n,
                                                    nb))):
        raise SystemExit("shard_rank K25 sort: differs")
    dev_ms, by = device_ms(lambda: K.shard_rank(ordl, ids, m, m, n, nb))
    emit({"kernel": "shard_rank",
          "shape": f"K25 sort, {n} runs of {m}",
          "ms": cuda_ms(lambda: K.shard_rank(ordl, ids, m, m, n, nb)),
          "device_ms": dev_ms, "by_kernel": by,
          "stream_ms": stream_ms(lambda: K.shard_rank(ordl, ids, m, m, n,
                                                      nb)),
          "route_ms": cuda_ms(lambda: K.shard_rank(
              ordl, K.lex_order([K.shard_lane(n, m), ordl], nb), m, m, n,
              nb)),
          "torch_sort_stable_ms": cuda_ms(
              lambda: torch.sort(ordl ^ K.I64_MIN, stable=True)),
          "bound_ms": (nb * 16 + nb * 8) / MEM_BPS * 1e3})
    kb = 16
    cand = torch.cat([K.lex_order([ordl[s * m:(s + 1) * m]], m, kb) + s * m
                      for s in range(n)])
    got = K.shard_rank(ordl, cand, kb, kb, n, kb)
    if not torch.equal(got, K.shard_rank_plain(ordl, cand, kb, kb, n, kb)):
        raise SystemExit("shard_rank K25 top-k: differs")
    emit({"kernel": "shard_rank",
          "shape": f"K25 top-k, {n} x {kb}",
          "ms": cuda_ms(lambda: K.shard_rank(ordl, cand, kb, kb, n, kb)),
          "device_ms": device_ms(lambda: K.shard_rank(ordl, cand, kb, kb,
                                                      n, kb))[0],
          "bound_ms": (n * kb * 16 + kb * 8) / MEM_BPS * 1e3})


def nvcc_cmd(root: str, source: str, extra) -> list:
    sys.path.insert(0, root)
    from tinysql_tpu_torch.ops import _ext
    return [_ext._nvcc()] + _ext.NVCC_FLAGS + \
        _ext.SOURCE_FLAGS.get(source, []) + list(extra) + \
        ["-I", _ext.CSRC, os.path.join(_ext.CSRC, f"{source}.cu")]


def bench_dir(root: str) -> str:
    d = os.path.join(root, "tinysql_tpu_torch", "_build", "bench")
    os.makedirs(d, exist_ok=True)
    return d


def ptxas(root: str, emit, sources=("expr_eval", "shard_rank")) -> None:
    """Registers, stack frame and spill bytes per kernel (ptxas -v), and
    the LDL / STL instructions of its SASS, for each of ``sources``."""
    d = bench_dir(root)
    for source in sources:
        lib = os.path.join(d, f"ptxas_{source}.so")
        cmd = nvcc_cmd(root, source, ["-Xptxas", "-v", "-o", lib])
        got = subprocess.run(cmd, capture_output=True, text=True)
        if got.returncode != 0:
            raise SystemExit(f"nvcc {source}: {got.stderr[-2000:]}")
        info, fn = {}, None
        for line in (got.stdout + got.stderr).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                info.setdefault(fn, {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and fn:
                info[fn].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
                continue
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                info.setdefault(fn, {})
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                info[fn]["registers"] = int(m.group(1))
        sass = subprocess.run(["cuobjdump", "-sass", lib],
                              capture_output=True, text=True).stdout
        per, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1)
                per[cur] = {"LDL": 0, "STL": 0}
            elif cur:
                for op in ("LDL", "STL"):
                    if re.search(rf"\b{op}\b", line):
                        per[cur][op] += 1
        for fn, v in info.items():
            emit({"ptxas": source, "function": fn, **v,
                  **per.get(fn, {})})


def run(root: str, out, with_ptxas: bool) -> None:
    import torch
    sys.path.insert(0, root)
    from tinysql_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", torch.cuda.current_device())
    name = card()

    def emit(rec):
        rec.update({"root": root, "card": name})
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    if with_ptxas:
        ptxas(root, emit)
    with K.use_device(dev):
        time_hk7(K, programs(K, dev), emit)
        time_hk14(K, dev, emit)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("expr_bench: no CUDA device", file=sys.stderr)
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
