"""HK4's sort core across sizes on the card, against one PyTorch call.

    python3 -m tinysql_tpu_torch.bench.sort_bench [--root DIR] [--out FILE]

Times ``kernels.lex_order`` (median of CUDA events around one wrapper
call) for the shapes that decide where the sort core's regimes meet:
a one-key ORDER BY through ``sort_lanes`` (a NULL-rank lane and a value
lane of random 62-bit integers) and the two-lane build sort of HK3's
multiplicity join (a dead-row lane and a key lane of 2^15 distinct keys),
at n = 2^11 .. 2^23, beside ``torch.argsort(stable=True)`` of the values;
then K6's and K7's joins (probe 2^20, build 2^15) through
``equi_join_unique`` / ``equi_join_mult``, which sort their build side.
Every result is checked against the plain version first.

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions of the sort
core are measured by the same script, in one call, on one card; run the
script as a file then (``python3 tinysql_tpu_torch/bench/sort_bench.py
--root DIR``), so that the package is not already imported from here.  Prints
one JSON object per shape, the card's name and power limit in each.
Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SIZES = tuple(range(11, 24))
SEED = 5


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


def run(root: str, sizes, out) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from tinysql_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", torch.cuda.current_device())
    name = card()
    rng = np.random.default_rng(SEED)

    def emit(rec):
        rec.update({"root": root, "card": name})
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    with K.use_device(dev):
        for e in sizes:
            n = 1 << e
            v = torch.as_tensor(rng.integers(0, 1 << 62, n)).to(dev)
            one = K.sort_lanes([(v, torch.zeros(n, dtype=torch.bool,
                                                device=dev))], [False],
                               torch.ones(n, dtype=torch.bool, device=dev))
            rk = torch.as_tensor(rng.integers(0, 1 << 15, n)).to(dev)
            dead = (torch.as_tensor(rng.random(n)).to(dev) < 0.1).long()
            build = [dead, rk ^ K.I64_MIN]
            for label, lanes in (("one_key", one), ("build_2_lanes", build)):
                got = K.lex_order(lanes, n)
                if not torch.equal(got, K.lex_order_plain(lanes, n)):
                    raise SystemExit(f"{label} n=2^{e}: differs from plain")
                reps = 20 if e < 21 else 5
                emit({"shape": label, "n": n,
                      "ms": cuda_ms(lambda: K.lex_order(lanes, n), reps),
                      "argsort_ms": cuda_ms(lambda: torch.argsort(
                          lanes[-1], stable=True), reps)})
        nl, nr = 1 << 20, 1 << 15
        lk = torch.as_tensor(rng.integers(0, nr, nl)).to(dev)
        uk = torch.arange(nr, device=dev)
        mk = torch.as_tensor(rng.integers(0, nr, nr)).to(dev)
        zl = torch.zeros(nl, dtype=torch.bool, device=dev)
        zr = torch.zeros(nr, dtype=torch.bool, device=dev)
        ol, orr = ~zl, ~zr
        for label, fn in (
                ("K6 equi_join_unique probe 2^20 build 2^15",
                 lambda: K.equi_join_unique(lk, zl, ol, uk, zr, orr)),
                ("K7 equi_join_mult probe 2^20 build 2^15",
                 lambda: K.equi_join_mult(lk, zl, ol, mk, zr, orr))):
            emit({"shape": label, "ms": cuda_ms(fn)})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="log2 of the row counts, comma-separated")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sort_bench: no CUDA device", file=sys.stderr)
        return 2
    sizes = [int(x) for x in a.sizes.split(",")]
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            run(os.path.abspath(a.root), sizes, f)
    else:
        run(os.path.abspath(a.root), sizes, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
