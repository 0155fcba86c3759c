"""Whether torch.profiler keeps every device record of a trace, with and
without trace_tpch.TRACE_PAUSE_S of idling at the trace's two ends.

    python3 -m tinysql_tpu_torch.bench.trace_window [--seconds S]

For S seconds (default 150) the script traces, in turn without a pause
and with TRACE_PAUSE_S, four calls of one upload and HK1 masked_reduce
over 2^22 rows (an elementwise NOT, mr_partial, mr_merge and a pageable
upload: four records a call), with untraced work in between so that the
process ages.  A trace is whole when it holds four records of each of
the four names.  Prints one JSON object: the traces taken, the seconds
into the run at which a trace was not whole, and the card's name and
power limit.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time


def _counts(fn, reps: int, pause: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(pause)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pause)
    c = collections.Counter()
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            c[e.key] += e.count
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_window: no CUDA device", file=sys.stderr)
        return 2
    from tinysql_tpu_torch.bench.trace_tpch import TRACE_PAUSE_S, _card
    from tinysql_tpu_torch.ops import kernels as K
    n, reps = 1 << 22, 4
    x = torch.rand(n, device="cuda", dtype=torch.float64)
    m = torch.rand(n, device="cuda") < 0.5
    h = torch.rand(1 << 16, dtype=torch.float64)

    def call():
        h.to("cuda")
        K.masked_reduce(m, [(x, ~m, "sum")])

    call()
    torch.cuda.synchronize()
    pauses = (0.0, TRACE_PAUSE_S)
    traces = {p: 0 for p in pauses}
    lost = {p: [] for p in pauses}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for p in pauses:
            c = _counts(call, reps, p)
            traces[p] += 1
            if len(c) != 4 or any(v != reps for v in c.values()):
                lost[p].append(round(time.perf_counter() - t0, 1))
        for _ in range(200):
            x.mul_(1.0)
        torch.cuda.synchronize()
    print(json.dumps({"card": _card(), "seconds": args.seconds,
                      "traces": {str(p): traces[p] for p in pauses},
                      "not_whole_at_s": {str(p): lost[p] for p in pauses}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
