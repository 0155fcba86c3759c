"""HK1 masked_reduce (with HK1b) and HK3 equi_join on the card, at the
main path's shapes, with the host syncs each call makes.

    python3 tinysql_tpu_torch/bench/scalar_join_bench.py [--root DIR]
        [--out FILE] [--ptxas]

Each shape is first checked against the kernel's plain version (integers,
counts and pairs exactly, float sums within 1e-6 relative), then timed:
the median of CUDA events around one wrapper call (``ms``: the host work
between the launches and any wait for a pull included), the device time
of one call from a whole torch.profiler trace (``device_ms``), and the
bound (the bytes the call must move at 3.35 TB/s).  ``syncs`` counts the
synchronizing CUDA calls of one call (torch.cuda.set_sync_debug_mode),
``d2h`` its counted pulls (STATS["d2h_transfers"]) and ``h2d`` its
counted uploads (a pageable upload synchronizes too).  Shapes:

- HK1 at Q6 (2^23 rows, 2% valid, one float64 SUM lane), at K5's shape
  (2^20 rows, 90% valid, a float64 SUM and a count) and HK1b at Q6's
  shape for B = 8 members, beside 8 solo calls;
- HK3 at TPC-H SF=1's per-operator joins: Q3 join 1 (orders probing
  customer: 2^20 probe rows, 2^15 build rows), Q3 join 2 (2^18 probe rows
  against a 2^20-row aggregate), K7's shape (2^20 probe rows against
  2^15 build rows of 2^15 distinct keys in any multiplicity) and K8's NOT
  IN membership (1.5M orders probing ~3M lineitem keys); each through the
  device entry point (``equi_join_unique``, ``equi_join_mult``,
  ``unique_match``; where the checkout has it, also
  ``equi_join_unique_packed``, the unique probe without the count's
  pull) and through the host one the executors call
  (``unique_join_match``, ``join_match``, ``semi_join_match``).

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions are measured by
one script, in one call, on one card; run the script as a file then.
``--ptxas`` prints each kernel's registers, stack and spills of the
root's ``masked_reduce.cu`` and ``equi_join.cu``.  One JSON object per
shape, the card's name and power limit in each.  Exits 2 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

if __package__:
    from .expr_bench import card, cuda_ms, device_ms, ptxas
else:  # run as a file, as --root needs
    from expr_bench import card, cuda_ms, device_ms, ptxas

SEED = 12
MEM_BPS = 3.35e12


def syncs_of(K, fn) -> dict:
    """The synchronizing CUDA calls of one call, its counted pulls and
    its counted uploads (a pageable upload synchronizes too)."""
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for rep in range(2):  # the first run's warnings may be one-off
            torch.cuda.synchronize()
            del seen[:]
            snap = K.stats_snapshot()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    now = K.stats_snapshot()
    return {"syncs": sum("synchroniz" in str(w.message) for w in seen),
            "d2h": now["d2h_transfers"] - snap["d2h_transfers"],
            "h2d": now["h2d_transfers"] - snap["h2d_transfers"]}


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
        dev_ms, by = device_ms(fn)
        return {"ms": cuda_ms(fn), "device_ms": dev_ms,
                "device_by_kernel": by, **syncs_of(K, fn), **extra}

    def same_sum(got, want, what):
        got = got.reshape(-1, got.shape[-1])
        want = want.reshape(-1, want.shape[-1])
        f = got[:, 2].contiguous().view(torch.float64)
        g = want[:, 2].contiguous().view(torch.float64)
        keep = [i for i in range(got.shape[-1]) if i != 2]
        if not torch.equal(got[..., keep], want[..., keep]) or \
                not torch.allclose(f, g, rtol=1e-6, atol=1e-9):
            raise SystemExit(f"{what}: differs from the plain version")

    def reduce_bytes(valid, lanes):
        nv = int(valid.sum())
        per = sum((0 if v is None else 8) + (m is not None)
                  for v, m, _op in lanes)
        return valid.numel() + nv * per + 8 * (2 + 2 * len(lanes)) * (
            valid.shape[0] if valid.dim() == 2 else 1)

    if with_ptxas:
        ptxas(root, emit, ("masked_reduce", "equi_join"))
    with K.use_device(dev):
        n = 1 << 23
        # -- HK1 --------------------------------------------------------
        valid = t(rng.random(n) < 0.02)
        q6 = [(t(np.round(rng.uniform(900.0, 105000.0, n), 2)),
               t(np.zeros(n, bool)), "sum")]
        same_sum(K.masked_reduce(valid, q6),
                 K.masked_reduce_plain(valid, q6), "HK1 Q6")
        emit({"kernel": "masked_reduce", "shape": "Q6 n=2^23 1 f64 SUM",
              **timed(lambda: K.masked_reduce(valid, q6)),
              "bound_ms": reduce_bytes(valid, q6) / MEM_BPS * 1e3})
        m = 1 << 20
        v5 = t(rng.random(m) < 0.9)
        k5 = [(t(rng.random(m)), t(np.zeros(m, bool)), "sum"),
              (None, t(np.zeros(m, bool)), "count")]
        same_sum(K.masked_reduce(v5, k5), K.masked_reduce_plain(v5, k5),
                 "HK1 K5")
        emit({"kernel": "masked_reduce", "shape": "K5 n=2^20 2 lanes",
              **timed(lambda: K.masked_reduce(v5, k5)),
              "bound_ms": reduce_bytes(v5, k5) / MEM_BPS * 1e3})
        nmem = 8
        vb = t(rng.random((nmem, n)) < 0.02)
        lb = [(t(np.round(rng.uniform(900.0, 105000.0, (nmem, n)), 2)),
               t(np.zeros(n, bool)), "sum")]
        got = K.masked_reduce_batched(vb, lb)
        for b in range(nmem):
            if not torch.equal(got[b], K.masked_reduce(
                    vb[b], K._member_lanes(lb, b))):
                raise SystemExit(f"HK1b member {b}: not its solo call")
        same_sum(got, K.masked_reduce_batched_plain(vb, lb), "HK1b")
        emit({"kernel": "masked_reduce_batched",
              "shape": "Q6 B=8 n=2^23 1 f64 SUM",
              **timed(lambda: K.masked_reduce_batched(vb, lb)),
              "solo_x8_ms": cuda_ms(lambda: [K.masked_reduce(
                  vb[b], K._member_lanes(lb, b)) for b in range(nmem)]),
              "bound_ms": reduce_bytes(vb, lb) / MEM_BPS * 1e3})
        del valid, q6, vb, lb, got
        torch.cuda.empty_cache()

        # -- HK3 --------------------------------------------------------
        def join(what, lk, ln, lv, rk, rn, rv, mode):
            dk = [t(a) for a in (lk, ln, lv, rk, rn, rv)]
            if mode == "member":
                dev_fn = lambda: K.unique_match(*dk)  # noqa: E731
                if not torch.equal(dev_fn(), K._unique_probe_plain(*dk)[0]):
                    raise SystemExit(f"{what}: membership differs")
                host_fn = lambda: K.semi_join_match(  # noqa: E731
                    (lk, ln), len(lk), (rk, rn), len(rk), anti=True,
                    null_aware=True, lvalid=lv, rvalid=rv)
                pairs = int(dev_fn().sum())
            else:
                f, fp, fh = ((K.equi_join_unique, K.equi_join_unique_plain,
                              K.unique_join_match) if mode == "unique" else
                             (K.equi_join_mult, K.equi_join_mult_plain,
                              K.join_match))
                dev_fn = lambda: f(*dk)  # noqa: E731
                a, b = dev_fn(), fp(*dk)
                if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                    raise SystemExit(f"{what}: pairs differ")
                host_fn = lambda: fh(  # noqa: E731
                    (lk, ln), len(lk), (rk, rn), len(rk), lvalid=lv,
                    rvalid=rv)
                pairs = int(a[0].shape[0])
            bound = (len(lk) * 10 + len(rk) * 10
                     + (pairs * 16 if mode != "member" else len(lk)))
            emit({"kernel": "equi_join", "mode": mode, "shape": what,
                  "pairs": pairs, **timed(dev_fn),
                  "bound_ms": bound / MEM_BPS * 1e3})
            if mode == "unique" and hasattr(K, "equi_join_unique_packed"):
                emit({"kernel": "equi_join", "mode": "unique (packed, no "
                      "pull)", "shape": what, "pairs": pairs,
                      **timed(lambda: K.equi_join_unique_packed(*dk)),
                      "bound_ms": bound / MEM_BPS * 1e3})
            emit({"kernel": "equi_join", "mode": mode + " (host API)",
                  "shape": what, **{k: v for k, v in timed(host_fn).items()
                                    if not k.startswith("device")}})

        nl, nr = 1 << 20, 1 << 15
        lv = (np.arange(nl) < 1_500_000) & (rng.random(nl) < 0.486)
        join("Q3 join 1: probe 2^20, build 2^15",
             rng.integers(1, 150_001, nl).astype(np.int64),
             np.zeros(nl, bool), lv, (np.arange(1, nr + 1) * 5)
             .astype(np.int64), np.zeros(nr, bool), rng.random(nr) < 0.91,
             "unique")
        join("Q3 join 2: probe 2^18, build 2^20",
             rng.integers(1, 1_500_001, 1 << 18).astype(np.int64),
             np.zeros(1 << 18, bool), rng.random(1 << 18) < 0.55,
             np.arange(1, (1 << 20) + 1).astype(np.int64),
             rng.random(1 << 20) < 0.2, np.arange(1 << 20) < 827_499,
             "unique")
        join("K7: probe 2^20, build 2^15 of 2^15 keys",
             rng.integers(0, 1 << 15, nl).astype(np.int64),
             np.zeros(nl, bool), np.ones(nl, bool),
             rng.integers(0, 1 << 15, nr).astype(np.int64),
             np.zeros(nr, bool), np.ones(nr, bool), "mult")
        no, nli = 1 << 21, 1 << 22
        ok = (np.arange(1, no + 1) * 4).astype(np.int64)
        lineitem = rng.choice(1_500_000, 2_998_334) * 4 + 4
        lineitem[rng.random(len(lineitem)) < 0.25] += 1  # a quarter miss
        join("K8 NOT IN: probe 2^21 (1.5M), build 2^22 (2,998,334)",
             ok, np.zeros(no, bool), np.arange(no) < 1_500_000,
             K.pad1(lineitem.astype(np.int64), nli), np.zeros(nli, bool),
             np.arange(nli) < len(lineitem), "member")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scalar_join_bench: no CUDA device", file=sys.stderr)
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
