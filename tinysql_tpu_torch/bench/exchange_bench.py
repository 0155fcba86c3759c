"""HK13 shard_exchange on the card: its exchange mode at pipeline Q10's
shuffle join and K25's partition of a join side (HK13's partition mode,
or the host's numpy scatter of an earlier checkout), with the host syncs,
counted pulls and uploads and the launches of each call.

    python3 tinysql_tpu_torch/bench/exchange_bench.py [--root DIR]
        [--out FILE] [--ptxas]

Each device shape is first checked against the kernel's plain version
(byte for byte), then timed: the median of CUDA events around one call
(``ms``: the wrapper's host work included), the device time of one call
from a whole torch.profiler trace (``device_ms``), the kernels, memsets
and copies one call enqueues by name (``by_kernel``, ``launches``: their
count a call), the synchronizing CUDA calls of one call (``syncs``), and
the bound: the bytes the call must move at 3.35 TB/s.  Shapes (8 shards):

- exchange mode at Q10's two sides: 2^21 order rows (1.5M live, their
  o_custkey; 7 lanes of 28 bytes a row: three columns' value and NULL
  lanes and the valid lane) and 2^18 customer rows (150,000 live; 15
  lanes of 64 bytes);
- K25's partition of one side at Q18's probe side (~6M lineitem order
  keys, every row live) and NOT IN's two sides (1.5M order keys; ~3M
  lineitem keys of half the orders, 1..7 lines each): with HK13's
  partition mode its count and scatter calls (``partition``) and the
  upload of the key lane and live mask; with the host scatter
  (``_Partitioned``, an earlier checkout) its host time and the upload of
  its key and id blocks;
- K25's entry points end to end (host clock around a call, synchronized;
  best of three): the unique join and the member mode at Q18's shapes
  (6M keys probing 57 order keys) and NOT IN (1.5M order keys against
  ~3M lineitem keys), with their syncs and their pulls and uploads
  (counted, and their bytes).

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions are measured by
one script, in one call, on one card: run parent, change, change, parent,
each as a file.  ``--ptxas`` prints the registers, stack and spills of the
root's ``shard_exchange.cu``.  One JSON object per shape, the card's name
and power limit in each.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__:
    from .compact_bench import device_of
    from .expr_bench import card, cuda_ms, ptxas
    from .scalar_join_bench import syncs_of
else:  # run as a file, as --root needs
    from compact_bench import device_of
    from expr_bench import card, cuda_ms, ptxas
    from scalar_join_bench import syncs_of

SEED = 16
MEM_BPS = 3.35e12
SHARDS = 8


def bound_ms(nbytes: int) -> float:
    return nbytes / MEM_BPS * 1e3


def run(root: str, out, with_ptxas: bool) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from tinysql_tpu_torch.ops import kernels as K
    from tinysql_tpu_torch.ops import shardops
    from tinysql_tpu_torch.parallel import dist
    dev = torch.device("cuda", torch.cuda.current_device())
    name = card()
    rng = np.random.default_rng(SEED)
    on_card = hasattr(K, "shard_partition")  # else the host scatter

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

    def wall_ms(fn, reps=3):
        best = None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        return best

    if with_ptxas:
        ptxas(root, emit, ("shard_exchange",))
    with K.use_device(dev):
        # -- exchange mode at Q10's two sides -----------------------------
        n_c, n_o = 150_000, 1_500_000

        def exchange(what, keys, n_rows, nb, n_cols):
            kp = K.pad1(keys.astype(np.int64), nb)
            lanes = []
            for _ in range(n_cols):
                lanes += [(t(rng.integers(-(1 << 40), 1 << 40, nb)), 0),
                          (t(rng.random(nb) < 0.05), True)]
            lanes.append((t(np.arange(nb) < n_rows), False))
            kt = t(kp)
            cap = dist.shuffle_cap(kp, SHARDS, n_rows)
            fn = lambda: K.shard_exchange(  # noqa: E731
                kt, n_rows, lanes, cap, SHARDS)
            got, want = fn(), K.shard_exchange_plain(kt, n_rows, lanes, cap,
                                                     SHARDS)
            if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(got, want)):
                raise SystemExit(f"shard_exchange differs: {what}")
            width = sum(v.element_size() for v, _ in lanes)
            emit({"kernel": "shard_exchange",
                  "shape": f"{what}: {nb} rows ({n_rows} live), cap {cap}, "
                           f"{len(lanes)} lanes of {width} B a row",
                  **timed(fn),
                  "bound_ms": bound_ms(nb * (8 + width)
                                       + SHARDS * SHARDS * cap * width)})

        o_cust = rng.integers(1, n_c + 1, n_o)
        exchange("Q10 side 1 (orders)", o_cust, n_o, 1 << 21, 3)
        exchange("Q10 side 2 (customer)", np.arange(1, n_c + 1), n_c,
                 1 << 18, 7)

        # -- K25's partition of one side -------------------------------------
        okeys = (np.sort(rng.choice(6_000_000, n_o, replace=False))
                 + 1).astype(np.int64)
        lines = rng.integers(1, 8, n_o)
        lk18 = np.repeat(okeys, lines)[:6_000_000].astype(np.int64)
        chosen = okeys[rng.random(n_o) < 0.5]
        bk_in = np.repeat(chosen, rng.integers(1, 8, len(chosen))).astype(
            np.int64)

        def partition(what, keys):
            live = np.ones(len(keys), bool)
            n_in = len(keys)
            rec = {"kernel": "shard_partition" if on_card else
                   "_Partitioned (host)", "shape": f"{what}: {n_in} keys"}
            if on_card:
                up = {}

                def upload():
                    up["k"], up["l"] = K.h2d(keys), K.h2d(live)
                rec["upload_ms"] = wall_ms(upload)
                kd, ld = up["k"], up["l"]
                part = K.shard_partition(kd, ld, SHARDS)
                cap = K.bucket(max(int(part.counts.max()), 1))
                fn = lambda: K.shard_partition_scatter(  # noqa: E731
                    K.shard_partition(kd, ld, SHARDS), cap)
                want = K.shard_partition_scatter_plain(
                    K.shard_partition_plain(kd, ld, SHARDS), cap)
                if not all(torch.equal(a.view(torch.uint8),
                                       b.view(torch.uint8))
                           for a, b in zip(fn(), want)):
                    raise SystemExit(f"shard_partition differs: {what}")
                rec.update(timed(fn))
            else:
                got = {}

                def host():
                    p = shardops._Partitioned(keys, live, SHARDS)
                    got["p"] = p
                    got["k"], got["i"] = p.scatter(keys, 0), p.scatter_ids()
                rec["host_ms"] = wall_ms(host)
                cap = got["p"].cap
                rec["upload_ms"] = wall_ms(lambda: (
                    K.h2d(got["k"].reshape(-1)), K.h2d(got["i"].reshape(-1))))
            rec["cap"] = cap
            rec["bound_ms"] = bound_ms(n_in * 9 + SHARDS * cap * 16)
            emit(rec)

        partition("Q18 probe side (lineitem)", lk18)
        partition("NOT IN probe side (orders)", okeys)
        partition("NOT IN build side (lineitem)", bk_in)

        # -- K25's entry points end to end ----------------------------------
        mesh = dist.Mesh(SHARDS, dev)
        q18_build = rng.choice(okeys, 57, replace=False)

        def entry(what, fn):
            fn()
            snap = K.stats_snapshot()
            fn()
            now = K.stats_snapshot()
            emit({"entry": what, "wall_ms": wall_ms(fn), **syncs_of(K, fn),
                  "d2h_bytes": now["d2h_bytes"] - snap["d2h_bytes"],
                  "h2d_bytes": now["h2d_bytes"] - snap["h2d_bytes"],
                  "on_card_partition": on_card})

        z = lambda n: np.zeros(n, bool)  # noqa: E731
        n18 = len(lk18)
        entry("Q18 unique join (6M probe keys, 57 build keys)",
              lambda: shardops.unique_join_match_sharded(
                  mesh, (lk18, z(n18)), n18, (q18_build, z(57)), 57))
        entry("Q18 member (semi)",
              lambda: shardops.semi_join_match_sharded(
                  mesh, (lk18, z(n18)), n18, (q18_build, z(57)), 57))
        nb_in = len(bk_in)
        entry("NOT IN member (1.5M probe, ~3M build keys)",
              lambda: shardops.semi_join_match_sharded(
                  mesh, (okeys, z(n_o)), n_o, (bk_in, z(nb_in)), nb_in,
                  anti=True, null_aware=True))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("exchange_bench: no CUDA device", file=sys.stderr)
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
