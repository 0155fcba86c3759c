"""HK12 shard_probe (probe, member and count modes) and HK8 csr_expand
(inner, LEFT and shard mode) on the card, at the main path's shapes, with
the host syncs and the launches of each call.

    python3 tinysql_tpu_torch/bench/meshjoin_bench.py [--root DIR]
        [--out FILE] [--ptxas]

Each shape is first checked against the kernel's plain version (byte for
byte), then timed: the median of CUDA events around one call (``ms``:
the wrapper's host work included), the device time of one call from a
whole torch.profiler trace (``device_ms``), the kernels, memsets and
copies one call enqueues by name (``by_kernel``, ``launches``: their
count a call), the synchronizing CUDA calls of one call (``syncs``) and
the bound: the larger of the bytes the call must move at 3.35 TB/s and
its compares at 67 T/s, as chip_smoke.py counts them.  Shapes (8 shards,
K25's partition of ops/shardops.py over the keys):

- HK12 at per-op mesh Q3's joins (join 1: ~727,000 order keys probing
  ~30,000 unique customer keys; join 2: ~147,000 keys probing ~727,000
  unique order keys), at pipeline Q10's shuffle join (1.5M o_custkey
  probing 150,000 customers in the exchange's blocks of 2^19 and 2^16
  slots a shard), at Q18's (6M lineitem keys probing 57 order keys),
  and its member mode at NOT IN's (1.5M order keys probing ~3M lineitem
  keys: half the orders, 1..7 lines each);
- HK12's count mode at K26's step (8 x 2^20 rows: ~6M lineitem order
  keys in order, probing 1.5M sorted order keys);
- HK8 at pipeline Q13's join (150,000 customers probing 1.5M orders
  through the o_custkey group index, one probe and two build lanes) as
  LEFT and inner, and in shard mode over 8 shards (a 2^19-slot bucket a
  shard).

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions are measured by
one script, in one call, on one card: run parent, change, change, parent,
each as a file.  ``--ptxas`` prints the registers, stack and spills of the
root's ``shard_join.cu`` and ``csr_expand.cu``.  One JSON object per
shape, the card's name and power limit in each.  Exits 2 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__:
    from .compact_bench import device_of
    from .expr_bench import card, cuda_ms, ptxas
    from .scalar_join_bench import syncs_of
else:  # run as a file, as --root needs
    from compact_bench import device_of
    from expr_bench import card, cuda_ms, ptxas
    from scalar_join_bench import syncs_of

SEED = 15
MEM_BPS = 3.35e12
OPS_PS = 67e12
SHARDS = 8


def bound_ms(nbytes: int, ops: int) -> float:
    return max(nbytes / MEM_BPS, ops / OPS_PS) * 1e3


def run(root: str, out, with_ptxas: bool) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from tinysql_tpu_torch.executor import devpipe
    from tinysql_tpu_torch.ops import kernels as K
    from tinysql_tpu_torch.ops import shardops
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
        ptxas(root, emit, ("shard_join", "csr_expand"))
    with K.use_device(dev):
        # -- HK12 probe and member modes ----------------------------------
        def blocks(lk, rk):
            """Both sides scattered as the mesh tier does: flat [n * cap]
            key and id lanes on the card."""
            if not hasattr(shardops, "partition_sides"):  # the host scatter
                pp = shardops._Partitioned(lk, np.ones(len(lk), bool),
                                           SHARDS)
                pb = shardops._Partitioned(rk, np.ones(len(rk), bool),
                                           SHARDS)
                return (t(pp.scatter(lk, 0).reshape(-1)),
                        t(pp.scatter_ids().reshape(-1)),
                        t(pb.scatter(rk, 0).reshape(-1)),
                        t(pb.scatter_ids().reshape(-1)))
            (p, b), _ = shardops.partition_sides(
                SHARDS, ((lk, np.ones(len(lk), bool), len(lk)),
                         (rk, np.ones(len(rk), bool), len(rk))))
            return p + b

        def exchanged(keys, cap):
            """One side as the shuffle join's exchange leaves it: flat
            [n * cap] key and id lanes, each shard's rows first."""
            dest = shardops.hash_partition(keys, 0, SHARDS)
            order = np.argsort(dest, kind="stable")
            starts = np.searchsorted(dest[order], np.arange(SHARDS))
            rank = np.arange(len(keys)) - starts[dest[order]]
            slot = dest[order] * cap + rank
            k = np.zeros(SHARDS * cap, np.int64)
            ids = np.full(SHARDS * cap, -1, np.int64)
            k[slot], ids[slot] = keys[order], order
            return t(k), t(ids)

        def hk12(what, lk, rk, member, caps=None):
            pk, pid, bk, bid = (blocks(lk, rk) if caps is None else
                                exchanged(lk, caps[0]) + exchanged(rk,
                                                                   caps[1]))
            bord, perm = shardops._build_order(SHARDS, bk, bid)
            fn = lambda: K.shard_probe(  # noqa: E731
                pk, pid, bord, bid, perm, SHARDS, member=member)

            def flat(x):
                return [x] if member else list(x)
            want = flat(K.shard_probe_plain(pk, pid, bord, bid, perm,
                                            SHARDS, member))

            def check(got):
                if not all(torch.equal(a, b) for a, b in zip(flat(got),
                                                             want)):
                    raise SystemExit(f"shard_probe differs: {what}")
            check(fn())
            npb, nbb = int(pk.shape[0]), int(bk.shape[0])
            steps = max(1, (nbb // SHARDS - 1).bit_length())
            hits = int(flat(fn())[0].sum())
            # probe slots' key, id and outputs; the run's bord and perm
            # once; bid at the hit slots, each once (probe mode)
            nbytes = (npb * (8 + 8 + 1 + (0 if member else 8)) + nbb * 16
                      + (0 if member else min(hits, nbb) * 8))
            rec = {"kernel": "shard_member" if member else "shard_probe",
                   "shape": f"{what}: probe {npb} slots (cap "
                            f"{npb // SHARDS}), build {nbb} (cap "
                            f"{nbb // SHARDS})",
                   "hits": hits, **timed(fn),
                   "bound_ms": bound_ms(nbytes, npb * steps)}
            emit(rec)

        n_c, n_o = 150_000, 1_500_000
        okeys = np.sort(rng.choice(6_000_000, n_o, replace=False)) + 1
        seg = rng.permutation(n_c)[:30_000] + 1  # BUILDING customers
        o_cust = rng.integers(1, n_c + 1, n_o)
        early = rng.random(n_o) < 0.485  # o_orderdate < 1995-03-15
        hk12("Q3 join 1", o_cust[early].astype(np.int64),
             seg.astype(np.int64), False)
        j1 = okeys[early & np.isin(o_cust, seg)]
        hk12("Q3 join 2", j1.astype(np.int64),
             okeys[early].astype(np.int64), False)
        hk12("Q10 join 1 (shuffle)", o_cust.astype(np.int64),
             np.arange(1, n_c + 1, dtype=np.int64), False,
             caps=(1 << 19, 1 << 16))
        lines = rng.integers(1, 8, n_o)
        lk18 = np.repeat(okeys, lines)[:6_000_000].astype(np.int64)
        hk12("Q18", lk18, rng.choice(okeys, 57, replace=False).astype(
            np.int64), False)
        chosen = okeys[rng.random(n_o) < 0.5]
        bk_in = np.repeat(chosen, rng.integers(1, 8, len(chosen)))
        hk12("NOT IN", okeys.astype(np.int64), bk_in.astype(np.int64), True)
        del lk18, bk_in

        # -- HK12 count mode at K26's step ---------------------------------
        rows = 1 << 20
        lk = np.repeat(okeys, lines)[:SHARDS * rows]
        n_l = len(lk)
        lk = t(K.pad1(lk.astype(np.int64), SHARDS * rows))
        lv = t(np.arange(SHARDS * rows) < n_l)
        rs = t(okeys.astype(np.int64))
        fn = lambda: K.shard_count(lk, lv, rs, SHARDS)  # noqa: E731
        a, b = fn(), K.shard_count_plain(lk, lv, rs, SHARDS)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise SystemExit("shard_count differs: K26")
        nl, nr = SHARDS * rows, n_o
        emit({"kernel": "shard_count",
              "shape": f"K26: {SHARDS} x {rows} rows ({n_l} valid), {nr} "
                       f"sorted build keys", "matches": int(a[0].sum()),
              **timed(fn),
              "bound_ms": bound_ms(nl * 17 + nr * 8 + SHARDS * 8,
                                   nl * 2 * max(1, (nr - 1).bit_length()))})
        del lk, lv, rs

        # -- HK8 at Q13's join ---------------------------------------------
        nbp, nbb = K.bucket(n_c), K.bucket(n_o)
        gi = devpipe.GroupIndex([(o_cust.astype(np.int64),
                                  np.zeros(n_o, bool))])
        ngb = K.bucket(gi.n_groups)
        zeros = lambda n: t(np.zeros(n, bool))  # noqa: E731
        ckey = t(K.pad1(np.arange(1, n_c + 1, dtype=np.int64), nbp))
        args = (t(K.pad1(gi.order, nbb)),
                t(K.pad1(gi.ends, ngb, fill=n_o - 1)), gi.n_groups, n_o,
                t(np.arange(nbb) < n_o), t(gi.pos_table()), gi.lo, gi.hi,
                [(ckey, zeros(nbp))], None, t(np.arange(nbp) < n_c))
        plns = [(ckey, zeros(nbp))]
        blns = [(t(K.pad1(okeys.astype(np.int64), nbb)), zeros(nbb)),
                (t(K.pad1(o_cust.astype(np.int64), nbb)), zeros(nbb))]

        def hk8(what, outer, ob, shards):
            fn = lambda: K.csr_expand(  # noqa: E731
                *args, outer, ob, plns, blns, shards=shards)
            a = fn()
            b = K.csr_expand_plain(*args, outer, ob, plns, blns,
                                   shards=shards)
            ok = torch.equal(a[0], b[0])
            for (x, xn), (y, yn) in zip(a[1] + a[2], b[1] + b[2]):
                ok = ok and torch.equal(xn, yn) and torch.equal(
                    x.view(torch.uint8), y.view(torch.uint8))
            if not ok:
                raise SystemExit(f"csr_expand differs: {what}")
            total = int(a[0].sum())
            nvp = n_c
            lane = 9  # an int64 lane and its NULL flag
            nbytes = (n_o * 9 + 8 * gi.n_groups + nbp + nvp * 4 + nvp * lane
                      + nvp * lane + 2 * lane * n_o + ob * shards
                      + total * 3 * lane)
            emit({"kernel": "csr_expand" if shards == 1
                  else "csr_expand_shard",
                  "shape": f"Q13 {what}: probe 2^18 ({n_c}), build 2^21 "
                           f"({n_o}, {gi.n_groups} groups), ob {ob} a shard "
                           f"x {shards}, 1 + 2 lanes, {total} slots",
                  **timed(fn), "bound_ms": bound_ms(nbytes, total)})

        hk8("LEFT", True, 1 << 21, 1)
        hk8("inner", False, 1 << 21, 1)
        hk8("LEFT, shard mode", True, 1 << 19, SHARDS)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("meshjoin_bench: no CUDA device", file=sys.stderr)
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
