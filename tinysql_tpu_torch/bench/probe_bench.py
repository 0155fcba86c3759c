"""HK10 semi_pick and HK6 dense_probe on the card, at the main path's
shapes, with the host syncs and the launches of each call.

    python3 tinysql_tpu_torch/bench/probe_bench.py [--root DIR]
        [--out FILE] [--ptxas]

Each shape is first checked against the kernel's plain version (exactly:
HK10's count and kept rows, HK6's valid mask and every gathered byte),
then timed: the median of CUDA events around one call (``ms``: the host
work between the launches and any wait for a pull included), the device
time of one call from a whole torch.profiler trace (``device_ms``), the
kernels, memsets and copies one call enqueues by name (``by_kernel``,
``launches``: their count a call), and the bound (the bytes the call must
move at 3.35 TB/s).  ``syncs`` counts the synchronizing CUDA calls of one
call (torch.cuda.set_sync_debug_mode), ``d2h`` its counted pulls.  Shapes:

- HK10 at NOT IN's SF=1 shape (1.5M orders in a 2^21 bucket probing
  ~3M lineitem keys in a 2^22 bucket; the membership from HK3's
  ``unique_match``) in semi, anti and NOT IN modes; with an empty build
  side (anti, NOT IN) and with one NULL build key (NOT IN);
- ``semi_join_match`` whole (upload, HK3, HK10, the pulls) at that shape
  as NOT IN (two pulls) and as a semi join keeping <= PRESENT_HEAD rows
  (one pull);
- HK6 at pipeline Q3's joins (chip_smoke.py's data): join 1 (2^21 probe
  rows, a 150,000-key table, a 2^18 build, 2 lanes) in inner, left, semi
  and anti modes; join 2 (2^21 probe rows against a 2^21-group
  aggregate, a 6M-entry table) inner; the composite mode (two keys,
  2^21 probe rows, a 2*10^6-entry table, 2^20 build rows) inner; and
  join 1's probe with one 1-, 4- or 8-byte lane, 16 lanes and 17 lanes
  (two launches); each HK6 shape also on the row path and on records,
  each forced (``forced``), where the checkout has both.

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions are measured by
one script, in one call, on one card: run parent, change, change, parent,
each as a file.  ``--ptxas`` prints the registers, stack and spills of the
root's ``semi_pick.cu`` and ``dense_probe.cu``.  One JSON object per
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
    from .probecases import RECORD_KINDS, records
    from .scalar_join_bench import syncs_of
else:  # run as a file, as --root needs
    from compact_bench import device_of
    from expr_bench import card, cuda_ms, ptxas
    from probecases import RECORD_KINDS, records
    from scalar_join_bench import syncs_of

SEED = 14
MEM_BPS = 3.35e12

#: HK10's modes: name -> (anti, null_aware)
SEMI_MODES = {"semi": (False, False), "anti": (True, False),
              "not in": (True, True)}


def hk10_bytes(mode: str, lv, rn, rv, n_kept: int) -> int:
    """What K8's ladder must move in ``mode``: the probe validity over
    every row and the membership and NULL bytes over the valid rows (NOT
    IN and semi read the NULL byte, anti does not need it), the build
    validity (anti, NOT IN) and, for NOT IN, the build NULL bytes over
    the valid build rows; the count and the kept rows written once."""
    n = int(lv.shape[0]) + int(lv.sum()) * (1 + (mode != "anti"))
    if mode != "semi":
        n += int(rv.shape[0])
    if mode == "not in":
        n += int(rv.sum())
    return n + 8 * (1 + n_kept)


def probe_bytes(K, keys, spec, lo, hi, tbl, blanes, gather: bool) -> int:
    """Bytes HK6 must move on this data: every key lane, its NULL flags
    and the validity read and the valid mask written per probe row; the
    table entry of each distinct in-range key and the build row it names
    (validity, and when gathering each lane's value and NULL flag) read
    once; each gathered lane's value and NULL flag written per probe
    row."""
    import torch
    nbp = int(keys[0][0].shape[0])
    key, ok = K.probe_keys_plain(keys, spec)
    ok = ok & (key >= lo) & (key <= hi)
    offs = torch.unique(key[ok] - lo)
    rows = int((tbl[offs.clamp(max=int(tbl.shape[0]) - 1)] >= 0).sum())
    lanes = blanes if gather else []
    build = 1 + sum(v.element_size() + (m is not None) for v, m in lanes)
    out = sum(v.element_size() + 1 for v, _m in lanes)
    kin = sum(8 + (m is not None) for _v, m in keys)
    return nbp * (kin + 1 + 1 + out) + 4 * len(offs) + rows * build


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
        return {"ms": cuda_ms(fn), **device_of(fn), **syncs_of(K, fn),
                **extra}

    if with_ptxas:
        ptxas(root, emit, ("semi_pick", "dense_probe"))
    with K.use_device(dev):
        # -- HK10 at NOT IN's SF=1 shape ----------------------------------
        n_ord = 1_500_000
        nl = K.bucket(n_ord)
        ok = np.arange(1, n_ord + 1)
        chosen = ok[rng.random(n_ord) < 0.5]
        bk = np.repeat(chosen, rng.integers(1, 8, len(chosen)))
        nr = K.bucket(len(bk))
        lk, lv = t(K.pad1(ok, nl), torch.int64), t(np.arange(nl) < n_ord)
        ln = t(np.zeros(nl, bool))
        rk, rv = t(K.pad1(bk, nr), torch.int64), t(np.arange(nr) < len(bk))
        rn = t(np.zeros(nr, bool))
        match = K.unique_match(lk, ln, lv, rk, rn, rv)

        def hk10(what, mode, m, ln_, lv_, rn_, rv_):
            anti, na = SEMI_MODES[mode]
            a = K.semi_pick(m, ln_, lv_, rn_, rv_, anti, na)
            b = K.semi_pick_plain(m, ln_, lv_, rn_, rv_, anti, na)
            n = int(a[0])
            if n != int(b[0]) or not torch.equal(a[:1 + n], b[:1 + n]):
                raise SystemExit(f"semi_pick differs: {what} {mode}")
            emit({"kernel": "semi_pick", "shape": f"{what}, {mode}",
                  "kept": n,
                  **timed(lambda: K.semi_pick(m, ln_, lv_, rn_, rv_, anti,
                                              na)),
                  "bound_ms": hk10_bytes(mode, lv_, rn_, rv_, n) / MEM_BPS
                  * 1e3})

        shape10 = f"NOT IN SF=1: probe 2^21 ({n_ord}), build 2^22 " \
                  f"({len(bk)})"
        for mode in SEMI_MODES:
            hk10(shape10, mode, match, ln, lv, rn, rv)
        z16 = t(np.zeros(16, bool))
        m0 = K.unique_match(lk, ln, lv, t(np.zeros(16), torch.int64), z16,
                            z16)
        for mode in ("anti", "not in"):
            hk10("probe 2^21, empty build", mode, m0, ln, lv, z16, z16)
        rn1 = rn.clone()
        rn1[12345] = True
        m1 = K.unique_match(lk, ln, lv, rk, rn1, rv)
        hk10(shape10 + ", one NULL build key", "not in", m1, ln, lv, rn1, rv)
        del m0, m1, rn1

        # -- semi_join_match whole ----------------------------------------
        hl = (np.asarray(ok), np.zeros(n_ord, bool))
        hr = (np.asarray(bk), np.zeros(len(bk), bool))
        for what, rkey, anti, na, want in (
                ("NOT IN", hr, True, True,
                 np.nonzero(~np.isin(ok, bk))[0]),
                ("semi, 3,000 kept", (ok[:3000], np.zeros(3000, bool)),
                 False, False, np.arange(3000))):
            fn = lambda: K.semi_join_match(  # noqa: E731
                hl, n_ord, rkey, len(rkey[0]), anti=anti, null_aware=na)
            got = fn()
            if not np.array_equal(got, want):
                raise SystemExit(f"semi_join_match differs: {what}")
            emit({"kernel": "semi_join_match", "shape":
                  f"{what}: probe {n_ord}, build {len(rkey[0])}",
                  "kept": len(want), **timed(fn)})
        del match, lk, rk, lv, rv, ln, rn

        # -- HK6 ------------------------------------------------------------
        def hk6(what, modes, keys, spec, pv, lo, hi, tbl, bv, bl):
            for mode in modes:
                if spec is None:
                    fn = lambda: K.dense_probe(  # noqa: E731
                        keys[0][0], keys[0][1], pv, lo, hi, tbl, bv, bl,
                        mode)
                    plain = K.dense_probe_plain(keys[0][0], keys[0][1], pv,
                                                lo, hi, tbl, bv, bl, mode)
                else:
                    fn = lambda: K.dense_probe_multi(  # noqa: E731
                        keys, spec, pv, tbl, bv, bl, mode)
                    plain = K.dense_probe_multi_plain(keys, spec, pv, tbl,
                                                      bv, bl, mode)
                a = fn()
                ok_ = torch.equal(a[0], plain[0]) and len(a[1]) == len(
                    plain[1])
                for (x, xn), (y, yn) in zip(a[1], plain[1]):
                    ok_ = ok_ and torch.equal(xn, yn) and torch.equal(
                        x.view(torch.uint8), y.view(torch.uint8))
                if not ok_:
                    raise SystemExit(f"dense_probe differs: {what} {mode}")
                gather = mode in ("inner", "left")
                emit({"kernel": "dense_probe", "shape": f"{what}, {mode}",
                      "valid_out": int(a[0].sum()), **timed(fn),
                      "bound_ms": probe_bytes(K, keys, spec, lo, hi, tbl,
                                              bl, gather) / MEM_BPS * 1e3,
                      **forced(fn, a)})

        def forced(fn, want):
            """Where the checkout has HK6's records (its rule,
            kernels._dense_records): the call on each path forced (each
            byte-equal to ``want``), the measurement behind the rule."""
            if not hasattr(K, "_dense_records"):
                return {}
            got = {}
            for kind in RECORD_KINDS:
                with records(K, kind):
                    b = fn()
                    if not torch.equal(b[0], want[0]) or not all(
                            torch.equal(x.view(torch.uint8),
                                        y.view(torch.uint8))
                            and torch.equal(xn, yn)
                            for (x, xn), (y, yn) in zip(b[1], want[1])):
                        raise SystemExit(f"dense_probe differs on the "
                                         f"{kind} path")
                    got[kind] = {"ms": cuda_ms(fn),
                                 "device_ms": device_of(fn)["device_ms"]}
            return {"forced": got}

        np1, nbb1 = 1 << 21, 1 << 18
        zero1 = t(np.zeros(np1, bool))
        keys1 = [(t(rng.integers(1, 150_001, np1), torch.int64), zero1)]
        pv1 = t((np.arange(np1) < 1_500_000) & (rng.random(np1) < 0.486))
        tbl1 = t(np.arange(150_000, dtype=np.int32))
        bv1 = t((np.arange(nbb1) < 150_000) & (rng.random(nbb1) < 0.2))
        zb1 = t(np.zeros(nbb1, bool))
        bl1 = [(t(np.arange(1, nbb1 + 1), torch.int64), zb1),
               (t(rng.integers(0, 5, nbb1), torch.int64), zb1)]
        hk6("Q3 join 1: probe 2^21, table 150,000, build 2^18, 2 lanes",
            ("inner", "left", "semi", "anti"), keys1, None, pv1, 1, 150_000,
            tbl1, bv1, bl1)
        lanes = {
            "one 1-byte lane": [(t(rng.random(nbb1) < 0.5), zb1)],
            "one 4-byte lane": [(t(rng.integers(0, 9, nbb1).astype(
                np.int32)), t(rng.random(nbb1) < 0.1))],
            "one 8-byte lane": [(t(rng.normal(size=nbb1)), None)],
            "16 lanes": [(t(rng.integers(0, 1 << 40, nbb1), torch.int64),
                          zb1)] * 16,
            "17 lanes": [(t(rng.integers(0, 1 << 40, nbb1), torch.int64),
                          zb1)] * 17}
        for what, bl in lanes.items():
            hk6(f"Q3 join 1's probe, {what}", ("inner",), keys1, None, pv1,
                1, 150_000, tbl1, bv1, bl)
        del lanes

        okeys = np.sort(rng.choice(6_000_000, 1_500_000, replace=False)) + 1
        tbl2 = np.full(int(okeys[-1] - okeys[0] + 1), -1, np.int32)
        tbl2[okeys - okeys[0]] = np.arange(1_500_000, dtype=np.int32)
        keys2 = [(t(K.pad1(rng.permutation(okeys), np1), torch.int64),
                  zero1)]
        pv2 = pv1 & t(rng.random(np1) < 0.2)
        ngb = 1 << 21
        bv2 = t((np.arange(ngb) < 1_500_000) & (rng.random(ngb) < 0.955))
        bl2 = [(t(K.pad1(okeys, ngb), torch.int64), t(np.zeros(ngb, bool))),
               (t(np.round(rng.uniform(900.0, 105000.0, ngb), 2)),
                t(rng.random(ngb) < 0.045))]
        hk6("Q3 join 2: probe 2^21, table 6M, build 2^21, 2 lanes",
            ("inner",), keys2, None, pv2, int(okeys[0]), int(okeys[-1]),
            t(tbl2), bv2, bl2)
        del keys2, bl2, tbl2

        spec6 = [(1, 4000, 500), (1, 500, 1)]
        nbb6 = 1 << 20
        comp6 = rng.choice(4000 * 500, nbb6, replace=False)
        tbl6 = np.full(4000 * 500, -1, np.int32)
        tbl6[comp6] = np.arange(nbb6, dtype=np.int32)
        keys6 = [(t(rng.integers(1, 4211, np1), torch.int64),
                  t(rng.random(np1) < 0.05)),
                 (t(rng.integers(1, 526, np1), torch.int64), None)]
        bl6 = [(t(rng.integers(0, 1 << 40, nbb6), torch.int64),
                t(np.zeros(nbb6, bool))),
               (t(rng.normal(size=nbb6)), t(rng.random(nbb6) < 0.1))]
        hk6("composite: probe 2^21, 2 keys, table 2*10^6, build 2^20, "
            "2 lanes", ("inner",), keys6, spec6, t(rng.random(np1) < 0.9),
            0, 4000 * 500 - 1, t(tbl6), t(rng.random(nbb6) < 0.8), bl6)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_bench: no CUDA device", file=sys.stderr)
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
