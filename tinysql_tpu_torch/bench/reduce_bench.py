"""HK2 segment_reduce, HK2b and HK5 csr_reduce on the card: the
few-segment reductions of TPC-H Q1 and their neighbours.

    python3 tinysql_tpu_torch/bench/reduce_bench.py [--root DIR]
        [--out FILE] [--sizes 16,...,23] [--ptxas]

Each shape is first checked against the kernel's plain version
(integers, counts and first rows exactly, float sums within 1e-6
relative), then timed: the median of CUDA events around one wrapper call
(``ms``), the device time of one call from a whole torch.profiler trace
(``device_ms``, the Q1 shapes), and the bound (the bytes the call must
move at 3.35 TB/s).  Shapes:

- Q1 at SF=1: 2^23 rows (98% valid), 16 segments, 7 float64 SUM lanes
  and 3 counts, over 12 uniform ids (the shape of earlier records) and
  over TPC-H Q1's 4 groups at their SF=1 frequencies; HK2b at B = 4 over
  the 4 groups (each member its own valid mask and SUM values, the NULL
  masks shared), beside 4 solo calls; HK5 over ~6M lineitem rows grouped
  by the 4 and by 6 keys through a group index (a stable argsort), beside
  the same rows as HK2 ids;
- the neighbours that must not get slower: HK2's sort regime at Q3's
  shape (2^21 segments) and HK5's skewed many-group index (one group of
  90% of the rows);
- a sweep: n = 2^16 .. 2^23 rows x ns in {1, 4, 16, 64, 65} (65: the
  sort regime just past kSmallSeg), Q1's lanes, for HK2, and for HK5
  with as many groups.

Beside each Q1 shape a partial call: ``index_add_`` of the stacked SUM
lanes over the live rows' ids (``partial_index_add_ms``: it computes the
sums only, not the table).

``--root DIR`` imports ``tinysql_tpu_torch`` from another checkout (an
earlier commit unpacked beside this one), so two versions are measured
by one script, in one call, on one card; run the script as a file then.
``--ptxas`` prints each kernel's registers, stack and spills of the
root's ``segment_reduce.cu`` and ``csr_reduce.cu``.  One JSON object per
shape, the card's name and power limit in each.  Exits 2 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__:
    from .expr_bench import card, cuda_ms, device_ms, ptxas
else:  # run as a file, as --root needs
    from expr_bench import card, cuda_ms, device_ms, ptxas

SEED = 11
MEM_BPS = 3.35e12
ROWS = 1 << 23
SIZES = tuple(range(16, 24))
#: TPC-H Q1's groups (l_returnflag, l_linestatus) at SF=1: A|F, N|F, N|O,
#: R|F counts of the query's answer (1,478,493; 38,854; 2,920,374;
#: 1,478,870)
Q1_FREQ = (1_478_493, 38_854, 2_920_374, 1_478_870)
#: the 6-key index of earlier records (chip_smoke.py's HK5 Q1 case)
SIX_FREQ = (0.25, 0.007, 0.25, 0.24, 0.003, 0.25)


def q1_lanes(t, rng, n, nmem=None, counts=(5, 7, 9)):
    """Q1's ten lanes: 7 float64 SUMs (per member [B, n] when nmem) and 3
    counts, every NULL mask a shared all-false [n] mask, as the fused
    program's lanes are."""
    import numpy as np
    lanes = []
    for j in range(10):
        m = t(np.zeros(n, bool))
        if j in counts:
            lanes.append((None, m, "count"))
        else:
            shp = n if nmem is None else (nmem, n)
            lanes.append((t(np.round(rng.uniform(900.0, 105000.0, shp), 2)),
                          m, "sum"))
    return lanes


def reduce_bytes(valid, lanes, rows: int, gid_bytes: int = 8) -> int:
    """Each member's valid mask over every row, then over the rows valid
    in it its own lanes' values and NULL bytes, over the rows valid in
    any member the shared lanes and the group ids, and each table
    written once (rows int64 a member)."""
    v = valid if valid.dim() == 2 else valid[None]
    nmem, n = int(v.shape[0]), int(v.shape[1])
    nv = [int(x) for x in v.sum(dim=1).tolist()]
    nu = int(v.any(dim=0).sum())
    shared, own = gid_bytes, 0
    for x, m, _op in lanes:
        for a, size in ((x, 8), (m, 1)):
            if a is None:
                continue
            if a.dim() == 2:
                own += size
            else:
                shared += size
    return nu * shared + sum(n + k * own for k in nv) + nmem * 8 * rows


def csr_bytes(lanes, n_rows: int, ng: int, ngb: int) -> int:
    """HK5: order and valid over the live rows, each lane's values and
    NULL mask over them, ends over the real groups, the table written."""
    per_row = 8 + 1 + sum((0 if v is None else 8) + (m is not None)
                          for v, m, _op in lanes)
    return n_rows * per_row + 8 * ng + 8 * (2 + 2 * len(lanes)) * ngb


def check(got, want, lanes, what: str) -> None:
    import torch
    if got.shape != want.shape:
        raise SystemExit(f"{what}: shape {tuple(got.shape)} vs "
                         f"{tuple(want.shape)}")
    for r in range(got.shape[-2] if got.dim() == 3 else got.shape[0]):
        a, b = (got[:, r], want[:, r]) if got.dim() == 3 else (got[r],
                                                                want[r])
        j = (r - 2) // 2
        if r >= 2 and r % 2 == 0 and lanes[j][2] == "sum" \
                and lanes[j][0] is not None \
                and lanes[j][0].dtype == torch.float64:
            if not torch.allclose(a.view(torch.float64),
                                  b.view(torch.float64), rtol=1e-6,
                                  atol=1e-9, equal_nan=True):
                raise SystemExit(f"{what}: float row {r} beyond 1e-6")
        elif not torch.equal(a, b):
            raise SystemExit(f"{what}: row {r} differs")


def index_of(K, t, keys, nb):
    """A group index over ``keys`` (a stable argsort), padded to nb
    positions and a bucket of groups."""
    import numpy as np
    import torch
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0]
    return (t(K.pad1(order.astype(np.int64), nb), torch.int64),
            t(K.pad1(ends.astype(np.int64), K.bucket(len(ends)),
                     fill=len(keys) - 1), torch.int64), len(ends))


def partial_sums(gid, valid, lanes):
    """index_add_ of the stacked SUM lanes over the live rows' ids."""
    import torch
    vals = torch.stack([v for v, _m, op in lanes if op == "sum"], dim=1)
    live = valid.nonzero().squeeze(1)
    ns = int(gid.max()) + 1

    def call():
        return torch.zeros((ns, vals.shape[1]), dtype=vals.dtype,
                           device=vals.device).index_add_(
            0, gid[live], vals[live])
    return call


def run(root: str, sizes, out, with_ptxas: bool) -> None:
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

    def hk2(what, gid, valid, ns, lanes, trace=False, **extra):
        got = K.segment_reduce(gid, valid, ns, lanes)
        check(got, K.segment_reduce_plain(gid, valid, ns, lanes), lanes,
              what)
        if not torch.equal(got, K.segment_reduce(gid, valid, ns, lanes)):
            raise SystemExit(f"{what}: two launches differ")
        rec = {"kernel": "segment_reduce", "shape": what,
               "ms": cuda_ms(lambda: K.segment_reduce(gid, valid, ns,
                                                      lanes)),
               "bound_ms": reduce_bytes(valid, lanes,
                                        (2 + 2 * len(lanes)) * ns)
               / MEM_BPS * 1e3}
        if trace:
            rec["device_ms"] = device_ms(lambda: K.segment_reduce(
                gid, valid, ns, lanes))[0]
        rec.update(extra)
        emit(rec)

    def hk5(what, order, ends, valid, lanes, n_rows, ng, trace=False,
            **extra):
        got = K.csr_reduce(order, ends, valid, lanes, n_rows, ng)
        check(got, K.csr_reduce_plain(order, ends, valid, lanes, n_rows,
                                         ng), lanes, what)
        if not torch.equal(got, K.csr_reduce(order, ends, valid, lanes,
                                             n_rows, ng)):
            raise SystemExit(f"{what}: two launches differ")
        rec = {"kernel": "csr_reduce", "shape": what,
               "ms": cuda_ms(lambda: K.csr_reduce(order, ends, valid, lanes,
                                                  n_rows, ng)),
               "bound_ms": csr_bytes(lanes, n_rows, ng, int(ends.shape[0]))
               / MEM_BPS * 1e3}
        if trace:
            rec["device_ms"] = device_ms(lambda: K.csr_reduce(
                order, ends, valid, lanes, n_rows, ng))[0]
        rec.update(extra)
        emit(rec)

    if with_ptxas:
        ptxas(root, emit, ("segment_reduce", "csr_reduce"))
    with K.use_device(dev):
        n = ROWS
        valid = t(rng.random(n) < 0.98)
        lanes = q1_lanes(t, rng, n)
        freq = np.array(Q1_FREQ) / sum(Q1_FREQ)
        for label, gid in (
                ("Q1 n=2^23 16 segments, 12 uniform ids",
                 t(rng.integers(0, 12, n), torch.int64)),
                ("Q1 n=2^23 16 segments, TPC-H's 4 groups",
                 t(rng.choice(4, n, p=freq).astype(np.int64)))):
            hk2(label, gid, valid, 16, lanes, trace=True,
                partial_index_add_ms=cuda_ms(partial_sums(gid, valid,
                                                          lanes)))
        # HK2b: 4 members over TPC-H's 4 groups
        nmem = 4
        validb = t(rng.random((nmem, n)) < 0.98)
        lanesb = q1_lanes(t, rng, n, nmem)
        got = K.segment_reduce_batched(gid, validb, 16, lanesb)
        check(got, K.segment_reduce_batched_plain(gid, validb, 16,
                                                     lanesb), lanesb,
              "HK2b Q1 B=4")
        for b in range(nmem):
            if not torch.equal(got[b], K.segment_reduce(
                    gid, validb[b], 16, K._member_lanes(lanesb, b))):
                raise SystemExit(f"HK2b Q1 B=4 member {b}: not solo")
        emit({"kernel": "segment_reduce_batched",
              "shape": "Q1 B=4 n=2^23 16 segments, TPC-H's 4 groups",
              "ms": cuda_ms(lambda: K.segment_reduce_batched(
                  gid, validb, 16, lanesb)),
              "device_ms": device_ms(lambda: K.segment_reduce_batched(
                  gid, validb, 16, lanesb))[0],
              "solo_x4_ms": cuda_ms(lambda: [K.segment_reduce(
                  gid, validb[b], 16, K._member_lanes(lanesb, b))
                  for b in range(nmem)]),
              "bound_ms": reduce_bytes(validb, lanesb, 22 * 16) / MEM_BPS
              * 1e3})
        del validb, lanesb, got
        # HK5: lineitem's ~6M rows (1-7 lines an order) by 4 and 6 keys
        lens = rng.integers(1, 8, 1_500_000)
        rows = int(lens.sum())
        valid5 = t(K.pad1(rng.random(rows) < 0.98, n))
        for label, p in (("TPC-H's 4 groups", freq),
                         ("6 keys", np.array(SIX_FREQ) / sum(SIX_FREQ))):
            key = rng.choice(len(p), rows, p=p)
            order, ends, ng = index_of(K, t, key, n)
            gid5 = t(K.pad1(key.astype(np.int64), n, fill=16))
            hk5(f"Q1 {rows} rows, {label}", order, ends, valid5, lanes,
                rows, ng, trace=True,
                same_rows_hk2_ms=cuda_ms(lambda: K.segment_reduce(
                    gid5, valid5, 16, lanes)),
                partial_index_add_ms=cuda_ms(partial_sums(
                    gid5[:rows], valid5[:rows],
                    [(v[:rows], m, op) for v, m, op in lanes
                     if op == "sum"])))
        # the neighbours: HK5 skewed many groups, HK2's sort regime (Q3)
        q3 = [(t(np.round(rng.uniform(900.0, 105000.0, n), 2)),
               t(np.zeros(n, bool)), "sum")]
        keysk = np.where(rng.random(rows) < 0.9, 0,
                         rng.integers(0, 1 << 21, rows))
        order, ends, ng = index_of(K, t, keysk, n)
        hk5("skew90 many groups (one of 90%)", order, ends, valid5, q3,
            rows, ng)
        gid3 = t(np.concatenate([np.repeat(np.arange(1_500_000), 4),
                                 np.zeros(n - 6_000_000, np.int64)]))
        valid3 = t(np.concatenate([rng.random(6_000_000) < 0.54,
                                   np.zeros(n - 6_000_000, bool)]))
        hk2("Q3 sort regime n=2^23 2^21 segments", gid3, valid3, 1 << 21,
            q3)
        del q3, gid3, valid3
        # the sweep
        for e in sizes:
            m = 1 << e
            vm = valid[:m]
            lm = [(None if v is None else v[:m], x[:m], op)
                  for v, x, op in lanes]
            for ns in (1, 4, 16, 64, 65):
                gid = t(rng.integers(0, ns, m), torch.int64)
                hk2(f"sweep n=2^{e} ns={ns}", gid, vm, ns, lm, rows=m, groups=ns)
                if ns <= 64:
                    order, ends, ng = index_of(
                        K, t, gid.cpu().numpy(), m)
                    hk5(f"sweep n=2^{e} ng={ns}", order, ends, vm, lm, m,
                        ng, rows=m, groups=ns)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="log2 of the sweep's row counts, comma-separated")
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("reduce_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(a.root)
    sizes = [int(x) for x in a.sizes.split(",") if x]
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            run(root, sizes, f, a.ptxas)
    else:
        run(root, sizes, None, a.ptxas)
    return 0


if __name__ == "__main__":
    sys.exit(main())
