"""Mesh-sharded operator tier: the port of tinysql_tpu/ops/shardops.py.

The reference runs each sharded family as a ``shard_map`` program over N
devices.  The port's mesh is N virtual shards on one device
(parallel/dist.py): shard s owns the contiguous row range
``[s * nb / N, (s + 1) * nb / N)``, per-shard work is an explicit index
range plus a kernel launch, and the psum / pmin / pmax of the partial
states is HK11 (:func:`kernels.shard_merge`).

- ``fused_scalar_aggregate_sharded`` (K25) — partial -> final global
  aggregation: HK7 evaluates the filter mask and the argument lanes,
  HK1 reduces each shard's rows (one launch per shard), HK11 merges.
  Stacked batch rounds over a sharded program are not ported (ROADMAP
  item 7): this entry point is not batchable, so a member runs solo.
- ``unique_join_match_sharded`` (K25) — partitioned build/probe: HK13's
  partition mode (:func:`kernels.shard_partition`, the spill
  partitioner's depth-0 hash of :func:`hash_partition` on the card)
  scatters both sides' LIVE rows into per-shard blocks, HK4 sorts every
  build block by (shard, key, liveness) in one launch, HK12
  (:func:`kernels.shard_probe`) probes each shard's block, the results go
  back to probe order on the card through the id lane, and one pull
  brings them to the host — byte-identical to the unsharded join.
- ``semi_join_match_sharded`` (K25 member) — the same partition blocks
  and build sort, HK12's member mode probes them, and the host applies
  the semi / anti / NOT IN ladder over the pulled membership bits.
- ``sort_permutation_sharded`` / ``top_k_sharded`` (K25 sort, top-k) —
  single-key orders over the total-order score: HK4 sorts each shard's
  rows (the shard id as the leading lane; per shard only its top kb for
  a top-k), HK14 (:func:`kernels.shard_rank`) merges the runs into the
  exact global order, ties to the lower row index.

Each keeps the reference's gates, which return None (run the
single-device kernel) for the calls the reference runs single-device.

``STATS`` is written only through this module's locked accessors.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from .. import fail
from ..obs import context as _obs
from ..parallel import dist
from . import kernels, progcache
from .batching import split_exact

# ---- observable state ------------------------------------------------------

_mu = threading.Lock()
#: process-cumulative sharded-tier economics (rendered on /metrics,
#: sampled into the time-series ring): shard_rounds = sharded dispatches,
#: shard_rows_hwm = per-shard row high-water mark, shard_exchange_bytes =
#: bytes scattered into partition blocks, shard_skew_retries = sharded
#: attempts abandoned for skew, shard_stacked_rounds = B-stacked
#: dispatches over sharded programs (none in the port yet: item 7)
STATS: Dict[str, float] = {
    "shard_rounds": 0, "shard_rows_hwm": 0, "shard_exchange_bytes": 0,
    "shard_skew_retries": 0, "shard_stacked_rounds": 0,
}

def _record(key: str, n: float = 1) -> None:
    with _mu:
        STATS[key] = STATS.get(key, 0) + n
    _obs.record(key, n)


def _hwm(key: str, n: float) -> None:
    with _mu:
        if n > STATS.get(key, 0):
            STATS[key] = n
    _obs.record_hwm(key, n)


def stats_snapshot() -> Dict[str, float]:
    with _mu:
        return dict(STATS)


def reset_stats() -> None:
    """Tests only."""
    with _mu:
        for k in STATS:
            STATS[k] = 0


def record_skew_retry() -> None:
    """A sharded attempt ran single-device because one shard's bound blew
    up (devpipe's CSR probe-skew retry; this module's capacity gate)."""
    _record("shard_skew_retries")


def record_exchange(nbytes: int) -> None:
    """Bytes moved through a shard exchange (partition-block scatter)."""
    _record("shard_exchange_bytes", int(nbytes))


def note_round(max_shard_rows: int) -> None:
    _record("shard_rounds")
    _hwm("shard_rows_hwm", int(max_shard_rows))


def note_stacked_round() -> None:
    """A coalesced batch round over a sharded program (item 7)."""
    _record("shard_stacked_rounds")


# ---- exact attribution splits ---------------------------------------------
# split_exact is ops/batching.py's (R1: exact under math.fsum in any order
# and under a left fold in member order; the reference's split is not
# exact under Python 3.12's compensated sum()).

def member_shard_shares(totals: dict, b: int, n: int) -> List[List[dict]]:
    """B x N attribution cells for one stacked-over-sharded dispatch:
    member shares split exactly, each member's share split exactly again
    across the N shards."""
    return [split_exact(m, n) for m in split_exact(totals, b)]


# ---- key introspection -----------------------------------------------------

def shards_of_key(key: tuple) -> int:
    """Mesh size a sharded progcache key was built for (0 = unsharded):
    every sharded key carries a ``("shards", n)`` marker pair."""
    if not isinstance(key, tuple) or not key:
        return 0
    for part in key:
        if isinstance(part, tuple) and len(part) == 2 \
                and part[0] == "shards":
            return int(part[1])
    return 0


def _shards_tag(mesh) -> tuple:
    return ("shards", dist.mesh_shards(mesh))


# ---- hash partitioning -------------------------------------------------------
# The reference's spill partitioner (tinysql_tpu/ops/spill.py:122-144).  The
# port has no ops/spill.py yet (ROADMAP item 6): when it lands it imports
# hash_partition from here, so one partitioner drives device placement and
# the spill ladder.  The mesh tier's partition runs the same hash on the
# card (HK13's partition mode; kernels.partition_dest is its torch twin).

#: per-depth seeds: recursion at depth d rehashes with a different mix
_SEEDS = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB,
          0xD6E8FEB86659FD93, 0xA5A3564A1F871D1F, 0xC2B2AE3D27D4EB4F,
          0x165667B19E3779F9, 0x27D4EB2F165667C5)


def hash_partition(keys: np.ndarray, depth: int, n_parts: int) -> np.ndarray:
    """Partition ids for ``keys`` (int64 or float64) at recursion level
    ``depth``: splitmix64-style avalanche over the raw 64-bit pattern.
    Equal keys always land in the same partition at every depth."""
    v = np.ascontiguousarray(keys)
    if v.dtype != np.int64:
        v = np.ascontiguousarray(v, dtype=np.float64)
        # -0.0 and 0.0 compare equal but differ bitwise: canonicalize
        v = np.where(v == 0.0, 0.0, v)
    u = v.view(np.uint64).copy()
    with np.errstate(over="ignore"):
        u += np.uint64(_SEEDS[depth % len(_SEEDS)])
        u ^= u >> np.uint64(30)
        u *= np.uint64(0xBF58476D1CE4E5B9)
        u ^= u >> np.uint64(27)
        u *= np.uint64(0x94D049BB133111EB)
        u ^= u >> np.uint64(31)
    return (u % np.uint64(n_parts)).astype(np.int64)


#: a shard's partition block may exceed the balanced share by this
#: factor before the sharded attempt runs single-device (skew)
SKEW_CAP_FACTOR = 2


def _skewed(n_shards: int, cap: int, n_input_bucket: int) -> bool:
    """The reference's skew gate of one side's partition blocks."""
    return n_shards * cap > max(SKEW_CAP_FACTOR * n_input_bucket,
                                16 * n_shards)


def partition_sides(n: int, sides):
    """Both sides of a partitioned join on the device: each side's key
    lane and live mask ((keys, live, n_input) host arrays) uploaded once,
    HK13's count calls, both sides' per-shard counts in one pull, cap =
    the bucketed largest count (at least 1), the reference's skew gate;
    then HK13's scatter calls.  Returns ([(key blocks, id blocks)] flat
    [n * cap] on the device, [cap]), or None for a skewed side (counted
    as a skew retry)."""
    parts = [kernels.shard_partition(kernels.h2d(k), kernels.h2d(live), n)
             for k, live, _ in sides]
    counts = kernels.d2h_many([p.counts for p in parts])
    caps = [kernels.bucket(max(int(c.max()), 1)) for c in counts]
    if any(_skewed(n, cap, kernels.bucket(max(n_in, 1)))
           for cap, (_, _, n_in) in zip(caps, sides)):
        record_skew_retry()
        return None
    blocks = [kernels.shard_partition_scatter(p, cap)
              for p, cap in zip(parts, caps)]
    # the reference counts each side's key blocks (n * cap keys)
    record_exchange(sum(n * cap * k.dtype.itemsize
                        for cap, (k, _, _) in zip(caps, sides)))
    note_round(max(caps))
    return blocks, caps


def _input_order(pid: torch.Tensor, vals: torch.Tensor, n_rows: int, fill):
    """Per-slot results back in input order on the device: slot i's value
    at row pid[i], ``fill`` where no slot lands (padding slots write a
    spare row past the end, dropped)."""
    out = torch.full((n_rows + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    idx = torch.where(pid >= 0, pid, torch.full_like(pid, n_rows))
    return out.scatter_(0, idx, vals)[:n_rows]


def _live_masks(n_left, n_right, lnull, rnull, lvalid, rvalid):
    lv = np.ones(n_left, dtype=bool) if lvalid is None \
        else np.asarray(lvalid[:n_left], dtype=bool)
    rv = np.ones(n_right, dtype=bool) if rvalid is None \
        else np.asarray(rvalid[:n_right], dtype=bool)
    return lv, rv


def _common_key_dtype(lk: np.ndarray, rk: np.ndarray):
    """Coerce both key lanes to one dtype BEFORE hashing: 5 and 5.0 must
    land in the same partition (the raw bit patterns differ)."""
    if lk.dtype != rk.dtype:
        return lk.astype(np.float64), rk.astype(np.float64)
    return lk, rk


def _join_sides(lkey, n_left: int, rkey, n_right: int, lvalid, rvalid):
    """The reference's shared gates of the partitioned joins: None, or
    (lk, ln, rk, rn, lv, rv) host lanes of one key dtype."""
    if not isinstance(lkey[0], np.ndarray) \
            or not isinstance(rkey[0], np.ndarray):
        return None
    lk = np.asarray(lkey[0])[:n_left]
    ln = np.asarray(lkey[1])[:n_left]
    rk = np.asarray(rkey[0])[:n_right]
    rn = np.asarray(rkey[1])[:n_right]
    if lk.dtype not in (np.int64, np.float64) \
            or rk.dtype not in (np.int64, np.float64):
        return None
    lk, rk = _common_key_dtype(lk, rk)
    lv, rv = _live_masks(n_left, n_right, ln, rn, lvalid, rvalid)
    return lk, ln, rk, rn, lv, rv


# ---- partitioned build/probe unique join ----------------------------------

def _local_unique_join(n: int, pk: torch.Tensor, pid: torch.Tensor,
                       bk: torch.Tensor, bid: torch.Tensor):
    """Every shard's local unique join over its partition blocks (flat
    [n * cap] lanes): HK4 sorts the build blocks by (shard, key with dead
    slots at the sentinel, dead) — stable, so the slot breaks ties as
    the reference's arange third key does — and HK12 probes each shard's
    sorted run.  Returns (hit, brow) per probe slot."""
    bord, perm = _build_order(n, bk, bid)
    return kernels.shard_probe(pk, pid, bord, bid, perm, n)


def _build_order(n: int, bk: torch.Tensor, bid: torch.Tensor):
    """The build blocks' uint64 order lane (dead slots at the sentinel)
    and HK4's order of (shard, key, dead) over them."""
    blive = bid >= 0
    sentinel = float("inf") if bk.dtype == kernels.F64 else kernels.I64_MAX
    bord = kernels._u64_lane(
        torch.where(blive, bk, torch.full_like(bk, sentinel)), False)
    nbb = int(bk.shape[0])
    perm = kernels.lex_order([kernels.shard_lane(n, nbb // n), bord,
                              (~blive).to(kernels.I64)], nbb)
    return bord, perm


def unique_join_match_sharded(mesh, lkey, n_left: int, rkey, n_right: int,
                              outer: bool = False,
                              lvalid: np.ndarray = None,
                              rvalid: np.ndarray = None):
    """Partitioned build/probe unique join over the mesh: the (li, ri)
    contract and tie semantics of kernels.unique_join_match, or None when
    sharding does not apply (skew, non-numeric keys, no mesh)."""
    n = dist.mesh_shards(mesh)
    sides = _join_sides(lkey, n_left, rkey, n_right, lvalid, rvalid) \
        if n >= 2 else None
    if sides is None:
        return None
    lk, ln, rk, rn, lv, rv = sides
    l_live = lv & ~ln
    r_live = rv & ~rn
    if not r_live.any():
        if outer:
            li = np.nonzero(lv)[0].astype(np.int64)
            return li, np.full(len(li), -1, dtype=np.int64)
        z = np.empty(0, dtype=np.int64)
        return z, z
    fail.inject("shardExchangeStall")
    got = partition_sides(n, ((lk, l_live, n_left), (rk, r_live, n_right)))
    if got is None:
        return None
    ((pk, pid), (bk, bid)), (cap_p, cap_b) = got
    key = ("join_sharded", _shards_tag(mesh), cap_p, cap_b, str(lk.dtype))
    fn = progcache.get(key, lambda: kernels.counted_launch(
        lambda *a: _local_unique_join(n, *a)))
    hit, brow = fn(pk, pid, bk, bid)
    cand = _input_order(pid, brow, n_left, -1)  # -1: no live match
    if outer:
        li = np.nonzero(lv)[0].astype(np.int64)
        return li, kernels.d2h(cand)[li]
    li = torch.nonzero(cand >= 0).reshape(-1)
    li, ri = kernels.d2h_many([li, cand[li]])
    return li.astype(np.int64), ri


# ---- partitioned semi / anti join ------------------------------------------

def _local_member(n: int, pk: torch.Tensor, pid: torch.Tensor,
                  bk: torch.Tensor, bid: torch.Tensor) -> torch.Tensor:
    """Every shard's membership bit over its partition blocks: the build
    sort of :func:`_local_unique_join` (HK4), then HK12's member mode."""
    bord, perm = _build_order(n, bk, bid)
    return kernels.shard_probe(pk, pid, bord, bid, perm, n, member=True)


def semi_join_match_sharded(mesh, lkey, n_left: int, rkey, n_right: int,
                            anti: bool = False, null_aware: bool = False,
                            lvalid: np.ndarray = None,
                            rvalid: np.ndarray = None):
    """Partitioned semi / anti membership over the mesh: both sides
    hash-partition, each shard answers membership for its partition
    (HK4 build sort + HK12's member mode), and the host applies the exact
    semi / anti / NOT IN keep ladder over the re-assembled member bits.
    Returns the surviving probe indices in probe order, or None when
    sharding does not apply."""
    n = dist.mesh_shards(mesh)
    sides = _join_sides(lkey, n_left, rkey, n_right, lvalid, rvalid) \
        if n >= 2 else None
    if sides is None:
        return None
    lk, ln, rk, rn, lv, rv = sides
    if int(rv.sum()) == 0:
        keep = lv if anti else np.zeros(n_left, dtype=bool)
        return np.nonzero(keep)[0].astype(np.int64)
    if anti and null_aware and bool((rv & rn).any()):
        return np.empty(0, dtype=np.int64)
    fail.inject("shardExchangeStall")
    got = partition_sides(n, ((lk, lv & ~ln, n_left),
                              (rk, rv & ~rn, n_right)))
    if got is None:
        return None
    ((pk, pid), (bk, bid)), (cap_p, cap_b) = got
    key = ("semi_sharded", _shards_tag(mesh), cap_p, cap_b, str(lk.dtype))
    fn = progcache.get(key, lambda: kernels.counted_launch(
        lambda *a: _local_member(n, *a)))
    member = kernels.d2h(_input_order(pid, fn(pk, pid, bk, bid), n_left,
                                      False))
    if anti:
        keep = lv & ~member
        if null_aware:
            keep &= ~ln
    else:
        keep = member
    return np.nonzero(keep)[0].astype(np.int64)


# ---- sharded partial->final scalar aggregation ----------------------------

def fused_scalar_aggregate_sharded(mesh, dev_cols, agg_specs, prog, lane_of,
                                   n_rows: int, nb: int, mask,
                                   program_key: tuple = (), params=None):
    """Mesh variant of kernels.fused_scalar_aggregate: HK7 evaluates the
    mask and the argument lanes once over all nb rows, HK1 reduces each
    shard's row range, HK11 merges the partials once (the reference's
    psum / pmin / pmax).  Same output contract (out_aggs, first_orig)."""
    n_dev = dist.mesh_shards(mesh)
    assert nb % n_dev == 0, (nb, n_dev)
    mask_key, mask_arr = kernels._mask_parts(mask)
    key = ("scalar_sharded", tuple(agg_specs), program_key, mask_key, nb,
           _shards_tag(mesh))

    def build():
        xp, lo = prog, list(lane_of)

        def program(cols, mask_in, n, pr):
            valid, pairs = kernels._run_agg_program(xp, lo, cols, mask_in,
                                                    pr, nb, n)
            lanes, plan = kernels._spec_lanes(agg_specs, pairs)
            return kernels.sharded_masked_reduce(valid, lanes, n_dev), plan
        return kernels.counted_launch(program)
    fn = progcache.get(key, build)
    note_round(nb // n_dev)
    out, plan = fn(dev_cols, mask_arr, n_rows, kernels._params_dev(params))
    return kernels._scalar_contract(kernels.d2h(out), plan)


# ---- sharded sort / top-k --------------------------------------------------

def _primary_score(key, desc: bool, n_rows: int):
    """The reference's kernels._primary_score: one sort key as a
    total-order score (bigger = earlier) with NULL ordering folded in, or
    None when the mapping is unsafe."""
    v, m = key
    if v.dtype == object or getattr(v.dtype, "kind", "") == "U":
        return None
    if v.dtype == np.int64:
        info = np.iinfo(np.int64)
        vmin = int(v.min()) if n_rows else 0
        vmax = int(v.max()) if n_rows else 0
        if vmin < info.min + 2 or vmax > info.max - 2:
            return None
        if desc:
            return np.where(m, info.min + 1, v)
        return np.where(m, info.max, ~v)
    if v.dtype == np.float64:
        w = np.where(m, 0.0, v)
        if n_rows and not np.isfinite(w).all():
            return None
        if desc:
            return np.where(m, -np.inf, w)
        return np.where(m, np.inf, -w)
    return None


def _score_order(key_cols, descs, n_rows: int, nb: int):
    """The uint64 order lane (ascending = the ORDER BY's order) of the
    padded score on the device, or None where the score mapping is
    unsafe; padding takes the worst sentinel, after every real row."""
    score = _primary_score(key_cols[0], descs[0], n_rows)
    if score is None:
        return None
    score = np.asarray(score[:n_rows])
    pad = np.iinfo(np.int64).min if score.dtype == np.int64 else -np.inf
    sp = kernels.h2d(kernels.pad1(score, nb, pad))
    # the negated score (~s, -s) as HK4's order lane
    return kernels._u64_lane(sp, True)


def _sorted_runs(n: int, ordl: torch.Tensor) -> torch.Tensor:
    """HK4's order of every shard's rows by (shard, score order, row)."""
    nb = int(ordl.shape[0])
    return kernels.lex_order([kernels.shard_lane(n, nb // n), ordl], nb)


def _sort_merge(n: int, ordl: torch.Tensor) -> torch.Tensor:
    """K25 sort on the card: the per-shard sorted runs (HK4), merged by
    their exact global ranks (HK14) into the permutation."""
    nb = int(ordl.shape[0])
    m = nb // n
    return kernels.shard_rank(ordl, _sorted_runs(n, ordl), m, m, n, nb)


def _topk_merge(n: int, kb: int, ordl: torch.Tensor) -> torch.Tensor:
    """K25 top-k on the card: each shard's top kb (HK4's top-k mode over
    its row range; lowest row among ties), then HK14 over the n * kb
    shard-major candidates: the first kb rows of the merged order."""
    m = int(ordl.shape[0]) // n
    ids = torch.cat([kernels.lex_order([ordl[s * m:(s + 1) * m]], m, kb)
                     + s * m for s in range(n)])
    return kernels.shard_rank(ordl, ids, kb, kb, n, kb)


def sort_permutation_sharded(mesh, key_cols, descs, n_rows: int):
    """Sharded ORDER BY permutation (single-key orders): per-shard sort
    and an exact rank merge on the device.  Returns None where the
    reference does (no mesh, several keys, a row bucket that does not
    shard, an unsafe score): the caller runs the single-device kernel."""
    n = dist.mesh_shards(mesh)
    if n < 2 or len(key_cols) != 1:
        return None
    nb = kernels.bucket(max(n_rows, 1))
    if not dist.shardable(nb, mesh):
        return None
    ordl = _score_order(key_cols, descs, n_rows, nb)
    if ordl is None:
        return None
    key = ("sort_sharded", nb, _shards_tag(mesh),
           str(key_cols[0][0].dtype))
    fn = progcache.get(key, lambda: kernels.counted_launch(
        lambda o: _sort_merge(n, o)))
    note_round(nb // n)
    return kernels.d2h(fn(ordl))[:n_rows]


def top_k_sharded(mesh, key_cols, descs, n_rows: int, k: int):
    """Sharded top-k row selection (single key, score-mapped): the k row
    indices in the requested order, or None where the reference returns
    None (no mesh, several keys, k <= 0 or above a shard's rows, a row
    bucket that does not shard, an unsafe score)."""
    n = dist.mesh_shards(mesh)
    if n < 2 or len(key_cols) != 1 or k <= 0:
        return None
    nb = kernels.bucket(max(n_rows, 1))
    if not dist.shardable(nb, mesh):
        return None
    m = nb // n
    if k > m:
        return None  # a shard cannot bound the candidate set
    ordl = _score_order(key_cols, descs, n_rows, nb)
    if ordl is None:
        return None
    kb = min(kernels.bucket(max(k, 1)), m)
    key = ("topk_sharded", nb, kb, _shards_tag(mesh),
           str(key_cols[0][0].dtype))
    fn = progcache.get(key, lambda: kernels.counted_launch(
        lambda o: _topk_merge(n, kb, o)))
    note_round(m)
    ids = kernels.d2h(fn(ordl))[:k]
    return ids[ids < n_rows]
