"""The mesh tier's policy and host helpers: the port of
tinysql_tpu/parallel/dist.py.

The reference shards rows over a 1-D ``jax.sharding.Mesh`` (axis
"shard") and merges partial states with psum / pmin / pmax inside
``shard_map`` programs.  The port's mesh is N VIRTUAL shards on one
device: shard ``s`` owns the contiguous row range
``[s * nb / N, (s + 1) * nb / N)`` of every padded lane — exactly the
slice ``P("shard")`` hands each device in the reference — so
``all_gather`` is the layout the lanes already have, per-shard work is
an explicit index range plus a kernel launch, and the psum / pmin / pmax
of the partial tables is one hand-written merge kernel
(``kernels.shard_merge``, HK11).  No ``shard_map`` is copied.

The shard count is ``TINYSQL_MESH_SHARDS`` (the counterpart of the
reference's forced host device count), read each time a mesh is formed;
unset, it is ``torch.cuda.device_count()`` on CUDA and 1 on the CPU.  A
count below 2 means no mesh: the statement runs single-device, as the
reference does with one device.  A count of 2 or more that is not a
power of two raises ``ValueError``.

The policy functions keep the reference's semantics: ``session_mesh`` /
``sized_mesh`` gate on ``tidb_mesh_parallel`` and cache ``Mesh``
objects, ``shard_bucket`` is the planner's estRows -> shard-count
launder, ``shardable`` the per-dispatch row-bucket gate.

The exchange and collective primitives (the reference's K26) run over
the hand kernels: ``hash_dest`` / ``exchange_lanes`` are HK13's
all-to-all (``kernels.shard_exchange``), ``local_unique_join`` every
shard's sort and probe of its received partition (HK4 + HK12, as K25's
unique join), ``sharded_group_sum`` HK2 per shard and HK11's psum,
``broadcast_join_counts`` HK12's count mode and HK11's psum, and
``distributed_query_step`` both as one step.  ``hash_dest_np`` and
``shuffle_cap`` are the host twins the shuffle join bounds its send
buckets with.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..ops import kernels

#: the environment variable that sets the mesh's shard count
SHARDS_ENV = "TINYSQL_MESH_SHARDS"


class Mesh:
    """N virtual shards on one device (the reference's 1-D device mesh
    over axis "shard")."""
    __slots__ = ("n_shards", "device")

    def __init__(self, n_shards: int, device: torch.device):
        self.n_shards = int(n_shards)
        self.device = device

    @property
    def shards(self) -> int:
        return self.n_shards

    def __repr__(self) -> str:
        return f"Mesh(n_shards={self.n_shards}, device={self.device})"


def env_shards() -> Optional[int]:
    """``TINYSQL_MESH_SHARDS`` as an int, None when unset."""
    raw = os.environ.get(SHARDS_ENV, "").strip()
    if not raw:
        return None
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{SHARDS_ENV}={raw!r} is not an integer") from None
    if n < 0 or (n >= 2 and n & (n - 1)):
        raise ValueError(f"{SHARDS_ENV}: a mesh needs a power-of-two shard "
                         f"count, got {n}")
    return n


def device_count() -> int:
    """The port's counterpart of ``len(jax.devices())``: the shards one
    mesh may have on the current device."""
    n = env_shards()
    if n is not None:
        return n
    if kernels.device().type == "cuda":
        return int(torch.cuda.device_count())
    return 1


_SESSION_MESH: Optional[Mesh] = None


def session_mesh(session_vars) -> Optional[Mesh]:
    """The query-execution mesh when the session asks for it
    (tidb_mesh_parallel) and 2 or more shards exist; cached per (shard
    count, device)."""
    if not bool(session_vars.get("tidb_mesh_parallel", 0)):
        return None
    n = device_count()
    if n < 2:
        return None
    global _SESSION_MESH
    dev = kernels.device()
    m = _SESSION_MESH
    if m is None or m.n_shards != n or m.device != dev:
        m = _SESSION_MESH = Mesh(n, dev)
    return m


_SIZED_MESHES: dict = {}


def sized_mesh(n_shards: int) -> Optional[Mesh]:
    """A cached k-shard mesh (k = min(n_shards, device_count())) for plans
    whose estRows-driven shard count is below the full count; k < 2 is
    None = run the single-device kernel."""
    if n_shards < 2:
        return None
    k = min(int(n_shards), device_count())
    if k < 2:
        return None
    dev = kernels.device()
    m = _SIZED_MESHES.get((k, str(dev)))
    if m is None:
        m = _SIZED_MESHES[(k, str(dev))] = Mesh(k, dev)
    return m


def mesh_shards(mesh) -> int:
    """Shard count of a mesh (0 for None) — the launder from mesh shape
    to a program-key literal."""
    return 0 if mesh is None else int(mesh.n_shards)


#: a shard must expect at least this many rows before fan-out pays for
#: the partition scatter and the merge (estRows-driven; the per-dispatch
#: row-bucket gate `shardable` still applies at runtime)
MIN_SHARD_ROWS = 256


def shard_bucket(est_rows: float, n_devices: int) -> int:
    """estRows -> power-of-two shard count <= n_devices: the planner's
    mesh annotation.  1 means 'stay single-device'."""
    n = 1
    est = max(float(est_rows or 0), 0.0)
    while n * 2 <= n_devices and est >= MIN_SHARD_ROWS * (n * 2):
        n *= 2
    return n


def shardable(nb: int, mesh) -> bool:
    """Row-bucket gate for sharding over ``mesh``: divisible and big
    enough to amortize the merge."""
    if mesh is None:
        return False
    n = int(mesh.n_shards)
    return nb % n == 0 and nb >= 16 * n


# ---- hash-partitioned (shuffle) join ---------------------------------------

# golden-ratio multiplier (two's-complement int64 of 0x9E3779B97F4A7C15)
HASH_GOLDEN = np.int64(kernels.HASH_GOLDEN)


def hash_dest_np(keys: np.ndarray, n_shards: int,
                 n_rows: Optional[int] = None) -> np.ndarray:
    """Destination shard per row (int64 wrap-around multiply); padding
    rows past ``n_rows`` spread round-robin."""
    with np.errstate(over="ignore"):
        h = keys.astype(np.int64, copy=False) * HASH_GOLDEN
    d = (h >> 33) & (n_shards - 1)
    if n_rows is not None:
        idx = np.arange(len(keys), dtype=np.int64)
        d = np.where(idx < n_rows, d, idx % n_shards)
    return d


def shuffle_cap(keys_padded: np.ndarray, n_shards: int, n_rows: int) -> int:
    """Power-of-two capacity per (source shard, dest shard) send bucket:
    the exact max block histogram of the destinations."""
    dest = hash_dest_np(keys_padded, n_shards, n_rows)
    per = len(keys_padded) // n_shards
    mx = 1
    for i in range(n_shards):
        c = np.bincount(dest[i * per:(i + 1) * per], minlength=n_shards)
        mx = max(mx, int(c.max()))
    return kernels.bucket(mx)


def hash_dest(keys: torch.Tensor, n_shards: int,
              n_rows: int) -> torch.Tensor:
    """Destination shard of every padded row on the device: the twin of
    :func:`hash_dest_np`, and the destinations HK13 scatters by."""
    return kernels.hash_dest(keys, n_shards, n_rows)


def exchange_lanes(keys: torch.Tensor, n_rows: int, lanes, cap: int,
                   n_shards: int) -> List[torch.Tensor]:
    """Every shard's send buckets of ``lanes`` ([(tensor [nb], fill)]) by
    the hash of ``keys``, exchanged all-to-all (HK13): per lane the
    received [n * n * cap] lane, flat [destination][source][cap] — shard
    d's received lanes are its [n * cap] slice, as the reference's tiled
    all_to_all lays them out."""
    return kernels.shard_exchange(keys, n_rows, lanes, cap, n_shards)


def local_unique_join(bk: torch.Tensor, blive: torch.Tensor,
                      pk: torch.Tensor, n_shards: int):
    """Every shard's unique join of its received partition (flat lanes of
    n * per-shard slots): the build slots sort by (key, liveness) per
    shard (HK4, stable) and each probe slot searches its shard's run
    (HK12).  Returns (hit, brow): hit = a LIVE build slot of the shard
    holds the key; brow = that slot's index in the flat build lanes (-1
    without one)."""
    from ..ops import shardops
    nbb = int(bk.shape[0])
    bid = torch.where(blive, torch.arange(nbb, dtype=torch.int64,
                                          device=bk.device),
                      torch.full_like(bk, -1))
    pid = torch.zeros_like(pk)
    return shardops._local_unique_join(n_shards, pk, pid, bk, bid)


def sharded_group_sum(mesh, bucket_ids: torch.Tensor, vals: torch.Tensor,
                      valid: torch.Tensor, n_buckets: int):
    """Per-shard bucket sums and counts merged over the mesh (the
    reference's make_sharded_group_sum): inputs [n_shards, rows] (bucket
    ids of any integer type, float64 values, bool validity); HK2 over
    each shard's rows into ``n_buckets`` segments and HK11's psum.
    Returns (sums float64 [n_buckets], counts int64 [n_buckets])."""
    n = mesh_shards(mesh)
    gid = bucket_ids.reshape(-1).to(torch.int64)
    v = vals.reshape(-1).contiguous()
    ok = valid.reshape(-1).contiguous()
    table = kernels.sharded_segment_reduce(gid, ok, int(n_buckets),
                                           [(v, None, "sum")], n)
    cnt = table[3]
    sums = torch.where(cnt > 0, table[2].view(torch.float64),
                       torch.zeros_like(v[:1]))
    return sums, cnt


def broadcast_join_counts(mesh, lkeys: torch.Tensor, lvalid: torch.Tensor,
                          rkeys_sorted: torch.Tensor):
    """Probe keys sharded over the mesh, the sorted build keys replicated
    (the reference's make_broadcast_join_counts): each shard counts its
    rows' matches (HK12's count mode) and HK11's psum totals them.
    Returns (counts int64 [n_shards, rows], total int64 scalar)."""
    n = mesh_shards(mesh)
    counts, partial = kernels.shard_count(
        lkeys.reshape(-1), lvalid.reshape(-1), rkeys_sorted, n)
    rows = int(lkeys.reshape(-1).shape[0]) // n
    total = kernels.shard_merge(partial, [kernels.MERGE_OPS["sum_i"]], rows,
                                n * rows)
    return counts.reshape(n, rows), total.reshape(())


def distributed_query_step(mesh, n_buckets: int = 64):
    """One distributed 'query step' (the reference's
    distributed_query_step): the sharded group sum and the broadcast join
    counts, as a function of (bucket_ids, vals, valid, lkeys, lvalid,
    rkeys_sorted) returning (sums, counts per bucket, match counts per
    probe row, total matches)."""
    def step(bucket_ids, vals, valid, lkeys, lvalid, rkeys_sorted):
        sums, cnts = sharded_group_sum(mesh, bucket_ids, vals, valid,
                                       n_buckets)
        counts, total = broadcast_join_counts(mesh, lkeys, lvalid,
                                              rkeys_sorted)
        return sums, cnts, counts, total
    return kernels.counted_launch(step)


def shard_rows(arr: np.ndarray, n_shards: int, fill=0) -> np.ndarray:
    """Host helper: pad + reshape a 1-D array to [n_shards, rows]."""
    n = len(arr)
    per = (n + n_shards - 1) // n_shards
    out = np.full(n_shards * per, fill, dtype=arr.dtype)
    out[:n] = arr
    return out.reshape(n_shards, per)
