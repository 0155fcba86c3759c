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
launder, ``shardable`` the per-dispatch row-bucket gate.  The host
shuffle helpers (``hash_dest_np``, ``shuffle_cap``) are copied for the
shuffle join that is still to port (ROADMAP item 10).
"""
from __future__ import annotations

import os
from typing import Optional

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


# ---- hash-partitioned (shuffle) join: host helpers --------------------------

# golden-ratio multiplier (two's-complement int64 of 0x9E3779B97F4A7C15)
HASH_GOLDEN = np.int64(0x9E3779B97F4A7C15 - (1 << 64))


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


def shard_rows(arr: np.ndarray, n_shards: int, fill=0) -> np.ndarray:
    """Host helper: pad + reshape a 1-D array to [n_shards, rows]."""
    n = len(arr)
    per = (n + n_shards - 1) // n_shards
    out = np.full(n_shards * per, fill, dtype=arr.dtype)
    out[:n] = arr
    return out.reshape(n_shards, per)
