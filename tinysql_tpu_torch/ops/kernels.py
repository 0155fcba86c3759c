"""Device core of the port and the relational kernels it runs.

The port of tinysql_tpu/ops/kernels.py.  The JAX package compiled every
operator family into XLA programs; here each family's core is one of
fourteen kernels written by hand for Hopper (csrc/*.cu, built by
ops/_ext.py), and the glue around them (key normalisation, packing,
present-row extraction) runs as plain torch tensor operations:

- HK1 :func:`masked_reduce` (csrc/masked_reduce.cu) — global aggregates
  (K1 fused_scalar_aggregate, K5 scalar_aggregate);
- HK2 :func:`segment_reduce` + :func:`present_compact`
  (csrc/segment_reduce.cu) — grouped aggregates (K2 fused_segment_*,
  K3 segment_group_aggregate, and K4 group_aggregate after an HK4 sort);
- HK3 :func:`equi_join_unique` / :func:`equi_join_mult`
  (csrc/equi_join.cu) — join matching (K6 unique_join_match, K7
  join_match, and K8 semi_join_match's membership test,
  :func:`unique_match`);
- HK4 :func:`lex_order` (csrc/lex_order.cu) — ORDER BY permutations and
  top-k (K9 sort_permutation, K10 top_k);
- HK5 :func:`csr_reduce` (csrc/csr_reduce.cu) — the pipeline tier's
  GROUP BY over a memoized group index (K17, executor/devpipe.py);
- HK6 :func:`dense_probe` (csrc/dense_probe.cu) — the pipeline tier's
  join probe through a dense key -> row table (K18's unique, semi and
  anti modes);
- HK7 :func:`expr_eval` (csrc/expr_eval.cu) — every expression evaluated
  on the device: filter masks, aggregate argument lanes, projections and
  sort keys, string compares on dictionary codes and the grouped
  aggregate's output layout (K13-K16, K22), as programs compiled by
  ops/exprjit.compile_program;
- HK8 :func:`csr_expand` (csrc/csr_expand.cu) — the pipeline tier's join
  with a non-unique build side, expanded over the build's group index
  (K18's multiplicity mode, one key or the composite lane; its shard
  mode expands each mesh shard's probe rows into its own bucket);
- HK9 :func:`run_bounds` (csrc/run_bounds.cu) — the runs of equal keys
  after an HK4 sort (K19's GROUP BY above a join, K4's boundary scan);
- HK10 :func:`semi_pick` (csrc/semi_pick.cu) — K8's semi / anti / NOT IN
  ladder over HK3's membership and the compaction of the kept rows;
- HK11 :func:`shard_merge` (csrc/shard_merge.cu) — the mesh tier's psum /
  pmin / pmax of per-shard partial tables (K11
  :func:`fused_segment_aggregate_sharded` over HK2, K25's scalar
  aggregate over HK1);
- HK12 :func:`shard_probe` (csrc/shard_join.cu) — the per-partition probe
  of the mesh tier's unique join (K25), over an HK4 sort of the build
  blocks; its member mode is K25's partitioned semi / anti join, its
  count mode (:func:`shard_count`) K26's broadcast join counts;
- HK13 :func:`shard_exchange` (csrc/shard_exchange.cu) — the mesh tier's
  all-to-all of rows by key hash (K18 shuffle, K26); its partition mode
  (:func:`shard_partition`, :func:`shard_partition_scatter`) K25's hash
  partition of a join side into per-shard blocks;
- HK14 :func:`shard_rank` (csrc/shard_rank.cu) — the exact merge of
  per-shard sorted runs (K25 sort and top-k).

Every kernel wrapper launches its kernel for a CUDA tensor and runs its
plain torch version (same contract: inputs, outputs, NULL, sentinel and
tie-break rules) only for a tensor that lies on the CPU — never as a
fallback.  ``LAUNCHES`` counts the calls of each wrapper that launched
on the card and ``PLAIN_CALLS`` the plain-version calls, so a run can
show which one served it.

Device selection: entry points run on the card unless the caller asks for
the CPU.  :func:`use_device` scopes the device for a statement (the
session enters it); without a scope :func:`device` resolves to CUDA and
raises when there is none.  Semantics are int64/float64 (MySQL
BIGINT/DOUBLE) with bool NULL masks, bucket-padded to powers of two
(:func:`bucket`, minimum 16).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import exprjit as _xj
from . import profiler, progcache
from .. import fail
from ..obs import context as _obs

I64 = torch.int64
F64 = torch.float64
I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1

# =========================================================================
# device selection (replaces ensure_live_backend / jax() / jnp())
# =========================================================================

_DEVICE: "contextvars.ContextVar[Optional[torch.device]]" = \
    contextvars.ContextVar("tinysql_torch_device", default=None)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, raising ``RuntimeError`` when
    CUDA is absent (never a silent drop to the CPU); ``"cpu"`` or a cuda
    device otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tinysql_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {d} requested but CUDA is absent")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


@contextlib.contextmanager
def use_device(device):
    """Scope the device every kernel entry point of this context uses
    (None: no scope — the first kernel use resolves CUDA or raises)."""
    if device is None:
        yield
        return
    tok = _DEVICE.set(resolve_device(device))
    try:
        yield
    finally:
        _DEVICE.reset(tok)


def device() -> torch.device:
    d = _DEVICE.get()
    return d if d is not None else resolve_device(None)


def backend() -> str:
    """``"cuda"`` or ``"cpu"`` — where the JAX package asked XLA for its
    backend name (``"tpu"`` / ``"cpu"``)."""
    return device().type


def _sync() -> None:
    if device().type == "cuda":
        torch.cuda.synchronize()


# =========================================================================
# counters (same names as the reference's STATS)
# =========================================================================

STATS = {"dispatches": 0, "d2h_transfers": 0, "d2h_bytes": 0,
         "h2d_transfers": 0, "h2d_bytes": 0,
         "host_dispatches": 0,
         "device_s": 0.0, "profiled_dispatches": 0,
         "flops": 0.0, "bytes_accessed": 0.0,
         "pipe_blocks": 0, "pipe_stage_s": 0.0, "pipe_dispatch_s": 0.0,
         "pipe_drain_s": 0.0, "pipe_wall_s": 0.0, "pipe_depth_hwm": 0}

from ..obs.metrics import HWM_STATS_KEYS as _HWM_KEYS  # noqa: E402

_STATS_MU = threading.Lock()

#: launching wrapper calls per hand-kernel entry point: one count per call
#: into a kernel library's C entry point (which may run several
#: __global__ kernels), where the wrapper launches on the card and nowhere
#: else
LAUNCHES: Dict[str, int] = {"masked_reduce": 0, "segment_reduce": 0,
                            "present_compact": 0, "equi_join": 0,
                            "lex_order": 0, "csr_reduce": 0,
                            "dense_probe": 0, "expr_eval": 0,
                            "csr_expand": 0, "run_bounds": 0,
                            "expr_eval_batched": 0,
                            "masked_reduce_batched": 0,
                            "segment_reduce_batched": 0,
                            "semi_pick": 0, "shard_merge": 0,
                            "shard_probe": 0, "shard_member": 0,
                            "shard_count": 0, "csr_expand_shard": 0,
                            "shard_exchange": 0, "shard_partition": 0,
                            "shard_rank": 0}
#: the entry points only the mesh tier (tidb_mesh_parallel) launches
MESH_LAUNCHES = ("shard_merge", "shard_probe", "shard_member", "shard_count",
                 "csr_expand_shard", "shard_exchange", "shard_partition",
                 "shard_rank")
#: plain-version calls per wrapper (CPU tensors)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_kernel_counts() -> None:
    with _STATS_MU:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            PLAIN_CALLS[k] = 0


def kernel_counts() -> dict:
    with _STATS_MU:
        return {"launches": dict(LAUNCHES), "plain_calls": dict(PLAIN_CALLS)}


def _count(table: Dict[str, int], name: str) -> None:
    with _STATS_MU:
        table[name] += 1


def stats_add(key: str, n) -> None:
    """THE accumulator write path: bumps the process-global counter under
    the lock and fans the increment out to the active per-query scope and
    operator (obs/context.py)."""
    with _STATS_MU:
        STATS[key] = STATS.get(key, 0) + n
    _obs.record(key, n)


def stats_hwm(key: str, n) -> None:
    """High-water-mark write path: keeps the max, globally and in the
    per-query scope."""
    with _STATS_MU:
        if n > STATS.get(key, 0):
            STATS[key] = n
    _obs.record_hwm(key, n)


def pipe_record(blocks: int = 0, stage_s: float = 0.0,
                dispatch_s: float = 0.0, drain_s: float = 0.0,
                wall_s: float = 0.0, depth_hwm: int = 0) -> None:
    """Accrue one block-wise run's stage / compute / drain walls into
    STATS (once per BlockPipeline consumer loop, not per block)."""
    stats_add("pipe_blocks", blocks)
    stats_add("pipe_stage_s", stage_s)
    stats_add("pipe_dispatch_s", dispatch_s)
    stats_add("pipe_drain_s", drain_s)
    stats_add("pipe_wall_s", wall_s)
    stats_hwm("pipe_depth_hwm", depth_hwm)


def pipe_overlap_frac(d: dict) -> float:
    """Staging/compute overlap estimate from a counter scope's ``pipe_*``
    walls (the reference's formula)."""
    pw = d.get("pipe_wall_s", 0.0)
    if not pw or pw <= 0:
        return 0.0
    busy = (d.get("pipe_stage_s", 0.0) + d.get("pipe_dispatch_s", 0.0)
            + d.get("pipe_drain_s", 0.0))
    return max(0.0, busy - pw) / pw


def set_compile_cache_dir(path: str) -> None:
    """The sysvar ``tidb_compile_cache_dir`` pointed JAX's persistent XLA
    cache somewhere.  It has no meaning under torch: the kernels are built
    once per checkout into ops/_ext.py's build directory.  Accepted and
    ignored."""


def stats_snapshot() -> dict:
    with _STATS_MU:
        out = dict(STATS)
        for k in _HWM_KEYS:
            STATS[k] = 0
    pc = progcache.stats_snapshot()
    out["progcache_hits"] = pc["hits"]
    out["progcache_misses"] = pc["misses"]
    out["prewarm_seeded"] = pc.get("prewarm_seeded", 0)
    out["prewarm_hits"] = pc.get("prewarm_hits", 0)
    return out


def stats_delta(since: dict) -> dict:
    """Counters moved since a :func:`stats_snapshot` (high-water marks as
    they stand)."""
    now = stats_snapshot()
    return {k: (v if k in _HWM_KEYS else v - since.get(k, 0))
            for k, v in now.items()}


def counted_launch(fn):
    """The counted launch wrapper (the reference's ``counted_jit``): every
    call of a device program counts one dispatch, reports it to the
    program catalog under the registry key it was built for, and — when
    the sampling profiler picks it — synchronizes so the recorded wall is
    device busy time."""
    prog_key = progcache.building_key()

    def call(*a, **k):
        fail.inject("kernelDispatchError")
        stats_add("dispatches", 1)
        sampled = profiler.should_sample()
        t0 = time.perf_counter() if sampled else 0.0
        with _obs.span("dispatch", cat="device"):
            res = fn(*a, **k)
            if sampled:
                _sync()
        if sampled:
            dt = time.perf_counter() - t0
            stats_add("device_s", dt)
            stats_add("profiled_dispatches", 1)
            profiler.observe(dt)
            progcache.note_dispatch(prog_key, device_s=dt)
        else:
            progcache.note_dispatch(prog_key)
        return res
    return call


# =========================================================================
# transfers, packing, padding
# =========================================================================

def h2d(a) -> torch.Tensor:
    """Counted host->device upload (a copy on the CPU device too, so no
    tensor aliases a host buffer)."""
    host = np.ascontiguousarray(a)
    dev = device()
    t = torch.from_numpy(host)
    out = t.to(dev) if dev.type != "cpu" else t.clone()
    stats_add("h2d_transfers", 1)
    stats_add("h2d_bytes", int(host.nbytes))
    return out


def h2d_pad(a: np.ndarray, n: int, fill=0) -> torch.Tensor:
    """Counted upload of ``pad1(a, n, fill)``."""
    return h2d(pad1(a, n, fill))


def _arg_dev(v, m, n: int):
    """An aggregate argument pair on the device: host arrays upload
    padded, device pairs (already padded) pass."""
    if isinstance(m, torch.Tensor):
        return v, m
    return h2d_pad(v, n), h2d_pad(m, n, True)


def _host(t: torch.Tensor) -> np.ndarray:
    out = t.detach().cpu().numpy()
    return out.copy() if t.device.type == "cpu" else out


def d2h(dev_arr) -> np.ndarray:
    """Counted device->host materialization."""
    fail.inject("kernelD2HError")
    with _obs.span("drain", cat="device"):
        out = _host(dev_arr) if isinstance(dev_arr, torch.Tensor) \
            else np.asarray(dev_arr)
    stats_add("d2h_transfers", 1)
    stats_add("d2h_bytes", out.nbytes)
    return out


def d2h_many(dev_arrs) -> List[np.ndarray]:
    """ONE counted device->host pull for several tensors: on the card they
    are packed into one byte buffer first, so the link pays one copy."""
    fail.inject("kernelD2HError")
    arrs = list(dev_arrs)
    with _obs.span("drain", cat="device"):
        if arrs and all(isinstance(a, torch.Tensor) and a.is_cuda
                        for a in arrs):
            flat = [a.contiguous().reshape(-1).view(torch.uint8)
                    for a in arrs]
            host = torch.cat(flat).cpu().numpy()
            outs, off = [], 0
            for a, f in zip(arrs, flat):
                nb = f.numel()
                dt = _np_dtype(a.dtype)
                outs.append(host[off:off + nb].view(dt).reshape(a.shape))
                off += nb
        else:
            outs = [_host(a) if isinstance(a, torch.Tensor)
                    else np.asarray(a) for a in arrs]
    stats_add("d2h_transfers", 1)
    stats_add("d2h_bytes", sum(o.nbytes for o in outs))
    return outs


def _np_dtype(dt: torch.dtype):
    return {torch.int64: np.int64, torch.float64: np.float64,
            torch.bool: np.bool_, torch.int32: np.int32,
            torch.uint8: np.uint8}[dt]


def pack_arrays(schema: list, arrays) -> tuple:
    """Concatenate 1-D tensors into one int64 and one float64 stream and
    record (dtype, length, stream) per array in ``schema`` (cleared
    first) for :func:`unpack_flat`."""
    del schema[:]
    ints, floats = [], []
    dev = None
    for a in arrays:
        dev = a.device
        if a.dtype == F64:
            schema.append(("float64", int(a.shape[0]), "f"))
            floats.append(a)
        elif a.dtype in (I64, torch.bool, torch.int32):
            schema.append((str(a.dtype).replace("torch.", ""),
                           int(a.shape[0]), "i"))
            ints.append(a if a.dtype == I64 else a.to(I64))
        else:
            raise TypeError(f"pack_arrays: unsupported dtype {a.dtype}")
    dev = dev or device()
    zi = torch.zeros(0, dtype=I64, device=dev)
    zf = torch.zeros(0, dtype=F64, device=dev)
    return (torch.cat(ints) if ints else zi,
            torch.cat(floats) if floats else zf)


def _split_flat(flat_i, flat_f, schema: list) -> List[np.ndarray]:
    out = []
    pi = pf = 0
    for dt, ln, stream in schema:
        if stream == "f":
            out.append(flat_f[pf:pf + ln])
            pf += ln
        else:
            seg = flat_i[pi:pi + ln]
            pi += ln
            if dt == "int64":
                out.append(seg)
            elif dt == "bool":
                out.append(seg != 0)
            else:
                out.append(seg.astype(np.dtype(dt)))
    return out


def unpack_flat(pair, schema: list) -> List[np.ndarray]:
    """ONE pull of both streams, then split per the recorded schema."""
    dev_i, dev_f = pair
    flat_i, flat_f = d2h_many([dev_i, dev_f])
    return _split_flat(flat_i, flat_f, schema)


def unpack_host(pair, schema: list) -> List[np.ndarray]:
    host_i, host_f = pair
    return _split_flat(host_i, host_f, schema)


def bucket(n: int) -> int:
    """Pad target: next power of two (min 16), reported to the active
    per-query scope."""
    b = 16
    while b < n:
        b <<= 1
    _obs.record_bucket(b)
    return b


def pad1(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(a) == n:
        return a
    if fill == 0 or fill is False:
        out = np.zeros(n, dtype=a.dtype)
    else:
        out = np.full(n, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


SMALL_PACK = 1 << 16
MAX_SEGMENTS = 1 << 16
MAX_DENSE_SEGMENTS = 1 << 21


def seg_limit(n_rows: int) -> int:
    """Segment-count budget for the segment-aggregate paths (the
    reference's rule)."""
    return min(MAX_DENSE_SEGMENTS, max(MAX_SEGMENTS, 8 * max(n_rows, 1)))


_ARANGE: Dict[tuple, torch.Tensor] = {}
_ARANGE_MU = threading.Lock()


def _arange(n: int) -> torch.Tensor:
    """Memoized row index 0..n-1 on the current device (the mask programs
    compare it against the live row count)."""
    dev = device()
    key = (n, str(dev))
    with _ARANGE_MU:
        t = _ARANGE.get(key)
        if t is None:
            t = _ARANGE[key] = torch.arange(n, dtype=I64, device=dev)
    return t


# =========================================================================
# kernel plumbing
# =========================================================================

_MAX_LANES = 16
_MAX_SORT_LANES = 8
_OPS = {"sum": 0, "min": 1, "max": 2, "count": 3}


class _CLanes(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p * _MAX_LANES),
                ("nulls", ctypes.c_void_p * _MAX_LANES),
                ("kind", ctypes.c_int * _MAX_LANES),
                ("op", ctypes.c_int * _MAX_LANES),
                ("n", ctypes.c_int)]


class _CLaneStrides(ctypes.Structure):
    _fields_ = [("v", ctypes.c_int64 * _MAX_LANES),
                ("nl", ctypes.c_int64 * _MAX_LANES)]


class _CSortIn(ctypes.Structure):
    _fields_ = [("lanes", ctypes.c_void_p * _MAX_SORT_LANES),
                ("pos", ctypes.c_void_p)]


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True: launch the kernel; False: the tensor lies on the CPU and the
    plain version serves.  Anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: unsupported device {t.device}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _need(t: torch.Tensor, dtype, n: int, dev, what: str) -> None:
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{what}: expected contiguous {dtype}[{n}] on "
                         f"{dev}, got {t.dtype}{tuple(t.shape)} on "
                         f"{t.device}")


# A reduction lane: (values int64/float64 tensor or None, null bool tensor
# or None, op in "sum" | "min" | "max" | "count").  Its outputs are the
# value (bits in the int64 result) and the count of live rows
# (valid and not NULL).

def _lane_kind(v: Optional[torch.Tensor]) -> int:
    return 1 if (v is not None and v.dtype == F64) else 0


def _norm_lanes(lanes, n: int, dev, what: str,
                nmem: Optional[int] = None):
    """Checked, contiguous lanes of n rows; with ``nmem`` (a batched
    entry point) each lane's values and NULL mask may also be one row per
    member, [nmem, n]."""
    def need(t, dtype):
        if nmem is None:
            _need(t, dtype, n, dev, what)
        else:
            _need_b(t, dtype, nmem, n, dev, what)

    out = []
    for v, m, op in lanes:
        if op not in _OPS:
            raise ValueError(f"{what}: unknown op {op}")
        if op == "count":
            v = None
        elif v is None:
            raise ValueError(f"{what}: op {op} needs values")
        else:
            if v.dtype == torch.bool:
                v = v.to(I64)
            v = v.contiguous()
            if v.dtype not in (I64, F64):
                raise ValueError(f"{what}: lane dtype {v.dtype}")
            need(v, v.dtype)
        if m is not None:
            m = m.contiguous()
            need(m, torch.bool)
        out.append((v, m, op))
    return out


def _c_lanes(lanes) -> _CLanes:
    c = _CLanes()
    c.n = len(lanes)
    for j, (v, m, op) in enumerate(lanes):
        c.vals[j] = _ptr(v)
        c.nulls[j] = _ptr(m)
        c.kind[j] = _lane_kind(v)
        c.op[j] = _OPS[op]
    return c


# The batched entry points (K12's stacked rounds) take B members' lanes:
# each lane's values and NULL mask are [B, n] (one row per member) or [n]
# (shared by every member).

def _need_b(t: torch.Tensor, dtype, nmem: int, n: int, dev, what: str):
    """A member lane [nmem, n] or a shared one [n]."""
    if t.dim() == 1:
        _need(t, dtype, n, dev, what)
    elif t.dtype != dtype or tuple(t.shape) != (nmem, n) \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{what}: expected contiguous {dtype}[{nmem}, {n}] "
                         f"or [{n}] on {dev}, got {t.dtype}"
                         f"{tuple(t.shape)} on {t.device}")


def _c_strides(lanes, n: int) -> _CLaneStrides:
    c = _CLaneStrides()
    for j, (v, m, _op) in enumerate(lanes):
        c.v[j] = n if v is not None and v.dim() == 2 else 0
        c.nl[j] = n if m is not None and m.dim() == 2 else 0
    return c


def _member(t: Optional[torch.Tensor], b: int):
    return t[b] if t is not None and t.dim() == 2 else t


def _member_lanes(lanes, b: int):
    return [(_member(v, b), _member(m, b), op) for v, m, op in lanes]


def _lane_fill(v: Optional[torch.Tensor], op: str):
    is_f = v is not None and v.dtype == F64
    if op == "min":
        return float("inf") if is_f else I64_MAX
    if op == "max":
        return float("-inf") if is_f else I64_MIN
    return 0.0 if is_f else 0


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(I64) if x.dtype == F64 else x


# =========================================================================
# HK1 masked_reduce
# =========================================================================

#: csrc/masked_reduce.cu's plan, mirrored so the wrapper sizes the
#: scratch without a call into the library: tiles of kThreads * kWord
#: rows, at most kMaxBlocks blocks, each (lane + 1, block) partial three
#: int64, one uint32 ticket a member
_HK1_TILE = 256 * 16
_HK1_MAX_BLOCKS = 256


def _hk1_blocks(n: int) -> int:
    """HK1's block count: a function of n alone."""
    tiles = -(-n // _HK1_TILE)
    tpb = max(1, -(-tiles // _HK1_MAX_BLOCKS))
    return max(1, -(-tiles // tpb))


def _hk1_launch(lib, valid, nmem: int, n: int, chunk, batched: bool):
    """One HK1 / HK1b launch over <= 16 lanes: returns int64 [nmem, 2 + 2
    * len(chunk)], a view of the call's one buffer, which also holds the
    partials and the tickets."""
    from . import _ext
    width = 2 + 2 * len(chunk)
    n_out = nmem * width
    n_part = 3 * nmem * (len(chunk) + 1) * _hk1_blocks(n)
    buf = torch.empty(n_out + n_part + (nmem + 1) // 2, dtype=I64,
                      device=valid.device)
    cl = _c_lanes(chunk)
    scratch = buf.data_ptr() + 8 * n_out
    if batched:
        rc = lib.hk1b_masked_reduce(
            valid.data_ptr(), nmem, n, ctypes.byref(cl),
            ctypes.byref(_c_strides(chunk, n)), scratch, buf.data_ptr(),
            _stream())
    else:
        rc = lib.hk1_masked_reduce(valid.data_ptr(), n, ctypes.byref(cl),
                                   scratch, buf.data_ptr(), _stream())
    _ext.check(rc, "masked_reduce_batched" if batched else "masked_reduce")
    return buf[:n_out].view(nmem, width)


def masked_reduce(valid: torch.Tensor, lanes) -> torch.Tensor:
    """Global masked reduction.  Returns int64[2 + 2 * len(lanes)] on
    ``valid``'s device: [n_valid, first valid row (0 when none), then per
    lane its value (float64 bit-cast) and its live count].  Empty lanes
    hold the identity (0, +inf / int64 max for min, -inf / int64 min for
    max); float min/max propagate NaN."""
    n = int(valid.shape[0])
    dev = valid.device
    on_card = _on_card(valid, "masked_reduce")
    _need(valid, torch.bool, n, dev, "masked_reduce valid")
    lanes = _norm_lanes(lanes, n, dev, "masked_reduce")
    if not on_card:
        return masked_reduce_plain(valid, lanes)
    from . import _ext
    lib = _ext.lib("masked_reduce")
    outs = []
    for c0 in range(0, max(len(lanes), 1), _MAX_LANES):
        out = _hk1_launch(lib, valid, 1, n, lanes[c0:c0 + _MAX_LANES],
                          False)[0]
        _count(LAUNCHES, "masked_reduce")
        outs.append(out if not outs else out[2:])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def masked_reduce_plain(valid: torch.Tensor, lanes) -> torch.Tensor:
    """Plain torch version of HK1 (same contract, any device)."""
    _count(PLAIN_CALLS, "masked_reduce")
    return _masked_reduce_rows(valid, lanes)


def _masked_reduce_rows(valid: torch.Tensor, lanes) -> torch.Tensor:
    n = int(valid.shape[0])
    dev = valid.device
    n_valid = valid.sum()
    first = (torch.argmax(valid.to(torch.uint8)) if n
             else torch.zeros((), dtype=I64, device=dev))
    parts = [n_valid.reshape(1).to(I64), first.reshape(1).to(I64)]
    for v, m, op in lanes:
        live = valid if m is None else valid & ~m
        cnt = live.sum().reshape(1).to(I64)
        if op == "count":
            val = torch.zeros(1, dtype=I64, device=dev)
        else:
            fill = _lane_fill(v, op)
            x = torch.where(live, v, torch.full_like(v, fill))
            empty = torch.tensor(fill, dtype=v.dtype, device=dev)
            if op == "sum":
                r = x.sum()
            elif op == "min":
                r = x.min() if n else empty
            else:
                r = x.max() if n else empty
            val = _bits(r.reshape(1).to(v.dtype))
        parts += [val, cnt]
    return torch.cat(parts)


def masked_reduce_batched(valid: torch.Tensor, lanes) -> torch.Tensor:
    """HK1b: the masked reductions of B members in one launch (K12's
    stacked round).  ``valid`` bool [B, n]; each lane's values and NULL
    mask [B, n] or shared [n].  Returns int64 [B, 2 + 2 * len(lanes)],
    row b equal, bit for bit, to :func:`masked_reduce` over member b."""
    if valid.dim() != 2:
        raise ValueError("masked_reduce_batched: valid must be [B, n]")
    nmem, n = int(valid.shape[0]), int(valid.shape[1])
    dev = valid.device
    on_card = _on_card(valid, "masked_reduce_batched")
    valid = valid.contiguous()
    _need_b(valid, torch.bool, nmem, n, dev, "masked_reduce_batched valid")
    lanes = _norm_lanes(lanes, n, dev, "masked_reduce_batched", nmem)
    if not on_card:
        return masked_reduce_batched_plain(valid, lanes)
    from . import _ext
    lib = _ext.lib("masked_reduce")
    outs = []
    for c0 in range(0, max(len(lanes), 1), _MAX_LANES):
        out = _hk1_launch(lib, valid, nmem, n, lanes[c0:c0 + _MAX_LANES],
                          True)
        _count(LAUNCHES, "masked_reduce_batched")
        outs.append(out if not outs else out[:, 2:])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def masked_reduce_batched_plain(valid: torch.Tensor, lanes) -> torch.Tensor:
    """Plain torch version of HK1b: the plain HK1 over each member."""
    _count(PLAIN_CALLS, "masked_reduce_batched")
    return torch.stack([_masked_reduce_rows(valid[b], _member_lanes(lanes, b))
                        for b in range(int(valid.shape[0]))])


# =========================================================================
# HK2 segment_reduce (+ present-segment compaction)
# =========================================================================

def segment_reduce(gid: torch.Tensor, valid: torch.Tensor, ns: int,
                   lanes, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment reduction over int64 group ids in [0, ns).  Returns the
    int64 table [(2 + 2 * len(lanes)), ns]: presence, first valid row
    (sentinel n when empty), then per lane its values (float64 bit-cast;
    identity when empty) and live counts.  ``out``: a contiguous table of
    that shape to write into (the mesh tier's per-shard partials)."""
    n = int(valid.shape[0])
    dev = valid.device
    on_card = _on_card(valid, "segment_reduce")
    _need(valid, torch.bool, n, dev, "segment_reduce valid")
    gid = gid.contiguous()
    _need(gid, I64, n, dev, "segment_reduce gid")
    lanes = _norm_lanes(lanes, n, dev, "segment_reduce")
    if ns < 1:
        raise ValueError("segment_reduce: ns must be >= 1")
    if out is not None and (tuple(out.shape) != (2 + 2 * len(lanes), ns)
                            or out.dtype != I64 or not out.is_contiguous()
                            or out.device != dev):
        raise ValueError("segment_reduce: out must be a contiguous int64 "
                         f"[{2 + 2 * len(lanes)}, {ns}] table on {dev}")
    if not on_card:
        table = segment_reduce_plain(gid, valid, ns, lanes)
        return table if out is None else out.copy_(table)
    from . import _ext
    lib = _ext.lib("segment_reduce")
    tables = []
    for c0 in range(0, max(len(lanes), 1), _MAX_LANES):
        chunk = lanes[c0:c0 + _MAX_LANES]
        whole = out is not None and len(lanes) <= _MAX_LANES
        out_c = out if whole else torch.empty(
            (2 + 2 * len(chunk), ns), dtype=I64, device=dev)
        scratch = torch.empty(max(lib.hk2_scratch_bytes(n, ns, len(chunk)),
                                  8), dtype=torch.uint8, device=dev)
        cl = _c_lanes(chunk)
        _ext.check(lib.hk2_segment_reduce(
            gid.data_ptr(), valid.data_ptr(), n, ns, ctypes.byref(cl),
            scratch.data_ptr(), out_c.data_ptr(), _stream()),
            "segment_reduce")
        _count(LAUNCHES, "segment_reduce")
        tables.append(out_c if not tables else out_c[2:])
    table = tables[0] if len(tables) == 1 else torch.cat(tables)
    return table if out is None or table is out else out.copy_(table)


def segment_reduce_plain(gid: torch.Tensor, valid: torch.Tensor, ns: int,
                         lanes) -> torch.Tensor:
    """Plain torch version of HK2 (same contract, any device)."""
    _count(PLAIN_CALLS, "segment_reduce")
    return _segment_reduce_table(gid, valid, ns, lanes)


def _segment_reduce_table(gid, valid, ns: int, lanes) -> torch.Tensor:
    n = int(valid.shape[0])
    dev = valid.device
    ok = valid & (gid >= 0) & (gid < ns)
    rows = torch.arange(n, dtype=I64, device=dev)
    g = gid[ok]
    pres = torch.zeros(ns, dtype=I64, device=dev).index_add_(
        0, g, torch.ones_like(g))
    first = torch.full((ns,), n, dtype=I64, device=dev).scatter_reduce_(
        0, g, rows[ok], "amin", include_self=True)
    out = [pres, first]
    for v, m, op in lanes:
        live = ok if m is None else ok & ~m
        gl = gid[live]
        cnt = torch.zeros(ns, dtype=I64, device=dev).index_add_(
            0, gl, torch.ones_like(gl))
        if op == "count":
            val = torch.zeros(ns, dtype=I64, device=dev)
        else:
            x = v[live]
            fill = _lane_fill(v, op)
            if op == "sum":
                r = torch.zeros(ns, dtype=v.dtype, device=dev).index_add_(
                    0, gl, x)
            else:
                r = torch.full((ns,), fill, dtype=v.dtype,
                               device=dev).scatter_reduce_(
                    0, gl, x, "amin" if op == "min" else "amax",
                    include_self=True)
            val = _bits(r)
        out += [val, cnt]
    return torch.stack(out)


def segment_reduce_batched(gid: torch.Tensor, valid: torch.Tensor, ns: int,
                           lanes) -> torch.Tensor:
    """HK2b: the per-segment reductions of B members over one set of group
    ids in one launch (K12's stacked round).  ``gid`` int64 [n] (shared),
    ``valid`` bool [B, n], each lane's values and NULL mask [B, n] or
    shared [n].  Returns int64 [B, 2 + 2 * len(lanes), ns], table b equal,
    bit for bit, to :func:`segment_reduce` over member b."""
    if valid.dim() != 2:
        raise ValueError("segment_reduce_batched: valid must be [B, n]")
    nmem, n = int(valid.shape[0]), int(valid.shape[1])
    dev = valid.device
    on_card = _on_card(valid, "segment_reduce_batched")
    valid = valid.contiguous()
    _need_b(valid, torch.bool, nmem, n, dev, "segment_reduce_batched valid")
    gid = gid.contiguous()
    _need(gid, I64, n, dev, "segment_reduce_batched gid")
    lanes = _norm_lanes(lanes, n, dev, "segment_reduce_batched", nmem)
    if ns < 1:
        raise ValueError("segment_reduce_batched: ns must be >= 1")
    if not on_card:
        return segment_reduce_batched_plain(gid, valid, ns, lanes)
    from . import _ext
    lib = _ext.lib("segment_reduce")
    tables = []
    for c0 in range(0, max(len(lanes), 1), _MAX_LANES):
        chunk = lanes[c0:c0 + _MAX_LANES]
        out = torch.empty((nmem, 2 + 2 * len(chunk), ns), dtype=I64,
                          device=dev)
        scratch = torch.empty(
            max(lib.hk2b_scratch_bytes(nmem, n, ns, len(chunk)), 8),
            dtype=torch.uint8, device=dev)
        cl, cs = _c_lanes(chunk), _c_strides(chunk, n)
        _ext.check(lib.hk2b_segment_reduce(
            gid.data_ptr(), valid.data_ptr(), nmem, n, ns, ctypes.byref(cl),
            ctypes.byref(cs), scratch.data_ptr(), out.data_ptr(),
            _stream()), "segment_reduce_batched")
        _count(LAUNCHES, "segment_reduce_batched")
        tables.append(out if not tables else out[:, 2:])
    return tables[0] if len(tables) == 1 else torch.cat(tables, dim=1)


def segment_reduce_batched_plain(gid: torch.Tensor, valid: torch.Tensor,
                                 ns: int, lanes) -> torch.Tensor:
    """Plain torch version of HK2b: the plain HK2 over each member."""
    _count(PLAIN_CALLS, "segment_reduce_batched")
    return torch.stack([
        _segment_reduce_table(gid, valid[b], ns, _member_lanes(lanes, b))
        for b in range(int(valid.shape[0]))])


#: present columns a pipeline's large output brings to the host together
#: with their count, in one transfer (:func:`present_rows`)
PRESENT_HEAD = 1 << 12


#: csrc/segment_reduce.cu's compaction tile (kPcTile: 256 threads x 2
#: segments x 4 rounds), mirrored so the wrapper sizes the tile counter
#: and the look-back words (one a tile) without a call into the library
_HK2_PRESENT_TILE = 256 * 2 * 4


def present_pack(table: torch.Tensor, ns: int, lo: int = 0,
                 ids: bool = True, head: int = 0):
    """HK2's present-segment compaction (presence row > 0), one pass on
    the card: returns (buffer, off).  ``buffer[off]`` is the count; each
    present segment, ids ascending, has a column of w words, its id
    (``ids``) and the table rows [lo, rows); the first ``head`` columns
    follow the count as rows [w, head] (one contiguous range with it), and
    every column lies in the body after them, rows [w, ns].  Words past
    the count are not written.  The buffer is sized from ns, the row count
    and ``head`` alone; no host sync."""
    table = table.contiguous()
    rows = int(table.shape[0])
    if table.dtype != I64 or table.dim() != 2 or table.shape[1] != ns \
            or not 0 <= lo <= rows or not 0 <= head <= ns:
        raise ValueError(f"present_pack: table {table.dtype}"
                         f"{tuple(table.shape)}, ns={ns}, lo={lo}, "
                         f"head={head}")
    w = int(ids) + rows - lo
    off = 1 + -(-ns // _HK2_PRESENT_TILE)
    buf = torch.empty(off + 1 + w * (head + ns), dtype=I64,
                      device=table.device)
    hd, body = buf[off + 1:off + 1 + w * head], buf[off + 1 + w * head:]
    if not _on_card(table, "present_compact"):
        _count(PLAIN_CALLS, "present_compact")
        present = torch.nonzero(table[0] > 0).reshape(-1)
        cols = table[lo:, present]
        if ids:
            cols = torch.cat([present[None, :], cols])
        n = int(present.shape[0])
        buf[off] = n
        body.view(w, ns)[:, :n] = cols
        hd.view(w, head)[:, :min(n, head)] = cols[:, :head]
        return buf, off
    from . import _ext
    _ext.check(_ext.lib("segment_reduce").hk2_present_pass(
        table.data_ptr(), rows, ns, lo, int(ids), head, buf.data_ptr(),
        buf[off:].data_ptr(), hd.data_ptr(), body.data_ptr(), _stream()),
        "present_pass")
    _count(LAUNCHES, "present_compact")
    return buf, off


def _pull_present(table: torch.Tensor, ns: int, lo: int,
                  ids: bool) -> np.ndarray:
    """The present columns of :func:`present_pack` on the host, int64[w,
    n], each row contiguous: one counted pull of the count and the first
    ``PRESENT_HEAD`` columns, a second of all of them from the body only
    when there are more."""
    w = int(ids) + int(table.shape[0]) - lo
    hb = min(PRESENT_HEAD, ns)
    buf, off = present_pack(table, ns, lo, ids, hb)
    got = d2h(buf[off:off + 1 + w * hb])
    n = int(got[0])
    if n <= hb:
        return got[1:].reshape(w, hb)[:, :n]
    return d2h(buf[off + 1 + w * hb:].view(w, ns)[:, :n])


def present_compact(table: torch.Tensor, ns: int):
    """Present segments (presence row > 0) compacted to a static bucket:
    returns (n_present, packed int64[(1 + rows), ob]) — row 0 the
    ascending segment ids (fill ns past the count), then every table row
    gathered at min(id, ns - 1).  On the card the packed rows are views of
    one buffer [1 + rows, ns] (each row contiguous); the count comes
    through one counted pull, and the fill past it is one more launch."""
    table = table.contiguous()
    if not _on_card(table, "present_compact"):
        return present_compact_plain(table, ns)
    rows = int(table.shape[0])
    buf, off = present_pack(table, ns)
    np_ = _pull_scalar(buf[off:off + 1])
    ob = min(bucket(max(np_, 1)), ns)
    packed = buf[off + 1:].view(1 + rows, ns)
    if ob > np_:
        from . import _ext
        _ext.check(_ext.lib("segment_reduce").hk2_present_pad(
            table.data_ptr(), rows, ns, np_, ob, packed.data_ptr(),
            _stream()), "present_pad")
    return np_, packed[:, :ob]


def present_compact_plain(table: torch.Tensor, ns: int):
    """Plain torch version of the present-segment compaction."""
    _count(PLAIN_CALLS, "present_compact")
    ids = torch.nonzero(table[0] > 0).reshape(-1)
    np_ = int(ids.shape[0])
    ob = min(bucket(max(np_, 1)), ns)
    full = torch.full((ob,), ns, dtype=I64, device=table.device)
    full[:np_] = ids
    safe = torch.clamp(full, max=ns - 1)
    return np_, torch.cat([full[None, :], table[:, safe]], dim=0)


def present_rows(table: torch.Tensor, ns: int) -> np.ndarray:
    """The columns of an int64 table [rows, ns] whose row 0 is positive,
    rows 1.. brought to the host (int64[rows - 1, n_present], columns
    ascending).  One transfer carries the count and the first
    ``PRESENT_HEAD`` present columns, so a small result costs one D2H and
    no count pull; a second transfer brings the rest only when there are
    more."""
    return _pull_present(table, ns, 1, False)


# =========================================================================
# HK3 equi_join
# =========================================================================
# Keys are int64 whose signed order is the key order (join_keys() maps
# float keys); l*/r* are (keys, null, valid) of the probe / build side.

def join_keys(k: torch.Tensor, null: torch.Tensor):
    """Key lane for HK3: int64 keys pass; float64 keys become order keys
    with -0.0 folded into +0.0 and NaN moved into the NULL mask."""
    if k.dtype == I64:
        return k.contiguous(), null.contiguous()
    x = k.to(F64) + 0.0  # -0.0 + 0.0 == +0.0
    nan = torch.isnan(x)
    bits = torch.where(nan, torch.zeros_like(x), x).view(I64)
    key = torch.where(bits < 0, bits ^ I64_MAX, bits)
    return key.contiguous(), (null | nan).contiguous()


def _join_checks(lk, ln, lv, rk, rn, rv):
    dev = lk.device
    nl, nr = int(lk.shape[0]), int(rk.shape[0])
    for t, dt, n, w in ((lk, I64, nl, "lk"), (ln, torch.bool, nl, "ln"),
                        (lv, torch.bool, nl, "lv"), (rk, I64, nr, "rk"),
                        (rn, torch.bool, nr, "rn"), (rv, torch.bool, nr,
                                                     "rv")):
        _need(t, dt, n, dev, f"equi_join {w}")
    return nl, nr, dev


#: csrc/equi_join.cu's workspace, mirrored so the wrapper sizes it
#: without a call into the library: the header (kHdrWords = 8) and
#: kStatBlocks = 1024 stats partials of three words, then the words the
#: memset zeroes (the stats ticket, the pick's tile counter, one look-back
#: word per tile of kPickTile = 256 * 4 probe rows)
_HK3_ZERO_OFF = 8 + 3 * 1024
_HK3_PICK_TILE = 256 * 4


def _hk3_buffers(nl: int, nr: int, dev, table: bool = True):
    """One allocation for an HK3 call: the workspace (the header at word
    0), then, 16-byte aligned, the key table sized from ``nr`` alone: the
    larger of the dense table the rule can pick (int32 x max(2^22, 4 *
    nr)) and the hash table (int64 x the power of two >= max(1024, 2 *
    nr)); the kernels fill only the entries the header names.  Returns
    (buffer, table address, table bytes)."""
    if nr >= 1 << 31:
        raise ValueError("equi_join: build side of 2^31 rows or more")
    words = _HK3_ZERO_OFF + 2 + max(1, -(-nl // _HK3_PICK_TILE))
    words += words & 1
    tbytes = 0
    if table:
        cap = 1024
        while cap < 2 * max(nr, 1):
            cap <<= 1
        tbytes = max(4 * max(1 << 22, 4 * nr), 8 * cap)
    buf = torch.empty(words + tbytes // 8, dtype=I64, device=dev)
    return buf, buf.data_ptr() + 8 * words, tbytes


def _pull_scalar(t: torch.Tensor) -> int:
    """A counted pull of one int64 (an output size)."""
    return int(d2h(t.reshape(1))[0])


def dense_ok(card: int, n_live: int) -> bool:
    """Dense key -> row table when the live key range is small enough
    (the reference host twin's rule; the card applies it in ej_stats)."""
    return card <= max(1 << 22, 4 * n_live)


def equi_join_unique_packed(lk, ln, lv, rk, rn, rv,
                            outer: bool = False) -> torch.Tensor:
    """Unique build side, packed: int64[1 + 2 * n_probe] = [count, li_0,
    ri_0, li_1, ri_1, ...] with li ascending.  Inner: the matched probe
    rows; outer: every valid probe row, ri = -1 where unmatched.  Among
    equal live build keys the lowest row is the match.  Words past 1 + 2 *
    count are not written.  No host pull: the count is the first word."""
    nl, nr, dev = _join_checks(lk, ln, lv, rk, rn, rv)
    if not _on_card(lk, "equi_join"):
        return equi_join_unique_packed_plain(lk, ln, lv, rk, rn, rv, outer)
    from . import _ext
    buf, tbuf, tbytes = _hk3_buffers(nl, nr, dev)
    out = torch.empty(1 + 2 * nl, dtype=I64, device=dev)
    _ext.check(_ext.lib("equi_join").hk3_unique_pick(
        lk.data_ptr(), ln.data_ptr(), lv.data_ptr(), nl, rk.data_ptr(),
        rn.data_ptr(), rv.data_ptr(), nr, int(outer), buf.data_ptr(), tbuf,
        tbytes, out.data_ptr(), _stream()), "unique_pick")
    _count(LAUNCHES, "equi_join")
    return out


def equi_join_unique_packed_plain(lk, ln, lv, rk, rn, rv, outer=False):
    """Plain torch version of :func:`equi_join_unique_packed`."""
    li, ri = equi_join_unique_plain(lk, ln, lv, rk, rn, rv, outer)
    out = torch.empty(1 + 2 * int(lk.shape[0]), dtype=I64, device=lk.device)
    n = int(li.shape[0])
    out[0] = n
    out[1:1 + 2 * n] = torch.stack([li, ri], dim=1).reshape(-1)
    return out


def equi_join_unique(lk, ln, lv, rk, rn, rv, outer: bool = False):
    """Unique build side: (li, ri) int64 tensors, li ascending (the
    packed call's pairs after one counted pull of the count; on the card
    strided views into its buffer).  Inner: the matched probe rows;
    outer: every valid probe row, ri = -1 where unmatched.  Among equal
    live build keys the lowest row is the match."""
    _join_checks(lk, ln, lv, rk, rn, rv)
    if not _on_card(lk, "equi_join"):
        return equi_join_unique_plain(lk, ln, lv, rk, rn, rv, outer)
    out = equi_join_unique_packed(lk, ln, lv, rk, rn, rv, outer)
    n = _pull_scalar(out[:1])
    pairs = out[1:1 + 2 * n].view(n, 2)
    return pairs[:, 0], pairs[:, 1]


def _unique_probe_plain(lk, ln, lv, rk, rn, rv):
    """Plain torch version of HK3's unique probe: (match, cand)."""
    r_live = rv & ~rn
    bidx = torch.nonzero(r_live).reshape(-1)
    bk = rk[bidx]
    order = torch.argsort(bk, stable=True)
    sk, srow = bk[order], bidx[order]
    l_live = lv & ~ln
    if sk.numel():
        pos = torch.searchsorted(sk, lk)
        pos_c = torch.clamp(pos, max=sk.numel() - 1)
        match = l_live & (pos < sk.numel()) & (sk[pos_c] == lk)
        cand = torch.where(match, srow[pos_c], torch.full_like(lk, -1))
    else:
        match = torch.zeros_like(l_live)
        cand = torch.full_like(lk, -1)
    return match, cand


def equi_join_unique_plain(lk, ln, lv, rk, rn, rv, outer=False):
    """Plain torch version of the unique HK3 mode (same contract)."""
    _count(PLAIN_CALLS, "equi_join")
    match, cand = _unique_probe_plain(lk, ln, lv, rk, rn, rv)
    keep = lv if outer else match
    li = torch.nonzero(keep).reshape(-1)
    ri = torch.where(match[li], cand[li], torch.full_like(li, -1))
    return li, ri


def unique_match(lk, ln, lv, rk, rn, rv) -> torch.Tensor:
    """HK3's membership alone (K8's test): bool per probe row, true when
    the live probe key equals some live build key.  No host pull."""
    nl, nr, dev = _join_checks(lk, ln, lv, rk, rn, rv)
    if not _on_card(lk, "equi_join"):
        _count(PLAIN_CALLS, "equi_join")
        return _unique_probe_plain(lk, ln, lv, rk, rn, rv)[0]
    from . import _ext
    buf, tbuf, tbytes = _hk3_buffers(nl, nr, dev)
    match = torch.empty(nl, dtype=torch.bool, device=dev)
    _ext.check(_ext.lib("equi_join").hk3_unique_match(
        lk.data_ptr(), ln.data_ptr(), lv.data_ptr(), nl, rk.data_ptr(),
        rn.data_ptr(), rv.data_ptr(), nr, buf.data_ptr(), tbuf, tbytes,
        match.data_ptr(), _stream()), "unique_match")
    _count(LAUNCHES, "equi_join")
    return match


def equi_join_header(rk, rn, rv) -> torch.Tensor:
    """HK3's build header on the card (ej_stats), no host pull: an int64
    tensor whose first words are [live rows, kmin, kmax, dense (1) or
    hash (0), table size] (the rest is the kernel's workspace)."""
    ws, _, _ = _hk3_buffers(0, int(rk.shape[0]), rk.device, table=False)
    from . import _ext
    _ext.check(_ext.lib("equi_join").hk3_build_stats(
        rk.data_ptr(), rn.data_ptr(), rv.data_ptr(), int(rk.shape[0]),
        ws.data_ptr(), _stream()), "build_stats")
    return ws


def equi_join_mult_count(lk, ln, lv, rk, rn, rv, outer: bool = False):
    """Any build multiplicity, phase 1: (plan, total), ``total`` the
    output size as an int64[1] tensor on the probe's device (no host
    pull); :func:`equi_join_mult_expand` writes the pairs."""
    nl, nr, dev = _join_checks(lk, ln, lv, rk, rn, rv)
    if not _on_card(lk, "equi_join"):
        return _mult_count_plain(lk, ln, lv, rk, rn, rv, outer)
    from . import _ext
    lib = _ext.lib("equi_join")
    ws = equi_join_header(rk, rn, rv)
    dead = (~(rv & ~rn)).to(I64)
    perm = lex_order([dead, rk ^ I64_MIN], nr) if nr else \
        torch.empty(0, dtype=I64, device=dev)
    lo = torch.empty(nl, dtype=I64, device=dev)
    cnt = torch.empty(nl, dtype=I64, device=dev)
    incl = torch.empty(nl, dtype=I64, device=dev)
    nb = max((nl + 1023) // 1024, 1)
    btot = torch.empty(nb + 1, dtype=I64, device=dev)
    _ext.check(lib.hk3_mult_count(
        lk.data_ptr(), ln.data_ptr(), lv.data_ptr(), nl, rk.data_ptr(),
        perm.data_ptr(), ws.data_ptr(), int(outer), lo.data_ptr(),
        cnt.data_ptr(), incl.data_ptr(), btot.data_ptr(),
        btot[nb:].data_ptr(), _stream()), "mult_count")
    _count(LAUNCHES, "equi_join")
    return ("card", lv, lo, cnt, incl, perm, outer), btot[nb:]


def equi_join_mult_expand(plan, total: int):
    """Any build multiplicity, phase 2: (li, ri) of ``total`` pairs (the
    host's pulled copy of phase 1's total)."""
    if plan[0] == "plain":
        return _mult_expand_plain(plan, total)
    from . import _ext
    _, lv, lo, cnt, incl, perm, outer = plan
    nl, dev = int(lv.shape[0]), lv.device
    li = torch.empty(total, dtype=I64, device=dev)
    ri = torch.empty(total, dtype=I64, device=dev)
    if total:
        _ext.check(_ext.lib("equi_join").hk3_mult_expand(
            lv.data_ptr(), nl, lo.data_ptr(), cnt.data_ptr(), incl.data_ptr(),
            perm.data_ptr(), int(outer), total, li.data_ptr(), ri.data_ptr(),
            _stream()), "mult_expand")
    return li, ri


def equi_join_mult(lk, ln, lv, rk, rn, rv, outer: bool = False):
    """Any build multiplicity: (li, ri) in probe-major order, build rows
    of one probe row in ascending row order; outer joins emit each
    unmatched valid probe row once with ri = -1.  One counted pull: the
    output size between the two phases."""
    plan, total = equi_join_mult_count(lk, ln, lv, rk, rn, rv, outer)
    return equi_join_mult_expand(plan, _pull_scalar(total))


def _mult_count_plain(lk, ln, lv, rk, rn, rv, outer):
    """Plain torch version of phase 1 (counts one plain call)."""
    _count(PLAIN_CALLS, "equi_join")
    r_live = rv & ~rn
    bidx = torch.nonzero(r_live).reshape(-1)
    bk = rk[bidx]
    order = torch.argsort(bk, stable=True)
    sk, srow = bk[order], bidx[order]
    l_live = lv & ~ln
    lo = torch.searchsorted(sk, lk)
    hi = torch.searchsorted(sk, lk, right=True)
    counts = torch.where(l_live, hi - lo, torch.zeros_like(lo))
    eff = torch.where(lv & (counts == 0), torch.ones_like(counts),
                      counts) if outer else counts
    return ("plain", lo, counts, eff, srow), eff.sum().reshape(1)


def _mult_expand_plain(plan, total: int):
    """Plain torch version of phase 2."""
    _, lo, counts, eff, srow = plan
    dev = lo.device
    if total == 0:
        z = torch.empty(0, dtype=I64, device=dev)
        return z, z
    li = torch.repeat_interleave(torch.arange(len(lo), dtype=I64,
                                              device=dev), eff)
    starts = torch.cumsum(eff, 0) - eff
    pos = torch.arange(total, dtype=I64, device=dev) - starts[li]
    matched = counts[li] > 0
    ridx = torch.clamp(lo[li] + pos, max=max(srow.numel() - 1, 0))
    ri = torch.where(matched, srow[ridx] if srow.numel()
                     else torch.zeros_like(ridx), torch.full_like(li, -1))
    return li, ri


def equi_join_mult_plain(lk, ln, lv, rk, rn, rv, outer=False):
    """Plain torch version of the any-multiplicity HK3 mode (the two
    phases, the output size read without a counted pull)."""
    plan, total = _mult_count_plain(lk, ln, lv, rk, rn, rv, outer)
    return _mult_expand_plain(plan, int(total))


# =========================================================================
# HK4 lex_order
# =========================================================================
# Lanes are int64 tensors holding uint64 ORDER keys (compared unsigned);
# the row index is the implicit last lane.

def lex_order(lanes: Sequence[torch.Tensor], n: int,
              k: Optional[int] = None) -> torch.Tensor:
    """Row indices of the first min(k, n) rows (all n when k is None) in
    ascending lexicographic order of (lanes..., row)."""
    lanes = [t.contiguous() for t in lanes]
    if not lanes:
        raise ValueError("lex_order: no lanes")
    dev = lanes[0].device
    for t in lanes:
        _need(t, I64, n, dev, "lex_order lane")
    on_card = _on_card(lanes[0], "lex_order")
    want = n if k is None else max(0, min(int(k), n))
    if not on_card:
        return lex_order_plain(lanes, n)[:want]
    if n == 0 or want == 0:
        return torch.empty(0, dtype=I64, device=dev)
    from . import _ext
    lib = _ext.lib("lex_order")
    perm = None
    # more than _MAX_SORT_LANES lanes: stable passes from the least
    # significant group to the most, each keyed by its place in the last
    groups = [lanes[i:i + _MAX_SORT_LANES]
              for i in range(0, len(lanes), _MAX_SORT_LANES)]
    for gi in range(len(groups) - 1, -1, -1):
        grp = groups[gi]
        if perm is not None:
            grp = [t[perm].contiguous() for t in grp]
        m = len(grp)
        kk = want if (gi == 0 and k is not None) else -1
        cin = _CSortIn()
        for j, t in enumerate(grp):
            cin.lanes[j] = t.data_ptr()
        cin.pos = None
        scratch = torch.empty(max(lib.hk4_scratch_bytes(m, n, kk), 8),
                              dtype=torch.uint8, device=dev)
        out = torch.empty(n if kk < 0 else kk, dtype=I64, device=dev)
        _ext.check(lib.hk4_lex_order(ctypes.byref(cin), m, n, kk,
                                     scratch.data_ptr(), out.data_ptr(),
                                     _stream()), "lex_order")
        _count(LAUNCHES, "lex_order")
        perm = out if perm is None else perm[out]
    return perm


def lex_order_plain(lanes, n: int) -> torch.Tensor:
    """Plain torch version of HK4 (the full order; a top-k is its
    prefix): least-significant-first stable sorts, uint64 order compared
    as signed after flipping the sign bit."""
    _count(PLAIN_CALLS, "lex_order")
    perm = torch.arange(n, dtype=I64, device=lanes[0].device)
    for t in reversed(lanes):
        s = (t ^ I64_MIN)[perm]
        perm = perm[torch.argsort(s, stable=True)]
    return perm


def _u64_lane(v: torch.Tensor, desc: bool) -> torch.Tensor:
    """One sort key's values as a uint64 order lane: integers through the
    sign-bit flip (DESC through ~v first, the overflow-free reversal);
    floats through their monotone bits (DESC through -v, so NaN stays
    last as in jnp.lexsort; -0.0 folds into +0.0)."""
    if v.dtype == F64:
        x = (-v if desc else v) + 0.0
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        bits = x.view(I64)
        return torch.where(bits < 0, ~bits, bits ^ I64_MIN)
    x = ~v if desc else v
    return x ^ I64_MIN


def sort_lanes(keys, descs, valid: torch.Tensor,
               zero_nulls: bool = True) -> List[torch.Tensor]:
    """HK4 lanes for (values, null) key pairs: per key a NULL-rank lane
    (NULL first ascending, last descending) and a value lane; invalid rows
    rank after every valid row (folded into the first rank lane).  ORDER
    BY zeroes the values under NULLs (ties then go by row); the group-by
    sort keeps them, as the reference's does."""
    lanes = []
    for i, ((v, m), desc) in enumerate(zip(keys, descs)):
        m = m.to(torch.bool)
        rank = (m if desc else ~m).to(I64)
        if i == 0:
            rank = rank + 2 * (~valid).to(I64)
        vv = torch.where(m, torch.zeros_like(v), v) if zero_nulls else v
        lanes += [rank, _u64_lane(vv, desc)]
    if not lanes:
        lanes = [(~valid).to(I64)]
    return lanes


# =========================================================================
# HK5 csr_reduce
# =========================================================================

#: HK5 reserves one lane slot for its presence pseudo-lane
_MAX_CSR_LANES = _MAX_LANES - 1


def csr_reduce(order: torch.Tensor, ends: torch.Tensor,
               valid: torch.Tensor, lanes, n_rows: int,
               ng: int) -> torch.Tensor:
    """Per-group reduction over a precomputed sorted order (a group
    index).  ``order`` int64[nb] maps sorted positions to rows (positions
    at or past ``n_rows`` are padding); ``ends`` int64[ngb] holds each
    group's last sorted position (groups at or past ``ng`` are padding);
    ``valid`` and the lanes are in row space; the live positions name
    distinct rows below ``n_rows`` (a group index is a permutation of its
    rows).  Returns HK2's table layout,
    int64[(2 + 2 * len(lanes)), ngb]: presence, first valid row (sentinel
    ``n_rows`` when none), then per lane its values (float64 bit-cast;
    identity when empty) and live counts."""
    nb = int(order.shape[0])
    ngb = int(ends.shape[0])
    dev = order.device
    on_card = _on_card(order, "csr_reduce")
    order, ends, valid = order.contiguous(), ends.contiguous(), \
        valid.contiguous()
    _need(order, I64, nb, dev, "csr_reduce order")
    _need(ends, I64, ngb, dev, "csr_reduce ends")
    _need(valid, torch.bool, nb, dev, "csr_reduce valid")
    lanes = _norm_lanes(lanes, nb, dev, "csr_reduce")
    if ngb < 1 or not 0 <= ng <= ngb or not 0 <= n_rows <= nb:
        raise ValueError(f"csr_reduce: bad sizes n_rows={n_rows} nb={nb} "
                         f"ng={ng} ngb={ngb}")
    if not on_card:
        return csr_reduce_plain(order, ends, valid, lanes, n_rows, ng)
    from . import _ext
    lib = _ext.lib("csr_reduce")
    tables = []
    for c0 in range(0, max(len(lanes), 1), _MAX_CSR_LANES):
        chunk = lanes[c0:c0 + _MAX_CSR_LANES]
        out = torch.empty((2 + 2 * len(chunk), ngb), dtype=I64, device=dev)
        scratch = torch.empty(max(lib.hk5_scratch_bytes(n_rows, len(chunk)),
                                  8), dtype=torch.uint8, device=dev)
        cl = _c_lanes(chunk)
        _ext.check(lib.hk5_csr_reduce(
            order.data_ptr(), ends.data_ptr(), valid.data_ptr(), n_rows, ng,
            ngb, ctypes.byref(cl), scratch.data_ptr(), out.data_ptr(),
            _stream()), "csr_reduce")
        _count(LAUNCHES, "csr_reduce")
        tables.append(out if not tables else out[2:])
    return tables[0] if len(tables) == 1 else torch.cat(tables)


def _order_flip(b: torch.Tensor) -> torch.Tensor:
    """float64 bits <-> int64 order keys whose signed order is the float
    order (-0.0 < +0.0), as the kernels' f64_order_key (an involution)."""
    return torch.where(b < 0, b ^ I64_MAX, b)


def csr_reduce_plain(order, ends, valid, lanes, n_rows: int,
                     ng: int) -> torch.Tensor:
    """Plain torch version of HK5 (same contract, any device): a group id
    per sorted position from ``ends``, then index_add_ / scatter_reduce_
    in sorted order.  Float min/max compare order keys and propagate NaN,
    as the kernel does."""
    _count(PLAIN_CALLS, "csr_reduce")
    nb = int(order.shape[0])
    ngb = int(ends.shape[0])
    dev = order.device
    pos = torch.arange(nb, dtype=I64, device=dev)
    gpos = torch.searchsorted(ends[:ng].contiguous(), pos)
    in_table = (pos < n_rows) & (gpos < ng)
    rows = torch.where(in_table, order, torch.zeros_like(order))
    vs = in_table & valid[rows]
    g, r = gpos[vs], rows[vs]
    pres = torch.zeros(ngb, dtype=I64, device=dev).index_add_(
        0, g, torch.ones_like(g))
    first = torch.full((ngb,), n_rows, dtype=I64, device=dev).scatter_reduce_(
        0, g, r, "amin", include_self=True)
    out = [pres, first]
    for v, m, op in lanes:
        live = vs if m is None else vs & ~m[rows]
        gl, rl = gpos[live], rows[live]
        cnt = torch.zeros(ngb, dtype=I64, device=dev).index_add_(
            0, gl, torch.ones_like(gl))
        if op == "count":
            val = torch.zeros(ngb, dtype=I64, device=dev)
        elif op == "sum":
            val = _bits(torch.zeros(ngb, dtype=v.dtype, device=dev)
                        .index_add_(0, gl, v[rl]))
        else:
            red = "amin" if op == "min" else "amax"
            fill = I64_MAX if op == "min" else I64_MIN
            x = v[rl]
            if v.dtype == F64:
                nan = torch.isnan(x)
                k = torch.full((ngb,), fill, dtype=I64, device=dev) \
                    .scatter_reduce_(0, gl[~nan], _order_flip(
                        x[~nan].view(I64)), red, include_self=True)
                ident = torch.tensor(_lane_fill(v, op), dtype=F64,
                                     device=dev).view(I64)
                val = torch.where(cnt == 0, ident, _order_flip(k))
                has_nan = torch.zeros(ngb, dtype=torch.bool, device=dev)
                has_nan[gl[nan]] = True
                val = torch.where(has_nan, torch.tensor(
                    float("nan"), dtype=F64, device=dev).view(I64), val)
            else:
                val = torch.full((ngb,), fill, dtype=I64, device=dev) \
                    .scatter_reduce_(0, gl, x, red, include_self=True)
        out += [val, cnt]
    return torch.stack(out)


# =========================================================================
# HK6 dense_probe
# =========================================================================

_PROBE_MODES = {"inner": 0, "left": 1, "semi": 2, "anti": 3}
#: key lanes of one probe (dense_table.cuh's kMaxKeys)
_MAX_KEYS = 8


class _CGather(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p * _MAX_LANES),
                ("nulls", ctypes.c_void_p * _MAX_LANES),
                ("out_vals", ctypes.c_void_p * _MAX_LANES),
                ("out_nulls", ctypes.c_void_p * _MAX_LANES),
                ("width", ctypes.c_int * _MAX_LANES),
                ("side", ctypes.c_int * _MAX_LANES),
                ("n", ctypes.c_int)]


def _gathers(lanes, n_out: int, dev):
    """dense_table.cuh's GatherLanes for ``lanes`` [(side, values, NULL
    mask or None)], kMaxLanes a launch: yields (struct, [(side, out
    values, out NULL flags)]) with the outputs of n_out slots; one empty
    struct for no lanes."""
    for c0 in range(0, max(len(lanes), 1), _MAX_LANES):
        chunk = lanes[c0:c0 + _MAX_LANES]
        cg = _CGather()
        cg.n = len(chunk)
        outs = []
        for j, (side, v, m) in enumerate(chunk):
            ov = torch.empty(n_out, dtype=v.dtype, device=dev)
            om = torch.empty(n_out, dtype=torch.bool, device=dev)
            cg.vals[j] = v.data_ptr()
            cg.nulls[j] = _ptr(m)
            cg.out_vals[j] = ov.data_ptr()
            cg.out_nulls[j] = om.data_ptr()
            cg.width[j] = v.element_size()
            cg.side[j] = side
            outs.append((side, ov, om))
        yield cg, outs


class _CKeySet(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p * _MAX_KEYS),
                ("nulls", ctypes.c_void_p * _MAX_KEYS),
                ("lo", ctypes.c_int64 * _MAX_KEYS),
                ("hi", ctypes.c_int64 * _MAX_KEYS),
                ("stride", ctypes.c_int64 * _MAX_KEYS),
                ("n", ctypes.c_int)]


def _key_set(keys, spec) -> _CKeySet:
    """keys: [(int64 values, bool NULL mask or None)]; spec: per key (lo,
    hi, stride) of the composite lane (ignored for one key)."""
    c = _CKeySet()
    c.n = len(keys)
    for j, (v, m) in enumerate(keys):
        c.vals[j] = v.data_ptr()
        c.nulls[j] = _ptr(m)
        if spec is not None:
            c.lo[j], c.hi[j], c.stride[j] = (int(x) for x in spec[j])
    return c


def _check_keys(keys, spec, nb: int, dev, what: str):
    if not 1 <= len(keys) <= _MAX_KEYS or (
            len(keys) > 1 and (spec is None or len(spec) != len(keys))):
        raise ValueError(f"{what}: {len(keys)} keys, spec {spec}")
    out = []
    for v, m in keys:
        v = v.contiguous()
        _need(v, I64, nb, dev, f"{what} key")
        if m is not None:
            m = m.contiguous()
            _need(m, torch.bool, nb, dev, f"{what} key null")
        out.append((v, m))
    return out


def probe_keys_plain(keys, spec):
    """The probe key lane of dense_table.cuh (same contract): (key, ok).
    One key: the lane itself, ok where not NULL.  Several: the composite
    lane sum((k_j - lo_j) * stride_j), ok where every part is not NULL
    and inside [lo_j, hi_j] (the offsets of other rows are not taken)."""
    if len(keys) == 1:
        v, m = keys[0]
        return v, (torch.ones_like(v, dtype=torch.bool) if m is None
                   else ~m)
    ok = torch.ones_like(keys[0][0], dtype=torch.bool)
    for (v, m), (lo, hi, _st) in zip(keys, spec):
        ok = ok & (v >= lo) & (v <= hi)
        if m is not None:
            ok = ok & ~m
    comp = torch.zeros_like(keys[0][0])
    for (v, _m), (lo, _hi, st) in zip(keys, spec):
        comp = comp + (torch.where(ok, v, torch.full_like(v, lo)) - lo) * st
    return comp, ok


def table_lookup_plain(tbl, lo: int, hi: int, key, ok):
    """dense_table.cuh's in-range lookup: tbl[min(key - lo, len - 1)] for
    a usable key inside [lo, hi], else -1 (key - lo taken only there)."""
    tbl_len = int(tbl.shape[0])
    inr = ok & (key >= lo) & (key <= hi)
    if not tbl_len:
        return torch.full_like(key, -1)
    off = (torch.where(inr, key, torch.full_like(key, lo)) - lo).clamp(
        max=tbl_len - 1)
    return torch.where(inr, tbl[off].to(I64), torch.full_like(key, -1))


def _probe_checks(pvalid, tbl, bvalid, blanes, mode):
    nb = int(pvalid.shape[0])
    dev = pvalid.device
    pvalid = pvalid.contiguous()
    _need(pvalid, torch.bool, nb, dev, "dense_probe valid")
    tbl = tbl.contiguous()
    _need(tbl, torch.int32, int(tbl.shape[0]), dev, "dense_probe table")
    bvalid = bvalid.contiguous()
    nbb = int(bvalid.shape[0])
    _need(bvalid, torch.bool, nbb, dev, "dense_probe build valid")
    if nbb < 1 or mode not in _PROBE_MODES:
        raise ValueError(f"dense_probe: nbb={nbb} mode={mode}")
    lanes = []
    for v, m in blanes:
        v = v.contiguous()
        _need(v, v.dtype, nbb, dev, "dense_probe build lane")
        if m is not None:
            m = m.contiguous()
            _need(m, torch.bool, nbb, dev, "dense_probe build null")
        lanes.append((v, m))
    return pvalid, tbl, bvalid, lanes


def dense_probe(kp, knull, pvalid, lo: int, hi: int, tbl, bvalid, blanes,
                mode: str):
    """Probe int64 keys (``kp``, NULL flags ``knull``, probe validity
    ``pvalid``) through a dense table ``tbl`` int32[hi - lo + 1] mapping
    key - lo to a build row (-1 = absent), live where ``bvalid`` holds.
    ``mode`` is inner, left, semi or anti.  Returns (valid_out, gathered):
    valid_out is pvalid (left), pvalid and matched (inner, semi) or pvalid
    and unmatched (anti); for inner and left, ``gathered`` holds each
    build lane (values, null) gathered per probe row, NULL where
    unmatched; for semi and anti it is empty."""
    return _dense_probe([(kp, knull)], None, pvalid, lo, hi, tbl, bvalid,
                        blanes, mode)


def dense_probe_multi(keys, spec, pvalid, tbl, bvalid, blanes, mode: str):
    """K18's multi-key unique mode: :func:`dense_probe` keyed by the
    composite lane of ``keys`` (spec: per key (lo, hi, stride)), through
    a table indexed by the composite lane itself."""
    return _dense_probe(keys, spec, pvalid, 0, int(tbl.shape[0]) - 1, tbl,
                        bvalid, blanes, mode)


def _dense_probe(keys, spec, pvalid, lo, hi, tbl, bvalid, blanes, mode):
    pvalid, tbl, bvalid, blanes = _probe_checks(pvalid, tbl, bvalid, blanes,
                                                mode)
    nb = int(pvalid.shape[0])
    dev = pvalid.device
    keys = _check_keys(keys, spec, nb, dev, "dense_probe")
    if not _on_card(pvalid, "dense_probe"):
        return _dense_probe_plain(keys, spec, pvalid, lo, hi, tbl, bvalid,
                                  blanes, mode)
    from . import _ext
    lib = _ext.lib("dense_probe")
    ks = _key_set(keys, spec)
    lanes = blanes if mode in ("inner", "left") else []
    nbb = int(bvalid.shape[0])
    at, sws, rec_at, total = _probe_plan(nb, nbb, int(tbl.shape[0]), lanes)
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    outs = [(buf[ov:ov + nb * v.element_size()].view(v.dtype),
             buf[on:on + nb].view(torch.bool))
            for (v, _m), (ov, on) in zip(lanes, at)]
    args = (ctypes.byref(ks), pvalid.data_ptr(), nb, int(lo), int(hi),
            tbl.data_ptr(), int(tbl.shape[0]), bvalid.data_ptr(), nbb,
            _PROBE_MODES[mode])
    for k, sw in enumerate(sws):
        chunk = lanes[k * _MAX_LANES:(k + 1) * _MAX_LANES]
        cat = at[k * _MAX_LANES:(k + 1) * _MAX_LANES]
        n = len(chunk)
        cg = _CGather()
        cg.n = n
        cg.vals[:n] = [v.data_ptr() for v, _m in chunk]
        cg.nulls[:n] = [_ptr(m) for _v, m in chunk]
        cg.out_vals[:n] = [base + ov for ov, _on in cat]
        cg.out_nulls[:n] = [base + on for _ov, on in cat]
        cg.width[:n] = [v.element_size() for v, _m in chunk]
        # a launch past the first kMaxLanes lanes leaves the mask alone
        _ext.check(lib.hk6_dense_probe(
            *args, ctypes.byref(cg), base + rec_at if sw else None, sw,
            base if k == 0 else None, _stream()), "dense_probe")
        _count(LAUNCHES, "dense_probe")
    return buf[:nb].view(torch.bool), outs


def _probe_plan(nb: int, nbb: int, tbl_len: int, lanes):
    """HK6's one buffer: the valid mask, then each lane's values and NULL
    flags, every part at a 16-byte boundary (the kernel's packed stores
    and 16-byte record loads), then the records of the launches that pack
    them (kMaxLanes lanes a launch).  Returns ([(values offset, NULL
    flags offset)] a lane, [record words] a launch, records offset, total
    bytes)."""
    at, total = [], _a16(nb)
    for v, _m in lanes:
        nv = _a16(nb * v.element_size())
        at.append((total, total + nv))
        total += nv + _a16(nb)
    sws = [_dense_records(nb, nbb, tbl_len, lanes[c0:c0 + _MAX_LANES])
           for c0 in range(0, max(len(lanes), 1), _MAX_LANES)]
    return at, sws, total, max(total + 8 * (tbl_len + 1) * max(sws), 16)


def _a16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def _dense_records(nb: int, nbb: int, tbl_len: int, lanes) -> int:
    """Words of HK6's records for a launch gathering ``lanes`` [(values,
    NULL mask or None)], or 0 for the row path.  A record a table slot
    (and one for keys with no slot) holds a flag word (the named build
    row's validity, each lane's NULL flag) and each lane's value in 8
    bytes, padded to 16 bytes, read 16 bytes a load: words / 2 random
    requests a probe row, where the row path makes 2 + a value and a NULL
    flag a lane (table entry, validity, lanes).  The records pay when the
    requests they save over the probe rows, at a 32-byte sector each,
    exceed their pack (a sector a random read of the table's build rows,
    and the records written) plus ``_RECORD_LAUNCH_BYTES``, and they stay
    in L2: at most ``_RECORD_L2_BYTES``, or no larger than what the row
    path reads at random.  Measured on an H100 (bench/probe_bench.py, each
    path forced): records win at Q3's join 1 (150,001 slots: 0.054 device
    ms against 0.098 with two lanes, 0.022 against 0.031 for semi / anti,
    0.28 against 0.52 with 16 lanes) and lose at join 2 (a 6M-slot table,
    192 MB of records: 0.26 against 0.114) and at the composite probe (2M
    slots, 64 MB: 0.152 against 0.083), where their random reads miss
    L2."""
    sw = 2 * -(-(1 + len(lanes)) // 2)
    nulls = sum(m is not None for _v, m in lanes)
    rows = 2 + len(lanes) + nulls
    records = (tbl_len + 1) * 8 * sw
    arrays = 4 * tbl_len + nbb * (1 + nulls + sum(
        v.element_size() for v, _m in lanes))
    pack = (tbl_len + 1) * (4 + 32 * (rows - 1)) + records
    saved = nb * 32 * (rows - sw // 2)
    if records > max(_RECORD_L2_BYTES, arrays):
        return 0
    return sw if saved > pack + _RECORD_LAUNCH_BYTES else 0


#: the cost of dp_pack's launch as bytes at the HBM rate (3 us at 3.35
#: TB/s)
_RECORD_LAUNCH_BYTES = 10 << 20
#: records up to half the H100's 50 MB L2 stay there while the probe runs
_RECORD_L2_BYTES = 25 << 20


def dense_probe_plain(kp, knull, pvalid, lo: int, hi: int, tbl, bvalid,
                      blanes, mode: str):
    """Plain torch version of HK6 (same contract, any device)."""
    return _dense_probe_plain([(kp, knull)], None, pvalid, lo, hi, tbl,
                              bvalid, blanes, mode)


def dense_probe_multi_plain(keys, spec, pvalid, tbl, bvalid, blanes,
                            mode: str):
    """Plain torch version of HK6's composite mode."""
    return _dense_probe_plain(keys, spec, pvalid, 0, int(tbl.shape[0]) - 1,
                              tbl, bvalid, blanes, mode)


def _dense_probe_plain(keys, spec, pvalid, lo, hi, tbl, bvalid, blanes,
                       mode):
    _count(PLAIN_CALLS, "dense_probe")
    nbb = int(bvalid.shape[0])
    key, ok = probe_keys_plain(keys, spec)
    pos = table_lookup_plain(tbl, lo, hi, key, ok)
    ps = pos.clamp(0, nbb - 1)
    match = (pos >= 0) & bvalid[ps]
    if mode == "left":
        valid_out = pvalid.clone()
    elif mode == "anti":
        valid_out = pvalid & ~match
    else:
        valid_out = pvalid & match
    if mode not in ("inner", "left"):
        return valid_out, []
    outs = []
    for v, m in blanes:
        gn = ~match if m is None else m[ps] | ~match
        outs.append((v[ps], gn))
    return valid_out, outs


# =========================================================================
# HK8 csr_expand
# =========================================================================

def csr_expand(order, ends, ng: int, n_rows: int, bvalid, tbl, lo: int,
               hi: int, keys, spec, pvalid, outer: bool, ob: int, probe_lanes,
               build_lanes, shards: int = 1):
    """K18's multiplicity join over the build's group index (HK8).

    ``order`` int64[nbb] / ``ends`` int64[ngb]: the group index of the
    build rows (sorted positions at or past ``n_rows`` and groups at or
    past ``ng`` are padding); ``bvalid`` bool[nbb] the build validity in
    row space; ``tbl`` int32 maps a key in [lo, hi] to its group (-1
    absent).  ``keys`` / ``spec``: the probe key lanes (one key, or the
    composite lane as :func:`dense_probe_multi` takes it); ``pvalid`` the
    probe validity; ``outer`` LEFT's null extension.  Output: the static
    bucket of ``ob`` slots, probe rows ascending and each one's valid
    build rows in group-index order: (valid_out bool[ob], probe lanes
    gathered, build lanes gathered with their NULL flag or-ed with
    "unmatched").  Slots past the total are invalid and name probe row 0
    and build row 0; ``ob`` must bound the total (the caller bounds it
    from the pre-filter group sizes).

    Shard mode (``shards`` > 1, K18 mult on the mesh, counted as
    ``csr_expand_shard``): shard s expands its own probe rows
    [s * nb / shards, (s + 1) * nb / shards) into its own bucket
    [s * ob, (s + 1) * ob) (``ob`` per shard), over the same build
    structures; its invalid slots name its first probe row."""
    order, ends = order.contiguous(), ends.contiguous()
    nbb, ngb = int(order.shape[0]), int(ends.shape[0])
    dev = order.device
    _need(order, I64, nbb, dev, "csr_expand order")
    _need(ends, I64, ngb, dev, "csr_expand ends")
    bvalid = bvalid.contiguous()
    _need(bvalid, torch.bool, nbb, dev, "csr_expand build valid")
    tbl = tbl.contiguous()
    _need(tbl, torch.int32, int(tbl.shape[0]), dev, "csr_expand table")
    pvalid = pvalid.contiguous()
    nb = int(pvalid.shape[0])
    _need(pvalid, torch.bool, nb, dev, "csr_expand probe valid")
    keys = _check_keys(keys, spec, nb, dev, "csr_expand")
    lanes = []
    for side, (ls, n) in enumerate(((probe_lanes, nb), (build_lanes, nbb))):
        for v, m in ls:
            v = v.contiguous()
            _need(v, v.dtype, n, dev, "csr_expand lane")
            if m is not None:
                m = m.contiguous()
                _need(m, torch.bool, n, dev, "csr_expand lane null")
            lanes.append((side, v, m))
    shards = int(shards)
    if not (0 <= ng <= ngb and 0 <= n_rows <= nbb and ob >= 1
            and shards >= 1 and nb % shards == 0):
        raise ValueError(f"csr_expand: ng={ng} ngb={ngb} n_rows={n_rows} "
                         f"nbb={nbb} ob={ob} shards={shards} nb={nb}")
    if not _on_card(pvalid, "csr_expand"):
        return csr_expand_plain(order, ends, ng, n_rows, bvalid, tbl, lo, hi,
                                keys, spec, pvalid, outer, ob,
                                [(v, m) for s_, v, m in lanes if s_ == 0],
                                [(v, m) for s_, v, m in lanes if s_ == 1],
                                shards=shards)
    from . import _ext
    lib = _ext.lib("csr_expand")
    scratch = torch.empty(lib.hk8_scratch_words(n_rows, ng, nb, shards),
                          dtype=I64, device=dev)
    n_out = ob * shards
    valid_out = torch.empty(n_out, dtype=torch.bool, device=dev)
    ks = _key_set(keys, spec)
    groups = list(_gathers(lanes, n_out, dev))
    tables = (_CGather * len(groups))(*[cg for cg, _got in groups])
    _ext.check(lib.hk8_csr_expand(
        order.data_ptr(), nbb, n_rows, ends.data_ptr(), ng,
        bvalid.data_ptr(), tbl.data_ptr(), int(tbl.shape[0]), int(lo),
        int(hi), ctypes.byref(ks), pvalid.data_ptr(), nb, int(outer), ob,
        shards, scratch.data_ptr(), tables, len(groups),
        valid_out.data_ptr(), _stream()), "csr_expand")
    outs = [o for _cg, got in groups for o in got]
    _count(LAUNCHES, "csr_expand" if shards == 1 else "csr_expand_shard")
    return (valid_out, [(v, m) for s_, v, m in outs if s_ == 0],
            [(v, m) for s_, v, m in outs if s_ == 1])


def csr_expand_plain(order, ends, ng: int, n_rows: int, bvalid, tbl,
                     lo: int, hi: int, keys, spec, pvalid, outer: bool,
                     ob: int, probe_lanes, build_lanes, shards: int = 1):
    """Plain torch version of HK8 (same contract, any device): the
    reference's kernel (valid counts from a cumsum over the sorted
    validity, the compacted order, probe -> group -> multiplicity, an
    exclusive scan), with each output slot's probe row found by a
    search over the inclusive ends instead of a running max.  Shard
    mode: the same over each shard's slice of the probe, concatenated."""
    _count(PLAIN_CALLS, "csr_expand" if shards == 1 else "csr_expand_shard")
    if shards > 1:
        nbl = int(pvalid.shape[0]) // shards
        parts = []
        for s in range(shards):
            sl = slice(s * nbl, (s + 1) * nbl)
            parts.append(_csr_expand_rows(
                order, ends, ng, n_rows, bvalid, tbl, lo, hi,
                [(v[sl], None if m is None else m[sl]) for v, m in keys],
                spec, pvalid[sl], outer, ob,
                [(v[sl], m if m is None else m[sl]) for v, m in probe_lanes],
                build_lanes))
        return (torch.cat([p[0] for p in parts]),
                [(torch.cat([p[1][j][0] for p in parts]),
                  torch.cat([p[1][j][1] for p in parts]))
                 for j in range(len(probe_lanes))],
                [(torch.cat([p[2][j][0] for p in parts]),
                  torch.cat([p[2][j][1] for p in parts]))
                 for j in range(len(build_lanes))])
    return _csr_expand_rows(order, ends, ng, n_rows, bvalid, tbl, lo, hi,
                            keys, spec, pvalid, outer, ob, probe_lanes,
                            build_lanes)


def _csr_expand_rows(order, ends, ng: int, n_rows: int, bvalid, tbl,
                     lo: int, hi: int, keys, spec, pvalid, outer: bool,
                     ob: int, probe_lanes, build_lanes):
    dev = order.device
    nbb, ngb = int(order.shape[0]), int(ends.shape[0])
    pos = torch.arange(nbb, dtype=I64, device=dev)
    vs = (pos < n_rows) & bvalid[order]
    cx = torch.zeros(nbb + 1, dtype=I64, device=dev)
    cx[1:] = torch.cumsum(vs.to(I64), 0)
    comp = order[torch.nonzero(vs).reshape(-1)]
    gidx = torch.arange(ngb, dtype=I64, device=dev)
    start = torch.where(gidx > 0, torch.cat([ends[:1], ends[:-1]]) + 1,
                        torch.zeros_like(ends))
    key, ok = probe_keys_plain(keys, spec)
    g = table_lookup_plain(tbl, lo, hi, key, ok & pvalid)
    g = torch.where(g < ng, g, torch.full_like(g, -1))
    gs = g.clamp(0, max(ngb - 1, 0))
    m = torch.where(g >= 0, cx[ends[gs] + 1] - cx[start[gs]],
                    torch.zeros_like(g))
    cnt = torch.where(pvalid, m.clamp(min=1), torch.zeros_like(m)) \
        if outer else m
    incl = torch.cumsum(cnt, 0)
    total = incl[-1] if incl.numel() else torch.zeros((), dtype=I64,
                                                      device=dev)
    j = torch.arange(ob, dtype=I64, device=dev)
    live = j < total
    p = torch.searchsorted(incl, j, right=True)
    p = torch.where(live, p, torch.zeros_like(p))
    k = j - (incl[p] - cnt[p])
    gp = g[p]
    matched = live & (gp >= 0) & (k < m[p])
    at = torch.where(matched, cx[start[gp.clamp(0, max(ngb - 1, 0))]] + k,
                     torch.zeros_like(k))
    brow = comp[at.clamp(0, max(comp.numel() - 1, 0))] if comp.numel() \
        else torch.zeros_like(at)
    brow = torch.where(matched, brow, torch.zeros_like(brow))
    pcols = [(v[p], torch.zeros(ob, dtype=torch.bool, device=dev)
              if mk is None else mk[p]) for v, mk in probe_lanes]
    bcols = [(v[brow], ~matched if mk is None else mk[brow] | ~matched)
             for v, mk in build_lanes]
    return live, pcols, bcols


# =========================================================================
# HK9 run_bounds
# =========================================================================

class _CRunKeys(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p * _MAX_KEYS),
                ("nulls", ctypes.c_void_p * _MAX_KEYS),
                ("is_f64", ctypes.c_int * _MAX_KEYS),
                ("n", ctypes.c_int)]


#: csrc/run_bounds.cu's tile (kRbTile: 256 threads x 4 sorted positions),
#: mirrored so the wrapper sizes the tile counter and the look-back words
_HK9_TILE = 256 * 4


def run_bounds(perm, valid, keys, want_gid: bool = False):
    """Runs of equal keys in a sorted order (HK9): ``perm`` int64[n]
    (valid rows first), ``valid`` bool[n] and ``keys`` [(int64 or float64
    values, bool NULL mask or None)] in row space; equal means both NULL
    or neither NULL and equal values (floats as floats).  Returns (count
    int64[1], lead int64[n], ends int64[n], gid int64[n] or None), all on
    ``perm``'s device: the group count; each group's leader position (0
    from the count on); each group's last sorted position (from the count
    on the last group's, -1 when there is none, so padding groups are
    empty runs); each row's group number (n for an invalid row)."""
    perm, valid = perm.contiguous(), valid.contiguous()
    n = int(perm.shape[0])
    dev = perm.device
    _need(perm, I64, n, dev, "run_bounds perm")
    _need(valid, torch.bool, n, dev, "run_bounds valid")
    if n < 1 or len(keys) > _MAX_KEYS:
        raise ValueError(f"run_bounds: n={n}, {len(keys)} keys")
    ks = []
    for v, m in keys:
        v = v.contiguous()
        if v.dtype not in (I64, F64):
            raise ValueError(f"run_bounds: key dtype {v.dtype}")
        _need(v, v.dtype, n, dev, "run_bounds key")
        if m is not None:
            m = m.contiguous()
            _need(m, torch.bool, n, dev, "run_bounds key null")
        ks.append((v, m))
    if not _on_card(perm, "run_bounds"):
        return run_bounds_plain(perm, valid, ks, want_gid)
    from . import _ext
    lib = _ext.lib("run_bounds")
    ck = _CRunKeys()
    ck.n = len(ks)
    for j, (v, m) in enumerate(ks):
        ck.vals[j] = v.data_ptr()
        ck.nulls[j] = _ptr(m)
        ck.is_f64[j] = int(v.dtype == F64)
    # [count, tile counter, a look-back word a tile]
    buf = torch.empty(2 + -(-n // _HK9_TILE), dtype=I64, device=dev)
    lead = torch.empty(n, dtype=I64, device=dev)
    ends = torch.empty(n, dtype=I64, device=dev)
    gid = torch.empty(n, dtype=I64, device=dev) if want_gid else None
    _ext.check(lib.hk9_run_bounds(
        perm.data_ptr(), n, valid.data_ptr(), ctypes.byref(ck),
        buf[1:].data_ptr(), buf.data_ptr(), lead.data_ptr(),
        ends.data_ptr(), _ptr(gid), _stream()), "run_bounds")
    _count(LAUNCHES, "run_bounds")
    return buf[:1], lead, ends, gid


def run_bounds_plain(perm, valid, keys, want_gid: bool = False):
    """Plain torch version of HK9 (same contract, any device): the
    reference's boundary diff over the sorted lanes, leaders, their
    cumsum, and each group's end where the next position leads a group
    or is invalid."""
    _count(PLAIN_CALLS, "run_bounds")
    n = int(perm.shape[0])
    dev = perm.device
    vs = valid[perm]
    same = torch.ones(max(n - 1, 0), dtype=torch.bool, device=dev)
    for v, m in keys:
        a = v[perm]
        eq = a[1:] == a[:-1]
        if m is None:
            same &= eq
        else:
            b = m[perm]
            same &= (b[1:] == b[:-1]) & (eq | b[1:])
    t = torch.ones(1, dtype=torch.bool, device=dev)
    lead_f = vs & torch.cat([t, ~vs[:-1] | ~same])
    end_f = vs & torch.cat([~vs[1:] | ~same, t])
    gnum = torch.cumsum(lead_f.to(I64), 0)
    count = gnum[-1:].clone()
    lead_pos = torch.nonzero(lead_f).reshape(-1)
    end_pos = torch.nonzero(end_f).reshape(-1)
    ng = int(lead_pos.shape[0])
    lead = torch.zeros(n, dtype=I64, device=dev)
    lead[:ng] = lead_pos
    ends = torch.full((n,), int(end_pos[-1]) if ng else -1, dtype=I64,
                      device=dev)
    ends[:ng] = end_pos
    gid = None
    if want_gid:
        gid = torch.empty(n, dtype=I64, device=dev)
        gid[perm] = torch.where(vs, gnum - 1, torch.full_like(gnum, n))
    return count, lead, ends, gid


# =========================================================================
# HK7 expr_eval
# =========================================================================
# An expression program (ops/exprjit.ExprProgram) over the columns of a
# view: ``cols`` is indexed by schema slot, each entry a (values, NULL
# mask) pair of device tensors (None where the program reads nothing);
# ``params`` the (int64, float64) parameter arrays on the same device.

class _CInLanes(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p * _xj.MAX_IN),
                ("nulls", ctypes.c_void_p * _xj.MAX_IN),
                ("n", ctypes.c_int)]


class _CInStrides(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_int64 * _xj.MAX_IN),
                ("nulls", ctypes.c_int64 * _xj.MAX_IN)]


class _COutLanes(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p * _xj.MAX_OUT),
                ("nulls", ctypes.c_void_p * _xj.MAX_OUT),
                ("guard", ctypes.c_int * _xj.MAX_OUT),
                ("n", ctypes.c_int)]


_LANE_DTYPE = {"i": I64, "f": F64, "b": torch.bool}


def _expr_lanes(prog, cols, n: int, dev):
    """The program's input lanes, checked: (values or None, NULL mask or
    None) per (slot, kind) of ``prog.inputs``."""
    out = []
    for slot, kind in prog.inputs:
        pair = cols[slot] if slot < len(cols) else None
        if pair is None:
            raise ValueError(f"expr_eval: no column at slot {slot}")
        v, m = pair
        if kind == "n":
            v = None
        else:
            if v is None:
                raise ValueError(f"expr_eval: slot {slot} has no values")
            v = v.contiguous()
            _need(v, _LANE_DTYPE[kind], n, dev, f"expr_eval slot {slot}")
        if m is not None:
            m = m.contiguous()
            _need(m, torch.bool, n, dev, f"expr_eval slot {slot} NULLs")
        out.append((v, m))
    return out


def expr_eval(prog, cols, params, n: int, n_rows: Optional[int] = None,
              mask_in: Optional[torch.Tensor] = None):
    """HK7: run an expression program over ``n`` rows.  Returns (mask,
    outs): the bool mask (``mask_in`` AND every condition; None when the
    program has no condition) and per output lane (values or None for a
    NULL-only lane, bool NULL mask).  Rows at or past ``n_rows`` (default
    n) are not evaluated: mask False, outputs 0 and NULL."""
    pi, pf = params
    dev = pi.device
    on_card = _on_card(pi, "expr_eval")
    n_rows = n if n_rows is None else max(0, min(int(n_rows), n))
    lanes = _expr_lanes(prog, cols, n, dev)
    if mask_in is not None:
        mask_in = mask_in.contiguous()
        _need(mask_in, torch.bool, n, dev, "expr_eval mask_in")
    if not on_card:
        return _expr_plain(prog, lanes, params, n, n_rows, mask_in)
    from . import _ext
    lib = _ext.lib("expr_eval")
    pi = pi.contiguous()
    pf = pf.contiguous().view(I64)
    code, offs = prog.device_code(dev)
    outs = [(None if dt == "n" else
             torch.empty(n, dtype=_LANE_DTYPE[dt], device=dev),
             torch.empty(n, dtype=torch.bool, device=dev))
            for dt in prog.outputs]
    tmps = [(torch.empty(n, dtype=I64, device=dev),
             torch.empty(n, dtype=torch.bool, device=dev))
            for _ in range(prog.n_tmp())]
    mask = torch.empty(n, dtype=torch.bool, device=dev) \
        if prog.has_mask else None
    m_in = mask_in
    for seg, off in zip(prog.segments(), offs):
        ci = _CInLanes()
        ci.n = len(seg.in_refs)
        for j, (src, k) in enumerate(seg.in_refs):
            v, m = lanes[k] if src == "in" else tmps[k]
            ci.vals[j] = _ptr(v)
            ci.nulls[j] = _ptr(m)
        co = _COutLanes()
        co.n = len(seg.out_refs)
        for j, (src, k) in enumerate(seg.out_refs):
            v, m = outs[k] if src == "out" else tmps[k]
            co.vals[j] = _ptr(v)
            co.nulls[j] = _ptr(m)
            co.guard[j] = int(src == "out")
        _ext.check(lib.hk7_expr_eval(
            code.data_ptr() + 4 * off, int(seg.code.shape[0]), seg.n_regs,
            ctypes.byref(ci), ctypes.byref(co), _ptr(pi), _ptr(pf),
            _ptr(m_in), _ptr(mask), n_rows, n, _stream()), "expr_eval")
        if mask is not None:
            m_in = mask
    _count(LAUNCHES, "expr_eval")
    return mask, outs


def expr_eval_plain(prog, cols, params, n: int,
                    n_rows: Optional[int] = None,
                    mask_in: Optional[torch.Tensor] = None):
    """Plain torch version of HK7 (same contract, any device)."""
    pi = params[0]
    n_rows = n if n_rows is None else max(0, min(int(n_rows), n))
    return _expr_plain(prog, _expr_lanes(prog, cols, n, pi.device),
                       params, n, n_rows, mask_in)


def _as_bool(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.bool else x != 0


def expr_eval_batched(prog, cols, params, n: int,
                      n_rows: Optional[int] = None,
                      mask_in: Optional[torch.Tensor] = None):
    """HK7b: one program over shared input lanes for B members, each with
    its own parameter row, in one launch per program segment (K12's
    stacked round).  ``params``: (int64 [B, Ni], float64 [B, Nf]);
    ``mask_in``: bool [n] (shared), [B, n] or None.  Returns (mask bool
    [B, n] or None, per output lane (values [B, n] or None, NULL [B, n])),
    member b's rows equal, bit for bit, to :func:`expr_eval` with its
    parameters."""
    pi, pf = params
    if pi.dim() != 2 or pf.dim() != 2 or pi.shape[0] != pf.shape[0]:
        raise ValueError("expr_eval_batched: params must be [B, Ni], "
                         "[B, Nf]")
    nmem = int(pi.shape[0])
    dev = pi.device
    on_card = _on_card(pi, "expr_eval_batched")
    n_rows = n if n_rows is None else max(0, min(int(n_rows), n))
    lanes = _expr_lanes(prog, cols, n, dev)
    if mask_in is not None:
        mask_in = mask_in.contiguous()
        _need_b(mask_in, torch.bool, nmem, n, dev, "expr_eval_batched mask_in")
    if not on_card:
        return _expr_plain_batched(prog, lanes, params, n, n_rows, mask_in)
    from . import _ext
    lib = _ext.lib("expr_eval")
    pi = pi.contiguous()
    pf = pf.contiguous().view(I64)
    code, offs = prog.device_code(dev)
    outs = [(None if dt == "n" else
             torch.empty((nmem, n), dtype=_LANE_DTYPE[dt], device=dev),
             torch.empty((nmem, n), dtype=torch.bool, device=dev))
            for dt in prog.outputs]
    tmps = [(torch.empty((nmem, n), dtype=I64, device=dev),
             torch.empty((nmem, n), dtype=torch.bool, device=dev))
            for _ in range(prog.n_tmp())]
    mask = torch.empty((nmem, n), dtype=torch.bool, device=dev) \
        if prog.has_mask else None
    m_in = mask_in
    mstride = n if mask_in is not None and mask_in.dim() == 2 else 0
    for seg, off in zip(prog.segments(), offs):
        ci, cs = _CInLanes(), _CInStrides()
        ci.n = len(seg.in_refs)
        for j, (src, k) in enumerate(seg.in_refs):
            v, m = lanes[k] if src == "in" else tmps[k]
            ci.vals[j] = _ptr(v)
            ci.nulls[j] = _ptr(m)
            if src != "in":  # a temporary: one row per member
                cs.vals[j] = 8 * n
                cs.nulls[j] = n
        co = _COutLanes()
        co.n = len(seg.out_refs)
        for j, (src, k) in enumerate(seg.out_refs):
            v, m = outs[k] if src == "out" else tmps[k]
            co.vals[j] = _ptr(v)
            co.nulls[j] = _ptr(m)
            co.guard[j] = int(src == "out")
        _ext.check(lib.hk7b_expr_eval(
            code.data_ptr() + 4 * off, int(seg.code.shape[0]), seg.n_regs,
            ctypes.byref(ci), ctypes.byref(cs), ctypes.byref(co), _ptr(pi),
            int(pi.shape[1]), _ptr(pf), int(pf.shape[1]), _ptr(m_in),
            mstride, _ptr(mask), nmem, n_rows, n, _stream()),
            "expr_eval_batched")
        if mask is not None:
            m_in, mstride = mask, n
    _count(LAUNCHES, "expr_eval_batched")
    return mask, outs


def expr_eval_batched_plain(prog, cols, params, n: int,
                            n_rows: Optional[int] = None,
                            mask_in: Optional[torch.Tensor] = None):
    """Plain torch version of HK7b: the plain HK7 over each member."""
    n_rows = n if n_rows is None else max(0, min(int(n_rows), n))
    return _expr_plain_batched(
        prog, _expr_lanes(prog, cols, n, params[0].device), params, n,
        n_rows, mask_in)


def _expr_plain_batched(prog, lanes, params, n: int, n_rows: int, mask_in):
    _count(PLAIN_CALLS, "expr_eval_batched")
    pi, pf = params
    got = [_expr_rows(prog, lanes, (pi[b], pf[b]), n, n_rows,
                      _member(mask_in, b))
           for b in range(int(pi.shape[0]))]
    mask = None if got[0][0] is None else torch.stack([g[0] for g in got])
    outs = []
    for k in range(len(prog.outputs)):
        vals = [g[1][k][0] for g in got]
        outs.append((None if vals[0] is None else torch.stack(vals),
                     torch.stack([g[1][k][1] for g in got])))
    return mask, outs


def _expr_plain(prog, lanes, params, n: int, n_rows: int, mask_in):
    _count(PLAIN_CALLS, "expr_eval")
    return _expr_rows(prog, lanes, params, n, n_rows, mask_in)


def _expr_rows(prog, lanes, params, n: int, n_rows: int, mask_in):
    """Run the program's segments instruction by instruction with
    ops/exprjit's own functions: _apply for every SQL function, its
    CASE / IN steps, code_cmp for K14 and the K15 layout formulas."""
    X = _xj
    pi, pf = params
    dev = pi.device
    zeros_b = torch.zeros(n, dtype=torch.bool, device=dev)
    want = {"i": I64, "f": F64}
    outs: List = [None] * len(prog.outputs)
    tmps: Dict[int, tuple] = {}
    mask = None
    if prog.has_mask:
        mask = mask_in.clone() if mask_in is not None else \
            torch.ones(n, dtype=torch.bool, device=dev)
    for seg in prog.segments():
        R: List = [None] * X.MAX_REGS
        for kind, d, u, meta, ddt in seg.plain:
            a = [R[x] for x in u]
            if kind == "ld":
                src, k = seg.in_refs[meta[0]]
                if src == "tmp":
                    R[d[0]] = tmps[k]
                    continue
                v, m = lanes[k]
                if v is None:
                    v = torch.zeros(n, dtype=I64, device=dev)
                R[d[0]] = (v, zeros_b if m is None else m)
                continue
            if kind == "st":
                dst, k = seg.out_refs[meta[0]]
                v, m = a[0]
                if dst == "tmp":
                    if v.dtype == torch.bool:
                        v = v.to(I64)
                    tmps[k] = (v.expand(n).contiguous(),
                               m.expand(n).contiguous())
                else:
                    outs[k] = (None if meta[1] else v.expand(n).contiguous(),
                               m.expand(n).contiguous())
                continue
            if kind == "mask":
                v, m = a[0]
                mask = mask & (v != 0) & ~m
                continue
            if kind == "ldc":
                which, slot, is_null = meta
                R[d[0]] = (params[which][slot].expand(n),
                           torch.full((n,), bool(is_null), dtype=torch.bool,
                                      device=dev))
            elif kind == "fn":
                name, arg_types, arg_uns, ret_int = meta
                R[d[0]] = X._apply(name, a, list(arg_types), ret_int,
                                   list(arg_uns))
            elif kind == "case_init":
                v, m, dec = X.case_init(n, want[meta[0]], dev)
                R[d[0]], R[d[1]] = (v, m), (dec, zeros_b)
                continue
            elif kind == "case_arm":
                (v, m), (dec, _), c, r = a
                v, m, dec = X.case_arm(v, m, _as_bool(dec), c, r,
                                       want[meta[0]])
                R[d[0]], R[d[1]] = (v, m), (dec, zeros_b)
            elif kind == "case_else":
                (v, m), (dec, _), r = a
                R[d[0]] = X.case_else(v, m, _as_bool(dec), r, want[meta[0]])
            elif kind == "in_init":
                R[d[0]] = X.in_init(n, dev)
                continue
            elif kind == "in_item":
                (hit, saw), x, it = a
                R[d[0]] = X.in_item(_as_bool(hit), saw, x, it, *meta)
                continue
            elif kind == "in_end":
                (hit, saw), x = a
                R[d[0]] = X.in_end(_as_bool(hit), saw, x[1])
            elif kind == "codecmp":
                op, lo, hi, card = meta
                code, null = a[0]
                r = X.code_cmp(op, code, pi[lo], pi[hi], pi[card], null=null)
                R[d[0]] = (r.to(I64), torch.zeros_like(null))
            elif kind == "keydec":
                stride, card, base = meta
                (ids, _), (live, _) = a
                code = torch.remainder(
                    torch.div(ids, pi[stride], rounding_mode="floor"),
                    pi[card] + 1)
                nullk = (code == pi[card]) | ~_as_bool(live)
                R[d[0]] = (torch.where(nullk, torch.zeros_like(code),
                                       code + pi[base]), nullk)
            elif kind == "avg":
                (sv, sm), (cv, _) = a
                den = torch.clamp(cv, min=1).to(F64)
                R[d[0]] = (sv.to(F64) / den, sm | (cv == 0))
            elif kind == "cvt":
                v, m = a[0]
                R[d[0]] = (X._to_real_u(v, meta[0] == X.CV_U2F), m)
            else:  # pragma: no cover
                raise ValueError(f"expr_eval: unknown instruction {kind}")
            got = R[d[0]][0].dtype
            if ddt in want and got != want[ddt]:
                raise RuntimeError(f"expr_eval: {kind} {meta} gave {got}, "
                                   f"the program says {ddt}")
    if n_rows < n:
        keep = torch.arange(n, device=dev) < n_rows
        outs = [(None if v is None else
                 torch.where(keep, v, torch.zeros_like(v)),
                 torch.where(keep, m, torch.ones_like(m)))
                for v, m in outs]
        if mask is not None:
            mask = mask & keep
    return mask, outs


# =========================================================================
# operator families (the reference's host entry points)
# =========================================================================
# The fused entry points take ONE HK7 expression program (exprjit.
# compile_program with mask=True) evaluating the filter conditions and the
# aggregate arguments, with ``lane_of`` giving per spec its output lane
# (None: no argument), and a mask spec:
#   ("host", bool_mask_dev)  — host-evaluated mask, uploaded: the
#                              program's incoming mask
#   ("dev", key)             — the program's own conditions; `key`
#                              joins the program key

def _mask_parts(mask):
    if mask[0] == "host":
        return ("hostmask",), mask[1]
    return ("devmask", mask[1]), None


def _params_dev(params):
    """The (int64, float64) parameter arrays on the device in ONE upload
    (the float64 slots travel as their bits).  A stacked round's
    parameters ([B, Ni], [B, Nf], exprjit.ParamTable.stack) upload the
    same way, one row per member."""
    if params is None:
        dev = device()
        return (torch.zeros(0, dtype=I64, device=dev),
                torch.zeros(0, dtype=F64, device=dev))
    pi, pf = params
    pi = np.asarray(pi, dtype=np.int64)
    ni = pi.shape[-1]
    t = h2d(np.concatenate([pi, np.asarray(pf, dtype=np.float64)
                            .view(np.int64)], axis=-1))
    return t[..., :ni].contiguous(), t[..., ni:].contiguous().view(F64)


def _spec_lanes(agg_specs, arg_pairs):
    """(lanes, plan): the reduction lanes of a list of aggregate specs and,
    per spec, how to read its output: ("nvalid",) for count_star or
    (func, lane index, float?).  ``arg_pairs``: per spec its argument's
    (values, NULL) pair, or None."""
    lanes, plan = [], []
    for (func, has_arg), ap in zip(agg_specs, arg_pairs):
        av = an = None
        if has_arg and ap is not None:
            av, an = ap
        if func == "count_star":
            plan.append(("count_star", -1, False))
            continue
        if func == "count":
            lanes.append((None, an, "count"))
        elif func in ("sum", "sum_int", "sum0"):
            lanes.append((av, an, "sum"))
        elif func in ("min", "max"):
            lanes.append((av, an, func))
        else:  # pragma: no cover
            raise ValueError(func)
        is_f = av is not None and av.dtype == F64 and func != "count"
        plan.append((func, len(lanes) - 1, is_f))
    return lanes, plan


def _run_agg_program(prog, lane_of, cols, mask_in, pr, nb: int,
                     n_rows: int):
    """HK7 over a fused aggregate's program: (valid mask, per spec its
    argument pair or None)."""
    valid, outs = expr_eval(prog, cols, pr, nb, n_rows=n_rows,
                            mask_in=mask_in)
    return valid, [None if j is None else outs[j] for j in lane_of]


def _lane_outputs(plan, value_row, count_row, presence):
    """Per spec (values, null) from the reduction outputs (numpy or
    torch): counts are never NULL, SUM/MIN/MAX are NULL over no live row,
    sum0 (a merged COUNT) is 0 over empty input."""
    outs = []
    for func, j, is_f in plan:
        if func == "count_star":
            outs.append((presence, presence != presence))
            continue
        cnt = count_row(j)
        if func == "count":
            outs.append((cnt, cnt != cnt))
            continue
        v = value_row(j, is_f)
        null = (cnt != cnt) if func == "sum0" else (cnt == 0)
        outs.append((v, null))
    return outs


def _np_value(bits: np.ndarray, is_f: bool) -> np.ndarray:
    return bits.view(np.float64) if is_f else bits


def _batch_round(mask, params, batchable: bool):
    """Cross-query micro-batching eligibility at a fused dispatch site
    (ops/batching.py): only explicitly batchable single-shot call sites
    with a params-compiled device mask qualify — the combination that
    makes one registered program serve a whole constant-variant digest
    family.  Records the ``batchable`` obs marker (the session's close
    hook learns family eligibility from it) and returns the active batch
    round, or None."""
    if not (batchable and mask[0] == "dev" and params is not None):
        return None
    _obs.record("batchable", 1)
    from . import batching
    return batching.current()


# ---- stacked-params batch execution (ops/batching.py dispatch leg) --------
# A batch round's parked members share one registered program and one set
# of replica-memoized data columns; only their ~100-byte parameter rows
# differ.  Stacking those on a leading batch axis (exprjit.ParamTable.
# stack) and running the program's batched variant — HK7b over the B
# parameter rows, then HK1b or HK2b over the B masks and lane sets — makes
# a whole round one launch of each instead of B back-to-back replays.
# Variants register in progcache under the base key extended with a
# power-of-two OCCUPANCY BUCKET (occupancy 3 runs the B=4 variant with an
# inert padding row), like any program family (prewarm_stacked).

def _stackable_launch(program, kind: str, stacked):
    """counted_launch + the stacking recipe (``stack_info``) that
    :func:`stacked_variant` reads: ``kind`` is the output protocol
    ("packed" = one [B, L] table pulled in one transfer, "tree" = per-
    member device slices) and ``stacked`` the batched program, called
    with the same data arguments and the stacked parameters."""
    w = counted_launch(program)
    w.stack_info = (kind, stacked)
    return w


def occupancy_bucket(n: int) -> int:
    """Power-of-two batch bucket for a stacked round (min 2 — a solo
    member never stacks)."""
    b = 2
    while b < n:
        b <<= 1
    return b


def _stacked_key(key: tuple, b: int) -> tuple:
    return key + (("stacked", b),)


def is_stacked_key(key: tuple) -> bool:
    """Is this registry key a B-stacked variant of a batchable program?"""
    return bool(key) and isinstance(key[-1], tuple) and len(key[-1]) == 2 \
        and key[-1][0] == "stacked"


def stacked_variant(key: tuple, base_fn, b: int):
    """The B-stacked variant of a batchable fused program, registered
    under the base key extended with the occupancy bucket ``b``.  Returns
    ``(counted batched program, kind)`` — kind ``"packed"`` outputs pull
    as one ``[B, L]`` table, kind ``"tree"`` outputs slice per member on
    the device — or None when the base program carries no stacking
    recipe."""
    info = getattr(base_fn, "stack_info", None)
    if info is None:
        return None
    kind, stacked = info
    return progcache.get(_stacked_key(key, b),
                         lambda: (counted_launch(stacked), kind))


def prewarm_stacked(buckets=(2, 4, 8, 16)) -> int:
    """Register the B-bucketed stacked variants of every registered
    batchable fused program (the auto-prewarm worker calls this inside
    its prewarm scope), so a storm's first stacked round is a plain
    registry hit.  Returns the number of variants now registered."""
    n = 0
    for key in progcache.keys("scalar") + progcache.keys("seg"):
        if is_stacked_key(key):
            continue
        fn = progcache.peek(key)
        if getattr(fn, "stack_info", None) is None:
            continue
        for b in buckets:
            if stacked_variant(key, fn, int(b)) is not None:
                n += 1
    return n


def prewarm_bucket(nb: int) -> int:
    """The reference AOT-compiles its bucket-keyed sort and top-k programs
    here.  The port's kernels take any shape; what a server pays once is
    the build of the kernel libraries (ops/_ext.py), done here on a CUDA
    device.  Returns the number of libraries built by this call."""
    if device().type != "cuda":
        return 0
    from . import _ext
    built = bool(_ext._LIBS)
    _ext.lib("masked_reduce")
    return 0 if built else len(_ext.SOURCES)


def fused_scalar_aggregate(dev_cols, agg_specs, prog, lane_of,
                           n_rows: int, nb: int, mask,
                           program_key: tuple = (), params=None,
                           batchable: bool = False):
    """Global-group fused path (K1 -> HK7 + HK1): one HK7 launch
    evaluates the filter mask and the argument expressions, one masked
    reduction produces every aggregate, one pull brings them back.
    Returns (out_aggs, first_orig) with zero or one output row.
    ``batchable=True`` (single-shot executor call sites) opts the
    dispatch into cross-query micro-batching (ops/batching.py): inside a
    batch round it parks (collect) and consumes its member's row of the
    stacked dispatch (replay)."""
    mask_key, mask_arr = _mask_parts(mask)
    key = ("scalar", tuple(agg_specs), program_key, mask_key, nb)
    args = (dev_cols, mask_arr, n_rows)
    rnd = _batch_round(mask, params, batchable)
    if rnd is not None and rnd.collecting:
        ent = progcache.peek(key)
        if ent is not None:  # warm programs only: cold families stay solo
            rnd.park(key, ent, args, params)

    def build():
        xp, lo = prog, list(lane_of)

        def program(cols, mask_in, n, pr):
            valid, pairs = _run_agg_program(xp, lo, cols, mask_in, pr, nb,
                                            n)
            lanes, plan = _spec_lanes(agg_specs, pairs)
            return masked_reduce(valid, lanes), plan

        def stacked(cols, mask_in, n, prs):
            valid, outs = expr_eval_batched(xp, cols, prs, nb, n_rows=n,
                                            mask_in=mask_in)
            lanes, plan = _spec_lanes(
                agg_specs, [None if j is None else outs[j] for j in lo])
            return masked_reduce_batched(valid, lanes), plan
        return _stackable_launch(program, "packed", stacked)
    fn = progcache.get(key, build)
    if rnd is not None and rnd.replaying:
        got = rnd.consume(key, args, params)
        if got is not None:
            # consume attributed the member's share of the round's
            # dispatch to this scope; a "host" row was pulled with the
            # whole stacked table
            tag, (out, plan) = got
            return _scalar_contract(out if tag == "host" else d2h(out),
                                    plan)
    out, plan = fn(*args, _params_dev(params))
    return _scalar_contract(d2h(out), plan)


def _scalar_contract(vals: np.ndarray, plan):
    n_valid = int(vals[0])
    ng = 1 if n_valid > 0 else 0
    first = vals[1:2][:ng]
    outs = _lane_outputs(
        plan, lambda j, f: _np_value(vals[2 + 2 * j:3 + 2 * j], f),
        lambda j: vals[3 + 2 * j:4 + 2 * j], vals[0:1])
    return [(v[:ng], np.asarray(m, dtype=bool)[:ng]) for v, m in outs], \
        first


def scalar_aggregate(agg_specs, arg_cols, n_rows: int,
                     filter_mask: np.ndarray = None):
    """Global aggregate over argument pairs (host arrays, or device lanes
    HK7 computed) (K5 -> HK1).  Returns
    (out_aggs, first_orig) with one row when any row survives."""
    nb = bucket(max(n_rows, 1))
    valid = np.zeros(nb, dtype=bool)
    valid[:n_rows] = filter_mask if filter_mask is not None else True
    it = iter([_arg_dev(v, m, nb) for v, m in arg_cols])
    stats_add("dispatches", 1)
    lanes, plan = _spec_lanes(agg_specs, [next(it) if has else None
                                          for _, has in agg_specs])
    out = masked_reduce(h2d(valid), lanes)
    return _scalar_contract(d2h(out), plan)


def _fused_segment_raw(dev_cols, gid_dev, n_segments: int, agg_specs,
                       prog, lane_of, n_rows: int, mask,
                       program_key: tuple = (), params=None,
                       batchable: bool = False):
    """The fused segment program (K2 -> HK7 + HK2) without extraction:
    returns (table, plan, ns) with the HK2 output table on the device.
    ``batchable``: as :func:`fused_scalar_aggregate`; a member's table is
    its slice of the stacked round's HK2b output."""
    nb = int(gid_dev.shape[0])
    ns = bucket(max(n_segments, 1))
    mask_key, mask_arr = _mask_parts(mask)
    key = ("seg", tuple(agg_specs), program_key, mask_key, ns, nb)
    args = (dev_cols, gid_dev, mask_arr, n_rows)
    rnd = _batch_round(mask, params, batchable)
    if rnd is not None and rnd.collecting:
        ent = progcache.peek(key)
        if ent is not None:  # warm programs only: cold families stay solo
            rnd.park(key, ent, args, params)

    def build():
        xp, lo = prog, list(lane_of)

        def program(cols, gid, mask_in, n, pr):
            valid, pairs = _run_agg_program(xp, lo, cols, mask_in, pr, nb,
                                            n)
            lanes, plan = _spec_lanes(agg_specs, pairs)
            return segment_reduce(gid, valid, ns, lanes), plan

        def stacked(cols, gid, mask_in, n, prs):
            valid, outs = expr_eval_batched(xp, cols, prs, nb, n_rows=n,
                                            mask_in=mask_in)
            lanes, plan = _spec_lanes(
                agg_specs, [None if j is None else outs[j] for j in lo])
            return segment_reduce_batched(gid, valid, ns, lanes), plan
        # tree output: member tables slice off axis 0 on the device and
        # flow into _present_extract in the member's own scope
        return _stackable_launch(program, "tree", stacked)
    fn = progcache.get(key, build)
    if rnd is not None and rnd.replaying:
        got = rnd.consume(key, args, params)
        if got is not None:
            _tag, (table, plan) = got
            return table, plan, ns
    table, plan = fn(*args, _params_dev(params))
    return table, plan, ns


def _present_extract(table, plan, ns: int, nb: int, limit: int = None):
    """Present segments -> (present_ids, out_aggs, first_orig) host arrays:
    one pull of the whole table (small tables) or HK2's compaction, whose
    count, ids and rows come in one pull when at most ``PRESENT_HEAD``
    segments are present, in two above (large)."""
    if ns <= SMALL_PACK:
        vals = d2h(table)
        present = np.nonzero(vals[0] > 0)[0]
        rows = vals[:, present]
    else:
        cols = _pull_present(table, ns, 0, True)
        present, rows = cols[0], cols[1:]
    first = np.minimum(rows[1], nb - 1)
    outs = _lane_outputs(
        plan, lambda j, f: _np_value(np.ascontiguousarray(rows[2 + 2 * j]),
                                     f),
        lambda j: rows[3 + 2 * j], rows[0])
    out_aggs = [(np.asarray(v), np.asarray(m, dtype=bool)) for v, m in outs]
    if limit is not None:
        keep = present < limit
        if not keep.all():
            present = present[keep]
            first = first[keep]
            out_aggs = [(v[keep], m[keep]) for v, m in out_aggs]
    return present, out_aggs, first


def fused_segment_aggregate(dev_cols, gid_dev, n_segments: int,
                            agg_specs, prog, lane_of, n_rows: int, mask,
                            program_key: tuple = (), params=None,
                            batchable: bool = False):
    """Grouped fused path (K2 -> HK7 + HK2).  Returns (present_ids,
    out_aggs, first_orig) host arrays, present segments ascending.
    ``batchable=True`` (single-shot executor call sites) opts the
    dispatch into cross-query micro-batching (ops/batching.py)."""
    table, plan, ns = _fused_segment_raw(
        dev_cols, gid_dev, n_segments, agg_specs, prog, lane_of, n_rows,
        mask, program_key=program_key, params=params, batchable=batchable)
    return _present_extract(table, plan, ns, int(gid_dev.shape[0]),
                            limit=n_segments)


def fused_segment_aggregate_keep(dev_cols, gid_dev, n_segments: int,
                                 agg_specs, prog, lane_of, n_rows: int,
                                 mask, program_key: tuple = (),
                                 params=None):
    """Device-resident variant (late materialization): compacts present
    segments on the device and returns (ids [ob], live [ob], out_aggs as
    device (values, null) pairs, n_present, ob); only n_present syncs.
    Padding rows carry id = ns and live = False.  It never parks (its
    per-member device assembly cannot ride a stacked dispatch) but marks
    its digest family batchable: inside a later batch round the executor
    takes the batchable :func:`fused_segment_aggregate` route instead."""
    if mask[0] == "dev" and params is not None:
        _obs.record("batchable", 1)
    table, plan, ns = _fused_segment_raw(
        dev_cols, gid_dev, n_segments, agg_specs, prog, lane_of, n_rows,
        mask, program_key=program_key, params=params)
    np_, packed = present_compact(table, ns)
    ob = int(packed.shape[1])
    ids = packed[0]
    live = ids < ns
    rows = packed[1:]
    outs = _lane_outputs(
        plan, lambda j, f: rows[2 + 2 * j].view(F64) if f
        else rows[2 + 2 * j], lambda j: rows[3 + 2 * j], rows[0])
    out_aggs = [(v, m | ~live) for v, m in outs]
    return ids, live, out_aggs, np_, ob


def fused_segment_aggregate_sharded(mesh, dev_cols, gid_dev,
                                    n_segments: int, agg_specs, prog,
                                    lane_of, n_rows: int, mask,
                                    program_key: tuple = (), params=None):
    """The mesh variant of the fused grouped aggregate (K11): rows shard
    over the mesh's N virtual shards, HK7 evaluates the filter mask and
    the argument lanes, HK2 segment-reduces each shard's rows, and HK11
    merges the partial tables (the reference's psum / pmin / pmax).
    Returns (present_ids, out_aggs, first_orig) as
    :func:`fused_segment_aggregate` does.  The bucket must divide over
    the shards (power-of-two buckets over power-of-two meshes do)."""
    from ..parallel import dist
    from . import shardops
    nb = int(gid_dev.shape[0])
    n_dev = dist.mesh_shards(mesh)
    assert nb % n_dev == 0, (nb, n_dev)
    ns = bucket(max(n_segments, 1))
    mask_key, mask_arr = _mask_parts(mask)
    key = ("seg_sharded", tuple(agg_specs), program_key, mask_key, ns, nb,
           ("shards", n_dev))

    def build():
        xp, lo = prog, list(lane_of)

        def program(cols, gid, mask_in, n, pr):
            valid, pairs = _run_agg_program(xp, lo, cols, mask_in, pr, nb,
                                            n)
            lanes, plan = _spec_lanes(agg_specs, pairs)
            return sharded_segment_reduce(gid, valid, ns, lanes,
                                          n_dev), plan
        return counted_launch(program)
    fn = progcache.get(key, build)
    shardops.note_round(nb // n_dev)
    table, plan = fn(dev_cols, gid_dev, mask_arr, n_rows,
                     _params_dev(params))
    return _present_extract(table, plan, ns, nb, limit=n_segments)


def segment_group_aggregate(gids: np.ndarray, n_segments: int, agg_specs,
                            arg_cols, n_rows: int,
                            filter_mask: np.ndarray = None):
    """Known-cardinality group aggregate over host group ids (K3 -> HK2).
    Returns (present_ids, out_aggs, first_orig)."""
    nb = bucket(max(n_rows, 1))
    valid = np.zeros(nb, dtype=bool)
    valid[:n_rows] = filter_mask if filter_mask is not None else True
    ns = bucket(max(n_segments, 1))
    g = h2d_pad(gids.astype(np.int64), nb)
    it = iter([_arg_dev(v, m, nb) for v, m in arg_cols])
    stats_add("dispatches", 1)
    lanes, plan = _spec_lanes(agg_specs, [next(it) if has else None
                                          for _, has in agg_specs])
    table = segment_reduce(g, h2d(valid), ns, lanes)
    return _present_extract(table, plan, ns, nb)


def group_aggregate(key_cols: List[Tuple[np.ndarray, np.ndarray]],
                    agg_specs: List[Tuple[str, bool]],
                    arg_cols: List[Tuple[np.ndarray, np.ndarray]],
                    n_rows: int, filter_mask: np.ndarray = None):
    """Sort-based group-by (K4): HK4 sorts the rows by their keys (NULL
    first, invalid rows last), HK9 numbers the runs of equal keys in the
    sorted order, and HK2 reduces per group.  Groups come out in key
    order.  Returns (group_key_cols, agg_out_cols, first_orig)."""
    nb = bucket(max(n_rows, 1))
    valid_h = np.zeros(nb, dtype=bool)
    valid_h[:n_rows] = filter_mask if filter_mask is not None else True
    valid = h2d(valid_h)
    kv = [h2d_pad(v, nb) for v, _ in key_cols]
    kn = [h2d_pad(m, nb, True) for _, m in key_cols]
    stats_add("dispatches", 1)
    perm = lex_order(sort_lanes(list(zip(kv, kn)), [False] * len(kv),
                                valid, zero_nulls=False), nb)
    # HK9: group numbers per row (nb for an invalid row) and the leaders
    count, lead, _ends, gid = run_bounds(
        perm, valid, [(v if v.dtype in (I64, F64) else v.to(I64), m)
                      for v, m in zip(kv, kn)], want_gid=True)
    it = iter([_arg_dev(v, m, nb) for v, m in arg_cols])
    lanes, plan = _spec_lanes(agg_specs, [next(it) if has else None
                                          for _, has in agg_specs])
    table = segment_reduce(gid, valid, nb, lanes)
    present, out_aggs, _ = _present_extract(table, plan, nb, nb)
    # each group's representative is its FIRST row in sorted order (the
    # reference's first_orig), not its lowest row: under a NULL key rows
    # sort by their hidden values.  [count, leader rows]: one counted pull
    # of the count and the first PRESENT_HEAD rows, a second of the rest
    first = _pull_kept(torch.cat([count, perm[lead]]))
    out_keys = [(np.asarray(v)[first], np.asarray(m)[first])
                for v, m in key_cols] if len(first) else \
        [(np.asarray(v)[:0], np.asarray(m)[:0]) for v, m in key_cols]
    return out_keys, out_aggs, first


def _dev_key(a, n: int, fill):
    """Already-padded device tensors (replica-memoized keys) pass; host
    arrays upload padded."""
    if isinstance(a, torch.Tensor):
        if a.shape[0] != n:
            raise ValueError(f"padded key of {a.shape[0]} rows, want {n}")
        return a
    return h2d_pad(np.asarray(a), n, fill)


def _join_inputs(lkey, n_left: int, rkey, n_right: int, lvalid, rvalid):
    nlb, nrb = bucket(max(n_left, 1)), bucket(max(n_right, 1))
    lv = np.zeros(nlb, dtype=bool)
    lv[:n_left] = lvalid[:n_left] if lvalid is not None else True
    rv = np.zeros(nrb, dtype=bool)
    rv[:n_right] = rvalid[:n_right] if rvalid is not None else True
    lk, ln = _dev_key(lkey[0], nlb, 0), _dev_key(lkey[1], nlb, True)
    rk, rn = _dev_key(rkey[0], nrb, 0), _dev_key(rkey[1], nrb, True)
    if lk.dtype != rk.dtype:
        lk, rk = lk.to(F64), rk.to(F64)
    lk, ln = join_keys(lk, ln.to(torch.bool))
    rk, rn = join_keys(rk, rn.to(torch.bool))
    return lk, ln, h2d(lv), rk, rn, h2d(rv)


def unique_join_match(lkey, n_left: int, rkey, n_right: int,
                      outer: bool = False, lvalid: np.ndarray = None,
                      rvalid: np.ndarray = None):
    """Equi-join whose build (right) key is unique among its live rows
    (K6 -> HK3).  Returns host (left_indices, right_indices); outer joins
    keep every valid left row with right index -1 when unmatched.  HK3's
    key table needs no sorted build side, so there is no ``build_sorted``
    claim for a validity mask with holes to break (the reference's R3).

    HK3 makes no host pull before its pairs: an outer join's output size
    is the host's count of valid left rows (as in the reference), so one
    pull brings exactly the pairs; an inner join's pull brings the count
    and the first ``PRESENT_HEAD`` pairs, and a second the rest only when
    there are more."""
    lk, ln, lv, rk, rn, rv = _join_inputs(lkey, n_left, rkey, n_right,
                                             lvalid, rvalid)
    stats_add("dispatches", 1)
    out = equi_join_unique_packed(lk, ln, lv, rk, rn, rv, outer=outer)
    if outer:
        n = n_left if lvalid is None else \
            int(np.count_nonzero(lvalid[:n_left]))
        pairs = d2h(out[1:1 + 2 * n]) if n else \
            np.empty(0, dtype=np.int64)
    else:
        pairs = _pull_kept(out, width=2)
    return pairs[0::2].copy(), pairs[1::2].copy()


def join_match(lkey: Tuple[np.ndarray, np.ndarray], n_left: int,
               rkey: Tuple[np.ndarray, np.ndarray], n_right: int,
               outer: bool = False, lvalid: np.ndarray = None,
               rvalid: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """Equi-join of any multiplicity (K7 -> HK3 + HK4 build sort).
    Returns host (left_indices, right_indices), probe-major, build rows in
    stable key order; outer joins emit unmatched valid left rows once with
    right index -1.  Two counted pulls: the output size, then the pairs."""
    lk, ln, lv, rk, rn, rv = _join_inputs(lkey, n_left, rkey, n_right,
                                             lvalid, rvalid)
    stats_add("dispatches", 1)
    li, ri = equi_join_mult(lk, ln, lv, rk, rn, rv, outer=outer)
    if li.numel() == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z
    li, ri = d2h_many([li, ri])
    return li, ri


def semi_join_match(lkey, n_left: int, rkey, n_right: int,
                    anti: bool = False, null_aware: bool = False,
                    lvalid: np.ndarray = None,
                    rvalid: np.ndarray = None) -> np.ndarray:
    """Probe rows surviving a semi (membership) or anti (non-membership)
    test, in probe order (K8).  Membership is HK3's unique probe
    (:func:`unique_match`); HK10 (:func:`semi_pick`) applies the NOT IN
    ladder on the card (an empty build side keeps every valid probe row,
    a NULL build key keeps none under ``null_aware``, a NULL probe key
    never passes it) and compacts the kept rows.  One pull brings the
    count and the first ``PRESENT_HEAD`` rows; a second the rest, only
    when there are more."""
    lk, ln, lv, rk, rn, rv = _join_inputs(lkey, n_left, rkey, n_right,
                                             lvalid, rvalid)
    stats_add("dispatches", 1)
    match = unique_match(lk, ln, lv, rk, rn, rv)
    return _pull_kept(semi_pick(match, ln, lv, rn, rv, anti, null_aware))


def _pull_kept(out: torch.Tensor, width: int = 1) -> np.ndarray:
    """Host int64 words of a device buffer [count, rows...] of ``width``
    words a row (:func:`semi_pick`'s rows, HK3's packed pairs): one pull
    of the count and the first ``PRESENT_HEAD`` rows, a second of the
    rest only when there are more."""
    head = min(PRESENT_HEAD, (int(out.shape[0]) - 1) // width)
    got = d2h(out[:1 + width * head])
    n = int(got[0])
    if n <= head:
        return got[1:1 + width * n]
    return np.concatenate([got[1:], d2h(out[1 + width * head:
                                            1 + width * n])])


# =========================================================================
# HK10 semi_pick
# =========================================================================

#: rows of an HK10 tile (csrc/semi_pick.cu's kSpTile)
_HK10_TILE = 8192


def semi_pick(match, ln, lv, rn, rv, anti: bool,
              null_aware: bool) -> torch.Tensor:
    """K8's ladder and compaction (HK10): ``match``, ``ln``, ``lv`` are a
    probe row's membership (HK3), NULL key and validity, ``rn``, ``rv``
    the build rows' NULL key and validity (all bool).  Returns int64[1 +
    n_probe]: [0] the count of kept probe rows, [1:1 + count] those rows
    ascending; the entries past the count are not written.  Semi keeps
    the live members; anti keeps every valid row when no build row is
    valid, else the valid non-members; ``null_aware`` anti (NOT IN) also
    drops NULL probe keys, and keeps nothing once a valid build key is
    NULL.  On the card: a memset, the build side's two flags (anti only)
    and one pass; the output is a view of one buffer that also holds the
    pass's scratch."""
    nl, nr, dev = int(match.shape[0]), int(rn.shape[0]), match.device
    for t, n, w in ((match, nl, "match"), (ln, nl, "ln"), (lv, nl, "lv"),
                    (rn, nr, "rn"), (rv, nr, "rv")):
        _need(t, torch.bool, n, dev, f"semi_pick {w}")
    if not _on_card(match, "semi_pick"):
        return semi_pick_plain(match, ln, lv, rn, rv, anti, null_aware)
    from . import _ext
    tiles = max(-(-nl // _HK10_TILE), 1)
    buf = torch.empty(1 + nl + 3 + tiles, dtype=I64, device=dev)
    _ext.check(_ext.lib("semi_pick").hk10_semi_pick(
        match.data_ptr(), ln.data_ptr(), lv.data_ptr(), nl, rn.data_ptr(),
        rv.data_ptr(), nr, int(anti), int(null_aware),
        buf.data_ptr() + 8 * (1 + nl), buf.data_ptr(), _stream()),
        "semi_pick")
    _count(LAUNCHES, "semi_pick")
    return buf[:1 + nl]


def semi_pick_plain(match, ln, lv, rn, rv, anti: bool,
                    null_aware: bool) -> torch.Tensor:
    """Plain torch version of HK10 (same contract)."""
    _count(PLAIN_CALLS, "semi_pick")
    if not anti:
        keep = match & lv & ~ln
    else:
        empty = ~rv.any()
        if null_aware:
            rest = lv & ~ln & ~match & ~(rv & rn).any()
        else:
            rest = lv & ~match
        keep = torch.where(empty, lv, rest)
    idx = torch.nonzero(keep).reshape(-1)
    out = torch.empty(1 + int(match.shape[0]), dtype=I64,
                      device=match.device)
    out[0] = idx.shape[0]
    out[1:1 + idx.shape[0]] = idx
    return out


# =========================================================================
# HK11 shard_merge, HK12 shard_probe (the mesh tier, K11 and K25)
# =========================================================================
# The mesh is N virtual shards on one device (parallel/dist.py): shard s
# owns rows [s * m, (s + 1) * m) of every padded lane, m = nb / N.

#: how one row of a partial table folds over the shards
#: (csrc/shard_merge.cu's MergeOp)
MERGE_OPS = {"sum_i": 0, "sum_f": 1, "min_i": 2, "max_i": 3, "min_f": 4,
             "max_f": 5, "first_seg": 6, "first_scalar": 7}
_MERGE_ROWS = 64  # rows one HK11 launch folds (kMaxMergeRows)


def merge_ops(lanes, first: str) -> List[int]:
    """HK11's per-row ops for an HK1 (``first="first_scalar"``) or HK2
    (``"first_seg"``) table over ``lanes``: the count / presence row
    sums, the first-row row takes its sentinel rule, then per lane its
    value row (sum, min or max in its type; a count lane's zeros sum) and
    its live-count row (sum)."""
    ops = [MERGE_OPS["sum_i"], MERGE_OPS[first]]
    for v, _m, op in lanes:
        kind = "sum" if op == "count" else op
        ops += [MERGE_OPS[f"{kind}_{'f' if _lane_kind(v) else 'i'}"],
                MERGE_OPS["sum_i"]]
    return ops


def shard_merge(parts: torch.Tensor, ops: Sequence[int], shard_rows: int,
                nb: int) -> torch.Tensor:
    """HK11: fold the per-shard partial tables ``parts`` (int64 [n, rows,
    width], shard s's table at parts[s], float values as their bits) into
    one int64 [rows, width] table, row r by ``ops[r]`` (:data:`MERGE_OPS`),
    over the shards in ascending order.  ``shard_rows`` (m) and ``nb``
    place a shard's local first row: ``first_seg`` maps HK2's "no row"
    sentinel (>= m) to nb - 1, ``first_scalar`` an empty shard (row 0 is
    0) to nb and a merged nb to 0.  Float min / max give NaN when any
    partial is NaN."""
    if parts.dim() != 3 or parts.dtype != I64:
        raise ValueError("shard_merge: parts must be int64 [n, rows, width]")
    n, rows, width = (int(x) for x in parts.shape)
    ops = [int(o) for o in ops]
    if len(ops) != rows or n < 1 or width < 1 \
            or any(o not in MERGE_OPS.values() for o in ops):
        raise ValueError(f"shard_merge: {len(ops)} ops for {rows} rows of "
                         f"{n} shards x {width}")
    parts = parts.contiguous()
    if not _on_card(parts, "shard_merge"):
        return shard_merge_plain(parts, ops, shard_rows, nb)
    from . import _ext
    lib = _ext.lib("shard_merge")
    out = torch.empty((rows, width), dtype=I64, device=parts.device)
    for r0 in range(0, rows, _MERGE_ROWS):
        k = min(_MERGE_ROWS, rows - r0)
        _ext.check(lib.hk11_shard_merge(
            parts.data_ptr(), n, rows, width, r0, k,
            (ctypes.c_int * k)(*ops[r0:r0 + k]), int(shard_rows), int(nb),
            out.data_ptr(), _stream()), "shard_merge")
        _count(LAUNCHES, "shard_merge")
    return out


def shard_merge_plain(parts: torch.Tensor, ops: Sequence[int],
                      shard_rows: int, nb: int) -> torch.Tensor:
    """Plain torch version of HK11: the same left fold over the shards,
    row by row, so kernel and plain version agree byte for byte."""
    _count(PLAIN_CALLS, "shard_merge")
    n, rows, width = (int(x) for x in parts.shape)
    dev = parts.device
    out = torch.empty((rows, width), dtype=I64, device=dev)
    base = torch.arange(n, dtype=I64, device=dev)[:, None] * shard_rows
    for r, op in enumerate(int(o) for o in ops):
        col = parts[:, r, :]
        if op == MERGE_OPS["first_seg"]:
            g = torch.where(col >= shard_rows,
                            torch.full_like(col, nb - 1), col + base)
            out[r] = g.min(dim=0).values
        elif op == MERGE_OPS["first_scalar"]:
            g = torch.where(parts[:, 0, :] == 0, torch.full_like(col, nb),
                            col + base)
            acc = g.min(dim=0).values
            out[r] = torch.where(acc >= nb, torch.zeros_like(acc), acc)
        elif op in (MERGE_OPS["sum_f"], MERGE_OPS["min_f"],
                    MERGE_OPS["max_f"]):
            acc = col[0].view(F64)
            for s in range(1, n):
                x = col[s].view(F64)
                if op == MERGE_OPS["sum_f"]:
                    acc = acc + x
                    continue
                better = x < acc if op == MERGE_OPS["min_f"] else x > acc
                take = ~torch.isnan(acc) & (torch.isnan(x) | better)
                acc = torch.where(take, x, acc)
            out[r] = acc.view(I64)
        else:
            acc = col[0]
            for s in range(1, n):
                if op == MERGE_OPS["sum_i"]:
                    acc = acc + col[s]
                elif op == MERGE_OPS["min_i"]:
                    acc = torch.minimum(acc, col[s])
                else:
                    acc = torch.maximum(acc, col[s])
            out[r] = acc
    return out


def _shard_partials(n_shards: int, shard_rows: int, rows: int, width: int,
                    dev, reduce_one) -> torch.Tensor:
    """int64 [n_shards, rows, width]: shard s's partial table, written by
    ``reduce_one(row slice, out)`` over its own row range."""
    parts = torch.empty((n_shards, rows, width), dtype=I64, device=dev)
    for s in range(n_shards):
        reduce_one(slice(s * shard_rows, (s + 1) * shard_rows), parts[s])
    return parts


def _lane_rows(lanes, sl: slice):
    return [(None if v is None else v[sl], None if m is None else m[sl], op)
            for v, m, op in lanes]


def sharded_masked_reduce(valid: torch.Tensor, lanes,
                          n_shards: int) -> torch.Tensor:
    """K25's scalar aggregate on the card: HK1 over each shard's row
    range (one launch per shard), HK11 merges the partials.  Same contract
    as :func:`masked_reduce` (the first valid row is global; 0 when
    none)."""
    nb = int(valid.shape[0])
    m = nb // n_shards
    lanes = _norm_lanes(lanes, nb, valid.device, "sharded_masked_reduce")
    rows = 2 + 2 * len(lanes)

    def one(sl, out):
        out[:, 0] = masked_reduce(valid[sl], _lane_rows(lanes, sl))
    parts = _shard_partials(n_shards, m, rows, 1, valid.device, one)
    return shard_merge(parts, merge_ops(lanes, "first_scalar"), m,
                       nb).reshape(-1)


def sharded_segment_reduce(gid: torch.Tensor, valid: torch.Tensor, ns: int,
                           lanes, n_shards: int) -> torch.Tensor:
    """K11 on the card: HK2 over each shard's row range into its slice of
    one partial table (one launch per shard), HK11 merges the partials.
    Same contract as :func:`segment_reduce` (first rows are global; a
    segment no shard holds carries nb - 1)."""
    nb = int(valid.shape[0])
    m = nb // n_shards
    lanes = _norm_lanes(lanes, nb, valid.device, "sharded_segment_reduce")
    rows = 2 + 2 * len(lanes)

    def one(sl, out):
        segment_reduce(gid[sl], valid[sl], ns, _lane_rows(lanes, sl),
                       out=out)
    parts = _shard_partials(n_shards, m, rows, ns, valid.device, one)
    return shard_merge(parts, merge_ops(lanes, "first_seg"), m, nb)


def _probe_order(pk: torch.Tensor) -> torch.Tensor:
    """A probe key lane as the signed form of HK4's uint64 order keys."""
    return _u64_lane(pk, False) ^ I64_MIN


def shard_probe(pk: torch.Tensor, pid: torch.Tensor, bord: torch.Tensor,
                bid: torch.Tensor, perm: torch.Tensor, n_shards: int,
                member: bool = False):
    """HK12: per probe slot of shard s (slot i, s = i // cap_p), the
    first slot of shard s's sorted build run whose key is at or above
    its key (a staged search: csrc/shard_join.cu).  ``pk``,
    ``pid``: int64 or float64 keys and int64 global ids (-1 = padding) of
    the probe blocks [n * cap_p]; ``bord``: the build blocks' uint64
    order keys (dead slots at the sentinel), ``bid`` their ids, ``perm``
    HK4's order of (shard, bord, dead) over [n * cap_b].  Returns (hit
    bool, brow int64) per probe slot: the live build slot with an equal
    key, and its id (-1 without one).  Member mode (``member``, K25's
    semi / anti join, counted as ``shard_member``): ``hit`` alone."""
    n = int(n_shards)
    npb, nbb = int(pk.shape[0]), int(bord.shape[0])
    if n < 1 or npb % n or nbb % n or npb == 0 or nbb == 0:
        raise ValueError(f"shard_probe: {npb} probe / {nbb} build slots "
                         f"over {n} shards")
    dev = pk.device
    if pk.dtype not in (I64, F64):
        raise ValueError(f"shard_probe: key dtype {pk.dtype}")
    pk = pk.contiguous()
    _need(pk, pk.dtype, npb, dev, "shard_probe pk")
    for t, ln, w in ((pid, npb, "pid"), (bord, nbb, "bord"),
                     (bid, nbb, "bid"), (perm, nbb, "perm")):
        _need(t, I64, ln, dev, f"shard_probe {w}")
    if not _on_card(pk, "shard_probe"):
        return shard_probe_plain(pk, pid, bord, bid, perm, n, member)
    from . import _ext
    hit = torch.empty(npb, dtype=torch.bool, device=dev)
    brow = None if member else torch.empty(npb, dtype=I64, device=dev)
    _ext.check(_ext.lib("shard_join").hk12_shard_probe(
        pk.data_ptr(), pid.data_ptr(), npb // n, bord.data_ptr(),
        bid.data_ptr(), perm.data_ptr(), nbb // n, n, int(pk.dtype == F64),
        hit.data_ptr(), _ptr(brow), _stream()), "shard_probe")
    _count(LAUNCHES, "shard_member" if member else "shard_probe")
    return hit if member else (hit, brow)


def shard_probe_plain(pk, pid, bord, bid, perm, n_shards: int,
                      member: bool = False):
    """Plain torch version of HK12: ``torch.searchsorted`` per shard (one
    batched call over the [n, cap_b] sorted runs)."""
    _count(PLAIN_CALLS, "shard_member" if member else "shard_probe")
    n = int(n_shards)
    cap_p, cap_b = int(pk.shape[0]) // n, int(bord.shape[0]) // n
    run = perm.reshape(n, cap_b)
    sk = (bord ^ I64_MIN)[run]
    pv = _probe_order(pk).reshape(n, cap_p).contiguous()
    lo = torch.searchsorted(sk, pv)
    loc = torch.clamp(lo, max=cap_b - 1)
    j = run.gather(1, loc)
    ok = (pid.reshape(n, cap_p) >= 0) & (lo < cap_b) \
        & (sk.gather(1, loc) == pv) & (bid[j] >= 0)
    if pk.dtype == F64:
        ok &= ~torch.isnan(pk).reshape(n, cap_p)
    if member:
        return ok.reshape(-1)
    brow = torch.where(ok, bid[j], torch.full_like(j, -1))
    return ok.reshape(-1), brow.reshape(-1)


def shard_count(lk: torch.Tensor, lvalid: torch.Tensor, rsorted: torch.Tensor,
                n_shards: int):
    """HK12's count mode (K26's broadcast join counts): per probe row of
    ``lk`` / ``lvalid`` (int64 / bool [n * rows], shard s owns rows
    [s * rows, (s + 1) * rows)) the number of build keys equal to its key
    in the replicated run ``rsorted`` (int64, ascending), 0 for an invalid
    row; and each shard's sum of them as the int64 partial table [n, 1, 1]
    HK11 merges."""
    n = int(n_shards)
    nl = int(lk.shape[0])
    dev = lk.device
    if n < 1 or nl == 0 or nl % n:
        raise ValueError(f"shard_count: {nl} probe rows over {n} shards")
    lk, lvalid, rsorted = (t.contiguous() for t in (lk, lvalid, rsorted))
    _need(lk, I64, nl, dev, "shard_count keys")
    _need(lvalid, torch.bool, nl, dev, "shard_count valid")
    _need(rsorted, I64, int(rsorted.shape[0]), dev, "shard_count build")
    if not _on_card(lk, "shard_count"):
        return shard_count_plain(lk, lvalid, rsorted, n)
    from . import _ext
    counts = torch.empty(nl, dtype=I64, device=dev)
    partial = torch.empty((n, 1, 1), dtype=I64, device=dev)
    _ext.check(_ext.lib("shard_join").hk12_shard_count(
        lk.data_ptr(), lvalid.data_ptr(), nl // n, n, rsorted.data_ptr(),
        int(rsorted.shape[0]), counts.data_ptr(), partial.data_ptr(),
        _stream()), "shard_count")
    _count(LAUNCHES, "shard_count")
    return counts, partial


def shard_count_plain(lk, lvalid, rsorted, n_shards: int):
    """Plain torch version of HK12's count mode: two searchsorted bounds."""
    _count(PLAIN_CALLS, "shard_count")
    lo = torch.searchsorted(rsorted, lk)
    hi = torch.searchsorted(rsorted, lk, right=True)
    counts = torch.where(lvalid, hi - lo, torch.zeros_like(lo))
    return counts, counts.reshape(int(n_shards), 1, -1).sum(
        dim=2, keepdim=True)


def shard_lane(n_shards: int, cap: int) -> torch.Tensor:
    """Each slot's shard id over [n_shards * cap] blocks (HK4's leading
    lane for a per-shard sort), memoized per device."""
    dev = device()
    key = ("shard_lane", n_shards, cap, str(dev))
    with _ARANGE_MU:
        t = _ARANGE.get(key)
        if t is None:
            t = _ARANGE[key] = torch.arange(
                n_shards, dtype=I64, device=dev).repeat_interleave(cap)
    return t


# =========================================================================
# HK13 shard_exchange, HK14 shard_rank (the mesh tier, K18 shuffle, K25
# sort / top-k, K26)
# =========================================================================

#: golden-ratio multiplier of the shuffle's destination hash
#: (two's-complement int64 of 0x9E3779B97F4A7C15)
HASH_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
#: the most shards one exchange takes (csrc/shard_exchange.cu kMaxShards)
MAX_EXCHANGE_SHARDS = 1024


def hash_dest(keys: torch.Tensor, n_shards: int, n_rows: int) -> torch.Tensor:
    """Destination shard of every padded row (HK13's, as torch ops):
    ``((key * HASH_GOLDEN) >> 33) & (n - 1)`` with int64 wrap-around for
    rows below ``n_rows``, ``row % n`` for a padding row."""
    h = keys * HASH_GOLDEN
    d = (h >> 33) & (n_shards - 1)
    g = torch.arange(int(keys.shape[0]), dtype=I64, device=keys.device)
    return torch.where(g < n_rows, d, g & (n_shards - 1))


#: csrc/shard_exchange.cu's ExchangeLanes, packed: vals, outs (pointers),
#: fill (int64), width (int) per lane, then n and the struct's padding
_C_EXCHANGE = struct.Struct(f"<{_MAX_LANES}Q{_MAX_LANES}Q{_MAX_LANES}q"
                            f"{_MAX_LANES}ii4x")


_FILL_FORMAT = {torch.float64: ("<d", "<q"), torch.float32: ("<f", "<i"),
                torch.float16: ("<e", "<h")}


_FILL_BITS: Dict[tuple, int] = {}


def _fill_bits(dtype: torch.dtype, fill) -> int:
    """A lane's fill as the int64 whose low bytes are its element's
    (plain ints: no tensor and no pull; memoized)."""
    key = (dtype, fill)
    got = _FILL_BITS.get(key)
    if got is None:
        got = _FILL_BITS[key] = _fill_int(dtype, fill)
    return got


def _fill_int(dtype: torch.dtype, fill) -> int:
    if dtype in _FILL_FORMAT:
        fmt, as_int = _FILL_FORMAT[dtype]
        return struct.unpack(as_int, struct.pack(fmt, float(fill)))[0]
    if dtype.is_floating_point or dtype.is_complex:
        raise ValueError(f"shard_exchange: lane dtype {dtype}")
    return int(bool(fill)) if dtype == torch.bool else int(fill)


def _exchange_checks(keys, n_rows: int, lanes, cap: int, n: int):
    nb = int(keys.shape[0])
    if n < 2 or n > MAX_EXCHANGE_SHARDS or n & (n - 1) or nb % n \
            or nb == 0 or cap < 1 or not lanes:
        raise ValueError(f"shard_exchange: {nb} rows, {n} shards, cap {cap},"
                         f" {len(lanes)} lanes")
    dev = keys.device
    keys = keys.contiguous()
    _need(keys, I64, nb, dev, "shard_exchange keys")
    out = []
    for v, fill in lanes:
        v = v.contiguous()
        if v.shape != keys.shape or v.device != dev \
                or v.dtype.itemsize not in (1, 2, 4, 8):
            raise ValueError(f"shard_exchange: a lane of {v.dtype}"
                             f"{tuple(v.shape)} on {v.device} for {nb} rows"
                             f" on {dev}")
        out.append((v, fill))
    return keys, out


def _overflow(n: int, cap: int):
    return RuntimeError(f"shard_exchange: a (source, destination) pair of "
                        f"{n} shards holds more rows than its capacity "
                        f"{cap}")


def _lane_buffer(dtypes, n_slots: int, dev):
    """The outputs of a call: one [k, n_slots] tensor per dtype for its k
    lanes, unbound into per-lane views in lane order.  Returns (outputs,
    their data pointers), the pointers computed, not read per view."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, dt in enumerate(dtypes):
        groups.setdefault(dt, []).append(i)
    outs: List[Optional[torch.Tensor]] = [None] * len(dtypes)
    ptrs = [0] * len(dtypes)
    for dt, idx in groups.items():
        buf = torch.empty((len(idx), n_slots), dtype=dt, device=dev)
        base, row = buf.data_ptr(), n_slots * dt.itemsize
        for j, (i, v) in enumerate(zip(idx, buf.unbind(0))):
            outs[i], ptrs[i] = v, base + j * row
    return outs, ptrs


def _exchange_chunk(lanes, ptrs) -> bytes:
    """One launch's lanes (and their outputs' pointers) as the C struct's
    bytes."""
    pad = [0] * (_MAX_LANES - len(lanes))
    return _C_EXCHANGE.pack(
        *[v.data_ptr() for v, _ in lanes], *pad, *ptrs, *pad,
        *[_fill_bits(v.dtype, f) for v, f in lanes], *pad,
        *[v.dtype.itemsize for v, _ in lanes], *pad, len(lanes))


def shard_exchange(keys: torch.Tensor, n_rows: int, lanes, cap: int,
                   n_shards: int) -> List[torch.Tensor]:
    """HK13: the all-to-all of ``lanes`` ([(tensor [nb], fill)]) over
    ``n_shards`` virtual shards by the hash of ``keys`` (int64 [nb]):
    source shard s owns rows [s * nb / n, (s + 1) * nb / n), row g goes to
    shard :func:`hash_dest` at its stable rank among the rows of s with
    that destination.  Returns per lane the received [n * n * cap] lane,
    flat [destination][source][cap], every unreached slot at the fill
    (views of one buffer per dtype).  Raises when a (source, destination) pair
    holds more than ``cap`` rows (the host bounds ``cap`` exactly: no row
    is dropped); the error word is the call's one read."""
    n, cap = int(n_shards), int(cap)
    keys, lanes = _exchange_checks(keys, n_rows, lanes, cap, n)
    if not _on_card(keys, "shard_exchange"):
        return shard_exchange_plain(keys, n_rows, lanes, cap, n)
    from . import _ext
    lib = _ext.lib("shard_exchange")
    nb = int(keys.shape[0])
    words = lib.hk13_scratch_words(nb, n, n)
    scratch = torch.empty(words, dtype=I64, device=keys.device)
    outs, ptrs = _lane_buffer([v.dtype for v, _ in lanes], n * n * cap,
                              keys.device)
    chunks = [_exchange_chunk(lanes[c:c + _MAX_LANES], ptrs[c:c + _MAX_LANES])
              for c in range(0, len(lanes), _MAX_LANES)]
    _ext.check(lib.hk13_exchange(keys.data_ptr(), nb, int(n_rows), n, cap,
                                 scratch.data_ptr(), b"".join(chunks),
                                 len(chunks), _stream()), "shard_exchange")
    _count(LAUNCHES, "shard_exchange")
    if int(scratch[words - 2]):  # the error word (the call's one read)
        raise _overflow(n, cap)
    return outs


def shard_exchange_plain(keys, n_rows: int, lanes, cap: int,
                         n_shards: int) -> List[torch.Tensor]:
    """Plain torch version of HK13: per source shard a stable argsort of
    the destinations, each row's rank by a searchsorted, and an index_put
    into [n, n, cap]."""
    _count(PLAIN_CALLS, "shard_exchange")
    n, nb = int(n_shards), int(keys.shape[0])
    m = nb // n
    dev = keys.device
    dest = hash_dest(keys, n, n_rows).reshape(n, m)
    src, slot = [], []
    for s in range(n):
        order = torch.argsort(dest[s], stable=True)
        ds = dest[s][order]
        rank = torch.arange(m, dtype=I64, device=dev) \
            - torch.searchsorted(ds, ds)
        if m and int(rank.max()) >= cap:
            raise _overflow(n, cap)
        src.append(order + s * m)
        slot.append((ds * n + s) * cap + rank)
    src, slot = torch.cat(src), torch.cat(slot)
    outs = []
    for v, fill in lanes:
        o = torch.full((n * n * cap,), fill, dtype=v.dtype, device=dev)
        o[slot] = v[src]
        outs.append(o)
    return outs


# ---- HK13's partition mode (K25's join and member sides) -------------------

#: splitmix64 of ops/shardops.hash_partition at depth 0, as int64 words
_SPLIT_SEED = 0x9E3779B97F4A7C15 - (1 << 64)
_SPLIT_MIX = (0xBF58476D1CE4E5B9 - (1 << 64), 0x94D049BB133111EB - (1 << 64))


def _srl(u: torch.Tensor, k: int) -> torch.Tensor:
    """A logical right shift of int64 words (torch's >> is arithmetic)."""
    return (u >> k) & ((1 << (64 - k)) - 1)


def partition_dest(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The partition of every key (int64, or float64 by its raw bits with
    -0.0 as +0.0): splitmix64 from the depth-0 seed, & (n - 1) — the
    numpy ``shardops.hash_partition(keys, 0, n)`` in int64 torch ops."""
    u = keys
    if keys.dtype == F64:
        u = keys.view(I64)
        u = torch.where(u == I64_MIN, torch.zeros_like(u), u)
    u = u + _SPLIT_SEED
    u = u ^ _srl(u, 30)
    u = u * _SPLIT_MIX[0]
    u = u ^ _srl(u, 27)
    u = u * _SPLIT_MIX[1]
    u = u ^ _srl(u, 31)
    return u & (int(n_shards) - 1)


class Partition:
    """One side's partition after its count call: its inputs, the live
    rows' count per destination (int64 [n], on the side's device) and the
    count call's scratch (None for the plain version)."""

    __slots__ = ("keys", "live", "n", "counts", "scratch")

    def __init__(self, keys, live, n, counts, scratch):
        self.keys, self.live, self.n = keys, live, n
        self.counts, self.scratch = counts, scratch


def _partition_checks(keys, live, n: int):
    nb = int(keys.shape[0])
    if n < 2 or n > MAX_EXCHANGE_SHARDS or n & (n - 1):
        raise ValueError(f"shard_partition: {nb} rows, {n} shards")
    if keys.dtype not in (I64, F64):
        raise ValueError(f"shard_partition: key dtype {keys.dtype}")
    keys, live = keys.contiguous(), live.contiguous()
    _need(keys, keys.dtype, nb, keys.device, "shard_partition keys")
    _need(live, torch.bool, nb, keys.device, "shard_partition live")
    return keys, live


def shard_partition(keys: torch.Tensor, live: torch.Tensor,
                    n_shards: int) -> Partition:
    """HK13's partition mode, its count call: the live rows of ``keys``
    (int64 or float64 [nb], ``live`` bool [nb]) per destination
    :func:`partition_dest` (``Partition.counts``, int64 [n]).  The caller
    pulls the counts, sets cap, then calls
    :func:`shard_partition_scatter`."""
    n = int(n_shards)
    keys, live = _partition_checks(keys, live, n)
    if not _on_card(keys, "shard_partition"):
        return shard_partition_plain(keys, live, n)
    from . import _ext
    lib = _ext.lib("shard_exchange")
    nb = int(keys.shape[0])
    words = lib.hk13_scratch_words(nb, n, 1)
    scratch = torch.empty(words, dtype=I64, device=keys.device)
    _ext.check(lib.hk13_partition_count(
        keys.data_ptr(), live.data_ptr(), nb, n, int(keys.dtype == F64),
        scratch.data_ptr(), _stream()), "shard_partition")
    _count(LAUNCHES, "shard_partition")
    return Partition(keys, live, n, scratch[words - 2 - n:words - 2],
                     scratch)


def shard_partition_plain(keys, live, n_shards: int) -> Partition:
    """Plain torch version of the count call: a bincount of the live rows'
    destinations."""
    _count(PLAIN_CALLS, "shard_partition")
    n = int(n_shards)
    dest = partition_dest(keys, n)[live]
    return Partition(keys, live, n, torch.bincount(dest, minlength=n),
                     None)


def shard_partition_scatter(part: Partition, cap: int):
    """HK13's partition mode, its scatter call: the live rows into flat
    [n * cap] blocks, each at its stable rank among the live rows of its
    destination, in row order (the reference's ``_Partitioned.scatter``
    of the keys and ``scatter_ids``, slot for slot).  Returns (keys [n * cap] in the keys' dtype, fill 0; row ids
    int64 [n * cap], fill -1); ``cap`` must hold every count."""
    n, cap = part.n, int(cap)
    if cap < 1:
        raise ValueError(f"shard_partition: cap {cap}")
    if part.scratch is None or not _on_card(part.keys, "shard_partition"):
        return shard_partition_scatter_plain(part, cap)
    from . import _ext
    nb = int(part.keys.shape[0])
    (ko, io), _ = _lane_buffer([part.keys.dtype, I64], n * cap,
                               part.keys.device)
    _ext.check(_ext.lib("shard_exchange").hk13_partition_scatter(
        part.keys.data_ptr(), part.live.data_ptr(), nb, n,
        int(part.keys.dtype == F64), cap, part.scratch.data_ptr(),
        ko.data_ptr(), io.data_ptr(), _stream()), "shard_partition scatter")
    _count(LAUNCHES, "shard_partition")
    return ko, io


def shard_partition_scatter_plain(part: Partition, cap: int):
    """Plain torch version of the scatter call: a stable argsort of the
    live rows' destinations, each row's rank by a searchsorted, and an
    index_put into [n * cap]."""
    _count(PLAIN_CALLS, "shard_partition")
    n, keys = part.n, part.keys
    dev = keys.device
    rows = torch.nonzero(part.live).reshape(-1)
    dest = partition_dest(keys[rows], n)
    order = torch.argsort(dest, stable=True)
    ds = dest[order]
    rank = torch.arange(int(ds.shape[0]), dtype=I64, device=dev) \
        - torch.searchsorted(ds, ds)
    if int(ds.shape[0]) and int(rank.max()) >= cap:
        raise _overflow(n, cap)
    slot = ds * cap + rank
    ko = torch.zeros(n * cap, dtype=keys.dtype, device=dev)
    io = torch.full((n * cap,), -1, dtype=I64, device=dev)
    ko[slot] = keys[rows[order]]
    io[slot] = rows[order]
    return ko, io


#: csrc/shard_rank.cu's kSmall: n * run elements merged by one block
RANK_SMALL = 1024


def shard_rank(ord_lane: torch.Tensor, ids: torch.Tensor, stride: int,
               run: int, n_shards: int, k_out: int) -> torch.Tensor:
    """HK14: the merged order of ``n_shards`` sorted runs.  Element (s, r)
    of run s (r < ``run``) is row ``ids[s * stride + r]``, its key
    ``ord_lane[row]`` (HK4's uint64 order lane, ascending; a run's equal
    keys in row order); its global rank is r plus, over the other runs,
    the count of keys <= its own in a lower run and < its own in a higher
    one.  Returns int64 [k_out]: the row ids of ranks 0 .. k_out - 1."""
    n, stride, run, k_out = int(n_shards), int(stride), int(run), int(k_out)
    dev = ids.device
    if n < 1 or run < 1 or stride < run or not 1 <= k_out <= n * run \
            or int(ids.shape[0]) < (n - 1) * stride + run:
        raise ValueError(f"shard_rank: {n} runs of {run} (stride {stride}),"
                         f" k_out {k_out}, {int(ids.shape[0])} ids")
    ord_lane, ids = ord_lane.contiguous(), ids.contiguous()
    _need(ord_lane, I64, int(ord_lane.shape[0]), dev, "shard_rank keys")
    _need(ids, I64, int(ids.shape[0]), dev, "shard_rank ids")
    if not _on_card(ids, "shard_rank"):
        return shard_rank_plain(ord_lane, ids, stride, run, n, k_out)
    from . import _ext
    # (key, id) pairs of the rounds between the first and the last (two
    # rounds from 3 runs up, three from 5); one block merges up to
    # RANK_SMALL elements in shared memory
    kv = [torch.empty(2 * n * run, dtype=I64, device=dev)
          if n > lo and n * run > RANK_SMALL else None for lo in (2, 4)]
    out = torch.empty(k_out, dtype=I64, device=dev)
    _ext.check(_ext.lib("shard_rank").hk14_shard_rank(
        ord_lane.data_ptr(), ids.data_ptr(), stride, run, n, k_out,
        _ptr(kv[0]), _ptr(kv[1]), out.data_ptr(), _stream()), "shard_rank")
    _count(LAUNCHES, "shard_rank")
    return out


def shard_rank_plain(ord_lane, ids, stride: int, run: int, n_shards: int,
                     k_out: int) -> torch.Tensor:
    """Plain torch version of HK14: the reference's searchsorted counts
    (side right for the lower runs, left for the higher), then
    out[rank] = row."""
    _count(PLAIN_CALLS, "shard_rank")
    n = int(n_shards)
    rows = torch.stack([ids[s * stride:s * stride + run] for s in range(n)])
    sk = ord_lane[rows] ^ I64_MIN  # uint64 order as signed
    rank = torch.arange(run, dtype=I64, device=ids.device).repeat(n, 1)
    sidx = torch.arange(n, device=ids.device)[:, None]
    for t in range(n):
        right = torch.searchsorted(sk[t].contiguous(), sk, right=True)
        left = torch.searchsorted(sk[t].contiguous(), sk)
        rank += torch.where(sidx > t, right,
                            torch.where(sidx < t, left,
                                        torch.zeros_like(left)))
    out = torch.empty(k_out, dtype=I64, device=ids.device)
    keep = rank < k_out
    out[rank[keep]] = rows[keep]
    return out


def sort_permutation(key_cols: List[Tuple[np.ndarray, np.ndarray]],
                     descs: List[bool], n_rows: int) -> np.ndarray:
    """Stable multi-key ORDER BY permutation (K9 -> HK4): NULL first
    ascending and last descending, ties by row index."""
    return _ordered(key_cols, descs, n_rows, None)


def top_k(key_cols: List[Tuple[np.ndarray, np.ndarray]], descs: List[bool],
          n_rows: int, k: int) -> np.ndarray:
    """Top-k row indices in ORDER BY order (K10 -> HK4): the first k of
    sort_permutation, lowest row index first among equal keys."""
    if k <= 0 or n_rows <= 0:
        return np.empty(0, dtype=np.int64)
    return _ordered(key_cols, descs, n_rows, k)


def host_sort_permutation(key_cols, descs, n_rows: int) -> np.ndarray:
    """Full ORDER BY permutation computed on the host (a numpy lexsort with
    HK4's order: NULL first ascending and last descending, ties by row
    index): the block-wise route for a sort above
    ``tidb_device_block_rows``, where uploading every sort key whole
    would break the device budget (the reference's path)."""
    stats_add("host_dispatches", 1)
    ops = []
    for i in range(len(key_cols) - 1, -1, -1):
        v, m = (np.asarray(x)[:n_rows] for x in key_cols[i])
        vv = np.where(m, 0, v)
        if descs[i]:
            vv = ~vv if vv.dtype == np.int64 else -vv
            rank = np.where(m, 1, 0).astype(np.int8)   # NULL last
        else:
            rank = np.where(m, 0, 1).astype(np.int8)   # NULL first
        ops.append(vv)
        ops.append(rank)
    return np.lexsort(ops)


def _ordered(key_cols, descs, n_rows: int, k: Optional[int]) -> np.ndarray:
    nb = bucket(max(n_rows, 1))
    valid_h = np.zeros(nb, dtype=bool)
    valid_h[:n_rows] = True
    keys = [(h2d_pad(np.asarray(v), nb), h2d_pad(np.asarray(m), nb, True))
            for v, m in key_cols]
    stats_add("dispatches", 1)
    lanes = sort_lanes(keys, descs, h2d(valid_h))
    want = n_rows if k is None else min(k, n_rows)
    perm = d2h(lex_order(lanes, nb, want))
    return perm[:want]
