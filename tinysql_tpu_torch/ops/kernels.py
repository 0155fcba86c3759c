"""Device core of the port and the relational kernels it runs.

The port of tinysql_tpu/ops/kernels.py.  The JAX package compiled every
operator family into XLA programs; here each family's core is one of six
kernels written by hand for Hopper (csrc/*.cu, built by ops/_ext.py), and
the elementwise work around them (the filter and argument expression
trees of ops/exprjit.py, key normalisation, output layout) runs as plain
torch tensor operations:

- HK1 :func:`masked_reduce` (csrc/masked_reduce.cu) — global aggregates
  (K1 fused_scalar_aggregate, K5 scalar_aggregate);
- HK2 :func:`segment_reduce` + :func:`present_compact`
  (csrc/segment_reduce.cu) — grouped aggregates (K2 fused_segment_*,
  K3 segment_group_aggregate, and K4 group_aggregate after an HK4 sort);
- HK3 :func:`equi_join_unique` / :func:`equi_join_mult`
  (csrc/equi_join.cu) — join matching (K6 unique_join_match, K7
  join_match, and K8 semi_join_match's membership test);
- HK4 :func:`lex_order` (csrc/lex_order.cu) — ORDER BY permutations and
  top-k (K9 sort_permutation, K10 top_k);
- HK5 :func:`csr_reduce` (csrc/csr_reduce.cu) — the pipeline tier's
  GROUP BY over a memoized group index (K17, executor/devpipe.py);
- HK6 :func:`dense_probe` (csrc/dense_probe.cu) — the pipeline tier's
  join probe through a dense key -> row table (K18's unique, semi and
  anti modes).

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
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
                            "dense_probe": 0}
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


def pipe_overlap_frac(d: dict) -> float:
    """Staging/compute overlap estimate from a counter scope's ``pipe_*``
    walls (the reference's formula; no pipelined path is ported yet, so
    it reads 0)."""
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


def _norm_lanes(lanes, n: int, dev, what: str):
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
            _need(v, v.dtype, n, dev, what)
        if m is not None:
            m = m.contiguous()
            _need(m, torch.bool, n, dev, what)
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
        chunk = lanes[c0:c0 + _MAX_LANES]
        out = torch.empty(2 + 2 * len(chunk), dtype=I64, device=dev)
        scratch = torch.empty(lib.hk1_scratch_bytes(n, len(chunk)),
                              dtype=torch.uint8, device=dev)
        cl = _c_lanes(chunk)
        _ext.check(lib.hk1_masked_reduce(
            valid.data_ptr(), n, ctypes.byref(cl), scratch.data_ptr(),
            out.data_ptr(), _stream()), "masked_reduce")
        _count(LAUNCHES, "masked_reduce")
        outs.append(out if not outs else out[2:])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def masked_reduce_plain(valid: torch.Tensor, lanes) -> torch.Tensor:
    """Plain torch version of HK1 (same contract, any device)."""
    _count(PLAIN_CALLS, "masked_reduce")
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


# =========================================================================
# HK2 segment_reduce (+ present-segment compaction)
# =========================================================================

def segment_reduce(gid: torch.Tensor, valid: torch.Tensor, ns: int,
                   lanes) -> torch.Tensor:
    """Per-segment reduction over int64 group ids in [0, ns).  Returns the
    int64 table [(2 + 2 * len(lanes)), ns]: presence, first valid row
    (sentinel n when empty), then per lane its values (float64 bit-cast;
    identity when empty) and live counts."""
    n = int(valid.shape[0])
    dev = valid.device
    on_card = _on_card(valid, "segment_reduce")
    _need(valid, torch.bool, n, dev, "segment_reduce valid")
    gid = gid.contiguous()
    _need(gid, I64, n, dev, "segment_reduce gid")
    lanes = _norm_lanes(lanes, n, dev, "segment_reduce")
    if ns < 1:
        raise ValueError("segment_reduce: ns must be >= 1")
    if not on_card:
        return segment_reduce_plain(gid, valid, ns, lanes)
    from . import _ext
    lib = _ext.lib("segment_reduce")
    tables = []
    for c0 in range(0, max(len(lanes), 1), _MAX_LANES):
        chunk = lanes[c0:c0 + _MAX_LANES]
        out = torch.empty((2 + 2 * len(chunk), ns), dtype=I64, device=dev)
        scratch = torch.empty(max(lib.hk2_scratch_bytes(n, ns, len(chunk)),
                                  8), dtype=torch.uint8, device=dev)
        cl = _c_lanes(chunk)
        _ext.check(lib.hk2_segment_reduce(
            gid.data_ptr(), valid.data_ptr(), n, ns, ctypes.byref(cl),
            scratch.data_ptr(), out.data_ptr(), _stream()),
            "segment_reduce")
        _count(LAUNCHES, "segment_reduce")
        tables.append(out if not tables else out[2:])
    return tables[0] if len(tables) == 1 else torch.cat(tables)


def segment_reduce_plain(gid: torch.Tensor, valid: torch.Tensor, ns: int,
                         lanes) -> torch.Tensor:
    """Plain torch version of HK2 (same contract, any device)."""
    _count(PLAIN_CALLS, "segment_reduce")
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


def present_compact(table: torch.Tensor, ns: int):
    """Present segments (presence row > 0) compacted to a static bucket:
    returns (n_present, packed int64[(1 + rows), ob]) — row 0 the
    ascending segment ids (fill ns past the count), then every table row
    gathered at min(id, ns - 1).  One scalar sync for the count."""
    rows = int(table.shape[0])
    dev = table.device
    table = table.contiguous()
    if not _on_card(table, "present_compact"):
        return present_compact_plain(table, ns)
    from . import _ext
    lib = _ext.lib("segment_reduce")
    nb = max((ns + 1023) // 1024, 1)
    btot = torch.empty(nb + 1, dtype=I64, device=dev)
    _ext.check(lib.hk2_present_count(table.data_ptr(), ns, btot.data_ptr(),
                                     btot[nb:].data_ptr(), _stream()),
               "present_count")
    np_ = int(btot[nb].item())
    ob = min(bucket(max(np_, 1)), ns)
    packed = torch.empty((1 + rows, ob), dtype=I64, device=dev)
    _ext.check(lib.hk2_present_pack(table.data_ptr(), rows, ns, ob,
                                    btot.data_ptr(), packed.data_ptr(),
                                    _stream()), "present_pack")
    _count(LAUNCHES, "present_compact")
    return np_, packed


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


def _build_stats(lib, rk, rn, rv, dev):
    from . import _ext
    n = int(rk.shape[0])
    part = torch.empty(3 * 512, dtype=I64, device=dev)
    out3 = torch.empty(3, dtype=I64, device=dev)
    _ext.check(lib.hk3_build_stats(rk.data_ptr(), rn.data_ptr(),
                                   rv.data_ptr(), n, part.data_ptr(),
                                   out3.data_ptr(), _stream()),
               "build_stats")
    return [int(x) for x in out3.cpu().tolist()]


def _pick(lib, keep, match, cand, dev):
    from . import _ext
    n = int(keep.shape[0])
    nb = max((n + 1023) // 1024, 1)
    btot = torch.empty(nb + 1, dtype=I64, device=dev)
    _ext.check(lib.hk3_pick_count(keep.data_ptr(), n, btot.data_ptr(),
                                  btot[nb:].data_ptr(), _stream()),
               "pick_count")
    total = int(btot[nb].item())
    li = torch.empty(total, dtype=I64, device=dev)
    ri = torch.empty(total, dtype=I64, device=dev)
    if total:
        _ext.check(lib.hk3_pick(keep.data_ptr(), match.data_ptr(),
                                cand.data_ptr(), n, btot.data_ptr(),
                                li.data_ptr(), ri.data_ptr(), _stream()),
                   "pick")
    return li, ri


def dense_ok(card: int, n_live: int) -> bool:
    """Dense key -> row table when the live key range is small enough
    (the reference host twin's rule)."""
    return card <= max(1 << 22, 4 * n_live)


def equi_join_unique(lk, ln, lv, rk, rn, rv, outer: bool = False,
                     keep: Optional[torch.Tensor] = None):
    """Unique build side: (li, ri) int64 tensors, li ascending.  Inner:
    the matched probe rows; outer: every valid probe row, ri = -1 where
    unmatched.  ``keep`` overrides which probe rows are emitted (the
    semi/anti membership test passes its own).  Among equal live build
    keys the lowest row is the match."""
    nl, nr, dev = _join_checks(lk, ln, lv, rk, rn, rv)
    if not _on_card(lk, "equi_join"):
        return equi_join_unique_plain(lk, ln, lv, rk, rn, rv, outer, keep)
    from . import _ext
    lib = _ext.lib("equi_join")
    n_live, kmin, kmax = _build_stats(lib, rk, rn, rv, dev)
    card = kmax - kmin + 1 if n_live else 1
    dense = n_live > 0 and dense_ok(card, n_live)
    if dense:
        tsize = card
    else:
        tsize = 1024
        while tsize < 2 * max(n_live, 1):
            tsize <<= 1
    table = torch.empty(tsize, dtype=I64, device=dev)
    cand = torch.empty(nl, dtype=I64, device=dev)
    match = torch.empty(nl, dtype=torch.bool, device=dev)
    _ext.check(lib.hk3_unique_match(
        lk.data_ptr(), ln.data_ptr(), lv.data_ptr(), nl, rk.data_ptr(),
        rn.data_ptr(), rv.data_ptr(), nr, int(dense),
        kmin if dense else 0, kmax if dense else 0, table.data_ptr(), tsize,
        cand.data_ptr(), match.data_ptr(), _stream()), "unique_match")
    if keep is None:
        keep = lv if outer else match
    li, ri = _pick(lib, keep.contiguous(), match, cand, dev)
    _count(LAUNCHES, "equi_join")
    return li, ri


def equi_join_unique_plain(lk, ln, lv, rk, rn, rv, outer=False,
                           keep=None):
    """Plain torch version of the unique HK3 mode (same contract)."""
    _count(PLAIN_CALLS, "equi_join")
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
    if keep is None:
        keep = lv if outer else match
    li = torch.nonzero(keep).reshape(-1)
    ri = torch.where(match[li], cand[li], torch.full_like(li, -1))
    return li, ri


def equi_join_mult(lk, ln, lv, rk, rn, rv, outer: bool = False):
    """Any build multiplicity: (li, ri) in probe-major order, build rows
    of one probe row in ascending row order; outer joins emit each
    unmatched valid probe row once with ri = -1."""
    nl, nr, dev = _join_checks(lk, ln, lv, rk, rn, rv)
    if not _on_card(lk, "equi_join"):
        return equi_join_mult_plain(lk, ln, lv, rk, rn, rv, outer)
    from . import _ext
    lib = _ext.lib("equi_join")
    n_live = _build_stats(lib, rk, rn, rv, dev)[0]
    dead = (~(rv & ~rn)).to(I64)
    perm = lex_order([dead, rk ^ I64_MIN], nr) if nr else \
        torch.empty(0, dtype=I64, device=dev)
    lo = torch.empty(nl, dtype=I64, device=dev)
    cnt = torch.empty(nl, dtype=I64, device=dev)
    nb = max((nl + 1023) // 1024, 1)
    btot = torch.empty(nb + 1, dtype=I64, device=dev)
    _ext.check(lib.hk3_mult_count(
        lk.data_ptr(), ln.data_ptr(), lv.data_ptr(), nl, rk.data_ptr(),
        perm.data_ptr(), n_live, int(outer), lo.data_ptr(), cnt.data_ptr(),
        btot.data_ptr(), btot[nb:].data_ptr(), _stream()), "mult_count")
    total = int(btot[nb].item())
    li = torch.empty(total, dtype=I64, device=dev)
    ri = torch.empty(total, dtype=I64, device=dev)
    if total:
        _ext.check(lib.hk3_mult_expand(
            lv.data_ptr(), nl, lo.data_ptr(), cnt.data_ptr(),
            perm.data_ptr(), int(outer), btot.data_ptr(), li.data_ptr(),
            ri.data_ptr(), _stream()), "mult_expand")
    _count(LAUNCHES, "equi_join")
    return li, ri


def equi_join_mult_plain(lk, ln, lv, rk, rn, rv, outer=False):
    """Plain torch version of the any-multiplicity HK3 mode."""
    _count(PLAIN_CALLS, "equi_join")
    dev = lk.device
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
    total = int(eff.sum())
    if total == 0:
        z = torch.empty(0, dtype=I64, device=dev)
        return z, z
    li = torch.repeat_interleave(torch.arange(len(lk), dtype=I64,
                                              device=dev), eff)
    starts = torch.cumsum(eff, 0) - eff
    pos = torch.arange(total, dtype=I64, device=dev) - starts[li]
    matched = counts[li] > 0
    ridx = torch.clamp(lo[li] + pos, max=max(srow.numel() - 1, 0))
    ri = torch.where(matched, srow[ridx] if srow.numel()
                     else torch.zeros_like(ridx), torch.full_like(li, -1))
    return li, ri


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
        buf_a = torch.empty((m + 1) * n, dtype=I64, device=dev)
        buf_b = torch.empty((m + 1) * n, dtype=I64, device=dev)
        out = torch.empty(n if kk < 0 else kk, dtype=I64, device=dev)
        _ext.check(lib.hk4_lex_order(ctypes.byref(cin), m, n, kk,
                                     buf_a.data_ptr(), buf_b.data_ptr(),
                                     out.data_ptr(), _stream()),
                   "lex_order")
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
    ``valid`` and the lanes are in row space.  Returns HK2's table layout,
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


class _CGather(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p * _MAX_LANES),
                ("nulls", ctypes.c_void_p * _MAX_LANES),
                ("out_vals", ctypes.c_void_p * _MAX_LANES),
                ("out_nulls", ctypes.c_void_p * _MAX_LANES),
                ("width", ctypes.c_int * _MAX_LANES),
                ("n", ctypes.c_int)]


def _probe_checks(kp, knull, pvalid, tbl, bvalid, blanes, mode):
    nb = int(kp.shape[0])
    dev = kp.device
    kp, knull, pvalid = kp.contiguous(), knull.contiguous(), \
        pvalid.contiguous()
    _need(kp, I64, nb, dev, "dense_probe key")
    _need(knull, torch.bool, nb, dev, "dense_probe key null")
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
    return kp, knull, pvalid, tbl, bvalid, lanes


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
    kp, knull, pvalid, tbl, bvalid, blanes = _probe_checks(
        kp, knull, pvalid, tbl, bvalid, blanes, mode)
    if not _on_card(kp, "dense_probe"):
        return dense_probe_plain(kp, knull, pvalid, lo, hi, tbl, bvalid,
                                 blanes, mode)
    from . import _ext
    lib = _ext.lib("dense_probe")
    nb = int(kp.shape[0])
    dev = kp.device
    lanes = blanes if mode in ("inner", "left") else []
    valid_out = torch.empty(nb, dtype=torch.bool, device=dev)
    outs = []
    for c0 in range(0, max(len(lanes), 1), _MAX_LANES):
        chunk = lanes[c0:c0 + _MAX_LANES]
        cg = _CGather()
        cg.n = len(chunk)
        for j, (v, m) in enumerate(chunk):
            ov = torch.empty(nb, dtype=v.dtype, device=dev)
            om = torch.empty(nb, dtype=torch.bool, device=dev)
            cg.vals[j] = v.data_ptr()
            cg.nulls[j] = _ptr(m)
            cg.out_vals[j] = ov.data_ptr()
            cg.out_nulls[j] = om.data_ptr()
            cg.width[j] = v.element_size()
            outs.append((ov, om))
        _ext.check(lib.hk6_dense_probe(
            kp.data_ptr(), knull.data_ptr(), pvalid.data_ptr(), nb, int(lo),
            int(hi), tbl.data_ptr(), int(tbl.shape[0]), bvalid.data_ptr(),
            int(bvalid.shape[0]), _PROBE_MODES[mode], ctypes.byref(cg),
            valid_out.data_ptr(), _stream()), "dense_probe")
        _count(LAUNCHES, "dense_probe")
    return valid_out, outs


def dense_probe_plain(kp, knull, pvalid, lo: int, hi: int, tbl, bvalid,
                      blanes, mode: str):
    """Plain torch version of HK6 (same contract, any device)."""
    _count(PLAIN_CALLS, "dense_probe")
    tbl_len = int(tbl.shape[0])
    nbb = int(bvalid.shape[0])
    inr = (kp >= lo) & (kp <= hi) & ~knull
    if tbl_len:
        # key - lo only for keys inside [lo, hi]: nothing wraps
        off = (torch.where(inr, kp, torch.full_like(kp, lo)) - lo).clamp(
            max=tbl_len - 1)
        pos = torch.where(inr, tbl[off].to(I64), torch.full_like(kp, -1))
    else:
        pos = torch.full_like(kp, -1)
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
# operator families (the reference's host entry points)
# =========================================================================
# mask spec accepted by the fused entry points:
#   ("host", bool_mask_dev)  — host-evaluated mask, uploaded
#   ("dev", mask_fn, key)    — mask_fn(cols, params, row_idx) evaluated
#                              on the device; `key` joins the program key

def _mask_parts(mask):
    if mask[0] == "host":
        return None, ("hostmask",), mask[1]
    _, mask_fn, key = mask[:3]
    return mask_fn, ("devmask", key), None


def _params_dev(params):
    if params is None:
        dev = device()
        return (torch.zeros(0, dtype=I64, device=dev),
                torch.zeros(0, dtype=F64, device=dev))
    pi, pf = params
    return (h2d(pi), h2d(pf))


def _spec_lanes(agg_specs, arg_fns, cols, pr):
    """(lanes, plan): the reduction lanes of a list of aggregate specs and,
    per spec, how to read its output: ("nvalid",) for count_star or
    (func, lane index, float?)."""
    lanes, plan = [], []
    for (func, has_arg), af in zip(agg_specs, arg_fns):
        av = an = None
        if has_arg and af is not None:
            av, an = af(cols, pr)
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


def fused_scalar_aggregate(dev_cols, agg_specs, arg_exprs, n_rows: int,
                           nb: int, mask, program_key: tuple = (),
                           params=None):
    """Global-group fused path (K1 -> HK1): the filter mask and the
    argument expressions evaluate on the device, one masked reduction
    produces every aggregate, one pull brings them back.  Returns
    (out_aggs, first_orig) with zero or one output row."""
    mask_fn, mask_key, mask_arr = _mask_parts(mask)
    key = ("scalar", tuple(agg_specs), program_key, mask_key, nb)

    def build():
        arg_fns = list(arg_exprs)

        def program(cols, mask_in, pr):
            valid = mask_fn(cols, pr, _arange(nb)) if mask_fn is not None \
                else mask_in
            lanes, plan = _spec_lanes(agg_specs, arg_fns, cols, pr)
            return masked_reduce(valid.contiguous(), lanes), plan
        return counted_launch(program)
    fn = progcache.get(key, build)
    out, plan = fn(dev_cols, mask_arr, _params_dev(params))
    vals = d2h(out)
    return _scalar_contract(vals, plan)


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
    """Global aggregate over host argument columns (K5 -> HK1).  Returns
    (out_aggs, first_orig) with one row when any row survives."""
    nb = bucket(max(n_rows, 1))
    valid = np.zeros(nb, dtype=bool)
    valid[:n_rows] = filter_mask if filter_mask is not None else True
    dev_args = [(h2d_pad(v, nb), h2d_pad(m, nb, True)) for v, m in arg_cols]
    it = iter(dev_args)
    arg_fns = [((lambda c, p, a=next(it): a) if has else None)
               for _, has in agg_specs]
    stats_add("dispatches", 1)
    lanes, plan = _spec_lanes(agg_specs, arg_fns, None, None)
    out = masked_reduce(h2d(valid), lanes)
    return _scalar_contract(d2h(out), plan)


def _fused_segment_raw(dev_cols, gid_dev, n_segments: int, agg_specs,
                       arg_exprs, mask, program_key: tuple = (),
                       params=None):
    """The fused segment program (K2 -> HK2) without extraction: returns
    (table, plan, ns) with the HK2 output table on the device."""
    nb = int(gid_dev.shape[0])
    ns = bucket(max(n_segments, 1))
    mask_fn, mask_key, mask_arr = _mask_parts(mask)
    key = ("seg", tuple(agg_specs), program_key, mask_key, ns, nb)

    def build():
        arg_fns = list(arg_exprs)

        def program(cols, gid, mask_in, pr):
            valid = mask_fn(cols, pr, _arange(nb)) if mask_fn is not None \
                else mask_in
            lanes, plan = _spec_lanes(agg_specs, arg_fns, cols, pr)
            return segment_reduce(gid, valid.contiguous(), ns, lanes), plan
        return counted_launch(program)
    fn = progcache.get(key, build)
    table, plan = fn(dev_cols, gid_dev, mask_arr, _params_dev(params))
    return table, plan, ns


def _present_extract(table, plan, ns: int, nb: int, limit: int = None):
    """Present segments -> (present_ids, out_aggs, first_orig) host arrays:
    one pull of the whole table (small tables) or a device compaction and
    one pull of the compacted rows (large)."""
    if ns <= SMALL_PACK:
        vals = d2h(table)
        present = np.nonzero(vals[0] > 0)[0]
        rows = vals[:, present]
    else:
        np_, packed = present_compact(table, ns)
        host = d2h(packed)
        present = host[0][:np_]
        rows = host[1:, :np_]
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
                            agg_specs, arg_exprs, n_rows: int, mask,
                            program_key: tuple = (), params=None):
    """Grouped fused path (K2 -> HK2).  Returns (present_ids, out_aggs,
    first_orig) host arrays, present segments ascending."""
    table, plan, ns = _fused_segment_raw(
        dev_cols, gid_dev, n_segments, agg_specs, arg_exprs, mask,
        program_key=program_key, params=params)
    return _present_extract(table, plan, ns, int(gid_dev.shape[0]),
                            limit=n_segments)


def fused_segment_aggregate_keep(dev_cols, gid_dev, n_segments: int,
                                 agg_specs, arg_exprs, mask,
                                 program_key: tuple = (), params=None):
    """Device-resident variant (late materialization): compacts present
    segments on the device and returns (ids [ob], live [ob], out_aggs as
    device (values, null) pairs, n_present, ob); only n_present syncs.
    Padding rows carry id = ns and live = False."""
    table, plan, ns = _fused_segment_raw(
        dev_cols, gid_dev, n_segments, agg_specs, arg_exprs, mask,
        program_key=program_key, params=params)
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
    dev_args = [(h2d_pad(v, nb), h2d_pad(m, nb, True)) for v, m in arg_cols]
    it = iter(dev_args)
    arg_fns = [((lambda c, p, a=next(it): a) if has else None)
               for _, has in agg_specs]
    stats_add("dispatches", 1)
    lanes, plan = _spec_lanes(agg_specs, arg_fns, None, None)
    table = segment_reduce(g, h2d(valid), ns, lanes)
    return _present_extract(table, plan, ns, nb)


def group_aggregate(key_cols: List[Tuple[np.ndarray, np.ndarray]],
                    agg_specs: List[Tuple[str, bool]],
                    arg_cols: List[Tuple[np.ndarray, np.ndarray]],
                    n_rows: int, filter_mask: np.ndarray = None):
    """Sort-based group-by (K4): HK4 sorts the rows by their keys (NULL
    first, invalid rows last), group ids come from the key boundaries of
    the sorted order, and HK2 reduces per group.  Groups come out in key
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
    vs = valid[perm]
    boundary = torch.zeros(nb, dtype=torch.bool, device=valid.device)
    boundary[0] = True
    for v, m in zip(kv, kn):
        a, b = v[perm], m[perm]
        diff = ((a[1:] != a[:-1]) & ~(b[1:] & b[:-1])) | (b[1:] != b[:-1])
        boundary[1:] |= diff
    gid_sorted = torch.cumsum(boundary.to(I64), 0) - 1
    gid = torch.empty_like(gid_sorted)
    gid[perm] = torch.where(vs, gid_sorted, torch.full_like(gid_sorted, nb))
    dev_args = [(h2d_pad(v, nb), h2d_pad(m, nb, True)) for v, m in arg_cols]
    it = iter(dev_args)
    arg_fns = [((lambda c, p, a=next(it): a) if has else None)
               for _, has in agg_specs]
    lanes, plan = _spec_lanes(agg_specs, arg_fns, None, None)
    table = segment_reduce(gid, valid, nb, lanes)
    present, out_aggs, _ = _present_extract(table, plan, nb, nb)
    # each group's representative is its FIRST row in sorted order (the
    # reference's first_orig), not its lowest row: under a NULL key rows
    # sort by their hidden values
    first = d2h(perm[torch.nonzero(boundary & vs).reshape(-1)])
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
    return lk, ln, h2d(lv), rk, rn, h2d(rv), lv


def unique_join_match(lkey, n_left: int, rkey, n_right: int,
                      outer: bool = False, lvalid: np.ndarray = None,
                      rvalid: np.ndarray = None):
    """Equi-join whose build (right) key is unique among its live rows
    (K6 -> HK3).  Returns host (left_indices, right_indices); outer joins
    keep every valid left row with right index -1 when unmatched.  HK3's
    key table needs no sorted build side, so there is no ``build_sorted``
    claim for a validity mask with holes to break (the reference's R3)."""
    lk, ln, lv, rk, rn, rv, _ = _join_inputs(lkey, n_left, rkey, n_right,
                                             lvalid, rvalid)
    stats_add("dispatches", 1)
    li, ri = equi_join_unique(lk, ln, lv, rk, rn, rv, outer=outer)
    if li.numel() == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z
    li, ri = d2h_many([li, ri])
    return li, ri


def join_match(lkey: Tuple[np.ndarray, np.ndarray], n_left: int,
               rkey: Tuple[np.ndarray, np.ndarray], n_right: int,
               outer: bool = False, lvalid: np.ndarray = None,
               rvalid: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """Equi-join of any multiplicity (K7 -> HK3 + HK4 build sort).
    Returns host (left_indices, right_indices), probe-major, build rows in
    stable key order; outer joins emit unmatched valid left rows once with
    right index -1."""
    lk, ln, lv, rk, rn, rv, _ = _join_inputs(lkey, n_left, rkey, n_right,
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
    test, in probe order (K8).  Membership is HK3's unique probe (the
    lowest matching build row stands for all); the NOT IN ladder (empty
    build side keeps every valid probe row, a NULL build key keeps none,
    a NULL probe key never passes) folds in as tensor ops."""
    lk, ln, lv, rk, rn, rv, lv_h = _join_inputs(lkey, n_left, rkey,
                                                n_right, lvalid, rvalid)
    stats_add("dispatches", 1)
    rv_h = np.zeros(rk.shape[0], dtype=bool)
    rv_h[:n_right] = rvalid[:n_right] if rvalid is not None else True
    n_build = int(rv_h.sum())
    if n_build == 0:
        keep = lv_h if anti else np.zeros(len(lv_h), dtype=bool)
        return np.nonzero(keep)[0].astype(np.int64)
    if anti and null_aware:
        rn_h = d2h(rn)
        if bool((rv_h & rn_h).any()):
            return np.empty(0, dtype=np.int64)
    li, _ = equi_join_unique(lk, ln, lv, rk, rn, rv)
    member = torch.zeros_like(lv)
    member[li] = True
    if not anti:
        keep = member
    else:
        keep = lv & ~member
        if null_aware:
            keep = keep & ~ln
    out = d2h(torch.nonzero(keep).reshape(-1))
    return out.astype(np.int64)


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
