"""Shared compiled-program registry — the ``_PROJ_CACHE`` pattern,
hoisted into ONE keyed table — plus the per-program CATALOG behind
``information_schema.compiled_programs`` and ``/debug/programs``.

Every device-program cache in the engine used to be an ad-hoc module
dict (``_PROJ_CACHE`` / ``_FILTER_CACHE`` in tpu_executors.py,
``_JIT_CACHE`` in devpipe.py, half a dozen ``*_CACHE`` tables in
kernels.py).  They all implemented the same two-line idiom and none of
them could answer the bench's question "did this query compile anything
or did it run warm?".  This registry replaces them:

- keys are NAMESPACED tuples of hashable scalars (first element a short
  domain string: ``"proj"``, ``"sort"``, ``"seg"``, ``"pipe"``, ...) so
  consumers can never collide (qlint TS105 applies to the key shapes);
- values are whatever the builder returns — usually a ``counted_jit``
  wrapper or a ``(fn, schema)`` pair for packed kernels;
- every lookup counts a hit or a miss; the bench exports the per-query
  delta (``progcache_hits`` / ``progcache_misses`` in kernels.STATS) as
  the in-process half of the compile-cache story (the on-disk half is
  jax's persistent compilation cache, kernels.set_compile_cache_dir);
- the prewarmer (tools/warm.py) seeds entries AOT through the same
  ``get`` path, so a prewarmed program is a plain hit at query time.

The catalog (``_CATALOG``) carries one :class:`ProgramMeta` per key:
domain, compile wall, prewarm provenance, per-program dispatch count,
cumulative MEASURED device time (fed by the sampling profiler,
ops/profiler.py), the program's XLA cost-analysis flops/bytes, and the
plan digest of the last statement that dispatched it — the join key
against ``statements_summary``.  ``counted_jit`` learns its key through
the build-scope thread-local (:func:`building_key`) and reports
dispatches back through :func:`note_dispatch`, so the catalog needs no
cooperation from individual builders.

Thread-safe: lookups and publishes take the registry lock; builders run
OUTSIDE it (they may recurse into the registry while tracing).  A lost
build race is benign — ``setdefault`` keeps the first-published entry,
and both candidates dispatch the same XLA program.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import context as _obs

_mu = threading.Lock()
_REG: Dict[tuple, object] = {}
_MISS = object()

#: registry hit/miss counters, exported through kernels.stats_snapshot as
#: progcache_hits / progcache_misses.  The prewarm pair carries program
#: provenance: ``prewarm_seeded`` counts programs built inside a
#: prewarm_scope (the auto-prewarm worker / tools/warm.py compiling off
#: the query path), ``prewarm_hits`` counts query-path lookups that found
#: such a seeded program — the compiles the prewarmer saved real queries.
#: ``compile_wall_s`` accrues every build's wall (INCLUSIVE of nested
#: builds a builder recurses into — same nesting the "compile" spans
#: show), the process half of the per-query ``compile_s`` attribution.
STATS = {"hits": 0, "misses": 0, "prewarm_seeded": 0, "prewarm_hits": 0,
         "compile_wall_s": 0.0}

#: keys whose entries were built inside a prewarm scope
_PREWARMED: set = set()

#: thread-local prewarm marker: the worker warms on its own thread, and
#: BlockPipeline stage threads it spawns inherit the obs context — but
#: progcache attribution only needs the directly-calling thread.  Also
#: carries the key currently being BUILT on this thread, so counted_jit
#: wrappers constructed inside a builder know their catalog identity.
_TLS = threading.local()


class prewarm_scope:
    """Mark this thread's registry builds as prewarm-seeded (reentrant)."""

    def __enter__(self):
        _TLS.depth = getattr(_TLS, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _TLS.depth -= 1
        return False


def prewarming() -> bool:
    return getattr(_TLS, "depth", 0) > 0


def building_key() -> Optional[tuple]:
    """The registry key whose builder is running on THIS thread (None
    outside a build) — counted_jit captures it at construction time as
    the program's catalog identity."""
    return getattr(_TLS, "build_key", None)


class ProgramMeta:
    """One compiled program's catalog entry (compiled_programs row)."""

    __slots__ = ("key", "domain", "created_at", "compile_s", "prewarmed",
                 "dispatches", "device_s", "profiled_dispatches",
                 "flops", "bytes_accessed", "peak_temp_bytes",
                 "peak_arg_bytes", "peak_out_bytes", "plan_digest",
                 "last_used")

    def __init__(self, key: tuple):
        self.key = key
        self.domain = str(key[0]) if key else ""
        self.created_at = 0.0
        self.compile_s = 0.0
        self.prewarmed = False
        self.dispatches = 0
        self.device_s = 0.0
        self.profiled_dispatches = 0
        self.flops = 0.0
        self.bytes_accessed = 0.0
        # XLA memory_analysis of the compiled program (peak scratch /
        # operand / result bytes) — the static half of the HBM story,
        # fed by the pending-cost resolver (kernels.resolve_pending_costs)
        self.peak_temp_bytes = 0.0
        self.peak_arg_bytes = 0.0
        self.peak_out_bytes = 0.0
        self.plan_digest = ""
        self.last_used = 0.0

    def to_dict(self) -> dict:
        return {"domain": self.domain, "key": str(self.key)[:256],
                "created_at": self.created_at,
                "compile_ms": round(self.compile_s * 1e3, 3),
                "prewarmed": int(self.prewarmed),
                "dispatches": self.dispatches,
                "device_ms": round(self.device_s * 1e3, 3),
                "profiled_dispatches": self.profiled_dispatches,
                "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "peak_temp_bytes": self.peak_temp_bytes,
                "peak_arg_bytes": self.peak_arg_bytes,
                "peak_out_bytes": self.peak_out_bytes,
                "plan_digest": self.plan_digest,
                "last_used": self.last_used}


#: per-key ProgramMeta (guarded by the registry lock)
_CATALOG: Dict[tuple, ProgramMeta] = {}


def _meta_locked(key: tuple) -> ProgramMeta:
    # caller holds _mu
    meta = _CATALOG.get(key)
    if meta is None:
        meta = _CATALOG[key] = ProgramMeta(key)
    return meta


def get(key: tuple, build: Callable[[], object]):
    """The one lookup path: return the entry for ``key``, building (and
    publishing) it on first sight.  ``build`` runs outside the lock."""
    warming = prewarming()
    prewarm_hit = False
    with _mu:
        ent = _REG.get(key, _MISS)
        if ent is not _MISS:
            STATS["hits"] += 1
            hit = True
            if not warming and key in _PREWARMED:
                STATS["prewarm_hits"] += 1
                prewarm_hit = True
        else:
            STATS["misses"] += 1
            hit = False
    # per-query attribution rides the obs scope (kernels.stats_snapshot
    # exports the global pair as progcache_hits/progcache_misses)
    _obs.record("progcache_hits" if hit else "progcache_misses", 1)
    if prewarm_hit:
        _obs.record("prewarm_hits", 1)
    if hit:
        return ent
    prev_key = getattr(_TLS, "build_key", None)
    _TLS.build_key = key
    t0 = time.perf_counter()
    try:
        with _obs.span("compile", cat="device", key=str(key[0])):
            ent = build()
    finally:
        _TLS.build_key = prev_key
    wall = time.perf_counter() - t0
    # the per-query compile attribution (EXPLAIN ANALYZE `compile:` cell,
    # statements_summary sum_compile_ms); nested builds accrue inclusive
    # walls, exactly like their nested "compile" spans
    _obs.record("compile_s", wall)
    now = time.time()
    with _mu:
        STATS["compile_wall_s"] += wall
        if warming and key not in _PREWARMED:
            _PREWARMED.add(key)
            STATS["prewarm_seeded"] += 1
        meta = _meta_locked(key)
        meta.compile_s += wall
        meta.prewarmed = meta.prewarmed or warming
        if not meta.created_at:
            meta.created_at = now
        return _REG.setdefault(key, ent)


def note_dispatch(key: Optional[tuple], device_s: Optional[float] = None,
                  cost: Optional[tuple] = None) -> None:
    """One dispatch of the program built under ``key`` (called by
    kernels.counted_jit; ``key`` None = a jit wrapper constructed
    outside any registry build — nothing to catalog).  ``device_s``
    carries the profiler's measured wall on sampled dispatches; ``cost``
    the resolved XLA cost analysis ``(flops, bytes_accessed)`` of the
    dispatched (program, shape) — static per program, so the catalog
    stores the per-dispatch value, not an accumulation."""
    if key is None:
        return
    q = _obs.current()
    digest = q.plan_digest if q is not None else ""
    now = time.time()
    with _mu:
        meta = _meta_locked(key)
        meta.dispatches += 1
        meta.last_used = now
        if device_s is not None:
            meta.device_s += device_s
            meta.profiled_dispatches += 1
        # (0, 0) is also the over-cap / unresolvable SENTINEL from the
        # pending-cost queue — never let it clobber a real measurement
        # from a previously resolved shape of this program
        if cost is not None and (cost[0] or cost[1]):
            meta.flops, meta.bytes_accessed = cost
        if digest:
            meta.plan_digest = digest


def note_memory(key: Optional[tuple], temp_bytes: float, arg_bytes: float,
                out_bytes: float) -> None:
    """Fold a compiled program's XLA ``memory_analysis`` (peak temp /
    argument / output bytes) into its catalog entry — called by the
    pending-cost resolver alongside cost analysis.  Shapes of the same
    program keep the LARGEST footprint seen (the conservative number
    admission wants); all-zero reports (backends without the API) never
    clobber a real measurement."""
    if key is None or not (temp_bytes or arg_bytes or out_bytes):
        return
    with _mu:
        meta = _meta_locked(key)
        meta.peak_temp_bytes = max(meta.peak_temp_bytes, float(temp_bytes))
        meta.peak_arg_bytes = max(meta.peak_arg_bytes, float(arg_bytes))
        meta.peak_out_bytes = max(meta.peak_out_bytes, float(out_bytes))


def _census_registry_values():
    """HBM census walker: every registered program entry.  Wrapper
    functions keep their program state inside XLA (not as live arrays),
    so this category normally reads 0 — but a builder that publishes a
    (fn, device-constant) tuple is claimed here instead of leaking into
    the unattributed bucket."""
    with _mu:
        return list(_REG.values())


from ..obs import memprof as _memprof  # noqa: E402  (cycle-free: memprof
#                                        imports no ops module at top level)
_memprof.register_census_walker("progcache", _census_registry_values)


def peek(key: tuple):
    """Entry or None, without counting or building (introspection)."""
    with _mu:
        return _REG.get(key)


def keys(domain: Optional[str] = None) -> List[tuple]:
    """Registered keys, optionally filtered by their namespace tag."""
    with _mu:
        return [k for k in _REG
                if domain is None or (len(k) > 0 and k[0] == domain)]


def size() -> int:
    with _mu:
        return len(_REG)


def clear() -> None:
    """Drop every entry (tests; a backend reset invalidates programs)."""
    with _mu:
        _REG.clear()
        _PREWARMED.clear()
        _CATALOG.clear()


def stats_snapshot() -> dict:
    with _mu:
        return dict(STATS)


# ---- the catalog read surfaces -------------------------------------------

#: information_schema.compiled_programs column order — MUST match
#: catalog_rows (catalog/memtables.py builds FieldTypes from this)
CATALOG_COLUMNS = [
    ("domain", "str"), ("prog_key", "str"), ("created", "str"),
    ("compile_ms", "real"), ("prewarmed", "int"), ("dispatches", "int"),
    ("device_ms", "real"), ("profiled_dispatches", "int"),
    ("flops", "real"), ("bytes_accessed", "real"),
    ("plan_digest", "str"), ("last_used", "str"),
    ("peak_temp_bytes", "real"), ("peak_arg_bytes", "real"),
    ("peak_out_bytes", "real"),
]


def catalog_snapshot() -> List[dict]:
    """Dict-form catalog (the ``/debug/programs`` payload), dispatch
    count descending so the hottest programs lead."""
    with _mu:
        metas = [m.to_dict() for m in _CATALOG.values()]
    metas.sort(key=lambda m: (-m["dispatches"], m["domain"], m["key"]))
    return metas


def catalog_rows() -> List[list]:
    """The ``compiled_programs`` mem-table payload, in CATALOG_COLUMNS
    order."""
    from ..obs.stmtsummary import _ts
    out: List[list] = []
    for m in catalog_snapshot():
        out.append([
            m["domain"], m["key"],
            _ts(m["created_at"]) if m["created_at"] else "",
            float(m["compile_ms"]), int(m["prewarmed"]),
            int(m["dispatches"]), float(m["device_ms"]),
            int(m["profiled_dispatches"]), float(m["flops"]),
            float(m["bytes_accessed"]), m["plan_digest"],
            _ts(m["last_used"]) if m["last_used"] else "",
            float(m["peak_temp_bytes"]), float(m["peak_arg_bytes"]),
            float(m["peak_out_bytes"]),
        ])
    return out
