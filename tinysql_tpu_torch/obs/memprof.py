"""Memory truth: continuous heap profiler, device-buffer census, and
measured-vs-tracked reconciliation (reference lineage: TiDB Dashboard's
continuous profiling applied to the HEAP axis + TiDB's memory-usage
introspection — the ledger every OOM postmortem wishes it had).

The "measured truth" series made device time, host CPU
and device transfers measured rather than
estimated; memory — the input to every spill-ladder and admission
decision — was still bookkeeping-only: ``utils/memory.MemTracker``
charges nominal byte counts and nothing ever checks the ledger against
the process.  This module owns the measured answer, from two sources
plus one reconciler:

1. **Host heap** (:class:`HeapProfiler` + :class:`MemprofSampler`): a
   tracemalloc-based sampling profiler following conprof's exact design
   — a background sampler on the server lifecycle paced by the GLOBAL
   ``tidb_memprof_rate`` sysvar (Hz, 0 = off, re-read live every tick),
   folding the top allocation SITES (``file:lineno`` chains) into
   bounded per-window aggregates with the stmtsummary/conprof
   rotation/eviction/tombstone semantics, classifying each site by
   serving ROLE (matched against live thread stacks through the
   conprof thread-name vocabulary), and attributing each tick's
   positive traced-heap delta to the statements currently EXECUTING
   (resolved through the interrupt registry) — so
   ``statements_summary`` gains ``sum_heap_alloc_kb`` / ``max_heap_kb``
   columns, all under the same hard <3% self-cost budget and backoff
   divisor conprof runs under.
2. **Device HBM census** (:func:`hbm_census`): a snapshot classifier
   that walks the tensors owners register, reconciles them against the
   CUDA allocator (``torch.cuda.memory_allocated`` / ``memory_stats``)
   and attributes every live device buffer to its birth site — replica-memoized
   columns (columnar/store.py device memos), ParamTable uploads, the
   spill working set, progcache-registered program state — with an
   *unattributed* leak bucket that must read empty after a quiesced
   workload.  Owners register walkers (:func:`register_census_walker`)
   so the census needs no knowledge of individual caches.  The census
   also feeds measured per-table row width back into the spill gates
   (:func:`measured_row_bytes` — replacing the nominal
   ``_NOMINAL_ROW_BYTES`` pricing with replica truth).
3. **Reconciliation** (:func:`memory_state`): one snapshot sampling
   tracked MemTracker bytes (the ledger) vs measured tracemalloc heap /
   RSS vs the HBM census — the ``memory_state`` time-series source the
   ``heap-growth`` / ``hbm-pressure`` / ``mem-untracked`` inspection
   rules judge, served as ``information_schema.memory_usage`` and
   ``/debug/heap`` (collapsed-site text sharing conprof's parser).

Semantics and honesty notes (the blind-spot contract, documented like
the device-transfer ``np.ascontiguousarray`` caveat):

- tracemalloc sees PYTHON allocations only.  XLA's C++ device arena,
  numpy buffers allocated before ``tracemalloc.start()``, and any
  malloc outside the CPython allocator are invisible to the traced
  number — that is exactly why RSS and the HBM census ride alongside
  it in ``memory_state`` instead of one number pretending to be truth.
- allocation sites carry ``file:lineno`` chains, NOT thread identity —
  tracemalloc drops the allocating thread.  Role classification is
  therefore best-effort: a site is attributed to a role when one of
  its call-site frames is live on a thread of that role at sample time
  (call-site ``(file, lineno)`` pairs match exactly between a
  traceback and a suspended frame); sites whose allocation path is no
  longer on any stack read ``other``.
- statement attribution splits each tick's POSITIVE traced-heap delta
  evenly among the statements executing at that instant, so the sum of
  ``sum_heap_alloc_kb`` across concurrent statements can never exceed
  the process's measured heap growth (the heap analogue of conprof's
  ``cpu <= wall`` cap); ``max_heap_kb`` is the traced-heap high water
  observed while the statement ran — an upper bound, process-wide by
  construction.
- the sampler's self-cost is measured every tick; past
  ``OVERHEAD_BUDGET_FRAC`` of one core the ``backoff`` divisor doubles
  (conprof's exact hysteresis) — the profiler may get coarser under
  load, never expensive.  ``tidb_memprof_rate = 0`` costs one sysvar
  read per idle slice and leaves every surface byte-identical.

WRITE DISCIPLINE (qlint OB407): the fold/attribution state here — and
the statement heap/HBM counters (``heap_kb`` / ``heap_peak_kb`` /
``hbm_bytes``) — are written ONLY from this module.  Any other writer
would publish un-measured bookkeeping as memory truth or corrupt the
window accounting.
"""
from __future__ import annotations

import os
import threading
import time
import tracemalloc
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .. import fail

DEFAULT_RATE_HZ = 1
DEFAULT_WINDOW_S = 60
DEFAULT_HISTORY = 15
DEFAULT_MAX_SITES = 256

#: ceiling on the applied rate regardless of the sysvar: a tracemalloc
#: snapshot is orders pricier than a frame walk — beyond this the
#: backoff would only fight the sysvar
MAX_RATE_HZ = 50

#: tracemalloc frames kept per allocation site (tracemalloc.start
#: depth; deeper costs every allocation in the process, not just ticks)
MAX_SITE_DEPTH = 12

#: top allocation sites (by live size) folded per tick — the window
#: aggregates the union across ticks, so the cap bounds tick cost, not
#: coverage
TOP_SITES_PER_TICK = 64

#: the sampler's self-cost budget as a fraction of one core; past it
#: the backoff divisor doubles (mem analogue of conprof's rule)
OVERHEAD_BUDGET_FRAC = 0.03
BACKOFF_MAX = 16

EVICTED_SITE = "(evicted)"

#: band for the mem-untracked reconciliation (obs/inspect.py): windowed
#: traced-heap growth may run this far past the MemTracker ledger
#: before the divergence is a finding — interpreter caches, compiled
#: program metadata, and obs stores all legitimately allocate outside
#: the statement ledger
UNTRACKED_BAND_BYTES = 64 << 20


def fold_site(frames: Iterable[Tuple[str, int]],
              max_depth: int = MAX_SITE_DEPTH) -> str:
    """``(file, lineno)`` chain (root->leaf) -> the folded site string
    ``base.py:lineno;...`` — same shape contract as conprof's folded
    stacks, so /debug/heap shares conprof.parse_collapsed and the
    flamegraph toolchain."""
    parts = [f"{f.rsplit('/', 1)[-1]}:{ln}" for f, ln in frames]
    return ";".join(parts[-max_depth:])


def _live_frame_roles(frames: Optional[Dict[int, object]] = None,
                      skip_idents: Tuple[int, ...] = ()) -> \
        Dict[Tuple[str, int], str]:
    """``(file basename, lineno) -> role`` over every frame currently
    suspended on a live thread (conprof's thread-name vocabulary).  The
    non-leaf entries are CALL SITES — the exact (file, lineno) pairs a
    tracemalloc traceback carries for its non-leaf frames — so a heap
    site allocated under a still-running call path matches its role."""
    import sys
    from .conprof import classify
    if frames is None:
        frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[Tuple[str, int], str] = {}
    for tid, frame in frames.items():
        if tid in skip_idents:
            continue
        role = classify(names.get(tid, ""))
        f = frame
        while f is not None:
            key = (f.f_code.co_filename.rsplit("/", 1)[-1], f.f_lineno)
            if key not in out or out[key] == "other":
                out[key] = role
            f = f.f_back
    return out


def classify_site(frames: Iterable[Tuple[str, int]],
                  rolemap: Dict[Tuple[str, int], str]) -> str:
    """Best-effort role of an allocation site: leaf-most frame that is
    live on some thread's stack wins; ``other`` when the allocation
    path is no longer executing anywhere."""
    for f, ln in reversed(list(frames)):
        role = rolemap.get((f.rsplit("/", 1)[-1], ln))
        if role is not None:
            return role
    return "other"


# ---- the windowed site store ----------------------------------------------

class _SiteAgg:
    __slots__ = ("samples", "size_kb", "peak_kb", "last_seen")

    def __init__(self):
        self.samples = 0
        self.size_kb = 0.0       # last-observed live bytes at this site
        self.peak_kb = 0.0       # max observed within the window
        self.last_seen = 0.0

    def merge(self, other: "_SiteAgg") -> None:
        # tombstone accounting: sizes SUM (distinct sites folded into
        # one bucket), peaks keep the max single site
        self.samples += other.samples
        self.size_kb += other.size_kb
        self.peak_kb = max(self.peak_kb, other.peak_kb)
        self.last_seen = max(self.last_seen, other.last_seen)


class HeapProfiler:
    """The fold/attribution store: current window + bounded rotated
    history, conprof-style.  Written from the sampler thread; read from
    any session scanning ``memory_usage`` or hitting ``/debug/heap`` —
    all paths take the lock."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 history: int = DEFAULT_HISTORY,
                 max_sites: int = DEFAULT_MAX_SITES):
        self.window_s = float(window_s)
        self.max_history = int(history)
        self.max_sites = int(max_sites)
        self._mu = threading.Lock()
        #: (role, folded site) -> aggregate, current window
        self._entries: Dict[Tuple[str, str], _SiteAgg] = {}
        #: anchored by the FIRST fold (stmtsummary window discipline)
        self.window_begin: Optional[float] = None
        #: rotated windows, oldest first: (window_begin, {key: agg})
        self.history: deque = deque()
        #: adaptive rate divisor: effective period = backoff / rate
        self.backoff = 1
        self._cost_ewma = 0.0
        #: traced-heap KB at the previous tick (attribution baseline);
        #: None = no baseline (first tick / tracing restarted)
        self._last_traced_kb: Optional[float] = None
        self._stats = {"ticks": 0, "sites": 0, "attributed": 0,
                       "self_s": 0.0, "evicted": 0, "errors": 0,
                       "traced_kb": 0.0, "traced_peak_kb": 0.0}

    # ---- the designated write path (sampler thread ONLY) ----------------
    def sample_once(self, period_s: float, now: Optional[float] = None,
                    stats: Optional[List[tuple]] = None,
                    frames: Optional[Dict[int, object]] = None,
                    traced_kb: Optional[float] = None,
                    traced_peak_kb: Optional[float] = None,
                    hbm_bytes: Optional[float] = None,
                    window_s: Optional[float] = None,
                    history: Optional[int] = None,
                    max_sites: Optional[int] = None,
                    skip_idents: Tuple[int, ...] = (),
                    attribute: bool = True) -> int:
        """One sampling tick: snapshot the traced heap, fold the top
        allocation sites, attribute the tick's positive traced-heap
        delta to executing statements.  ``now``/``stats``/``frames``/
        ``traced_kb`` are injectable for deterministic tests (``stats``
        is ``[(frames root->leaf as (file, lineno) tuples, size_bytes),
        ...]``); the ``window_s``/``history``/``max_sites`` overrides
        carry the live sysvars.  ``attribute=False`` folds only — the
        overhead probe's back-to-back ticks must never write statement
        heap.  Returns the number of sites folded."""
        t0 = time.perf_counter()
        fail.inject("memprofSampleError")
        if now is None:
            now = time.time()
        if stats is None:
            stats = self._snapshot_sites()
        if traced_kb is None:
            if tracemalloc.is_tracing():
                cur, peak = tracemalloc.get_traced_memory()
                traced_kb = cur / 1024.0
                if traced_peak_kb is None:
                    traced_peak_kb = peak / 1024.0
            else:
                traced_kb = 0.0
        if traced_peak_kb is None:
            traced_peak_kb = traced_kb
        if hbm_bytes is None:
            hbm_bytes = _hbm_total_fast()
        rolemap = _live_frame_roles(frames=frames,
                                    skip_idents=skip_idents)
        n = 0
        for site_frames, size in stats:
            folded = fold_site(site_frames)
            if not folded:
                continue
            role = classify_site(site_frames, rolemap)
            self._fold(role, folded, size / 1024.0, now,
                       window_s=window_s, history=history,
                       max_sites=max_sites)
            n += 1
        delta_kb = 0.0
        if self._last_traced_kb is not None:
            delta_kb = traced_kb - self._last_traced_kb
        self._last_traced_kb = traced_kb
        if attribute and delta_kb > 0:
            self._attribute(delta_kb, traced_kb, hbm_bytes)
        wall = time.perf_counter() - t0
        with self._mu:
            self._stats["ticks"] += 1
            self._stats["self_s"] += wall
            self._stats["traced_kb"] = traced_kb
            if traced_peak_kb > self._stats["traced_peak_kb"]:
                self._stats["traced_peak_kb"] = traced_peak_kb
        self._note_cost(wall, period_s)
        return n

    @staticmethod
    def _snapshot_sites() -> List[tuple]:
        """Live top-N allocation sites as ``[(frames root->leaf,
        size_bytes), ...]`` — empty when tracemalloc is off (the
        sampler starts it; a bare profiler without tracing still ticks,
        it just has no sites to fold)."""
        if not tracemalloc.is_tracing():
            return []
        snap = tracemalloc.take_snapshot()
        try:
            snap = snap.filter_traces((
                tracemalloc.Filter(False, tracemalloc.__file__),))
        except Exception:
            pass
        out: List[tuple] = []
        for st in snap.statistics("traceback")[:TOP_SITES_PER_TICK]:
            frames = tuple((f.filename, f.lineno) for f in st.traceback)
            out.append((frames, st.size))
        return out

    @staticmethod
    def _statement_scopes() -> List[object]:
        """QueryObs of every statement currently EXECUTING (interrupt
        registry — the processlist feed)."""
        from ..utils import interrupt
        out: List[object] = []
        seen: set = set()
        for tid, sess in interrupt.executing_threads().items():
            qobs = getattr(sess, "last_query_stats", None)
            if qobs is not None and id(qobs) not in seen:
                seen.add(id(qobs))
                out.append(qobs)
        return out

    def _fold(self, role: str, folded: str, size_kb: float, now: float,
              window_s=None, history=None, max_sites=None) -> None:
        with self._mu:
            if window_s is not None:
                self.window_s = float(window_s)
            if history is not None:
                self.max_history = int(history)
            if max_sites is not None:
                self.max_sites = int(max_sites)
            if self.window_begin is None:
                self.window_begin = now
            elif self.window_s > 0 \
                    and now - self.window_begin >= self.window_s:
                self._rotate(now)
            key = (role, folded)
            agg = self._entries.get(key)
            if agg is None:
                if self.max_sites > 0:
                    # _evict_one reports progress (the conprof
                    # tombstone-floor discipline): once only tombstones
                    # remain, looping on an unchanged length would spin
                    # under the lock forever
                    while len(self._entries) >= self.max_sites:
                        if not self._evict_one():
                            break
                agg = self._entries[key] = _SiteAgg()
            agg.samples += 1
            agg.size_kb = size_kb
            if size_kb > agg.peak_kb:
                agg.peak_kb = size_kb
            agg.last_seen = now
            self._stats["sites"] += 1

    def _attribute(self, delta_kb: float, traced_kb: float,
                   hbm_bytes: float) -> None:
        """Split this tick's positive traced-heap growth evenly among
        the executing statements — each share is <= the total growth,
        so the sum of per-statement heap attribution can never exceed
        the process's measured allocation (the <=-growth invariant,
        tested).  The traced high water and the HBM census total ride
        along as high-water marks."""
        try:
            scopes = self._statement_scopes()
            if not scopes:
                return
            share = delta_kb / len(scopes)
            for qobs in scopes:
                qobs.add_counter("heap_kb", share)
                qobs.hwm_counter("heap_peak_kb", traced_kb)
                if hbm_bytes > 0:
                    qobs.hwm_counter("hbm_bytes", hbm_bytes)
            with self._mu:
                self._stats["attributed"] += len(scopes)
        except Exception:
            # a statement finishing mid-attribution must never kill the
            # sampler tick
            pass

    def _rotate(self, now: float) -> None:
        # caller holds the lock
        if self._entries:
            self.history.append((self.window_begin, self._entries))
            while len(self.history) > max(self.max_history, 0):
                self.history.popleft()
        self._entries = {}
        self.window_begin = now

    def _evict_one(self) -> bool:
        # caller holds the lock: least-recently-seen site folds into its
        # role's tombstone (stmtsummary eviction discipline).  Returns
        # False when no evictable entry remains OR the eviction CREATED
        # the tombstone (no slot freed) — the caller must stop, not spin.
        victims = [k for k in self._entries if k[1] != EVICTED_SITE]
        if not victims:
            return False
        vkey = min(victims, key=lambda k: self._entries[k].last_seen)
        victim = self._entries.pop(vkey)
        tkey = (vkey[0], EVICTED_SITE)
        tomb = self._entries.get(tkey)
        created = tomb is None
        if created:
            tomb = self._entries[tkey] = _SiteAgg()
        tomb.merge(victim)
        self._stats["evicted"] += 1
        return not created

    def note_error(self) -> None:
        """Sampler-tick failure accounting (memprofSampleError and any
        torn snapshot): the error is COUNTED, the thread lives on."""
        with self._mu:
            self._stats["errors"] += 1

    def _note_cost(self, tick_wall_s: float, period_s: float) -> None:
        """conprof's adaptive overhead control verbatim: EWMA the
        per-tick self cost; past the budget share of one core the
        backoff divisor doubles, stepping back down only with
        hysteresis."""
        with self._mu:
            self._cost_ewma = tick_wall_s if self._cost_ewma == 0.0 \
                else 0.8 * self._cost_ewma + 0.2 * tick_wall_s
            cost_frac = self._cost_ewma / max(period_s, 1e-9)
            if cost_frac > OVERHEAD_BUDGET_FRAC \
                    and self.backoff < BACKOFF_MAX:
                self.backoff *= 2
            elif self.backoff > 1 \
                    and cost_frac * 2 < 0.5 * OVERHEAD_BUDGET_FRAC:
                self.backoff //= 2

    # ---- reads -----------------------------------------------------------
    def _maybe_rotate_stale(self, now: Optional[float]) -> None:
        # caller holds the lock (read-side rotation: a long-expired
        # window must not present as current)
        if now is None:
            now = time.time()
        if self.window_begin is not None and self.window_s > 0 \
                and now - self.window_begin >= self.window_s:
            self._rotate(now)

    def collapsed(self, window_s: Optional[float] = None,
                  now: Optional[float] = None) -> str:
        """The /debug/heap payload: collapsed-site text, one
        ``role;file:line;... kb`` line per distinct (role, site), merged
        across every retained window whose begin falls inside the last
        ``window_s`` seconds (None or 0 = everything retained).  Counts
        are live KB (max across windows — a persistent allocation must
        not double across rotations); conprof.parse_collapsed ingests
        it, as does flamegraph.pl."""
        if now is None:
            now = time.time()
        horizon = now - window_s if window_s else None
        merged: Dict[str, int] = {}
        with self._mu:
            self._maybe_rotate_stale(now)
            windows = list(self.history)
            if self._entries:
                windows.append((self.window_begin, self._entries))
            for begin, entries in windows:
                if horizon is not None and begin < horizon:
                    continue
                for (role, folded), agg in entries.items():
                    line = f"{role};{folded}"
                    kb = int(round(agg.peak_kb))
                    if kb > merged.get(line, -1):
                        merged[line] = kb
        return "\n".join(f"{site} {kb}"
                         for site, kb in sorted(merged.items()))

    def stats_snapshot(self) -> Dict[str, float]:
        with self._mu:
            out = dict(self._stats)
            out["backoff"] = self.backoff
            out["site_entries"] = len(self._entries)
            out["windows"] = len(self.history) + (
                1 if self._entries else 0)
            return out

    def reset(self) -> None:
        """Tests only."""
        with self._mu:
            self._entries = {}
            self.history.clear()
            self.window_begin = None
            self.backoff = 1
            self._cost_ewma = 0.0
            self._last_traced_kb = None
            self._stats = {"ticks": 0, "sites": 0, "attributed": 0,
                           "self_s": 0.0, "evicted": 0, "errors": 0,
                           "traced_kb": 0.0, "traced_peak_kb": 0.0}


#: the process-global profiler every surface reads
PROF = HeapProfiler()


def collapsed(window_s: Optional[float] = None) -> str:
    return PROF.collapsed(window_s=window_s)


def stats_snapshot() -> Dict[str, float]:
    return PROF.stats_snapshot()


def reset() -> None:
    """Tests only."""
    PROF.reset()


def measure_overhead(n: int = 20,
                     rate_hz: int = DEFAULT_RATE_HZ) -> Dict[str, float]:
    """The heap profiler's steady-state cost, THE definition both
    benches publish as ``memprof_overhead_frac`` when no live sampler
    ran: one tick's wall (averaged over ``n`` live snapshots of THIS
    process) times the ticks-per-second at ``rate_hz``.  Probes a
    PRIVATE HeapProfiler so the measurement never pollutes the live
    store; starts tracemalloc only if it was off, and stops it again."""
    prof = HeapProfiler()
    period = 1.0 / max(rate_hz, 1)
    started = False
    if not tracemalloc.is_tracing():
        tracemalloc.start(MAX_SITE_DEPTH)
        started = True
    try:
        # attribute=False: back-to-back probe ticks must not fabricate
        # statement heap growth
        prof.sample_once(period, attribute=False)  # warm lazy imports
        t0 = time.perf_counter()
        for _ in range(n):
            prof.sample_once(period, attribute=False)
        per_tick_s = (time.perf_counter() - t0) / n
    finally:
        if started:
            tracemalloc.stop()
    return {"tick_wall_s": round(per_tick_s, 6), "rate_hz": rate_hz,
            "memprof_overhead_frac": round(per_tick_s * rate_hz, 6)}


def live_overhead_frac(stats_before: Dict[str, float],
                       stats_after: Dict[str, float],
                       wall_s: float) -> float:
    """Sampler self-cost over a measured live window: the delta of the
    profiler's own accumulated tick wall divided by the elapsed wall —
    what bench_serve.py hard-gates against the 3% budget (alongside the
    conprof gate)."""
    d = float(stats_after.get("self_s", 0.0)) \
        - float(stats_before.get("self_s", 0.0))
    return round(d / max(wall_s, 1e-9), 6)


# ---- the device HBM census ------------------------------------------------

#: census category -> walker yielding candidate owner objects (arrays,
#: or containers searched recursively for device arrays).  Owners
#: register here (columnar/store.py, ops/exprjit.py, ops/spill.py,
#: ops/progcache.py) so the census needs no per-cache knowledge.
_CENSUS_WALKERS: Dict[str, Callable[[], Iterable[object]]] = {}


def register_census_walker(category: str,
                           fn: Callable[[], Iterable[object]]) -> None:
    _CENSUS_WALKERS[category] = fn


def _torch_if_loaded():
    """torch ONLY if something already imported it — the census must
    never be the thing that pays torch's import (a pure-KV process has no
    device buffers to count anyway)."""
    import sys
    return sys.modules.get("torch")


def _iter_device_arrays(obj, torch_mod, depth: int = 0):
    """Tensors nested anywhere inside ``obj`` (tuples/lists/dicts of memo
    values — the replica cache stores (values, codes, n) bundles)."""
    if depth > 4 or obj is None:
        return
    if isinstance(obj, torch_mod.Tensor):
        yield obj
        return
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_device_arrays(v, torch_mod, depth + 1)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _iter_device_arrays(v, torch_mod, depth + 1)


def _cuda_live(torch_mod):
    """(bytes, buffers) the CUDA caching allocator holds live, or None
    before CUDA was initialized (a CPU-device process)."""
    try:
        if not torch_mod.cuda.is_initialized():
            return None
        stats = torch_mod.cuda.memory_stats()
        return (int(torch_mod.cuda.memory_allocated()),
                int(stats.get("active.all.current", 0)))
    except Exception:
        return None


def hbm_census() -> dict:
    """Snapshot of the live device buffers, attributed to their birth
    site: ``{"total_bytes", "buffers", "by_category": {cat: {"bytes",
    "buffers"}}, "unattributed_bytes", "unattributed_buffers"}``.  Owners
    register walkers that yield their tensors; the total comes from the
    CUDA allocator (``torch.cuda.memory_allocated`` / ``memory_stats``),
    so whatever no owner claims lands in the *unattributed* bucket — the
    leak bucket.  On a CPU device the total is what the owners claim."""
    torch_mod = _torch_if_loaded()
    by_cat = {cat: {"bytes": 0, "buffers": 0} for cat in _CENSUS_WALKERS}
    out = {"total_bytes": 0, "buffers": 0, "by_category": by_cat,
           "unattributed_bytes": 0, "unattributed_buffers": 0}
    if torch_mod is None:
        return out
    seen = set()
    claimed_b = claimed_n = 0
    for cat, walker in _CENSUS_WALKERS.items():
        try:
            for obj in walker():
                for arr in _iter_device_arrays(obj, torch_mod):
                    key = (str(arr.device), arr.data_ptr())
                    if key in seen:
                        continue
                    seen.add(key)
                    nbytes = int(arr.nbytes)
                    by_cat[cat]["bytes"] += nbytes
                    by_cat[cat]["buffers"] += 1
                    claimed_b += nbytes
                    claimed_n += 1
        except Exception:
            continue
    live = _cuda_live(torch_mod)
    if live is None:
        out["total_bytes"], out["buffers"] = claimed_b, claimed_n
        return out
    total_b, total_n = live
    out["total_bytes"] = max(total_b, claimed_b)
    out["buffers"] = max(total_n, claimed_n)
    out["unattributed_bytes"] = max(total_b - claimed_b, 0)
    out["unattributed_buffers"] = max(total_n - claimed_n, 0)
    return out


def _hbm_total_fast() -> float:
    """Total live device bytes for per-tick statement attribution (the
    allocator's number; 0 when CUDA never initialized)."""
    torch_mod = _torch_if_loaded()
    if torch_mod is None:
        return 0.0
    live = _cuda_live(torch_mod)
    return float(live[0]) if live is not None else 0.0


def hbm_limit_bytes() -> float:
    """The card's memory capacity (0 without an initialized CUDA device) —
    the hbm-pressure rule's denominator."""
    torch_mod = _torch_if_loaded()
    if torch_mod is None or _cuda_live(torch_mod) is None:
        return 0.0
    try:
        return float(torch_mod.cuda.get_device_properties(
            torch_mod.cuda.current_device()).total_memory)
    except Exception:
        return 0.0


def measured_row_bytes(table_id: int, default: int,
                       storage=None) -> int:
    """Measured per-row working-set width of a table, census-derived:
    the replica's device-memoized column bytes (falling back to its
    host column bytes before any device upload) divided by row count.
    ``default`` (the old nominal constant) applies when no replica
    exists — so the spill gates price rows from measured truth whenever
    there is any, and never regress when there is none.  ``storage``
    scopes the lookup to ONE storage's replica store (the statement's
    own); without it every live store is consulted — fine in a server
    process, ambiguous when several storages share table ids (tests)."""
    torch_mod = _torch_if_loaded()
    try:
        from ..columnar import store as colstore
        if storage is not None:
            stores = [colstore.store_of(storage)]
        else:
            stores = colstore.live_stores()
        for s in stores:
            tbl = s.get(table_id)
            if tbl is None or not tbl.n_rows:
                continue
            dev = 0
            if torch_mod is not None:
                for arr in _iter_device_arrays(list(tbl.cache.values()),
                                               torch_mod):
                    dev += int(arr.nbytes)
            if dev <= 0:
                for v, m in tbl.columns.values():
                    dev += int(v.nbytes) + int(m.nbytes)
                if tbl.handles is not None:
                    dev += int(tbl.handles.nbytes)
            if dev > 0:
                return max(1, dev // tbl.n_rows)
    except Exception:
        pass
    return int(default)


# ---- reconciliation: tracked vs measured ----------------------------------

def _rss_bytes() -> float:
    """Resident set from /proc/self/statm (0 where proc is absent)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        return 0.0


def tracked_bytes() -> float:
    """The ledger: live statement MemTracker bytes summed over the
    interrupt session registry (the processlist number)."""
    from ..utils import interrupt
    total = 0
    for _cid, sess in interrupt.sessions():
        mt = getattr(sess, "_stmt_mem", None)
        if mt is not None and getattr(sess, "stmt_running", False):
            total += mt.consumed
    return float(total)


def memory_state() -> Dict[str, float]:
    """The ``memory_state`` time-series source: tracked-ledger bytes vs
    measured heap (tracemalloc) / RSS vs the HBM census, plus the
    sampler's self-accounting — everything the heap-growth /
    hbm-pressure / mem-untracked inspection rules judge."""
    if tracemalloc.is_tracing():
        cur, peak = tracemalloc.get_traced_memory()
    else:
        cur, peak = 0, 0
    tracked = tracked_bytes()
    census = hbm_census()
    s = PROF.stats_snapshot()
    return {
        "tinysql_mem_tracked_bytes": tracked,
        "tinysql_mem_traced_bytes": float(cur),
        "tinysql_mem_traced_peak_bytes": float(peak),
        "tinysql_mem_rss_bytes": _rss_bytes(),
        "tinysql_mem_untracked_bytes": max(0.0, float(cur) - tracked),
        "tinysql_hbm_live_bytes": float(census["total_bytes"]),
        "tinysql_hbm_buffers": float(census["buffers"]),
        "tinysql_hbm_unattributed_bytes":
            float(census["unattributed_bytes"]),
        "tinysql_hbm_limit_bytes": hbm_limit_bytes(),
        "tinysql_memprof_ticks_total": s.get("ticks", 0),
        "tinysql_memprof_sites_total": s.get("sites", 0),
        "tinysql_memprof_attributed_total": s.get("attributed", 0),
        "tinysql_memprof_self_seconds_total": s.get("self_s", 0.0),
        "tinysql_memprof_evicted_total": s.get("evicted", 0),
        "tinysql_memprof_errors_total": s.get("errors", 0),
        "tinysql_memprof_backoff": s.get("backoff", 1),
    }


#: information_schema.memory_usage column order — MUST match
#: memory_usage_rows (catalog/memtables.py builds FieldTypes from this)
MEMORY_USAGE_COLUMNS = [
    ("source", "str"), ("item", "str"), ("bytes", "int"),
    ("detail", "str"),
]


def memory_usage_rows() -> List[list]:
    """The ``memory_usage`` mem-table payload: one row per ledger /
    measurement / census bucket, reconciliation last — so ``SELECT *
    FROM information_schema.memory_usage`` answers "where is the
    memory, and does the ledger agree" in one scan."""
    if tracemalloc.is_tracing():
        cur, peak = tracemalloc.get_traced_memory()
    else:
        cur, peak = 0, 0
    tracked = int(tracked_bytes())
    census = hbm_census()
    rows: List[list] = [
        ["tracked", "statements", tracked,
         "sum of live statement MemTracker bytes (the ledger; "
         "processlist mem_bytes)"],
        ["measured", "traced_heap", int(cur),
         "tracemalloc current traced bytes (python allocations only — "
         "XLA's C++ arena is invisible here)"],
        ["measured", "traced_peak", int(peak),
         "tracemalloc peak traced bytes since tracing started"],
        ["measured", "rss", int(_rss_bytes()),
         "resident set size (/proc/self/statm)"],
    ]
    for cat in sorted(census["by_category"]):
        c = census["by_category"][cat]
        rows.append(["hbm", cat, int(c["bytes"]),
                     f"{c['buffers']} live device buffer(s)"])
    rows.append(["hbm", "unattributed",
                 int(census["unattributed_bytes"]),
                 f"{census['unattributed_buffers']} live device "
                 "buffer(s) no registered owner claims — the leak "
                 "bucket"])
    rows.append(["recon", "untracked", max(0, int(cur) - tracked),
                 "traced heap beyond the MemTracker ledger; the "
                 f"mem-untracked rule fires past a {UNTRACKED_BAND_BYTES >> 20}"
                 " MiB windowed band"])
    return rows


# ---- per-query probe (bench detail) ---------------------------------------

class QueryMemProbe:
    """Bracket one query with measured memory detail (bench.py's
    per-query ``peak_heap_kb`` / ``peak_hbm_bytes`` /
    ``mem_untracked_frac``).  Uses tracemalloc's resettable peak where
    available, so the probe measures THIS query's heap high water, not
    the process's history.  All writes stay inside this module
    (qlint OB407)."""

    def __init__(self):
        self._started = False
        self._base_kb = 0.0

    def start(self) -> None:
        if not tracemalloc.is_tracing():
            tracemalloc.start(MAX_SITE_DEPTH)
            self._started = True
        try:
            tracemalloc.reset_peak()
        except AttributeError:
            pass
        self._base_kb = tracemalloc.get_traced_memory()[0] / 1024.0

    def finish(self, tracked_peak_bytes: int = 0) -> Dict[str, float]:
        cur, peak = tracemalloc.get_traced_memory()
        peak_kb = max(0.0, peak / 1024.0 - self._base_kb)
        alloc_bytes = peak_kb * 1024.0
        untracked = max(0.0, alloc_bytes - float(tracked_peak_bytes))
        out = {
            "peak_heap_kb": round(peak_kb, 1),
            "peak_hbm_bytes": _hbm_total_fast(),
            "mem_untracked_frac":
                round(untracked / alloc_bytes, 4) if alloc_bytes > 0
                else 0.0,
        }
        if self._started:
            tracemalloc.stop()
            self._started = False
        return out


# ---- the background sampler (server lifecycle) ---------------------------

class MemprofSampler:
    """Background thread pacing ``PROF.sample_once`` by the GLOBAL
    ``tidb_memprof_rate`` sysvar (Hz; re-read every tick like the
    conprof/tsring samplers — 0 pauses sampling at the cost of ONE
    sysvar read per idle slice).  Starts tracemalloc on first demand
    and stops it again when the rate drops to 0 (tracing taxes every
    allocation in the process, so off must mean OFF).  The effective
    period is ``backoff / rate``: the profiler's own overhead control
    stretches it when a snapshot costs too much."""

    def __init__(self, storage, profiler: Optional[HeapProfiler] = None):
        self.storage = storage
        self.profiler = profiler if profiler is not None else PROF
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_tracing = False
        #: start/close lifecycle lock (the tsring Sampler discipline)
        self._mu = threading.Lock()

    def _int_sysvar(self, name: str, default: int) -> int:
        from ..server.pool import read_global_int
        return read_global_int(self.storage, name, default)

    def rate_hz(self) -> int:
        return self._int_sysvar("tidb_memprof_rate", DEFAULT_RATE_HZ)

    def start(self) -> None:
        with self._mu:
            if self._thread is not None:
                return
            self._stop.clear()  # restartable after close()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="memprof-sampler")
            self._thread.start()

    def close(self) -> None:
        with self._mu:
            self._stop.set()
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._mu:
            if self._thread is t:
                self._thread = None
        self._stop_tracing()

    def _stop_tracing(self) -> None:
        with self._mu:
            started, self._started_tracing = self._started_tracing, False
        if started and tracemalloc.is_tracing():
            tracemalloc.stop()
            # baseline is gone with the traces: the next tick must not
            # read a restart as a huge negative (or positive) delta
            self.profiler._last_traced_kb = None

    def _loop(self) -> None:
        elapsed = 0.0
        while True:
            rate = self.rate_hz()
            if rate <= 0:
                # disabled: ONE sysvar read per slice, nothing else —
                # and no tracemalloc tax on the allocator
                self._stop_tracing()
                if self._stop.wait(0.25):
                    return
                elapsed = 0.0
                continue
            if not tracemalloc.is_tracing():
                tracemalloc.start(MAX_SITE_DEPTH)
                with self._mu:
                    self._started_tracing = True
            rate = min(rate, MAX_RATE_HZ)
            period = self.profiler.backoff / rate
            slice_s = min(period, 0.25)
            if self._stop.wait(slice_s):
                return
            elapsed += slice_s
            if elapsed + 1e-9 < period:
                continue
            elapsed = 0.0
            try:
                self.profiler.sample_once(
                    period,
                    window_s=self._int_sysvar("tidb_memprof_window",
                                              DEFAULT_WINDOW_S),
                    history=self._int_sysvar("tidb_memprof_history",
                                             DEFAULT_HISTORY),
                    max_sites=self._int_sysvar("tidb_memprof_max_sites",
                                               DEFAULT_MAX_SITES),
                    skip_idents=(threading.get_ident(),))
            except Exception:
                # a torn snapshot (or an armed memprofSampleError) must
                # never kill the sampler thread — counted, logged, the
                # next tick runs clean
                self.profiler.note_error()
                import logging
                logging.getLogger("tinysql_tpu.memprof").warning(
                    "memprof sample failed", exc_info=True)
