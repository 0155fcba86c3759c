"""Continuous host-CPU profiler: the host half of the truth story
(reference lineage: TiDB Dashboard's continuous profiling + TopSQL's
statement CPU attribution — an always-on, low-overhead profiler treated
as a first-class subsystem, not a tool someone attaches after the
incident).

The device profiler made *device* time measured truth; every host-side number was
still a wall clock around who-knows-what.  This module owns the
host-side answer: a background sampler thread walks
``sys._current_frames()`` at ``tidb_conprof_rate`` Hz (0 = off, re-read
live like the tsring sampler), classifies each thread by its serving
ROLE (the thread-name vocabulary below — pool workers, conn threads,
the accept loop, devpipe producers, the tsring/prewarm/distsql workers),
folds each stack into bounded per-window aggregates with
retention/rotation semantics matching obs/stmtsummary.py (window
rotation into bounded history; over-cap stacks evict into a single
``(evicted)`` tombstone that keeps counting), and attributes samples
landing on a thread that is currently EXECUTING a statement (resolved
through the interrupt session registry) to that statement's QueryObs —
so ``statements_summary`` gains ``sum_cpu_ms`` / ``cpu_samples``
columns and a latency regression can be split into "the CPU went here"
straight from SQL.

Serving surfaces (all computed from this module's state):

- ``information_schema.continuous_profiling`` (catalog/memtables.py):
  one row per (window, role, folded stack) with sample counts and
  estimated cpu_ms;
- ``/debug/conprof?window=N`` (server/http_status.py): collapsed-stack
  text (``role;frame;frame... count`` per line) that flamegraph.pl and
  speedscope ingest directly;
- ``tinysql_conprof_*`` metrics in the central registry and the
  time-series ring (the ``conprof`` source in obs/tsring.py);
- two inspection rules (obs/inspect.py): ``cpu-saturation`` (one role
  window-dominant in busy samples while the admission queue is
  non-empty) and ``profiler-overhead`` (the sampler's own cost ran past
  its budget — the rule reports it AND the sampler backs off its rate
  via the ``backoff`` divisor below).

Semantics and honesty notes:

- "cpu_ms" is SAMPLE-ESTIMATED on-thread milliseconds (samples x the
  effective sampling period), not an OS scheduler reading — the same
  estimate flamegraphs are built from.  Samples whose leaf frame is a
  known blocking primitive (``wait``/``select``/``accept``/...) are
  counted separately as IDLE: they appear in the folded stacks (a
  thread parked in a lock is diagnostic gold) but stay out of busy-CPU
  shares and the cpu-saturation rule.  Caveat: a thread blocked in a C
  BUILTIN called directly (raw ``time.sleep``, a bare ``sock.recv``)
  has no Python wrapper frame, so its caller reads as the leaf and the
  sample counts busy — the engine's own threads all park through
  ``threading``/wire wrappers that classify idle, and qlint FP501
  already bans raw ``time.sleep`` in retry paths.
- Statement attribution counts only samples on the statement's OWN
  executing thread (session.stmt_thread_ident), never its helper
  threads (devpipe producer, distsql workers) — so the invariant
  ``sum_cpu_ms <= exec wall`` holds per statement; each attribution
  increment is additionally capped by the statement's elapsed wall so
  period quantization cannot break it.
- The sampler's self-cost is measured every tick; when its EWMA runs
  past ``OVERHEAD_BUDGET_FRAC`` of one core the ``backoff`` divisor
  doubles (halving the effective rate) until the cost fits — the
  profiler may get coarser under load, never expensive.

WRITE DISCIPLINE (qlint OB406): the fold/attribution state here — and
the statement cpu counters (``cpu_s`` / ``cpu_samples``) — are written
ONLY from this module.  Any other writer would publish un-sampled wall
time as CPU truth or corrupt the window accounting.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

DEFAULT_RATE_HZ = 10
DEFAULT_WINDOW_S = 60
DEFAULT_HISTORY = 15
DEFAULT_MAX_STACKS = 512

#: ceiling on the applied rate regardless of the sysvar: beyond this a
#: pure-Python frame walk is all overhead, no additional signal
MAX_RATE_HZ = 250

#: frames kept per folded stack (leaf-most win; the role prefix keeps
#: the root context)
MAX_STACK_DEPTH = 48

#: the sampler's self-cost budget as a fraction of one core; past it
#: the backoff divisor doubles (profiler-overhead rule evidence)
OVERHEAD_BUDGET_FRAC = 0.03
BACKOFF_MAX = 16

EVICTED_STACK = "(evicted)"

# ---- the thread-role vocabulary -------------------------------------------
# THE shared naming contract (the thread-name vocabulary): every thread
# the engine spawns carries one of these stable ``name=`` prefixes, so
# conprof role classification, race-stress contention reports, and
# py-spy output all read the same words.  tests/test_conprof.py asserts
# live threads classify off this table; the thread-root coverage test
# (tests/test_lint.py) pins the spawn sites themselves.

ROLE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("stmt-pool-", "pool-worker"),      # server/pool.py workers
    ("conn-", "conn"),                  # server/server.py per-connection
    ("mysql-accept", "accept"),         # server/server.py accept loop
    ("aio-loop-", "aio"),               # server/aio.py event loops
    ("devpipe-stage", "devpipe"),       # executor/devpipe.py producer
    ("metrics-sampler", "tsring"),      # obs/tsring.py Sampler
    ("conprof-sampler", "conprof"),     # this module's own sampler
    ("memprof-sampler", "memprof"),     # obs/memprof.py heap sampler
    ("flight-writer", "flight"),        # obs/flight.py segment writer
    ("auto-prewarm", "prewarm"),        # session/prewarm.py worker
    ("distsql-cop", "distsql"),         # distsql/client.py task pool
    ("status-http", "http"),            # server/http_status.py
    ("domain-reload-", "domain"),       # domain/domain.py ticker
    ("ddl-owner-", "ddl"),              # domain/domain.py owner loop
    ("range-", "kv"),                   # kv/range_task.py pools
    ("kv-", "kv"),                      # kv commit / lookup / schema pools
    ("MainThread", "main"),
)

#: the closed role set (per-role busy-sample counters are registered
#: metrics, so the catalogue must be finite and known to obs/metrics.py)
ROLES: Tuple[str, ...] = tuple(sorted(
    {role for _, role in ROLE_PREFIXES} | {"other"}))


def classify(thread_name: str) -> str:
    """Thread name -> serving role (``other`` for anything outside the
    vocabulary, e.g. http handler threads or test harness threads)."""
    for prefix, role in ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            return role
    return "other"


def role_metric(role: str) -> str:
    """The registered per-role busy-sample counter name."""
    return f"tinysql_conprof_{role.replace('-', '_')}_busy_samples_total"


# ---- stack folding --------------------------------------------------------

#: leaf function names that mean "parked, not computing" — the sample
#: still folds (a thread stuck in a lock is diagnostic gold) but counts
#: as idle, outside busy-CPU shares and the cpu-saturation rule
_IDLE_LEAVES = frozenset((
    "wait", "wait_for_tstate_lock", "acquire", "select", "poll", "epoll",
    "accept", "recv", "recv_into", "recvfrom", "read", "readinto",
    "sleep", "get", "put", "join", "getaddrinfo", "settimeout",
    "_recv_bytes", "do_wait", "block_until_ready",
    # the wire layer's blocking-socket wrappers: a thread whose leaf is
    # one of these sits in sock.recv/sendall (C frames are invisible to
    # sys._current_frames, so the WRAPPER is the leaf we see)
    "_read_exact", "read_packet", "sendall", "_accept_loop",
))

#: stdlib files whose leaf frames are treated as parked even when the
#: function name is project-like
_IDLE_FILES = ("threading.py", "selectors.py", "socket.py", "queue.py",
               "ssl.py")


def fold_stack(frame, max_depth: int = MAX_STACK_DEPTH) -> Tuple[str, bool]:
    """(folded stack root->leaf joined with ';', is_idle).  Frame labels
    are ``module.function`` (file basename, extension stripped) — stable
    across runs, compact enough to keep per-window aggregates small."""
    parts: List[str] = []
    idle = False
    f = frame
    first = True
    while f is not None and len(parts) < max_depth:
        code = f.f_code
        fname = code.co_filename
        base = fname.rsplit("/", 1)[-1]
        if first:
            leaf_file = base
            idle = (code.co_name in _IDLE_LEAVES
                    or leaf_file in _IDLE_FILES)
            first = False
        parts.append(f"{base[:-3] if base.endswith('.py') else base}"
                     f".{code.co_name}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts), idle


def parse_collapsed(text: str) -> Dict[str, int]:
    """Inverse of :func:`Profiler.collapsed` — ``{stack: count}``.  The
    format round-trip test and any offline tooling share this parser
    (it is the exact contract flamegraph.pl consumes: everything up to
    the last space is the stack, the tail is the count)."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        out[stack] = out.get(stack, 0) + int(count)
    return out


# ---- the windowed aggregate store -----------------------------------------

class _StackAgg:
    __slots__ = ("samples", "idle_samples", "cpu_s", "last_seen")

    def __init__(self):
        self.samples = 0
        self.idle_samples = 0
        self.cpu_s = 0.0
        self.last_seen = 0.0

    def merge(self, other: "_StackAgg") -> None:
        self.samples += other.samples
        self.idle_samples += other.idle_samples
        self.cpu_s += other.cpu_s
        self.last_seen = max(self.last_seen, other.last_seen)


#: information_schema.continuous_profiling column order — MUST match
#: Profiler.rows
COLUMNS = [
    ("window_begin", "str"), ("role", "str"), ("folded_stack", "str"),
    ("samples", "int"), ("idle_samples", "int"), ("cpu_ms", "real"),
]


class Profiler:
    """The fold/attribution store: current window + bounded rotated
    history, stmtsummary-style.  Written from the sampler thread; read
    from any session scanning ``continuous_profiling`` or hitting
    ``/debug/conprof`` — all paths take the lock."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 history: int = DEFAULT_HISTORY,
                 max_stacks: int = DEFAULT_MAX_STACKS):
        self.window_s = float(window_s)
        self.max_history = int(history)
        self.max_stacks = int(max_stacks)
        self._mu = threading.Lock()
        #: (role, folded stack) -> aggregate, current window
        self._entries: Dict[Tuple[str, str], _StackAgg] = {}
        #: anchored by the FIRST fold, like stmtsummary's window_begin
        self.window_begin: Optional[float] = None
        #: rotated windows, oldest first: (window_begin, {key: agg})
        self.history: deque = deque()
        #: adaptive rate divisor (profiler-overhead backoff): the
        #: effective sampling period is backoff / tidb_conprof_rate
        self.backoff = 1
        self._cost_ewma = 0.0
        self._stats = {"ticks": 0, "samples": 0, "idle_samples": 0,
                       "attributed": 0, "self_s": 0.0, "evicted": 0}
        #: process-cumulative busy samples per role (ring source feed)
        self._role_busy: Dict[str, int] = {r: 0 for r in ROLES}

    # ---- the designated write path (sampler thread ONLY) ----------------
    def sample_once(self, period_s: float, now: Optional[float] = None,
                    frames: Optional[Dict[int, object]] = None,
                    window_s: Optional[float] = None,
                    history: Optional[int] = None,
                    max_stacks: Optional[int] = None,
                    skip_idents: Tuple[int, ...] = (),
                    attribute: bool = True) -> int:
        """One sampling tick: walk every live thread's frame, fold, and
        attribute.  ``now``/``frames`` are injectable for deterministic
        tests; the ``window_s``/``history``/``max_stacks`` overrides
        carry the live sysvars.  ``attribute=False`` folds only — the
        overhead probe must never write statement CPU (its ticks are
        back-to-back, not period-spaced, so attributing them would
        fabricate un-sampled CPU time).  Returns the number of threads
        sampled."""
        t0 = time.perf_counter()
        if now is None:
            now = time.time()
        if frames is None:
            frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        att = self._statement_threads() if attribute else {}
        n = 0
        for tid, frame in frames.items():
            if tid in skip_idents:
                continue
            folded, idle = fold_stack(frame)
            if not folded:
                continue
            role = classify(names.get(tid, ""))
            self._fold(role, folded, idle, period_s, now,
                       window_s=window_s, history=history,
                       max_stacks=max_stacks)
            n += 1
            # attribution counts every on-thread sample (blocked time
            # is still the statement's wall); the busy/idle split only
            # matters for role shares
            qobs = att.get(tid)
            if qobs is not None:
                self._attribute(qobs, period_s, now)
        wall = time.perf_counter() - t0
        with self._mu:
            self._stats["ticks"] += 1
            self._stats["self_s"] += wall
        self._note_cost(wall, period_s)
        return n

    @staticmethod
    def _statement_threads() -> Dict[int, object]:
        """ident -> QueryObs of the statement currently EXECUTING on
        that thread, resolved through the interrupt session registry
        (``interrupt.executing_threads`` — the processlist feed).
        Helper threads a statement spawns are deliberately absent —
        per-statement cpu must stay <= wall."""
        from ..utils import interrupt
        out: Dict[int, object] = {}
        for tid, sess in interrupt.executing_threads().items():
            qobs = getattr(sess, "last_query_stats", None)
            if qobs is not None:
                out[tid] = qobs
        return out

    def _fold(self, role: str, folded: str, idle: bool, period_s: float,
              now: float, window_s=None, history=None,
              max_stacks=None) -> None:
        with self._mu:
            if window_s is not None:
                self.window_s = float(window_s)
            if history is not None:
                self.max_history = int(history)
            if max_stacks is not None:
                self.max_stacks = int(max_stacks)
            if self.window_begin is None:
                self.window_begin = now
            elif self.window_s > 0 \
                    and now - self.window_begin >= self.window_s:
                self._rotate(now)
            key = (role, folded)
            agg = self._entries.get(key)
            if agg is None:
                if self.max_stacks > 0:
                    # _evict_one reports progress: once only tombstones
                    # remain there is nothing left to fold away, and
                    # looping on an unchanged length would spin forever
                    # under the lock (wedging the sampler AND every
                    # reader) — e.g. max_stacks=1 with one tombstone
                    while len(self._entries) >= self.max_stacks:
                        if not self._evict_one():
                            break
                agg = self._entries[key] = _StackAgg()
            agg.samples += 1
            agg.last_seen = now
            self._stats["samples"] += 1
            if idle:
                agg.idle_samples += 1
                self._stats["idle_samples"] += 1
            else:
                agg.cpu_s += period_s
                self._role_busy[role] = self._role_busy.get(role, 0) + 1

    def _attribute(self, qobs, period_s: float, now: float) -> None:
        """Fold one sample into the running statement's scope.  The
        increment is capped by the statement's elapsed wall so the
        quantized estimate can never exceed it (the cpu_ms <= exec wall
        invariant, tested)."""
        try:
            elapsed = max(0.0, now - qobs.started_at)
            cur = float(qobs.device_totals().get("cpu_s", 0.0))
            inc = min(period_s, elapsed - cur)
            if inc > 0:
                qobs.add_counter("cpu_s", inc)
            qobs.add_counter("cpu_samples", 1)
            with self._mu:
                self._stats["attributed"] += 1
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
        # caller holds the lock: least-recently-seen stack folds into
        # its role's tombstone so window sample totals stay accountable
        # (the stmtsummary eviction discipline).  Returns False when no
        # evictable (non-tombstone) entry remains — the caller must
        # stop, not spin.  An eviction that CREATES the tombstone frees
        # no slot either, so that also reports no progress.
        victims = [k for k in self._entries if k[1] != EVICTED_STACK]
        if not victims:
            return False
        vkey = min(victims, key=lambda k: self._entries[k].last_seen)
        victim = self._entries.pop(vkey)
        tkey = (vkey[0], EVICTED_STACK)
        tomb = self._entries.get(tkey)
        created = tomb is None
        if created:
            tomb = self._entries[tkey] = _StackAgg()
        tomb.merge(victim)
        self._stats["evicted"] += 1
        return not created

    def _note_cost(self, tick_wall_s: float, period_s: float) -> None:
        """Adaptive overhead control: EWMA the per-tick self cost; when
        it runs past the budget share of one core the backoff divisor
        doubles (the sampler thread halves its rate next tick).  Steps
        back down only when a halved backoff would still sit well under
        budget (hysteresis — no flapping at the boundary)."""
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
        # caller holds the lock (stmtsummary read-side rotation: a
        # long-expired window must not present as current)
        if now is None:
            now = time.time()
        if self.window_begin is not None and self.window_s > 0 \
                and now - self.window_begin >= self.window_s:
            self._rotate(now)

    def rows(self, now: Optional[float] = None) -> List[list]:
        """``continuous_profiling`` payload: retained windows oldest
        first, current window last, stacks ordered by samples desc
        within each window."""
        from .stmtsummary import _ts
        with self._mu:
            self._maybe_rotate_stale(now)
            windows = list(self.history)
            if self._entries:
                windows.append((self.window_begin, self._entries))
            out: List[list] = []
            for begin, entries in windows:
                stamp = _ts(begin)
                for (role, folded), agg in sorted(
                        entries.items(),
                        key=lambda kv: -kv[1].samples):
                    out.append([stamp, role, folded, agg.samples,
                                agg.idle_samples,
                                round(agg.cpu_s * 1e3, 3)])
            return out

    def collapsed(self, window_s: Optional[float] = None,
                  now: Optional[float] = None) -> str:
        """The /debug/conprof payload: flamegraph.pl / speedscope
        collapsed-stack text, one ``role;frame;... count`` line per
        distinct (role, stack), merged across every retained window
        whose begin falls inside the last ``window_s`` seconds (None or
        0 = everything retained)."""
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
                    merged[line] = merged.get(line, 0) + agg.samples
        return "\n".join(f"{stack} {count}"
                         for stack, count in sorted(merged.items()))

    def stats_snapshot(self) -> Dict[str, float]:
        with self._mu:
            out = dict(self._stats)
            out["backoff"] = self.backoff
            out["stacks"] = len(self._entries)
            out["windows"] = len(self.history) + (
                1 if self._entries else 0)
            out["role_busy"] = dict(self._role_busy)
            return out

    def reset(self) -> None:
        """Tests only."""
        with self._mu:
            self._entries = {}
            self.history.clear()
            self.window_begin = None
            self.backoff = 1
            self._cost_ewma = 0.0
            self._stats = {"ticks": 0, "samples": 0, "idle_samples": 0,
                           "attributed": 0, "self_s": 0.0, "evicted": 0}
            self._role_busy = {r: 0 for r in ROLES}


#: the process-global profiler every surface reads
PROF = Profiler()


def rows() -> List[list]:
    return PROF.rows()


def collapsed(window_s: Optional[float] = None) -> str:
    return PROF.collapsed(window_s=window_s)


def stats_snapshot() -> Dict[str, float]:
    return PROF.stats_snapshot()


def reset() -> None:
    """Tests only."""
    PROF.reset()


def measure_overhead(n: int = 50,
                     rate_hz: int = DEFAULT_RATE_HZ) -> Dict[str, float]:
    """The profiler's steady-state cost, THE definition both benches
    publish as ``conprof_overhead_frac`` when no live sampler ran: one
    tick's wall (averaged over ``n`` live frame walks against THIS
    process) times the ticks-per-second at ``rate_hz``.  Probes a
    PRIVATE Profiler so the measurement never pollutes the live store.
    """
    prof = Profiler()
    period = 1.0 / max(rate_hz, 1)
    # attribute=False: the probe's ticks are back-to-back, and a live
    # statement in this process must not collect fabricated CPU time
    prof.sample_once(period, attribute=False)  # warm lazy imports
    t0 = time.perf_counter()
    for _ in range(n):
        prof.sample_once(period, attribute=False)
    per_tick_s = (time.perf_counter() - t0) / n
    return {"tick_wall_s": round(per_tick_s, 6), "rate_hz": rate_hz,
            "conprof_overhead_frac": round(per_tick_s * rate_hz, 6)}


def live_overhead_frac(stats_before: Dict[str, float],
                       stats_after: Dict[str, float],
                       wall_s: float) -> float:
    """Sampler self-cost over a measured live window: the delta of the
    profiler's own accumulated tick wall divided by the elapsed wall —
    what bench_serve.py hard-gates against the 3% budget."""
    d = float(stats_after.get("self_s", 0.0)) \
        - float(stats_before.get("self_s", 0.0))
    return round(d / max(wall_s, 1e-9), 6)


# ---- the background sampler (server lifecycle) ---------------------------

class ConprofSampler:
    """Background thread pacing ``PROF.sample_once`` by the GLOBAL
    ``tidb_conprof_rate`` sysvar (Hz; re-read every tick like the
    tsring sampler — 0 pauses sampling without stopping the thread).
    The effective period is ``backoff / rate``: the profiler's own
    overhead control stretches it when a tick costs too much."""

    def __init__(self, storage, profiler: Optional[Profiler] = None):
        self.storage = storage
        self.profiler = profiler if profiler is not None else PROF
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: start/close lifecycle lock (the tsring Sampler discipline):
        #: two racing start() calls must not leak a second sampler
        self._mu = threading.Lock()

    def _int_sysvar(self, name: str, default: int) -> int:
        from ..server.pool import read_global_int
        return read_global_int(self.storage, name, default)

    def rate_hz(self) -> int:
        return self._int_sysvar("tidb_conprof_rate", DEFAULT_RATE_HZ)

    def start(self) -> None:
        with self._mu:
            if self._thread is not None:
                return
            self._stop.clear()  # restartable after close()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="conprof-sampler")
            self._thread.start()

    def close(self) -> None:
        # stop flag set atomically with the thread-slot read; the slot
        # clears only after the join (the tsring close() contract — an
        # interleaved start() must keep seeing the old thread)
        with self._mu:
            self._stop.set()
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._mu:
            if self._thread is t:
                self._thread = None

    def _loop(self) -> None:
        elapsed = 0.0
        while True:
            rate = self.rate_hz()
            if rate <= 0:
                # disabled: ONE sysvar read per slice, nothing else —
                # the query path never notices the profiler exists
                if self._stop.wait(0.25):
                    return
                elapsed = 0.0
                continue
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
                    window_s=self._int_sysvar("tidb_conprof_window",
                                              DEFAULT_WINDOW_S),
                    history=self._int_sysvar("tidb_conprof_history",
                                             DEFAULT_HISTORY),
                    max_stacks=self._int_sysvar("tidb_conprof_max_stacks",
                                                DEFAULT_MAX_STACKS),
                    skip_idents=(threading.get_ident(),))
            except Exception:
                # a torn frame walk must never kill the sampler thread
                import logging
                logging.getLogger("tinysql_tpu.conprof").warning(
                    "conprof sample failed", exc_info=True)
