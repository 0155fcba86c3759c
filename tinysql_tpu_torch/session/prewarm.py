"""Stats-driven auto-prewarm: the serving-side answer to the cold start.

The FIRST run of a query family pays what a warm run does not: in the
port, the one-time build of the CUDA kernel libraries (ops/_ext.py) and
the registration of the family's fused programs.  Literal
parameterization (ops/exprjit.ParamTable + shape-keyed program
registry) already makes one registered program serve an entire
normalized-SQL digest family; this module spends idle serving time
making sure those family programs, and their stacked variants, exist
BEFORE the next query needs them.

:class:`PrewarmWorker` is a background thread wired into the server
lifecycle (server/server.py).  Each cycle it:

1. reads ``statements_summary`` (obs/stmtsummary.py) and ranks digest
   families by ``exec_count x max observed exec wall`` — the max wall of
   a family is dominated by its cold run, so the product is an
   exec-count-weighted miss-cost proxy;
2. takes the top K (``tidb_auto_prewarm_top_k``), skips families inside
   their cooldown window (``tidb_auto_prewarm_cooldown`` seconds,
   applied after success AND failure) or whose last warm compiled
   NOTHING (already fully warm — re-executing their sample would be
   pure wasted query work; the skip lifts when the program registry is
   reset), and stops once the per-cycle wall budget
   (``tidb_auto_prewarm_budget_ms``) is spent;
3. warms each family inside ``progcache.prewarm_scope()``: AOT-compiles
   the plan-derived + feedback-observed shape buckets
   (kernels.prewarm_bucket: in the port, the one-time build of the CUDA
   kernel libraries, which take any shape) and executes the family's
   sample SQL once on an INTERNAL session — registering the fused
   structural programs in the shared registry — then registers the
   B-bucketed stacked variants of its batchable programs
   (kernels.prewarm_stacked).  Internal
   sessions skip the observability fan-out, so the worker's own runs
   never feed the ranking they came from.

Provenance: programs built under a prewarm scope are marked in
ops/progcache; a later query-path hit on one counts as a
``prewarm_hits`` stat (per-query detail, bench, /metrics) — the compile
the worker saved that query.

The worker reads the GLOBAL sysvar scope every cycle, so
``SET GLOBAL tidb_auto_prewarm = 0`` takes effect without a restart.
``tools/warm.py`` shares :func:`plan_buckets`; the CLI remains the
manual/offline form of the same warming.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from .. import fail

log = logging.getLogger("tinysql_tpu.prewarm")

#: worker counters for /metrics (tinysql_prewarm_*) and /debug/prewarm
PREWARM_STATS: Dict[str, int] = {
    "cycles": 0, "families_warmed": 0, "bucket_programs": 0,
    "stacked_programs": 0,
    "errors": 0, "skipped_cooldown": 0, "skipped_budget": 0,
    "skipped_satisfied": 0,
}
_STATS_MU = threading.Lock()


def _bump(key: str, n: int = 1) -> None:
    with _STATS_MU:
        PREWARM_STATS[key] = PREWARM_STATS.get(key, 0) + n


def stats_snapshot() -> Dict[str, int]:
    with _STATS_MU:
        return dict(PREWARM_STATS)


def reset_stats() -> None:
    """Tests only."""
    with _STATS_MU:
        for k in PREWARM_STATS:
            PREWARM_STATS[k] = 0


def plan_buckets(session, sql: str) -> set:
    """Plan one statement (parse -> logical -> placed physical, no
    execution) and return its estimated shape buckets.  Shared by the
    worker and tools/warm.py; warming must never fail the caller."""
    from ..parser import parse
    from ..planner.builder import PlanBuilder
    from ..planner.buckets import bucket_estimates
    try:
        phys = session._optimize(
            PlanBuilder(session).build_select(parse(sql)[0]), True)
        return bucket_estimates(phys, session.sysvars)
    except Exception:
        return set()
    finally:
        session._pinned_is = None


def rank_candidates(records: List[dict], top_k: int) -> List[dict]:
    """Rank statement-summary records (stmtsummary.snapshot() dicts) into
    the top-K prewarm candidates: SELECT families with a replayable
    sample, scored by ``exec_count x max exec ms`` (the family's max
    wall is dominated by its cold run — an exec-weighted miss-cost
    proxy).  The eviction tombstone and bookkeeping statements never
    qualify."""
    from ..obs.stmtsummary import EVICTED_DIGEST
    scored = []
    for r in records:
        if r.get("digest") == EVICTED_DIGEST:
            continue
        if (r.get("stmt_type") or "").lower() != "select":
            continue
        sql = r.get("sample_sql") or ""
        if not sql:
            continue
        count = int(r.get("exec_count", 0) or 0)
        max_exec_ms = float((r.get("max_ms") or {}).get("exec", 0.0))
        scored.append((count * max(max_exec_ms, 1.0), r))
    scored.sort(key=lambda t: -t[0])
    return [r for _, r in scored[:max(int(top_k), 0)]]


class PrewarmWorker:
    """Background family warmer owned by the server (one per process is
    the intended shape; tests drive :meth:`run_cycle` directly)."""

    def __init__(self, storage, domain=None, device=None):
        self.storage = storage
        self.domain = domain
        #: the torch device the worker's session runs on (the server's)
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._session = None
        #: family key -> monotonic timestamp of the last warm attempt
        self._last_warm: Dict[tuple, float] = {}
        #: families whose last warm compiled NOTHING, mapped to the
        #: program-registry size observed then: re-executing their sample
        #: SQL would be pure wasted query work, so they are skipped until
        #: the registry shrinks (progcache.clear — a fresh cache)
        self._satisfied: Dict[tuple, int] = {}
        self._mu = threading.Lock()

    # ---- sysvars (GLOBAL scope, re-read every cycle) --------------------
    def _sysvar(self, name: str):
        from .session import DEFAULT_SYSVARS
        g = getattr(self.storage, "_global_vars", None) or {}
        return g.get(name, DEFAULT_SYSVARS.get(name))

    def _int_sysvar(self, name: str, default: int = 0) -> int:
        try:
            return int(self._sysvar(name) or 0)
        except (TypeError, ValueError):
            return default

    def enabled(self) -> bool:
        try:
            return bool(int(self._sysvar("tidb_auto_prewarm") or 0))
        except (TypeError, ValueError):
            return False

    # ---- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()  # a worker may be restarted after close()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="auto-prewarm")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        # sessions are weakref-registered (utils/interrupt): dropping the
        # reference retires the worker's conn id from the processlist.
        # Under _mu (qlint CC701): a close() racing a still-draining
        # cycle must not null the slot between _ensure_session's
        # None-check and its use — the worker would crash on a vanished
        # session instead of finishing its cycle
        with self._mu:
            self._session = None

    def _loop(self) -> None:
        # first cycle one full interval AFTER start: a cold server has an
        # empty summary anyway, and short-lived test servers never pay
        # for a worker cycle they don't want
        while True:
            interval = max(self._int_sysvar("tidb_auto_prewarm_interval",
                                            60), 1)
            if self._stop.wait(interval):
                return
            try:
                self.run_cycle()
            except Exception:
                # a broken cycle must never kill the worker thread
                _bump("errors")
                log.warning("prewarm cycle failed", exc_info=True)

    # ---- one cycle (tests call this directly) ---------------------------
    def run_cycle(self, now: Optional[float] = None) -> dict:
        """Rank -> cooldown/budget gate -> warm.  Returns a cycle report
        (also the /debug/prewarm payload shape)."""
        if not self.enabled():
            return {"enabled": False}
        from ..obs import stmtsummary
        top_k = self._int_sysvar("tidb_auto_prewarm_top_k", 8)
        budget_ms = self._int_sysvar("tidb_auto_prewarm_budget_ms", 0)
        cooldown_s = self._int_sysvar("tidb_auto_prewarm_cooldown", 0)
        now = time.monotonic() if now is None else now
        t0 = time.monotonic()
        report = {"enabled": True, "candidates": 0, "warmed": [],
                  "skipped_cooldown": 0, "skipped_satisfied": 0,
                  "skipped_budget": 0, "errors": 0}
        cands = rank_candidates(stmtsummary.snapshot(), top_k)
        report["candidates"] = len(cands)
        from ..ops import progcache
        for rec in cands:
            if self._stop.is_set():
                break
            spent_ms = (time.monotonic() - t0) * 1e3
            if budget_ms > 0 and spent_ms >= budget_ms:
                n_left = len(cands) - len(report["warmed"]) \
                    - report["skipped_cooldown"] \
                    - report["skipped_satisfied"] - report["errors"]
                _bump("skipped_budget", n_left)
                report["skipped_budget"] = n_left
                break
            fam = (rec.get("digest", ""), rec.get("plan_digest", ""))
            with self._mu:
                sat_size = self._satisfied.get(fam)
                if sat_size is not None:
                    # the registry only shrinks on clear(): while it has
                    # not, everything the family's sample would trace is
                    # still registered — re-executing it warms nothing
                    if progcache.size() >= sat_size:
                        _bump("skipped_satisfied")
                        report["skipped_satisfied"] += 1
                        continue
                    del self._satisfied[fam]  # cache was reset: re-warm
                last = self._last_warm.get(fam)
                if last is not None and cooldown_s > 0 \
                        and now - last < cooldown_s:
                    _bump("skipped_cooldown")
                    report["skipped_cooldown"] += 1
                    continue
                # claim the slot BEFORE warming: success and failure both
                # start the cooldown window (a family whose compile keeps
                # failing must not be retried every cycle)
                self._last_warm[fam] = now
            try:
                misses0 = progcache.stats_snapshot()["misses"]
                self._warm_family(rec)
                _bump("families_warmed")
                report["warmed"].append(rec.get("digest", ""))
                if progcache.stats_snapshot()["misses"] == misses0:
                    # nothing compiled: the family was already fully warm
                    with self._mu:
                        self._satisfied[fam] = progcache.size()
            except Exception as e:
                _bump("errors")
                report["errors"] += 1
                log.warning("prewarm of digest %s failed: %s",
                            rec.get("digest", ""), e)
        _bump("cycles")
        report["wall_ms"] = round((time.monotonic() - t0) * 1e3, 1)
        return report

    def _warm_family(self, rec: dict) -> None:
        """AOT-compile one digest family: plan-derived + feedback buckets
        through kernels.prewarm_bucket, then one execution of the sample
        SQL inside a prewarm scope (programs it builds are marked
        prewarm-seeded)."""
        fail.inject("prewarmCompileError")
        from ..ops import kernels, progcache
        from ..planner.buckets import merge_feedback
        s = self._ensure_session()
        schema = rec.get("schema") or ""
        if schema:
            s.execute(f"use `{schema}`")
        sql = rec["sample_sql"]
        # the worker's thread holds no statement's device scope: warm on
        # the server's device (kernels.prewarm_bucket builds there)
        with progcache.prewarm_scope(), kernels.use_device(s.device):
            buckets = plan_buckets(s, sql)
            fb = os.environ.get("TINYSQL_STATS_FEEDBACK")
            if fb:
                merge_feedback(fb, into=buckets)
            for nb in sorted(buckets):
                _bump("bucket_programs", kernels.prewarm_bucket(nb))
            s.query(sql)
            # B-bucketed stacked variants of whatever batchable fused
            # programs the sample just traced (ops/batching.py stacked
            # dispatch leg): a storm's first multi-member round is then
            # a plain cache hit at every occupancy bucket up to
            # tidb_batch_stack_max
            stack_max = self._int_sysvar("tidb_batch_stack_max", 16)
            if stack_max >= 2:
                bs, b = [], 2
                while b <= kernels.occupancy_bucket(stack_max):
                    bs.append(b)
                    b <<= 1
                _bump("stacked_programs", kernels.prewarm_stacked(bs))

    def _ensure_session(self):
        from .session import DEFAULT_SYSVARS, Session
        # check-and-create under _mu, then work on the LOCAL reference:
        # a concurrent close() nulling self._session between the check
        # and the use was a crash (AttributeError on None) in the
        # middle of a warming cycle (qlint CC701)
        with self._mu:
            s = self._session
            if s is None:
                s = Session(self.storage, domain=self.domain)
                s.device = self.device
                s.internal = True  # stay OUT of the obs fan-out (see
                #                    Session._finish_obs)
                self._session = s
        # re-overlay the GLOBAL scope every use: Session.__init__
        # snapshots globals once, but the worker lives for the server's
        # lifetime — a later SET GLOBAL (tidb_use_tpu=0, block rows,
        # pipeline depth, ...) must reach warming executions
        s.sysvars = dict(DEFAULT_SYSVARS)
        s.sysvars.update(getattr(self.storage, "_global_vars", None) or {})
        return s

    def snapshot(self) -> dict:
        """/debug/prewarm payload: process counters + per-family cooldown
        state."""
        with self._mu:
            families = {f"{d}/{p}": round(time.monotonic() - ts, 1)
                        for (d, p), ts in self._last_warm.items()}
        return {"enabled": self.enabled(), "stats": stats_snapshot(),
                "families_last_warmed_s_ago": families}
