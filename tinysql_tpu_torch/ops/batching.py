"""Cross-query micro-batching: the same-digest coalescer core.

Literal parameterization makes every query in a normalized-SQL
digest family share ONE registered program with its constants as runtime
operands (exprjit.ParamTable).  This module supplies the other half of
the serving win: when several concurrently-admitted statements belong
to the same WARM family, the statement pool (server/pool.py) executes
them as one *batch round* — N ParamTables through one compiled program
in a single back-to-back device round — instead of N independent,
interleaved dispatches.

Protocol (driven by the pool's worker thread; all members run
sequentially on it):

1. **collect** — each member statement executes normally under the
   round's collect scope.  When its fused aggregate reaches the device
   dispatch boundary with a params-compiled dev mask AND the program
   already warm (ops/kernels.py fused entries, ``batchable=True`` call
   sites), it *parks*: the round captures ``(program key, cached
   program, non-param args, this member's params)`` and the statement
   aborts with :class:`Parked` (invisible to observability — the
   session skips the obs fan-out for parked attempts).  Members whose
   statements never reach a batchable dispatch (host paths, cold
   programs, non-SELECTs) simply COMPLETE during collect: transparent
   solo fallback.
2. **dispatch** — the round groups parked members by (program key,
   staged-array identity) and, when ``tidb_batch_stack_max`` allows it
   and >= 2 members' ParamTables share a slot layout, STACKS them on a
   leading batch axis (exprjit.ParamTable.stack) and runs the program's
   batched variant (kernels.stacked_variant, registered under the base
   key extended with a power-of-two occupancy bucket B — occupancy 3
   rides the B=4 variant with an inert padding row): one launch of HK7b
   (csrc/expr_eval.cu) and one of HK1b or HK2b (csrc/masked_reduce.cu,
   csrc/segment_reduce.cu) for the whole group, and packed outputs pull
   in one transfer.  Groups refused before any launch (stacking off,
   layout mismatch, no stacking recipe on the program, singleton
   leftovers) run the legacy back-to-back leg — one ParamTable replay
   per member.  The dispatch runs on the pool worker between members'
   statements, so it enters the device the members parked on.  Each
   dispatch leg runs inside a CAPTURE observability scope; its device
   counters (dispatches, device_s, transfer bytes) are split across the
   members it served — occupancy-weighted for a stacked group, exact for
   a solo replay — so statements_summary and EXPLAIN ANALYZE stay
   truthful and member shares sum to the global counters
   (:func:`split_exact`).

   No fallback: an error raised by a launch (a device error, an armed
   ``kernelDispatchError``) is stored as every served member's result,
   and each member's replay raises it — no member is re-run on another
   leg.  The reference instead caught any stacked-dispatch error and
   quietly re-ran the members back to back.
3. **replay** — each parked member re-executes; at the same boundary it
   *consumes* its precomputed device output (matched by program key +
   the identity of the staged device arrays + its own param bytes) and
   the rest of the statement — unpack, d2h, result assembly,
   observability — runs normally in the member's own scope.  A consume
   miss (the replica rotated between phases, plan re-placed, ...)
   falls through to a plain solo dispatch on the card: batching is an
   optimization, never a correctness dependency.

Family eligibility is learned, not declared: the session's statement
close hook calls :func:`note_family` for statements that executed a
batchable fused dispatch (the ``batchable`` obs marker), and the pool
only forms rounds for digests seen here.

Counter-write discipline: ``STATS`` is written only through this
module's accessors (qlint OB401/OB402 — batching.py is an owning
module).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import threading
from typing import Dict, List, Optional

from ..obs import context as _obs

#: process-total coalescing counters (exported to /metrics and the
#: serve bench): batches = rounds that dispatched >= 1 parked member,
#: batched_statements = members served from a round dispatch,
#: occupancy_sum / batches = average batch occupancy, parks / replays
#: the protocol legs, fallbacks = replay consume misses (solo re-dispatch)
#: dispatch_s_sum accumulates wall seconds inside round dispatch legs
#: (exported as tinysql_batch_dispatch_seconds_total: the device-side
#: half of a batched member's wait attribution).  The stacked leg:
#: stacked_rounds = groups served by ONE batched dispatch,
#: stacked_statements = members inside them, stacked_occupancy_sum /
#: stacked_rounds = average stacked occupancy, stack_fallbacks = groups
#: refused before any launch and sent to the legacy back-to-back leg
#: (layout mismatch, no stacking recipe)
STATS = {"batches": 0, "batched_statements": 0, "occupancy_sum": 0,
         "parks": 0, "replays": 0, "fallbacks": 0, "dispatch_s_sum": 0.0,
         "stacked_rounds": 0, "stacked_statements": 0,
         "stacked_occupancy_sum": 0, "stack_fallbacks": 0}
_stats_mu = threading.Lock()


def _stat_add(key: str, n: int = 1) -> None:
    with _stats_mu:
        STATS[key] = STATS.get(key, 0) + n


def stats_snapshot() -> Dict[str, int]:
    with _stats_mu:
        return dict(STATS)


def reset_stats() -> None:
    """Tests only."""
    with _stats_mu:
        for k in STATS:
            STATS[k] = 0


class Parked(Exception):
    """Control-flow signal of the collect leg: the statement reached a
    batchable warm dispatch and its params were captured.  Never
    surfaces to clients — only the pool's batch runner catches it, and
    the session skips the observability fan-out for parked attempts."""


class _ParkedDispatch:
    __slots__ = ("key", "fn", "args", "arg_ids", "params_key", "params",
                 "device", "out", "share")

    def __init__(self, key, fn, args, params, device):
        self.key = key
        self.fn = fn
        self.args = args            # positional device args WITHOUT params
        self.arg_ids = _leaf_ids(args)
        self.params = params        # the member's (pi, pf) host vectors
        self.params_key = _params_key(params)
        self.device = device        # the torch device the member parked on
        self.out = None             # ("dev"|"host"|"error", payload)
        self.share = None           # this member's device-counter share


def _params_key(params) -> bytes:
    pi, pf = params
    return bytes(memoryview(pi).cast("B")) + b"|" + \
        bytes(memoryview(pf).cast("B"))


def _leaf_ids(x) -> tuple:
    """Structural identity of a dispatch's non-param arguments: the
    executor rebuilds its ``dev_cols`` list (and the (values, null)
    tuples in it) per execution, but the LEAF device arrays are
    replica-memoized — the same objects across a family's queries until
    a write invalidates the replica.  Matching on leaf ids is exactly
    the guard batching needs: a replica rotation between the collect and
    replay legs changes the leaves, the consume misses, and the member
    falls back to a solo dispatch over the fresh data."""
    if x is None:
        return ("~",)
    if isinstance(x, int):  # a row count: the same value, not the same
        return ("#", x)     # object, across a family's queries
    if isinstance(x, (list, tuple)):
        out = ["("]
        for v in x:
            out.extend(_leaf_ids(v))
        out.append(")")
        return tuple(out)
    return (id(x),)


def split_exact(totals: dict, k: int) -> List[dict]:
    """Split a device-counter dict into ``k`` per-member shares that add
    up to the input exactly, float counters included.

    The first k - 1 members take ``q``, ``v / k`` with its low
    ``bit_length(k - 1)`` mantissa bits cleared, and the last takes
    ``v - (k - 1) * q``.  Every partial sum ``j * q`` (j < k) is then a
    float with no rounding, and so is the remainder, so the shares'
    exact (real) sum is ``v``.  Exact under: a left fold in member order
    (``((s0 + s1) + s2) + ...``, every step exact), and ``math.fsum``
    in any order and nesting — a member's share split again by this
    function still sums exactly to the round's total.  Not promised:
    an arbitrary reassociation, or Python 3.12's compensated ``sum()``
    of floats, whose result the reference's split (``shardops.
    split_exact``, a plain ``v / k`` share and a rounded remainder) does
    not reproduce."""
    if k <= 1:
        return [dict(totals)]
    shares: List[dict] = [dict() for _ in range(k)]
    for key, v in totals.items():
        q = _coarse(v / k, k)
        acc = 0.0
        for i in range(k - 1):
            shares[i][key] = q
            acc += q
        shares[k - 1][key] = v - acc
    return shares


def _coarse(q: float, k: int) -> float:
    """``q`` with its low ``bit_length(k - 1)`` mantissa bits cleared
    (toward zero), so that ``j * q`` is exact for every j < k."""
    if q == 0.0 or not math.isfinite(q):
        return q
    drop = (k - 1).bit_length()
    m, e = math.frexp(q)
    scale = float(1 << (53 - drop))
    return math.ldexp(math.trunc(m * scale) / scale, e)


@contextlib.contextmanager
def _capture_scope():
    """A throwaway QueryObs installed around one round dispatch leg:
    counted_jit / d2h / h2d report into it like into any statement
    scope, and the collected totals become the served members'
    attribution shares (the replay-side consume records them into each
    member's own scope).  Without it the whole round's device_s and
    transfer bytes would land on no statement at all — the pool worker
    drives the dispatch leg outside every member context."""
    cap = _obs.QueryObs()
    tok = _obs.activate(cap)
    try:
        yield cap
    finally:
        _obs.deactivate(tok)


class BatchRound:
    """One coalesced group's shared state across collect/dispatch/replay.
    Used from the single pool worker thread driving the group (members
    run sequentially), so no internal locking is needed beyond the
    global counters.  ``stack_max`` is the live ``tidb_batch_stack_max``
    value (0/1 = legacy back-to-back only; >= 2 caps how many members
    one stacked dispatch may carry)."""

    def __init__(self, stack_max: int = 0):
        self.collecting = False
        self.replaying = False
        self.stack_max = max(int(stack_max), 0)
        self._parked: List[_ParkedDispatch] = []
        #: (key, arg_ids, params_key) -> [(out, share)]: a LIST because
        #: concurrent clients legitimately submit IDENTICAL statements —
        #: each member consumes one stored output
        self._results: Dict[tuple, list] = {}

    # ---- collect ---------------------------------------------------------
    def park(self, key, fn, args, params) -> None:
        """Capture one member's dispatch and abort its collect execution
        (raises :class:`Parked`)."""
        from . import kernels
        self._parked.append(
            _ParkedDispatch(key, fn, args, params, kernels.device()))
        _stat_add("parks")
        raise Parked()

    @property
    def parked_count(self) -> int:
        return len(self._parked)

    # ---- dispatch --------------------------------------------------------
    def dispatch(self) -> int:
        """Serve every parked member: same-program/same-data groups of
        >= 2 layout-compatible members go through ONE stacked-params
        dispatch (``stack_max`` permitting), everything else replays
        back-to-back through the captured solo program.  Returns the
        round's occupancy (members served).  No program is built on a
        warm path — park only happens on registered programs, and the
        stacked variants are prewarmable (kernels.prewarm_stacked).  A
        dispatch that raises (a device error, an injected fault) stores
        the error as each of its members' result: their replays raise
        it."""
        import time as _time
        t0 = _time.perf_counter()
        groups: Dict[tuple, list] = {}
        order: List[tuple] = []
        for p in self._parked:
            k = (p.key, p.arg_ids)
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(p)
        occ = 0
        for k in order:
            members = groups[k]
            while members:
                chunk = members[: max(self.stack_max, 1)]
                members = members[len(chunk):]
                if len(chunk) >= 2 and self._dispatch_stacked(chunk):
                    occ += len(chunk)
                    continue
                for p in chunk:
                    occ += self._dispatch_solo(p)
        if occ:
            _stat_add("batches")
            _stat_add("batched_statements", occ)
            _stat_add("occupancy_sum", occ)
            _stat_add("dispatch_s_sum", _time.perf_counter() - t0)
        return occ

    def _store(self, p: _ParkedDispatch, out, share: dict) -> None:
        p.out = out
        p.share = share
        self._results.setdefault(
            (p.key, p.arg_ids, p.params_key), []).append((out, share))

    def _dispatch_solo(self, p: _ParkedDispatch) -> int:
        """Legacy back-to-back leg: one ParamTable replay through the
        member's captured solo program.  The capture scope's totals are
        this member's EXACT attribution (the whole dispatch served only
        it) — including any sampled device_s, so the profiler's measured
        time lands on the member that caused it, not on whoever
        dispatched the round."""
        from . import kernels
        cap = None
        try:
            with kernels.use_device(p.device), _capture_scope() as cap:
                out = p.fn(*p.args, kernels._params_dev(p.params))
        except Exception as e:
            self._store(p, ("error", e), cap.device_totals() if cap else {})
            return 1
        self._store(p, ("dev", out), cap.device_totals())
        return 1

    def _dispatch_stacked(self, chunk: List[_ParkedDispatch]) -> bool:
        """ONE dispatch for the whole chunk: stack the members'
        ParamTables on a leading batch axis padded to the occupancy
        bucket, run the B-stacked variant, and split the output per
        member — packed outputs pull as one [B, L] transfer here (host
        rows, no further d2h at replay), tree outputs slice off axis 0
        on the device.  The capture scope's totals are split exactly
        across the chunk's members (:func:`split_exact`).  Returns False
        only for a refusal decided before any launch (no stacking
        recipe, a slot-layout mismatch): the chunk then takes the legacy
        leg.  A launch error fails every member (module docstring)."""
        from . import kernels
        from .exprjit import ParamTable
        p0 = chunk[0]
        n = len(chunk)
        b = kernels.occupancy_bucket(n)
        ent = kernels.stacked_variant(p0.key, p0.fn, b)
        if ent is None:
            _stat_add("stack_fallbacks")
            return False
        vfn, kind = ent
        try:
            stacked = ParamTable.stack([p.params for p in chunk], b)
        except ValueError:
            _stat_add("stack_fallbacks")
            return False
        cap = None
        try:
            with kernels.use_device(p0.device), _capture_scope() as cap:
                res, plan = vfn(*p0.args, kernels._params_dev(stacked))
                if kind == "packed":
                    rows = kernels.d2h(res)
        except Exception as e:
            shares = split_exact(cap.device_totals() if cap else {}, n)
            for i, p in enumerate(chunk):
                self._store(p, ("error", e), shares[i])
            return True
        shares = split_exact(cap.device_totals(), n)
        for i, p in enumerate(chunk):
            if kind == "packed":
                out = ("host", (rows[i], plan))
            else:
                out = ("dev", (res[i], plan))
            self._store(p, out, shares[i])
        _stat_add("stacked_rounds")
        _stat_add("stacked_statements", n)
        _stat_add("stacked_occupancy_sum", n)
        return True

    # ---- replay ----------------------------------------------------------
    def consume(self, key, args, params):
        """The replay-side lookup: this member's precomputed
        ``(tag, output)``, or None when the capture no longer matches
        (fall back to a solo dispatch).  A hit records the member's
        attribution share — its occupancy-weighted slice of the round
        dispatch's device counters — into the member's own live scope,
        so summing statements_summary across members reconciles with
        the global counters."""
        outs = self._results.get(
            (key, _leaf_ids(args), _params_key(params)))
        if outs:
            _stat_add("replays")
            out, share = outs.pop()
            for k, v in share.items():
                _obs.record(k, v)
            _obs.record("coalesced", 1)
            if out[0] == "error":
                raise out[1]
            return out
        _stat_add("fallbacks")
        return None


_ROUND: contextvars.ContextVar = contextvars.ContextVar(
    "tinysql_batch_round", default=None)


def activate(rnd: Optional[BatchRound]):
    return _ROUND.set(rnd)


def deactivate(token) -> None:
    _ROUND.reset(token)


def current() -> Optional[BatchRound]:
    return _ROUND.get()


def active() -> bool:
    """True while a batch round's collect or replay leg drives THIS
    context — executors use it to prefer the batchable fused paths over
    per-member-only variants (device passthrough) so a round's members
    park and consume along the same route."""
    rnd = _ROUND.get()
    return rnd is not None and (rnd.collecting or rnd.replaying)


# ---- family registry (learned batch eligibility) --------------------------

#: normalized-SQL digests whose statements executed a batchable fused
#: dispatch (dev-mask + params, single-shot path).  Bounded: serving
#: works with O(active digest families).
_FAM_MAX = 512
_fam_mu = threading.Lock()
_FAMILIES: Dict[str, int] = {}


def note_family(sql_digest: str) -> None:
    """Mark a digest family batchable (called from the session statement
    close hook for statements that recorded the ``batchable`` marker)."""
    if not sql_digest:
        return
    with _fam_mu:
        if len(_FAMILIES) >= _FAM_MAX and sql_digest not in _FAMILIES:
            _FAMILIES.pop(next(iter(_FAMILIES)))
        _FAMILIES[sql_digest] = _FAMILIES.get(sql_digest, 0) + 1


def family_batchable(sql_digest: str) -> bool:
    with _fam_mu:
        return sql_digest in _FAMILIES


def have_families() -> bool:
    """Cheap pre-check so the pool skips per-statement SQL
    normalization until at least one batchable family exists."""
    with _fam_mu:
        return bool(_FAMILIES)


def reset_families() -> None:
    """Tests only."""
    with _fam_mu:
        _FAMILIES.clear()
