"""Opt-in dispatch-level device timing (``tidb_device_profile_rate``).

Every timing the engine publishes by default is a HOST wall: the
``dispatch`` span in ops/kernels.counted_jit wraps an *asynchronous* XLA
enqueue, so on a real accelerator it measures submit time, not device
time — the numbers it feeds into EXPLAIN ANALYZE, statements_summary,
and the bench are fiction there.  This module owns the opt-in truth
path: at a *sampled* dispatch, counted_jit closes the call with
``block_until_ready`` and records the measured wall

- into the per-query scope and the global counters through
  ``kernels.stats_add("device_s", ...)`` (so EXPLAIN ANALYZE's
  ``device:`` cell, statements_summary's ``sum_device_ms``, and the
  ``tinysql_device_busy_seconds_total`` ring series all agree),
- into the per-program catalog (ops/progcache.note_dispatch), and
- into the ``tinysql_dispatch_device_seconds`` histogram owned here.

Sampling is DETERMINISTIC — every ``round(1/rate)``-th dispatch — so
tests and repeated runs see stable counts.  Rate 0 (the default) is a
single dict read on the dispatch path and leaves results, program-cache
keys, and dispatch behavior byte-identical to an unprofiled process;
rate 1 forces a sync per dispatch, which also serializes the async
block pipeline's overlap — profile to diagnose, not as a steady state.

WRITE DISCIPLINE (qlint OB405): the device-time counter keys
(``device_s`` / ``profiled_dispatches`` / ``compile_s``) may be written
only from this module, ops/kernels.py, and ops/progcache.py — any other
writer would publish a host wall as device truth.
"""
from __future__ import annotations

import threading
from typing import Dict

#: upper bounds (seconds) of the device-time histogram buckets; +Inf
#: implied.  Device programs span ~10us (tiny bucketed kernels on a
#: local backend) to seconds (cold SF=10 aggregations over a tunnel).
DEVICE_TIME_BUCKETS_S = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
                         1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                         0.1, 0.25, 0.5, 1.0, 2.5)

_mu = threading.Lock()

#: rate: fraction of dispatches closed with block_until_ready (0 = off,
#: clamped to [0, 1]); tick: the deterministic sampling counter
_STATE = {"rate": 0.0, "tick": 0}

_hist = [0] * (len(DEVICE_TIME_BUCKETS_S) + 1)
_hist_sum = 0.0
_hist_count = 0


def set_rate(rate: float) -> None:
    """Apply ``tidb_device_profile_rate`` (session SET hook / server
    start).  Process-global, like the compile-cache dir: there is one
    dispatch path."""
    try:
        r = float(rate)
    except (TypeError, ValueError):
        r = 0.0
    with _mu:
        _STATE["rate"] = min(max(r, 0.0), 1.0)


def rate() -> float:
    return _STATE["rate"]


def should_sample() -> bool:
    """The per-dispatch sampling decision: deterministic every-N-th
    (N = round(1/rate)), cheap single read when profiling is off."""
    r = _STATE["rate"]
    if r <= 0.0:
        return False
    if r >= 1.0:
        return True
    period = max(1, int(round(1.0 / r)))
    with _mu:
        _STATE["tick"] += 1
        return _STATE["tick"] % period == 0


def observe(seconds: float) -> None:
    """Record one sampled dispatch's measured device wall into the
    ``tinysql_dispatch_device_seconds`` histogram."""
    global _hist_sum, _hist_count
    with _mu:
        for i, le in enumerate(DEVICE_TIME_BUCKETS_S):
            if seconds <= le:
                _hist[i] += 1
                break
        else:
            _hist[-1] += 1
        _hist_sum += seconds
        _hist_count += 1


def histogram_snapshot() -> Dict[str, object]:
    """``{"buckets": [(le_s, count), ...], "overflow": n, "sum": s,
    "count": n}`` with PER-BUCKET (non-cumulative) counts — the same
    shape as stmtsummary.histogram_snapshot entries; /metrics renders
    the Prometheus cumulative form."""
    with _mu:
        return {"buckets": list(zip(DEVICE_TIME_BUCKETS_S, _hist)),
                "overflow": _hist[-1],
                "sum": _hist_sum, "count": _hist_count}


def snapshot() -> Dict[str, float]:
    with _mu:
        return {"rate": _STATE["rate"], "sampled": _hist_count,
                "device_s_sum": _hist_sum}


def reset() -> None:
    """Tests only."""
    global _hist, _hist_sum, _hist_count
    with _mu:
        _STATE["rate"] = 0.0
        _STATE["tick"] = 0
        _hist = [0] * (len(DEVICE_TIME_BUCKETS_S) + 1)
        _hist_sum = 0.0
        _hist_count = 0
