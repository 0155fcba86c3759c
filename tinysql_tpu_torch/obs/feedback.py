"""Measured-runtime feedback for bucket prewarming.

The prewarmer (tools/warm.py) derives shape buckets from planner
*estimates*; this module closes the loop with *observed* per-operator
cardinalities: after a statement finishes, ``maybe_emit`` appends one
JSONL record — plan digest, per-operator actual rows, and the
power-of-two buckets those rows land in — to the file named by
``TINYSQL_STATS_FEEDBACK``.  ``tools/warm.py --from-stats FILE`` (via
planner/buckets.merge_feedback) merges those buckets into the AOT
prewarm set, so buckets the estimates missed (stats drift, filters more
or less selective than modeled) still compile ahead of time.
"""
from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

_mu = threading.Lock()


def observed_buckets(qobs) -> List[int]:
    """Buckets this query actually touched, two sources unioned:

    - the shape buckets its kernels PADDED TO (``kernels.bucket``
      reports into the scope) — covers fused-pipeline input shapes that
      never flow through an operator's ``next()``;
    - per-operator actual output rows, re-bucketed.

    Both get the same growth headroom the estimate path applies
    (planner/buckets.buckets_for_rows)."""
    from ..planner.buckets import buckets_for_rows
    out = set()
    for b in qobs.observed_shape_buckets():
        out.update(buckets_for_rows(int(b)))
    for op in qobs.operators():
        out.update(buckets_for_rows(int(op.get("act_rows", 0) or 0)))
    return sorted(out)


def build_record(qobs) -> dict:
    return {"plan_digest": qobs.plan_digest,
            "sql": qobs.sql[:256].replace("\n", " "),
            "buckets": observed_buckets(qobs),
            "operators": [{"label": o["label"],
                           "act_rows": o["act_rows"]}
                          for o in qobs.operators()]}


def maybe_emit(qobs, path: Optional[str] = None) -> Optional[dict]:
    """Append this query's feedback record when a destination is
    configured (arg > TINYSQL_STATS_FEEDBACK env); never raises."""
    path = path or os.environ.get("TINYSQL_STATS_FEEDBACK")
    if not path or qobs is None:
        return None
    try:
        rec = build_record(qobs)
        if not rec["buckets"]:
            return None
        with _mu:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec
    except Exception:
        return None  # feedback is advisory; the query already succeeded
