"""Range task runner — reference: store/tikv/range_task.go
(RangeTaskRunner: split a key range by region, run a handler per
subrange on a bounded worker pool, re-split and retry on region errors,
aggregate completed-region / failure statistics).

The consumer shape is background maintenance over the whole keyspace —
GC, diagnostics, bulk deletes — where per-region parallelism and
stale-topology retry matter but transactional isolation does not.

A handler must be idempotent per subrange: when it raises RegionError,
``_run_one`` runs it again over the WHOLE failed subrange (re-split into
the new regions), so keys it already handled before the error are handed
to it again.  A handler that cannot repeat work (one that counts, moves
or appends) has to resume from a progress key of its own.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from . import backoff as bo
from .backoff import Backoffer
from .errors import BackoffExceeded, RegionError
from .rpc import RegionCache


@dataclass
class RangeTaskStat:
    """Mirrors range_task.go's completed/failed region counters."""
    completed_regions: int = 0
    failed_regions: int = 0
    _mu: threading.Lock = field(default_factory=threading.Lock,
                                repr=False)

    def _add(self, ok: bool) -> None:
        with self._mu:
            if ok:
                self.completed_regions += 1
            else:
                self.failed_regions += 1


# handler(start, end) -> None; raises RegionError to trigger a re-split
RangeTaskHandler = Callable[[bytes, bytes], None]


class RangeTaskRunner:
    """Split [start, end) by region and run `handler` per subrange with
    bounded concurrency (range_task.go RunOnRange)."""

    def __init__(self, name: str, cache: RegionCache,
                 concurrency: int = 4, max_retries_per_range: int = 8):
        self.name = name
        self.cache = cache
        self.concurrency = max(1, concurrency)
        self.max_retries = max_retries_per_range

    def run_on_range(self, start: bytes, end: bytes,
                     handler: RangeTaskHandler) -> RangeTaskStat:
        stat = RangeTaskStat()
        splits = self.cache.split_range_by_regions(start, end)
        with ThreadPoolExecutor(max_workers=self.concurrency,
                                thread_name_prefix=f"range-{self.name}"
                                ) as pool:
            futs = [pool.submit(self._run_one, s, e, handler, stat)
                    for _r, s, e in splits]
            errs = [f.exception() for f in futs]
        for e in errs:
            if e is not None:
                raise e
        return stat

    def _run_one(self, start: bytes, end: bytes,
                 handler: RangeTaskHandler, stat: RangeTaskStat) -> None:
        """One subrange: on a region error the topology moved under us —
        invalidate, RE-SPLIT the remaining subrange, and run the pieces
        (a split/merge mid-task must neither drop nor double keys)."""
        boer = Backoffer(bo.COP_NEXT_MAX_BACKOFF)
        for _ in range(self.max_retries):
            try:
                handler(start, end)
                stat._add(True)
                return
            except RegionError as e:
                self.cache.invalidate_all()
                boer.backoff(bo.BO_REGION_MISS, e)
                pieces = self.cache.split_range_by_regions(start, end)
                if len(pieces) > 1:
                    for _r, s, e2 in pieces:
                        self._run_one(s, e2, handler, stat)
                    return
        stat._add(False)
        raise BackoffExceeded(
            f"range task {self.name}: {start!r}..{end!r} kept failing")
