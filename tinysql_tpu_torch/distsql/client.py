"""Coprocessor client: region scatter-gather with parallel workers
(reference: store/tikv/coprocessor.go — buildCopTasks :204, copIterator
worker pool :317-521, per-task retry with region re-split :569-640; and
distsql/distsql.go Select / select_result.go SelectResult).

`select()` splits the key ranges into per-region tasks, runs them on a
bounded worker pool (`tidb_distsql_scan_concurrency`), retries region
errors after re-splitting against the refreshed cache, resolves lock
conflicts, and yields each task's rows in task (key) order.

Robustness contract:

- every task attempt passes the ``copTaskError`` failpoint, so chaos
  tests can drive the whole retry ladder (RegionError -> re-split,
  KeyIsLocked -> resolve) or surface a typed error;
- workers run inside a COPY of the caller's context, so the statement
  kill flag / max_execution_time deadline (utils/interrupt.py) and the
  per-query observability scope both reach them;
- early close (a root LIMIT abandoning the iterator) sets a cancel
  event that every worker observes at its next attempt or mid-backoff
  (Backoffer wakes on it), then joins the pool with
  ``shutdown(wait=True, cancel_futures=True)`` — no worker thread
  survives the generator (the reference copIterator Close contract).
"""
from __future__ import annotations

import concurrent.futures as cf
import contextvars
import threading
from dataclasses import replace
from typing import Iterator, List, Optional, Tuple

from .. import fail
from ..kv import backoff as bo
from ..kv.backoff import Backoffer
from ..kv.errors import KeyIsLocked, RegionError, TaskCancelled
from ..kv.rpc import RegionCtx
from ..utils import interrupt
from .request import DAGRequest

DEFAULT_CONCURRENCY = 15


class CopClient:
    def __init__(self, storage):
        self.storage = storage

    def build_tasks(self, ranges: List[Tuple[bytes, bytes]]):
        tasks = []
        for start, end in ranges:
            for region, s, e in \
                    self.storage.cache.split_range_by_regions(start, end):
                tasks.append((region, s, e))
        return tasks

    def _run_task(self, req: DAGRequest, region, s: bytes, e: bytes,
                  cancel: Optional[threading.Event] = None,
                  boer: Optional[Backoffer] = None) -> list:
        """Execute one region task with backoff; re-splits on region errors
        (reference: coprocessor.go handleTaskOnce + onRegionError).  The
        Backoffer is threaded through re-split recursion — each level
        must spend the SAME retry budget, so a persistently failing
        region exhausts it as a typed BackoffExceeded instead of
        recursing a fresh budget per level."""
        if boer is None:
            boer = Backoffer(bo.COP_NEXT_MAX_BACKOFF, cancel=cancel)
        resolved: Tuple[int, ...] = req.resolved
        while True:
            interrupt.check()
            if cancel is not None and cancel.is_set():
                raise TaskCancelled("cop task cancelled")
            try:
                fail.inject("copTaskError")
                return self.storage.client.coprocessor(
                    RegionCtx(region.id, region.epoch),
                    {"req": replace(req, resolved=resolved), "range": (s, e)})
            except RegionError as err:
                self.storage.cache.invalidate(region.id)
                boer.backoff(bo.BO_REGION_MISS, err)
                out = []
                for r2, s2, e2 in \
                        self.storage.cache.split_range_by_regions(s, e):
                    out.extend(self._run_task(req, r2, s2, e2, cancel,
                                              boer))
                return out
            except KeyIsLocked as lk:
                if self.storage.resolver.resolve(boer, lk):
                    # outcome KNOWN (committed/rolled back) and the
                    # resolve was sent: the server may now ignore this
                    # txn's leftovers.  A still-LIVE lock must NOT be
                    # added — reading around it would miss a commit
                    # that lands with commit_ts below our snapshot
                    # (chaos-suite find: stale point reads under a
                    # pending 2PC)
                    if lk.lock_ts not in resolved:
                        resolved = resolved + (lk.lock_ts,)
                else:
                    boer.backoff(bo.BO_TXN_LOCK_FAST, lk)

    def select(self, req: DAGRequest, ranges: List[Tuple[bytes, bytes]],
               concurrency: int = DEFAULT_CONCURRENCY) -> Iterator[list]:
        """Yield per-task row batches in task order (keep-order semantics;
        reference: copIterator with keepOrder + sendToRespCh)."""
        tasks = self.build_tasks(ranges)
        if not tasks:
            return
        if concurrency <= 1 or len(tasks) == 1:
            for region, s, e in tasks:
                yield self._run_task(req, region, s, e)
            return
        # bounded in-flight window: at most `concurrency` region results
        # buffered (the reference copIterator's respChan backpressure)
        cancel = threading.Event()
        # "distsql-cop" is the conprof role vocabulary
        # (obs/conprof.ROLE_PREFIXES): cop workers classify as role
        # `distsql` in continuous_profiling / race-stress / py-spy
        pool = cf.ThreadPoolExecutor(max_workers=min(concurrency, len(tasks)),
                                     thread_name_prefix="distsql-cop")

        def submit(task):
            region, s, e = task
            # fresh context COPY per task: one Context object cannot be
            # entered concurrently, and workers must see the caller's
            # statement guard + obs scope
            ctx = contextvars.copy_context()
            return pool.submit(ctx.run, self._run_task, req, region, s, e,
                               cancel)
        try:
            futs = []
            nxt = 0
            done = 0
            while done < len(tasks):
                while nxt < len(tasks) and nxt - done < concurrency:
                    futs.append(submit(tasks[nxt]))
                    nxt += 1
                yield futs[done].result()
                futs[done] = None  # release the buffered rows
                done += 1
        except BaseException:
            # early close (root LIMIT satisfied -> GeneratorExit), a
            # statement kill raised out of .result(), or any task error:
            # cancel pending work and JOIN the pool — a worker mid-retry
            # observes `cancel` at its next attempt or mid-backoff, so
            # the join is bounded and no thread outlives the iterator
            cancel.set()
            pool.shutdown(wait=True, cancel_futures=True)
            raise
        pool.shutdown(wait=True)


def select(storage, req: DAGRequest, ranges, concurrency=DEFAULT_CONCURRENCY):
    return CopClient(storage).select(req, ranges, concurrency)
