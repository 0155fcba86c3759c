"""Device-resident query pipelines: the port of
tinysql_tpu/executor/devpipe.py.

A supported physical subtree (scans -> filters -> grouped aggregates over
the group index -> joins -> GROUP BYs above them -> topn/sort/limit/
projection -> a scalar aggregate) runs as ONE pipeline call on the
device: every node splits into a host-side ``prepare`` (replica uploads,
group indexes, position tables, expansion bounds, parameter tables —
memoized per replica version) and an ``emit`` over the pipeline's
positional inputs; DevPipeExec composes the emits, registers the
composition once per (structure, shape) key and runs it.  Intermediates
stay on the device; the only device->host transfer of a query is the
packed result, folded into the same call for small outputs, and the count
and first rows of a large one in one transfer — one dispatch, one
download, as in the reference.

Where the reference traced the emits into one XLA program, here they run
eagerly as torch ops around the hand kernels:

- K17 ``_AggIndexNode``: GROUP BY over the memoized group index (the
  table sorted once per replica version by its key) is one HK5
  :func:`kernels.csr_reduce` call over the index's order and group ends —
  no per-query sort, no scatter.  Float sums add each group's rows in
  sorted order (the reference differenced a running prefix sum: R6);
  int64 sums are exact mod 2^64.
- K18 ``_JoinNode``: a unique build side keyed by a bounded int64 key (or
  the composite lane of several) is a dense key -> row table (memoized
  per replica version; the group index's key -> group table for a
  group-index build side); probing it, the validity checks and the
  gathers are one HK6 :func:`kernels.dense_probe` call.  Semi / anti
  joins are the same probe folded into the probe side's validity.  A
  non-unique build side expands over its group index through HK8
  :func:`kernels.csr_expand` into a bucket bounded on the host.
- K19 ``_SortGroupNode``: GROUP BY above a join or another non-leaf view
  is HK4 over the key lanes, HK9 :func:`kernels.run_bounds` for the runs
  of equal keys, then HK5 over (sorted order, run ends) — each group sums
  its own rows (the reference differenced one cumsum: R7).
- K20 ``_ScalarAggNode``: HK1 :func:`kernels.masked_reduce`.
- K21 ``_OrderNode``: HK4 :func:`kernels.lex_order` over
  :func:`kernels.sort_lanes` (top-k mode for TopN).
- K22 ``_SelNode`` / ``_ProjNode`` (and the leaf's scan filters, the
  aggregates' argument lanes and ``_OrderNode``'s key expressions): one
  HK7 :func:`kernels.expr_eval` launch per node over the program
  ops/exprjit.py compiles; a large output compacts through HK2's
  :func:`kernels.present_rows`.

Strings ride order-preserving dictionary codes on the device (decoded on
materialize only), the same codes the per-operator tier uses.

Routing (``tidb_devpipe``: -1 auto = the pipeline on CUDA, 0 off, 1
force).  A plan shape the pipeline does not take (``compile`` or
``prepare`` returns None: a dirty transaction, a key range over
MAX_DENSE_RANGE, a table over ``tidb_device_block_rows``) or spill
pressure runs on the per-operator tier.  An exception while compiling
or running a pipeline fails the statement in every mode: nothing re-runs
behind the caller's back.

``BlockPipeline`` / ``pipeline_depth`` stage the per-operator tier's
block-wise runs (a table over ``tidb_device_block_rows``): inline by
default; at ``tidb_pipeline_depth`` > 0, uploads on a thread and a CUDA
side stream, kernels on the statement's stream.

Under ``tidb_mesh_parallel`` (N virtual shards on the device,
parallel/dist.py) a pipeline runs the reference's mesh modes: the unique
join's broadcast mode (the probe sharded, the build replicated: HK6
over the probe lanes as they lie, the output in the same shard-major
layout), its shuffle mode (K18 shuffle: both sides exchanged by key hash
through HK13, a local join per shard on HK4 + HK12), the CSR join's
mesh mode (HK8's shard mode: each shard expands its own probe rows into
its own bucket), and K21 mesh, the distributed TopN (``_OrderNode._
prepare_mesh``: HK4 over shard-led lanes, each shard's top candidates,
HK4 again over the gathered candidates).  An aggregate-only pipeline
goes to the per-operator tier's sharded aggregates, as in the
reference.  The reference's gates that run a join single-device (skew,
no host key lane) are kept and counted as it counts them.

Not ported yet (ROADMAP queue 1): graph capture of a pipeline key.
"""
from __future__ import annotations

import contextvars
import os
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import fail as _fail
from ..obs import context as _obs
from ..utils import interrupt as _interrupt

from ..chunk import Chunk, Column as CCol
from ..expression import Column as ExprColumn, Constant
from ..expression.aggregation import AGG_COUNT, AGG_SUM
from ..mytypes import EvalType
from ..ops import kernels, progcache
from ..ops.exprjit import (ParamTable, compile_program, is_jittable,
                           stable_shape_key)
from ..planner.physical import (PhysicalHashAgg, PhysicalHashJoin,
                                PhysicalLimit, PhysicalMergeJoin,
                                PhysicalProjection, PhysicalSelection,
                                PhysicalSort, PhysicalTableReader,
                                PhysicalTopN)

MAX_DENSE_RANGE = 1 << 25   # dense key->pos tables up to 32M slots (128MB)
MAX_EXPAND = 1 << 23        # CSR-join output bucket cap (8M rows)

# structural node keys that have actually been compiled into some
# pipeline — introspection surface for tests.  Guarded: concurrent
# sessions publish keys, and set.update over an iterable is not atomic
_CNK_MU = threading.Lock()
COMPILED_NODE_KEYS: set = set()


def _note_compiled(kparts) -> None:
    with _CNK_MU:
        COMPILED_NODE_KEYS.update(kparts)


# =========================================================================
# block pipeline: host staging on a side stream, compute on the main one
# =========================================================================

def pipeline_depth(session_vars=None) -> int:
    """Staging-queue depth of the block pipeline: how many staged blocks
    may be in flight ahead of the consumer.  0 = synchronous inline
    staging: no thread, no side stream, the exact sequential order.
    Resolution: TINYSQL_PIPELINE_DEPTH env > tidb_pipeline_depth sysvar >
    default 0 (inline: the uploads are from pageable host memory, which
    a side stream cannot overlap)."""
    env = os.environ.get("TINYSQL_PIPELINE_DEPTH")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            return 0
    if session_vars is not None:
        try:
            return max(0, int(session_vars.get("tidb_pipeline_depth", 0)
                              or 0))
        except Exception:
            return 0
    return 0


#: end-of-stream marker on the staging queue
_PIPE_DONE = object()


def _tensors(x):
    """Every tensor inside a staged block (nested tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class BlockPipeline:
    """Bounded-depth staging queue: ONE producer thread runs
    ``stage_fn(item)`` for each item IN ORDER — the host half of a block
    (slice, pad, upload) — while the consumer iterates the staged results
    in the same order and launches the block's kernels.

    On CUDA the producer stages on a side stream of its own: block k+1's
    uploads run while block k's kernels run on the consumer's stream.
    Each staged block carries an event recorded on the side stream after
    its uploads; the consumer's stream waits on it before the block is
    handed over, and every tensor of the block is marked as used by the
    consumer's stream (``record_stream``), so the caching allocator does
    not hand its memory to the side stream again before the consumer's
    kernels are done with it.

    ``depth <= 0`` stages inline with NO thread and no side stream: the
    same calls in the same order, so results are byte-identical with the
    pipeline on or off (the TINYSQL_PIPELINE_DEPTH=0 contract).

    Error contract: an exception inside ``stage_fn`` is captured, the
    producer stops, and the exception re-raises ON THE CALLER at the
    point the failed block would have been consumed — blocks staged
    before it still deliver.  Abandoning the iterator (break / caller
    exception) cancels the producer and joins the thread; ``close()`` is
    idempotent."""

    def __init__(self, stage_fn: Callable, items, depth: int = 2):
        self._stage = stage_fn
        self._items = list(items)
        self._sync = depth <= 0
        self._mu = threading.Lock()
        self._stage_s = 0.0
        self._hwm = 0
        self._cancel = threading.Event()
        self._q = None
        self._thread = None
        self._dev = None
        self._side = None
        if not self._sync:
            self._dev = kernels.device()
            if self._dev.type == "cuda":
                self._side = torch.cuda.Stream(device=self._dev)
            self._q = queue.Queue(maxsize=max(1, depth))
            # the producer runs inside a COPY of the creator's context:
            # the statement's device scope, its QueryObs scope and span
            # parent carry across the thread boundary
            cctx = contextvars.copy_context()
            self._thread = threading.Thread(
                target=cctx.run, args=(self._run,),
                name="devpipe-stage", daemon=True)
            self._thread.start()

    def _stage_timed(self, item):
        t0 = time.time()
        # a statement kill or deadline stops the producer between blocks,
        # and the staging failpoint exercises the error contract
        _interrupt.check()
        _fail.inject("devpipeStageError")
        with _obs.span("stage", cat="pipeline"):
            out = self._stage(item)
        dt = time.time() - t0
        with self._mu:
            self._stage_s += dt
        return out

    # ---- producer -------------------------------------------------------
    def _run(self) -> None:
        if self._side is None:
            self._produce()
            return
        with torch.cuda.device(self._dev), torch.cuda.stream(self._side):
            self._produce()

    def _produce(self) -> None:
        try:
            for item in self._items:
                if self._cancel.is_set():
                    return
                out = self._stage_timed(item)
                ev = None
                if self._side is not None:
                    ev = torch.cuda.Event()
                    ev.record(self._side)
                if not self._put((out, ev, None)):
                    return
        except BaseException as exc:  # delivered to the consumer
            self._put((None, None, exc))
            return
        self._put(_PIPE_DONE)

    def _put(self, entry) -> bool:
        """Cancellation-aware bounded put: a consumer that stopped
        pulling must never leave this thread parked on a full queue."""
        while not self._cancel.is_set():
            try:
                self._q.put(entry, timeout=0.05)
            except queue.Full:
                continue
            with self._mu:
                self._hwm = max(self._hwm, self._q.qsize())
            return True
        return False

    # ---- consumer -------------------------------------------------------
    def _hand_over(self, out, ev):
        """Order the consumer's stream after the block's uploads."""
        if ev is None:
            return out
        cur = torch.cuda.current_stream(self._dev)
        cur.wait_event(ev)
        for t in _tensors(out):
            if t.is_cuda:
                t.record_stream(cur)
        return out

    def __iter__(self):
        if self._sync:
            for item in self._items:
                yield self._stage_timed(item)
            return
        try:
            while True:
                entry = self._q.get()
                if entry is _PIPE_DONE:
                    break
                out, ev, exc = entry
                if exc is not None:
                    raise exc
                yield self._hand_over(out, ev)
        finally:
            self.close()

    def close(self) -> None:
        """Cancel the producer and join its thread (idempotent)."""
        self._cancel.set()
        if self._thread is None:
            return
        while True:  # wake a producer parked on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)

    def stats(self) -> dict:
        """{"blocks", "stage_s", "depth_hwm"} — feed kernels.pipe_record
        AFTER the consumer loop (the producer is joined by then)."""
        with self._mu:
            return {"blocks": len(self._items),
                    "stage_s": self._stage_s,
                    "depth_hwm": self._hwm}


class _PipeBuilder:
    """Collects the pipeline's runtime inputs and structural cache key
    while the node tree prepares.  Input ORDER is deterministic for a
    given key (prepare is a deterministic tree walk), so a cache-hit
    pipeline re-binds fresh inputs positionally.  Inputs are device
    tensors, host numpy arrays (uploaded by :meth:`run_inputs`) or host
    ints (sizes and bounds the kernels take as launch arguments)."""
    __slots__ = ("inputs", "kparts")

    def __init__(self):
        self.inputs: List = []
        self.kparts: List = []

    def add(self, arr) -> int:
        self.inputs.append(arr)
        return len(self.inputs) - 1

    def params(self, pt: ParamTable):
        pi, pf = pt.arrays()
        return self.add(pi), self.add(pf)

    def key(self, part) -> None:
        self.kparts.append(part)

    def run_inputs(self) -> list:
        """The inputs with every host array on the device: one counted
        upload per dtype (parameter tables and host-leaf columns), each
        array a contiguous slice of it."""
        out = list(self.inputs)
        by_dtype: dict = {}
        for i, a in enumerate(self.inputs):
            if isinstance(a, np.ndarray):
                by_dtype.setdefault(a.dtype.str, []).append(i)
        for idxs in by_dtype.values():
            dev = kernels.h2d(np.concatenate(
                [self.inputs[i].reshape(-1) for i in idxs]))
            off = 0
            for i in idxs:
                n = self.inputs[i].size
                out[i] = dev[off:off + n]
                off += n
        return out


class _TView:
    """A node's view: ``emit(args) -> (valid, [(vals, null), ...])`` over
    the pipeline's positional inputs, plus the host-side column metadata
    (ret_type, string decode table) and bucket size."""
    __slots__ = ("emit", "nb", "meta")

    def __init__(self, emit: Callable, nb: int, meta: List[tuple]):
        self.emit = emit
        self.nb = nb
        self.meta = meta


# =========================================================================
# group index: the sorted-replica clustered index (host numpy, copied)
# =========================================================================

class GroupIndex:
    """Per (replica version, key columns) sorted order + group boundaries.
    order[i] = original row of sorted position i; groups are contiguous
    runs; ends[g] = last sorted position of group g (host int64 [ng]);
    keycols[j] = (values[ng], null[ng]) per key column (NULL keys form
    one group; a multi-column key groups by the TUPLE).  The single-int-
    key index additionally exposes gkeys/lo/hi + the dense pos_table the
    join build sides ride."""
    __slots__ = ("order", "ends", "keycols", "n_groups", "lo", "hi")

    def __init__(self, key_cols: List[tuple]):
        # lexsort: last key is primary -> feed (vals, nulls) pairs in
        # reverse column order, nulls after their values so each column
        # sorts non-null-first.  Values under a null mask are garbage:
        # mask them to 0 so the sort (and the boundary diff below) never
        # splits the NULL group on them.
        ops = []
        svs = []
        for vals, nulls in key_cols:
            svs.append((np.where(nulls, 0, vals), nulls))
        for mv, nl in reversed(svs):
            ops.append(mv)
            ops.append(nl)
        order = np.lexsort(tuple(ops))
        n = len(order)
        svs = [(mv[order], nl[order]) for mv, nl in svs]
        if n == 0:
            self.order = order
            self.ends = np.empty(0, dtype=np.int64)
            self.keycols = [(np.empty(0, dtype=v.dtype),
                             np.empty(0, dtype=bool)) for v, _ in key_cols]
            self.n_groups = 0
            self.lo = self.hi = 0
            return
        boundary = np.zeros(n, dtype=bool)
        boundary[0] = True
        for sv, sn in svs:
            # a value diff only splits groups when NEITHER row is NULL:
            # all NULL keys form ONE group
            boundary[1:] |= ((sv[1:] != sv[:-1]) & ~(sn[1:] & sn[:-1])) \
                | (sn[1:] != sn[:-1])
        starts = np.nonzero(boundary)[0]
        ends = np.empty(len(starts), dtype=np.int64)
        ends[:-1] = starts[1:] - 1
        ends[-1] = n - 1
        self.order = order
        self.ends = ends
        self.keycols = [(sv[ends], sn[ends]) for sv, sn in svs]
        self.n_groups = len(ends)
        if len(key_cols) == 1 and self.gkeys.dtype == np.int64:
            nn = self.gkeys[~self.gkey_null]
            self.lo = int(nn.min()) if len(nn) else 0
            self.hi = int(nn.max()) if len(nn) else 0
        else:
            self.lo = self.hi = 0

    @property
    def gkeys(self) -> np.ndarray:
        return self.keycols[0][0]

    @property
    def gkey_null(self) -> np.ndarray:
        return self.keycols[0][1]

    def raw_counts(self) -> np.ndarray:
        """Rows per group (host int64 [ng]) — the pre-filter group sizes
        the CSR join uses for its expansion upper bound."""
        if self.n_groups == 0:
            return np.empty(0, dtype=np.int64)
        prev = np.concatenate(([np.int64(-1)], self.ends[:-1]))
        return self.ends - prev

    def pos_table(self) -> Optional[np.ndarray]:
        """Dense key -> group index (int32), -1 for absent keys; None when
        the key range is too wide for a dense table (single-int-key
        indexes only)."""
        if len(self.keycols) != 1 or self.gkeys.dtype != np.int64:
            return None
        rng = self.hi - self.lo + 1
        if rng > MAX_DENSE_RANGE:
            return None
        tbl = np.full(rng, -1, dtype=np.int32)
        live = ~self.gkey_null
        tbl[self.gkeys[live] - self.lo] = np.nonzero(live)[0]
        return tbl


def _group_index(rep, sids: tuple, key_cols: List[tuple]) -> GroupIndex:
    """sids: tuple of stable slot ids (one per key column)."""
    return rep.memo(("groupindex", sids), lambda: GroupIndex(key_cols))


def _col_bounds(rep, sid, vals, nulls):
    """Host min/max of a replica int column's non-null values."""
    def build():
        nn = vals[~nulls]
        if len(nn) == 0:
            return None
        return int(nn.min()), int(nn.max())
    return rep.memo(("bounds", sid), build)


def _rep_pos_table(rep, sid, vals, nulls):
    """Dense key -> row index table for a UNIQUE replica column (the
    planner proves uniqueness: pk / single-column unique index)."""
    def build():
        b = _col_bounds(rep, sid, vals, nulls)
        if b is None:
            return None
        lo, hi = b
        rng = hi - lo + 1
        if rng > MAX_DENSE_RANGE:
            return None
        tbl = np.full(rng, -1, dtype=np.int32)
        live = ~nulls
        tbl[vals[live] - lo] = np.nonzero(live)[0].astype(np.int32)
        return lo, hi, tbl
    return rep.memo(("postable", sid), build)


# =========================================================================
# nodes
# =========================================================================

class _Ctx:
    """Per-query compile context; ``opened`` lists the executors the
    leaves opened, so a failed compile can close them all."""

    def __init__(self, exec_ctx, mesh=None):
        self.exec_ctx = exec_ctx
        self.mesh = mesh  # the session's mesh (tidb_mesh_parallel) or None
        self.opened: list = []


def mesh_if_enabled(session_vars):
    from ..parallel import dist
    return dist.session_mesh(session_vars)


def _dev_upload(rep, key, build_np):
    # counted H2D (kernels.h2d): replica-memoized per device, so the
    # transfer is charged once per (replica, key) — to whichever query
    # materializes it
    return rep.memo(tuple(key) + (str(kernels.device()),),
                    lambda: kernels.h2d(build_np()))


class _ReplicaLeaf:
    """Full-table scan from the columnar replica: device columns are
    version-memoized uploads (shared with the per-operator tier); scan
    filters become the validity mask."""

    def __init__(self, reader_exec, plan):
        self.ex = reader_exec
        self.plan = plan
        self._rep = None  # set at prepare(): take_raw_replica consumes
        self._chk = None

    @staticmethod
    def compile(plan: PhysicalTableReader, ctx: _Ctx):
        from .executors import TableReaderExec
        from .gpu_executors import _block_budget
        scan = plan.scan
        if scan.ranges is not None or scan.pushed_agg is not None \
                or scan.pushed_topn is not None \
                or scan.pushed_limit is not None:
            return None
        ex = TableReaderExec(plan)
        ex.open(ctx.exec_ctx)
        if ex._replica is None:
            ex.close()
            return None
        budget = _block_budget(getattr(ctx.exec_ctx, "session_vars", {}))
        if budget > 0 and ex._replica.n_rows > budget:
            # table exceeds the device buffer budget: the per-op tier's
            # block-wise route serves it
            ex.close()
            return None
        ctx.opened.append(ex)
        return _ReplicaLeaf(ex, plan)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        from .gpu_executors import (_build_device_mask, _dev_memo,
                                    _rep_string_dict, _slot_id)
        chk, filters, rep = self.ex.take_raw_replica()
        if chk is None:
            return None
        self._rep = rep
        self._chk = chk
        n = chk.full_rows()
        nb = kernels.bucket(max(n, 1))
        pt = ParamTable()
        dm = _build_device_mask(self.ex, rep, chk, filters)
        if dm is None:
            return None
        conds, mask_key, _needed = dm
        prog = compile_program(conds, (), pt, mask=True)
        slots = []
        meta: List[tuple] = []
        dts = []
        for idx, c in enumerate(chk.columns):
            v = c.values()
            m = c.null_mask()
            sid = _slot_id(self.ex, idx)
            dn = _dev_memo(rep, "devn", sid, nb,
                           lambda m=m: kernels.h2d_pad(m, nb, True))
            if v.dtype == object or v.dtype.kind == "U":
                codes, _card, _, uniques = _rep_string_dict(rep, sid, chk,
                                                            idx)
                dv = _dev_memo(rep, "devcodes", sid, nb,
                               lambda c_=codes: kernels.h2d_pad(c_, nb))
                meta.append((c.ft, uniques))
                dts.append("s")
            else:
                dv = _dev_memo(rep, "devv", sid, nb,
                               lambda v=v: kernels.h2d_pad(v, nb))
                meta.append((c.ft, None))
                dts.append("f" if v.dtype == np.float64 else "i")
            slots.append((pb.add(dv), pb.add(dn)))
        ip, fp = pb.params(pt)
        inr = pb.add(n)
        pb.key(("leaf", mask_key, nb, tuple(dts)))

        def emit(args):
            pairs = [(args[iv], args[im]) for iv, im in slots]
            # HK7: the scan filters, rows past the table's count padding
            valid, _ = kernels.expr_eval(prog, pairs, (args[ip], args[fp]),
                                         nb, n_rows=args[inr])
            return valid, pairs
        return _TView(emit, nb, meta)

    # host info the parent join/agg stages need (valid after prepare())
    def replica(self):
        return self._rep if self._rep is not None else self.ex._replica

    def chunk(self):
        return self._chk

    def close(self):
        self.ex.close()


class _HostLeaf:
    """Any other numeric subtree: run its regular executor and upload the
    materialized chunk (this is the CPU -> device boundary).  Numeric
    columns only — a string column here would need a per-query dictionary
    build, which defeats the point."""

    def __init__(self, child_exec, plan):
        self.ex = child_exec
        self.plan = plan
        self._chk = None

    @staticmethod
    def compile(plan, ctx: _Ctx):
        for c in plan.schema.columns:
            if c.ret_type.eval_type is EvalType.STRING:
                return None
        if _contains_join(plan):
            # an unsupported JOIN subtree as a host leaf would nest
            # another pipeline inside (materialize + re-upload per
            # layer); the per-operator tier takes the whole statement
            return None
        from .executors import build_executor
        ex = build_executor(plan, True)
        if ex is None:
            return None
        ex.open(ctx.exec_ctx)
        ctx.opened.append(ex)
        return _HostLeaf(ex, plan)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        from .gpu_executors import _drain_chunk
        chk = _drain_chunk(self.ex, self.ex.field_types()).compact()
        self._chk = chk
        n = chk.num_rows()
        nb = kernels.bucket(max(n, 1))
        slots = []
        meta = []
        dts = []
        for c, oc in zip(chk.columns, self.plan.schema.columns):
            v = c.values()
            m = c.null_mask()
            slots.append((pb.add(kernels.pad1(v, nb)),
                          pb.add(kernels.pad1(m, nb, True))))
            meta.append((oc.ret_type, None))
            dts.append("f" if v.dtype == np.float64 else "i")
        vi = pb.add(kernels.pad1(np.ones(n, dtype=bool), nb))
        pb.key(("host", nb, tuple(dts)))

        def emit(args):
            return args[vi], [(args[a], args[b]) for a, b in slots]
        return _TView(emit, nb, meta)

    def chunk(self):
        return self._chk

    def close(self):
        self.ex.close()


def _assemble_agg_specs(plan):
    """Shared descriptor lowering for the device aggregation nodes:
    returns (specs, slots) or None.  specs[k] = (kind, expr|None) with
    kind in count_star/count/sum/sum0/min/max — sum0 is a SUM of partial
    COUNT states, 0 over empty input instead of NULL; slots[i] maps
    descriptor i to ("one", k) or ("avg", k_sum, k_cnt) — avg decomposes
    into sum+count with the quotient taken on the device (reference
    partial-state split, aggregation/descriptor.go)."""
    from ..expression.aggregation import (AGG_AVG, AGG_MAX, AGG_MIN,
                                          AggMode)
    from ..expression.builtins import new_function
    specs: List[tuple] = []
    slots: List[tuple] = []
    for d in plan.aggs:
        if d.distinct:
            return None
        if d.mode is AggMode.FINAL:
            # FINAL merges partial STATES (reference aggfuncs mode split):
            # count -> SUM of partial counts; avg -> sum(sums)/sum(counts);
            # sum/min/max merge with themselves
            if d.name == AGG_COUNT and is_jittable(d.args[0]):
                # sum0: COUNT merged from partial states is 0 over empty
                # input, never NULL (unlike SUM)
                specs.append(("sum0", d.args[0]))
                slots.append(("one", len(specs) - 1))
            elif d.name == AGG_AVG and len(d.args) == 2 \
                    and all(is_jittable(a) for a in d.args):
                a0 = d.args[0]
                if a0.eval_type is not EvalType.REAL:
                    a0 = new_function("cast_real", [a0])
                specs.append(("sum", a0))
                specs.append(("sum", d.args[1]))
                slots.append(("avg", len(specs) - 2, len(specs) - 1))
            elif d.name == AGG_SUM and is_jittable(d.args[0]):
                a = d.args[0]
                if (d.ret_type.eval_type is EvalType.REAL
                        and a.eval_type is not EvalType.REAL):
                    a = new_function("cast_real", [a])
                specs.append(("sum", a))
                slots.append(("one", len(specs) - 1))
            elif d.name in (AGG_MIN, AGG_MAX) and is_jittable(d.args[0]) \
                    and not (d.args[0].eval_type is EvalType.INT
                             and getattr(d.args[0].ret_type,
                                         "is_unsigned", False)):
                specs.append((("min" if d.name == AGG_MIN else "max"),
                              d.args[0]))
                slots.append(("one", len(specs) - 1))
            else:
                return None
            continue
        if d.name == AGG_COUNT and isinstance(d.args[0], Constant) \
                and d.args[0].value is not None:
            specs.append(("count_star", None))
            slots.append(("one", len(specs) - 1))
        elif d.name == AGG_COUNT and is_jittable(d.args[0]):
            specs.append(("count", d.args[0]))
            slots.append(("one", len(specs) - 1))
        elif d.name == AGG_SUM and is_jittable(d.args[0]):
            a = d.args[0]
            if (d.ret_type.eval_type is EvalType.REAL
                    and a.eval_type is not EvalType.REAL):
                a = new_function("cast_real", [a])
            specs.append(("sum", a))
            slots.append(("one", len(specs) - 1))
        elif d.name == AGG_AVG and is_jittable(d.args[0]):
            a = d.args[0]
            ar = a if a.eval_type is EvalType.REAL \
                else new_function("cast_real", [a])
            specs.append(("sum", ar))
            specs.append(("count", a))
            slots.append(("avg", len(specs) - 2, len(specs) - 1))
        elif d.name in (AGG_MIN, AGG_MAX) and is_jittable(d.args[0]):
            a = d.args[0]
            if (a.eval_type is EvalType.INT
                    and getattr(a.ret_type, "is_unsigned", False)):
                return None  # unsigned order map: CPU/per-op tiers
            specs.append((("min" if d.name == AGG_MIN else "max"), a))
            slots.append(("one", len(specs) - 1))
        else:
            return None
    return specs, slots


def _agg_out_map(plan):
    """schema slot -> ("agg", descriptor i) | ("gb", key j), or None."""
    out_map = []
    for src, i in getattr(plan, "output_map", []):
        out_map.append(("agg", i) if src == "agg" else ("gb", i))
    if len(out_map) != len(plan.schema.columns):
        return None
    return out_map


def _spec_program(specs, pt: ParamTable):
    """ONE HK7 program computing every spec's argument lane (COUNT keeps
    only the NULL mask), per spec its output index (None for
    count_star), and the specs' shape key; constants ride ``pt``."""
    outs = []
    lane_of = []
    keys = []
    for kind, a in specs:
        if a is None:
            lane_of.append(None)
            keys.append(kind)
            continue
        outs.append(("null", a) if kind == "count" else a)
        lane_of.append(len(outs) - 1)
        keys.append(f"{kind}:{stable_shape_key(a)}")
    return compile_program((), outs, pt), lane_of, tuple(keys)


def _spec_lanes(spec_kinds, prog, lane_of, pairs, pr, nb: int):
    """The reduction lanes of the specs — (values, null, op) with sum0
    summing and count reading only the NULL mask — from one HK7 launch,
    and per spec its lane index (-1 for count_star, which is the
    presence row)."""
    outs = kernels.expr_eval(prog, pairs, pr, nb)[1] if prog.outputs \
        else []
    lanes, lane_idx = [], []
    for kind, j in zip(spec_kinds, lane_of):
        if kind == "count_star":
            lane_idx.append(-1)
            continue
        av, an = outs[j]
        if kind == "count":
            lanes.append((None, an, "count"))
        else:
            lanes.append((av, an, "sum" if kind == "sum0" else kind))
        lane_idx.append(len(lanes) - 1)
    return lanes, lane_idx


def _spec_results(spec_kinds, lanes, lane_of, table):
    """Per spec (values, null) from a reduction table in HK2's layout
    (presence, first row, then per lane value bits and live count) — the
    NULL-when-empty semantics live ONCE here for both aggregation nodes:
    counts are never NULL, SUM/MIN/MAX are NULL over no live row, sum0 (a
    merged COUNT) is 0 over empty input."""
    never = torch.zeros(int(table.shape[1]), dtype=torch.bool,
                        device=table.device)
    res = []
    for kind, j in zip(spec_kinds, lane_of):
        if kind == "count_star":
            res.append((table[0], never))
            continue
        cnt = table[3 + 2 * j]
        if kind == "count":
            res.append((cnt, never))
            continue
        bits = table[2 + 2 * j]
        v = bits.view(torch.float64) \
            if lanes[j][0].dtype == torch.float64 else bits
        res.append((v, never if kind == "sum0" else cnt == 0))
    return res


def _slot_outputs(res, slots):
    """Descriptor outputs from spec results: direct, or the avg quotient
    (NULL when the count is zero)."""
    outs = []
    for slot in slots:
        if slot[0] == "one":
            outs.append(res[slot[1]])
        else:
            sv, _ = res[slot[1]]
            cv, _ = res[slot[2]]
            q = sv / torch.clamp(cv, min=1).to(sv.dtype)
            outs.append((q, cv == 0))
    return outs


def _gb_key_ok(e) -> bool:
    """Group keys the device nodes handle: plain columns — signed ints,
    reals, or strings (dictionary codes on device)."""
    if not isinstance(e, ExprColumn):
        return False
    if e.eval_type is EvalType.INT \
            and getattr(e.ret_type, "is_unsigned", False):
        return False
    return True


class _AggIndexNode:
    """GROUP BY directly over the columnar replica, via the group index:
    filter mask, then one HK5 reduction of each group's run in the
    index's sorted order.  Multi-column keys group by the tuple (strings
    ride dictionary codes); the index is built ONCE per (replica version,
    key set) and memoized, so a per-query aggregate is one kernel call
    over [nb] with an [ngb] output."""

    def __init__(self, leaf: _ReplicaLeaf, plan, key_cols, specs, slots,
                 out_map):
        self.leaf = leaf
        self.plan = plan
        self.key_cols = key_cols    # [ExprColumn]
        self.specs = specs
        self.slots = slots
        self.out_map = out_map      # schema slot -> ("agg", i) | ("gb", j)
        self.gidx: Optional[GroupIndex] = None
        self._sids: Optional[tuple] = None

    @staticmethod
    def compile(plan: PhysicalHashAgg, ctx: _Ctx):
        if not plan.group_by:
            return None
        if not all(_gb_key_ok(e) for e in plan.group_by):
            return None
        child = plan.children[0]
        if not isinstance(child, PhysicalTableReader):
            return None
        leaf = _ReplicaLeaf.compile(child, ctx)
        if leaf is None:
            return None
        got = _assemble_agg_specs(plan)
        out_map = _agg_out_map(plan)
        if got is None or out_map is None:
            leaf.close()
            return None
        specs, slots = got
        return _AggIndexNode(leaf, plan, list(plan.group_by), specs, slots,
                             out_map)

    def _host_key_cols(self, rep):
        """[(vals, nulls)] per key column (codes for strings), their
        stable slot ids, and decode tables."""
        from .gpu_executors import _rep_string_dict, _slot_id
        chk = self.leaf.chunk()
        key_cols, sids, decodes = [], [], []
        for e in self.key_cols:
            idx = e.index
            sid = _slot_id(self.leaf.ex, idx)
            if sid == "handle":
                kv = rep.handles
                km = np.zeros(rep.n_rows, dtype=bool)
                decode = None
            elif e.eval_type is EvalType.STRING:
                got = _rep_string_dict(rep, sid, chk, idx)
                if got is None:
                    return None
                kv = got[0]
                km = chk.columns[idx].null_mask()
                decode = got[3]
            else:
                kv, km = rep.columns[sid]
                decode = None
            key_cols.append((kv, km))
            sids.append(sid)
            decodes.append(decode)
        return key_cols, tuple(sids), decodes

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        tv = self.leaf.prepare(pb)
        if tv is None:
            return None
        rep = self.leaf.replica()
        got = self._host_key_cols(rep)
        if got is None:
            return None
        key_cols, sids, decodes = got
        gidx = _group_index(rep, sids, key_cols)
        self.gidx = gidx
        self._sids = sids
        ng = gidx.n_groups
        ngb = kernels.bucket(max(ng, 1))
        nb = tv.nb
        io = pb.add(_dev_upload(rep, ("gi_order", sids, nb),
                                lambda: kernels.pad1(gidx.order, nb)))
        ie = pb.add(_dev_upload(rep, ("gi_ends", sids, ngb),
                                lambda: kernels.pad1(
                                    gidx.ends, ngb,
                                    fill=max(rep.n_rows - 1, 0))))
        gb_slots = []
        for j, (gk, gn) in enumerate(gidx.keycols):
            ik = pb.add(_dev_upload(rep, ("gi_gkeys", sids, j, ngb),
                                    lambda gk=gk: kernels.pad1(gk, ngb)))
            ikn = pb.add(_dev_upload(rep, ("gi_gknull", sids, j, ngb),
                                     lambda gn=gn: kernels.pad1(gn, ngb,
                                                                True)))
            gb_slots.append((ik, ikn))
        ing = pb.add(ng)
        irows = pb.add(rep.n_rows)
        pt = ParamTable()
        prog, prog_lanes, keys = _spec_program(self.specs, pt)
        ip, fp = pb.params(pt)
        # the cache key must pin EVERYTHING the closure depends on: key
        # column ids + dtypes, the descriptor->spec slot mapping, and the
        # output column map
        kdts = tuple((str(s), str(gk.dtype))
                     for s, (gk, _) in zip(sids, gidx.keycols))
        pb.key(("aggindex", keys, kdts, tuple(self.slots),
                tuple(self.out_map), nb, ngb))
        spec_kinds = [k for k, _ in self.specs]
        slots = self.slots
        out_map = self.out_map
        schema_cols = self.plan.schema.columns

        def emit(args):
            valid, pairs = tv.emit(args)
            pr = (args[ip], args[fp])
            n_groups = args[ing]
            lanes, lane_of = _spec_lanes(spec_kinds, prog, prog_lanes, pairs,
                                         pr, nb)
            # sorted positions past the table's rows are padding (they map
            # to row 0) and groups past n_groups are padding: HK5 reads
            # neither
            table = kernels.csr_reduce(args[io], args[ie], valid, lanes,
                                       args[irows], n_groups)
            res = _spec_results(spec_kinds, lanes, lane_of, table)
            outs = _slot_outputs(res, slots)
            gvalid = (kernels._arange(ngb) < n_groups) & (table[0] > 0)
            cols = []
            for m in out_map:
                if m[0] == "agg":
                    cols.append(outs[m[1]])
                else:
                    cols.append((args[gb_slots[m[1]][0]],
                                 args[gb_slots[m[1]][1]]))
            return gvalid, cols
        meta = []
        for oc, m in zip(schema_cols, out_map):
            decode = decodes[m[1]] if m[0] == "gb" else None
            meta.append((oc.ret_type, decode))
        return _TView(emit, ngb, meta)

    def build_key_info(self):
        """(lo, hi, pos_table np) for the parent join — static per
        replica version (single-int-key indexes only)."""
        rep = self.leaf.replica()
        got = self._host_key_cols(rep)
        if got is None:
            return None
        _, sids, _ = got

        def mk():
            tbl = self.gidx.pos_table()
            if tbl is None:
                return None
            return self.gidx.lo, self.gidx.hi, tbl
        return rep.memo(("gi_postable", sids), mk)

    def key_slot(self) -> int:
        """Schema slot of the (single) group key in the output view."""
        if len(self.key_cols) != 1:
            return -1
        for i, slot in enumerate(self.out_map):
            if slot[0] == "gb":
                return i
        return -1

    def close(self):
        self.leaf.close()


class _JoinNode:
    """Equi-join on int keys — a single key directly, or several keys
    combined into one COMPOSITE lane (sum((k_i - lo_i) * stride_i), a
    bijection over the bounded cross range).  Device layouts:

    - unique build (planner-proven pk/unique, or a group-index
      aggregate): a dense key -> row table, one HK6 probe per pipeline
      (:func:`kernels.dense_probe`, :func:`kernels.dense_probe_multi` for
      the composite lane), probe-shaped output, no expansion.  Semi / anti
      joins fold the same membership test into the probe side's validity.
    - general multiplicity: the build replica's group index is a CSR
      layout; HK8 :func:`kernels.csr_expand` maps each probe key to its
      group through the dense table, counts the group's valid rows and
      expands into a static bucket the host bounds at prepare time from
      the pre-filter group sizes (so no count is pulled mid-pipeline).
    """

    def __init__(self, probe, build, probe_keys, build_keys, tp,
                 probe_is_left, plan, mesh=None, mult=False,
                 session_vars=None):
        self.probe = probe
        self.build = build
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.probe_key = self.probe_keys[0]
        self.build_key = self.build_keys[0]
        self.nk = len(self.probe_keys)
        self.tp = tp
        self.probe_is_left = probe_is_left
        self.plan = plan
        self.mesh = mesh
        self.mult = mult
        self.session_vars = session_vars or {}
        self.n_mesh = int(mesh.n_shards) if mesh is not None else 0

    @staticmethod
    def compile(plan: PhysicalHashJoin, ctx: _Ctx):
        if isinstance(plan, PhysicalMergeJoin):
            return None
        if plan.tp not in ("inner", "left", "semi", "anti"):
            return None
        if not plan.left_keys or plan.other_conditions \
                or len(plan.left_keys) != len(plan.right_keys):
            return None
        for k in list(plan.left_keys) + list(plan.right_keys):
            if not isinstance(k, ExprColumn) \
                    or k.eval_type is not EvalType.INT \
                    or getattr(k.ret_type, "is_unsigned", False):
                return None
        if getattr(plan, "left_conditions", None) \
                or getattr(plan, "right_conditions", None):
            return None  # side conds live in Selections below by now
        nk = len(plan.left_keys)
        lk, rk = plan.left_keys[0], plan.right_keys[0]
        mult = False
        if plan.tp in ("semi", "anti"):
            # semi/anti = a VALIDITY filter on the probe view: the build
            # side's dense pos-table answers membership, so the build
            # must be planner-proven unique; the NOT IN null-aware ladder
            # falls to the per-op executor
            if nk != 1 or getattr(plan, "null_aware", False) \
                    or not getattr(plan, "right_unique", False):
                return None
            build = _compile_node(plan.children[1], ctx)
            if build is None:
                return None
            if not _has_build_key_info(build, rk):
                _close_node(build)
                return None
            probe = _compile_node(plan.children[0], ctx)
            if probe is None:
                _close_node(build)
                return None
            return _JoinNode(probe, build, [lk], [rk], plan.tp, True, plan,
                             mesh=ctx.mesh,
                             session_vars=getattr(ctx.exec_ctx,
                                                  "session_vars", None))
        if nk > 1:
            # multi-key: composite lane over a dense range, leaf/sel
            # build sides only; non-unique key sets ride the same CSR
            # expansion as single keys, over the composite lane
            build_side, probe_side = 1, 0
            build_keys = list(plan.right_keys)
            probe_keys = list(plan.left_keys)
            mult = not getattr(plan, "right_unique", False)
        elif getattr(plan, "right_unique", False):
            build_side, probe_side = 1, 0
            build_keys, probe_keys = [rk], [lk]
        elif getattr(plan, "left_unique", False) and plan.tp == "inner":
            build_side, probe_side = 0, 1
            build_keys, probe_keys = [lk], [rk]
        else:
            # general multiplicity: build stays the right child (the
            # probe must stay the outer side of a LEFT join), CSR over
            # the build replica's group index
            build_side, probe_side = 1, 0
            build_keys, probe_keys = [rk], [lk]
            mult = True
        build = _compile_node(plan.children[build_side], ctx)
        if build is None:
            return None
        ok = _leafish(build) is not None if (nk > 1 or mult) \
            else _has_build_key_info(build, build_keys[0])
        if not ok:
            _close_node(build)
            return None
        probe = _compile_node(plan.children[probe_side], ctx)
        if probe is None:
            _close_node(build)
            return None
        return _JoinNode(probe, build, probe_keys, build_keys, plan.tp,
                         probe_side == 0, plan, mesh=ctx.mesh, mult=mult,
                         session_vars=getattr(ctx.exec_ctx,
                                              "session_vars", None))

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        btv = self.build.prepare(pb)
        if btv is None:
            return None
        ptv = self.probe.prepare(pb)
        if ptv is None:
            return None
        if self.tp in ("semi", "anti"):
            return self._prepare_semi(pb, btv, ptv)
        if self.mult:
            return self._prepare_mult(pb, btv, ptv)
        if self.nk > 1:
            return self._prepare_unique_multi(pb, btv, ptv)
        return self._prepare_unique(pb, btv, ptv)

    def _joined(self, valid_out, pcols, bcols):
        """The join's view: the probe side's columns first when it is
        the plan's left child."""
        if self.probe_is_left:
            return valid_out, list(pcols) + list(bcols)
        return valid_out, list(bcols) + list(pcols)

    def _meta(self, ptv, btv):
        return ptv.meta + btv.meta if self.probe_is_left \
            else btv.meta + ptv.meta

    # ---- semi / anti: membership folds into probe validity -------------

    def _prepare_semi(self, pb, btv, ptv) -> Optional[_TView]:
        """Semi/anti join as a validity AND over the probe view: the
        probe's pairs pass through untouched, so a join chain with an
        interleaved semijoin stays one pipeline."""
        info = _prepare_build_key_info(self.build, self.build_key, pb)
        if info is None:
            return None
        lo, hi, it, tbl_len = info
        ilo, ihi = pb.add(lo), pb.add(hi)
        nb, nbb = ptv.nb, btv.nb
        pk_slot = self.probe_key.index
        mode = self.tp
        pb.key(("semijoin", mode == "anti", nb, nbb, tbl_len, pk_slot,
                len(ptv.meta), len(btv.meta)))

        def emit(args):
            bvalid, bpairs = btv.emit(args)
            pvalid, ppairs = ptv.emit(args)
            kp, knull = ppairs[pk_slot]
            # anti (NOT EXISTS shape, never null-aware here): a NULL probe
            # key matches nothing and therefore SURVIVES
            valid_out, _ = kernels.dense_probe(
                kp, knull, pvalid, args[ilo], args[ihi], args[it], bvalid,
                bpairs, mode)
            return valid_out, list(ppairs)
        return _TView(emit, nb, ptv.meta)

    # ---- multi-key unique build: composite lane + dense table ----------

    def _host_raw_key_cols(self, node, keys):
        """Raw host (vals, nulls) per key over a leaf/sel chain, plus the
        (replica, stable slot ids)."""
        leaf = _leafish(node)
        if leaf is None:
            return None
        rep = leaf.replica()
        if rep is None:
            return None
        from .gpu_executors import _slot_id
        cols, sids = [], []
        for k in keys:
            sid = _slot_id(leaf.ex, k.index)
            if sid == "handle":
                kv = rep.handles
                km = np.zeros(rep.n_rows, dtype=bool)
            else:
                kv, km = rep.columns[sid]
            if kv.dtype != np.int64:
                return None
            cols.append((kv, km))
            sids.append(sid)
        return rep, tuple(sids), cols

    def _prepare_unique_multi(self, pb, btv, ptv) -> Optional[_TView]:
        got = self._host_raw_key_cols(self.build, self.build_keys)
        if got is None:
            return None
        rep, sids, cols = got
        # per replica version: the full-column min/max scans + composite
        # lane build amortize like the single-key bounds/pos tables
        spec = rep.memo(("composite_spec", sids),
                        lambda: _composite_spec(cols))
        if spec is None:
            return None
        los, his, strides, comp, null_any, total = spec
        nb, nbb = ptv.nb, btv.nb
        pk_slots = tuple(k.index for k in self.probe_keys)
        mode = "left" if self.tp == "left" else "inner"

        def mk():
            # dense composite -> build row (uniqueness over the key SET
            # is planner-proven; rows with any NULL key never match)
            tbl = np.full(total, -1, dtype=np.int32)
            live = ~null_any
            tbl[comp[live]] = np.nonzero(live)[0].astype(np.int32)
            return tbl
        it = pb.add(_dev_upload(rep, ("postable_multi", sids), mk))
        ispec = pb.add(tuple(zip(los, his, strides)))
        pb.key(("joinmk", nb, nbb, total, pk_slots, mode == "left",
                self.probe_is_left, len(btv.meta), len(ptv.meta)))

        def emit(args):
            bvalid, bpairs = btv.emit(args)
            pvalid, ppairs = ptv.emit(args)
            valid_out, gathered = kernels.dense_probe_multi(
                [ppairs[i] for i in pk_slots], args[ispec], pvalid,
                args[it], bvalid, bpairs, mode)
            return self._joined(valid_out, ppairs, gathered)
        return _TView(emit, nb, self._meta(ptv, btv))

    # ---- unique build side: dense pos table + gather -------------------

    def _host_key_lane(self, node, key: ExprColumn):
        """The raw (pre-filter) host values of a node view's key lane
        (unpadded), the live row count, and a (rep, memo_key) handle for
        replica-backed lanes so the capacity histogram memoizes per
        replica version.  None = no host-visible keys (broadcast)."""
        if isinstance(node, _SelNode):
            return self._host_key_lane(node.child, key)
        if isinstance(node, _ReplicaLeaf):
            rep = node.replica()
            if rep is None:
                return None
            from .gpu_executors import _slot_id
            sid = _slot_id(node.ex, key.index)
            kv = rep.handles if sid == "handle" else rep.columns[sid][0]
            if kv.dtype != np.int64:
                return None
            return kv, rep.n_rows, (rep, ("shufcap", sid))
        if isinstance(node, _AggIndexNode):
            if node.gidx is None or node.key_slot() != key.index:
                return None
            gk = node.gidx.gkeys
            if gk.dtype != np.int64:
                return None
            rep = node.leaf.replica()
            return gk, node.gidx.n_groups, (rep, ("shufcap_gi",
                                                  node._sids))
        if isinstance(node, _HostLeaf):
            chk = node.chunk()
            if chk is None:
                return None
            v = chk.columns[key.index].values()
            if v.dtype != np.int64:
                return None
            return v, chk.num_rows(), None  # per-query data: no memo
        return None

    @staticmethod
    def _shuffle_cap_of(lane, nbucket: int, n: int) -> int:
        from ..parallel import dist
        kv, n_rows, memo = lane

        def calc():
            return dist.shuffle_cap(kernels.pad1(kv, nbucket), n, n_rows)
        if memo is None:
            return calc()
        rep, mkey = memo
        return rep.memo(mkey + (nbucket, n), calc)

    @staticmethod
    def _broadcast_default() -> int:
        """The sysvar's shipped default: a session value differing from
        it is an explicit operator override."""
        from ..session.session import DEFAULT_SYSVARS
        return int(DEFAULT_SYSVARS["tidb_broadcast_build_max_rows"])

    def _shuffle_wanted(self, nb: int, nbb: int, mesh) -> bool:
        """Broadcast-vs-shuffle strategy: the planner decides by cost
        (planner/device.py _mesh_join_strategy); the
        tidb_broadcast_build_max_rows knob applies only when set away
        from its default, and a plan-time broadcast stays subject to it
        at run time (the actual build bucket may outgrow the
        estimate)."""
        if mesh is None:
            return False
        n = int(mesh.n_shards)
        if n & (n - 1) or nb % n or nbb % n:
            return False
        default = self._broadcast_default()
        try:
            thresh = int(self.session_vars.get(
                "tidb_broadcast_build_max_rows", default))
        except (TypeError, ValueError):
            return False
        if thresh != default:
            return nbb > thresh  # explicit knob override
        if getattr(self.plan, "mesh_strategy", None) == "shuffle":
            return True
        return nbb > thresh

    def _prepare_unique_shuffle(self, pb, btv, ptv, mesh) \
            -> Optional[_TView]:
        """The partitioned-build mesh join (K18 shuffle): both sides are
        exchanged all-to-all by key hash (HK13), then every shard joins
        its partition locally (HK4 + HK12) and the build columns gather
        at the matched slots.  Returns None where the reference does — no
        host key lane on either side, or a skew gate — and the broadcast
        mode runs.  The view is the received probe layout: n * n * capp
        slots, shard-major, as the reference's shard_map output."""
        from ..parallel import dist
        n = int(mesh.n_shards)
        nb, nbb = ptv.nb, btv.nb
        got_p = self._host_key_lane(self.probe, self.probe_key)
        got_b = self._host_key_lane(self.build, self.build_key)
        if got_p is None or got_b is None:
            return None
        capp = self._shuffle_cap_of(got_p, nb, n)
        capb = self._shuffle_cap_of(got_b, nbb, n)
        from ..ops import shardops
        if n * n * capp > max(MAX_EXPAND, 2 * nb) \
                or n * n * capb > max(MAX_EXPAND, 2 * nbb):
            shardops.record_skew_retry()
            return None
        irows = pb.add((got_p[1], got_b[1]))
        pk_slot = self.probe_key.index
        bk_slot = self.build_key.index
        outer = self.tp == "left"
        npc, nbc = len(ptv.meta), len(btv.meta)
        pb.key(("joinshuf", nb, nbb, capp, capb, pk_slot, bk_slot, outer,
                self.probe_is_left, nbc, npc, n))
        # the exchange's lane volume per dispatch (value + NULL byte per
        # slot, plus the validity lane) and one round at the receive HWM
        shardops.record_exchange(n * capp * (9 * npc + 1)
                                 + n * capb * (9 * nbc + 1))
        shardops.note_round(max(n * capp, n * capb))

        def exchange(pairs, valid, slot, n_rows, cap):
            lanes = []
            for v, m in pairs:
                lanes += [(v, 0), (torch.zeros_like(valid) if m is None
                                   else m, True)]
            lanes.append((valid, False))
            got = dist.exchange_lanes(pairs[slot][0], n_rows, lanes, cap, n)
            return ([(got[2 * i], got[2 * i + 1])
                     for i in range(len(pairs))], got[-1])

        def emit(args):
            bvalid, bpairs = btv.emit(args)
            pvalid, ppairs = ptv.emit(args)
            pn_rows, bn_rows = args[irows]
            pcols, pv_r = exchange(ppairs, pvalid, pk_slot, pn_rows, capp)
            bcols, bv_r = exchange(bpairs, bvalid, bk_slot, bn_rows, capb)
            bk_r, bkn_r = bcols[bk_slot]
            pk_r, pkn_r = pcols[pk_slot]
            hit, brow = dist.local_unique_join(bk_r, bv_r & ~bkn_r, pk_r, n)
            matched = hit & ~pkn_r & pv_r
            valid_out = pv_r if outer else matched
            at = brow.clamp(min=0)
            gathered = [(v[at], m[at] | ~matched) for v, m in bcols]
            return self._joined(valid_out, pcols, gathered)
        return _TView(emit, n * n * capp, self._meta(ptv, btv))

    def _prepare_unique(self, pb, btv, ptv) -> Optional[_TView]:
        from ..parallel import dist
        if self._shuffle_wanted(ptv.nb, btv.nb,
                                self.mesh if dist.shardable(ptv.nb,
                                                            self.mesh)
                                else None):
            out = self._prepare_unique_shuffle(pb, btv, ptv, self.mesh)
            if out is not None:
                return out  # else: broadcast below
        info = _prepare_build_key_info(self.build, self.build_key, pb)
        if info is None:
            return None
        lo, hi, it, tbl_len = info
        ilo, ihi = pb.add(lo), pb.add(hi)
        nb, nbb = ptv.nb, btv.nb
        pk_slot = self.probe_key.index
        mode = "left" if self.tp == "left" else "inner"
        # the mesh's broadcast mode: the probe shards over the mesh and
        # the build table replicates; on one device every shard's probe
        # block is its row range of the probe lanes, so one HK6 launch
        # over the lanes as they lie is every shard's probe, and its
        # output is the reference's shard-major layout of nb rows
        n_mesh = self.n_mesh if dist.shardable(nb, self.mesh) else 0
        pb.key(("join", nb, nbb, tbl_len, pk_slot, mode == "left",
                self.probe_is_left, len(btv.meta), len(ptv.meta), n_mesh))

        def emit(args):
            bvalid, bpairs = btv.emit(args)
            pvalid, ppairs = ptv.emit(args)
            kp, knull = ppairs[pk_slot]
            valid_out, gathered = kernels.dense_probe(
                kp, knull, pvalid, args[ilo], args[ihi], args[it], bvalid,
                bpairs, mode)
            return self._joined(valid_out, ppairs, gathered)
        return _TView(emit, nb, self._meta(ptv, btv))

    # ---- general multiplicity: CSR over the build group index ----------

    def _prepare_mult(self, pb, btv, ptv) -> Optional[_TView]:
        from .gpu_executors import _slot_id
        leaf = _leafish(self.build)
        rep = leaf.replica()
        if rep is None:
            return None
        cspec = None
        if self.nk > 1:
            # multi-key CSR: group index over the composite lane
            got = self._host_raw_key_cols(self.build, self.build_keys)
            if got is None:
                return None
            rep, sids0, bcols_host = got
            cspec = rep.memo(("composite_spec", sids0),
                             lambda: _composite_spec(bcols_host))
            if cspec is None:
                return None
            kv, km = cspec[3], cspec[4]
            sids = ("comp",) + sids0
        else:
            sid = _slot_id(leaf.ex, self.build_key.index)
            if sid == "handle":
                kv, km = rep.handles, np.zeros(rep.n_rows, dtype=bool)
            else:
                kv, km = rep.columns[sid]
            sids = (sid,)
        gidx = _group_index(rep, sids, [(kv, km)])

        def mk():
            tbl = gidx.pos_table()
            return None if tbl is None else (gidx.lo, gidx.hi, tbl)
        got = rep.memo(("gi_postable", sids), mk)
        if got is None:
            return None
        lo, hi, tbl = got
        raw = gidx.raw_counts()
        outer = self.tp == "left"
        per_probe = self._per_probe_counts(raw, tbl, lo, hi, ptv, outer,
                                           cspec=cspec)
        # the mesh mode shards the probe side, each shard expanding its
        # rows into its own bucket over the broadcast CSR structures; the
        # per-shard bound needs host probe keys, and a probe skew past it
        # retries unsharded (counted)
        from ..parallel import dist
        n_mesh = self.n_mesh if per_probe is not None \
            and dist.shardable(ptv.nb, self.mesh) else 0
        ob = self._expand_bucket(raw, ptv, outer, per_probe,
                                 shards=max(n_mesh, 1))
        if ob is None and n_mesh:
            from ..ops import shardops
            shardops.record_skew_retry()
            n_mesh = 0
            ob = self._expand_bucket(raw, ptv, outer, per_probe)
        if ob is None:
            return None
        nbb = btv.nb          # build bucket == leaf bucket (sel keeps nb)
        ng = gidx.n_groups
        ngb = kernels.bucket(max(ng, 1))
        tbl_len = int(tbl.shape[0])
        pk_slots = tuple(k.index for k in self.probe_keys)
        io = pb.add(_dev_upload(rep, ("gi_order", sids, nbb),
                                lambda: kernels.pad1(gidx.order, nbb)))
        ie = pb.add(_dev_upload(rep, ("gi_ends", sids, ngb),
                                lambda: kernels.pad1(
                                    gidx.ends, ngb,
                                    fill=max(rep.n_rows - 1, 0))))
        it = pb.add(_dev_upload(rep, ("gi_postable_dev", sids),
                                lambda: tbl))
        # sizes and bounds are launch arguments: positional inputs, so a
        # registered pipeline re-binds the current replica version's
        iscal = pb.add((ng, rep.n_rows, lo, hi))
        ispec = pb.add(None if cspec is None
                       else tuple(zip(cspec[0], cspec[1], cspec[2])))
        nb = ptv.nb
        pb.key(("joinm", nb, nbb, ngb, ob, tbl_len, pk_slots, outer,
                self.probe_is_left, len(btv.meta), len(ptv.meta), n_mesh))
        shards = max(n_mesh, 1)

        def emit(args):
            bvalid, bpairs = btv.emit(args)
            pvalid, ppairs = ptv.emit(args)
            ng_, n_rows, lo_, hi_ = args[iscal]
            valid_out, pcols, bcols = kernels.csr_expand(
                args[io], args[ie], ng_, n_rows, bvalid, args[it], lo_, hi_,
                [ppairs[i] for i in pk_slots], args[ispec], pvalid, outer,
                ob, ppairs, bpairs, shards=shards)
            return self._joined(valid_out, pcols, bcols)
        return _TView(emit, ob * shards, self._meta(ptv, btv))

    def _per_probe_counts(self, raw, tbl, lo, hi, ptv, outer, cspec=None):
        """Host per-probe-row match-count UPPER bounds (pre-filter group
        sizes; filters only shrink), padded to the probe bucket.  None
        when the probe side has no host-visible keys."""
        from .gpu_executors import _slot_id
        pkv = pkm = None
        if cspec is not None:
            got = self._host_raw_key_cols(self.probe, self.probe_keys)
            if got is not None:
                _, _, pcols = got
                los, his, strides = cspec[0], cspec[1], cspec[2]
                pkm = np.zeros(len(pcols[0][0]), dtype=bool)
                pkv = np.zeros(len(pcols[0][0]), dtype=np.int64)
                for (kvj, kmj), klo, khi, kst in zip(pcols, los, his,
                                                     strides):
                    pkm |= kmj | (kvj < klo) | (kvj > khi)
                    pkv += (np.clip(kvj, klo, khi) - klo) * kst
        else:
            pleaf = _leafish(self.probe)
            if pleaf is not None:
                prep = pleaf.replica()
                if prep is not None:
                    psid = _slot_id(pleaf.ex, self.probe_key.index)
                    if psid == "handle":
                        pkv = prep.handles
                        pkm = np.zeros(prep.n_rows, dtype=bool)
                    else:
                        pkv, pkm = prep.columns[psid]
        if pkv is None:
            return None
        inr = (~pkm) & (pkv >= lo) & (pkv <= hi)
        gsafe = np.where(inr, pkv - lo, 0)
        g = np.where(inr, tbl[gsafe], -1)
        per = np.where(g >= 0, raw[np.clip(g, 0, max(len(raw) - 1, 0))],
                       0)
        if outer:
            per = np.maximum(per, 1)
        return kernels.pad1(per.astype(np.int64), ptv.nb)

    def _expand_bucket(self, raw, ptv, outer, per_probe, shards: int = 1):
        """Static (per-shard) output bucket for the CSR expansion.  None =
        too large: the per-operator tier takes the plan (or, over shards,
        the single-device expansion does)."""
        if per_probe is None:
            mx = int(raw.max()) if len(raw) else 0
            bound = ptv.nb * max(mx, 1 if outer else 0)
        elif shards > 1:
            blk = ptv.nb // shards
            bound = int(per_probe.reshape(shards, blk).sum(axis=1).max())
        else:
            bound = int(per_probe.sum())
        if bound * shards > MAX_EXPAND:
            return None
        return kernels.bucket(max(bound, 1))

    def close(self):
        _close_node(self.probe)
        _close_node(self.build)


class _SortGroupNode:
    """GROUP BY above an arbitrary device view (join outputs included):
    HK4 sorts the view by its key lanes (valid rows first, NULL first),
    HK9 finds the runs of equal keys (their leaders, ends and count, all
    on the card), and HK5 reduces each run in sorted order over
    (perm, ends).  Each group sums only its own rows: the reference
    differenced one cumsum over the whole sorted lane (R7).  Output view:
    group g at slot g of the child-sized bucket, valid = g < the count."""

    def __init__(self, child, key_cols, specs, slots, out_map, plan):
        self.child = child
        self.key_cols = key_cols
        self.specs = specs
        self.slots = slots
        self.out_map = out_map
        self.plan = plan

    @staticmethod
    def compile(plan: PhysicalHashAgg, ctx: _Ctx):
        if not plan.group_by:
            return None
        if not all(_gb_key_ok(e) for e in plan.group_by):
            return None
        got = _assemble_agg_specs(plan)
        out_map = _agg_out_map(plan)
        if got is None or out_map is None:
            return None
        specs, slots = got
        child = _compile_node(plan.children[0], ctx)
        if child is None:
            return None
        return _SortGroupNode(child, list(plan.group_by), specs, slots,
                              out_map, plan)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        tv = self.child.prepare(pb)
        if tv is None:
            return None
        nb = tv.nb
        key_idx = []
        decodes = []
        for e in self.key_cols:
            if e.index >= len(tv.meta):
                return None
            decode = tv.meta[e.index][1]
            if e.eval_type is EvalType.STRING and decode is None:
                return None  # string key without device codes
            key_idx.append(e.index)
            decodes.append(decode)
        pt = ParamTable()
        prog, prog_lanes, keys = _spec_program(self.specs, pt)
        ip, fp = pb.params(pt)
        pb.key(("sortgroup", keys, tuple(key_idx), tuple(self.slots),
                tuple(self.out_map), nb, len(tv.meta)))
        spec_kinds = [k for k, _ in self.specs]
        slots = self.slots
        out_map = self.out_map
        nkeys = len(key_idx)

        def emit(args):
            valid, pairs = tv.emit(args)
            kvs = [pairs[i] for i in key_idx]
            # the reference's _sort_ops: NULL first, invalid rows last,
            # ties by row
            perm = kernels.lex_order(
                kernels.sort_lanes(kvs, (False,) * nkeys, valid), nb)
            count, lead, ends, _ = kernels.run_bounds(perm, valid, kvs)
            lanes, lane_of = _spec_lanes(spec_kinds, prog, prog_lanes, pairs,
                                         (args[ip], args[fp]), nb)
            # ends past the count repeat the last group's end: HK5 sees
            # empty runs there, so the count never leaves the card
            table = kernels.csr_reduce(perm, ends, valid, lanes, nb, nb)
            res = _spec_results(spec_kinds, lanes, lane_of, table)
            outs = _slot_outputs(res, slots)
            gvalid = kernels._arange(nb) < count
            lead_rows = perm[lead]
            cols = []
            for m in out_map:
                if m[0] == "agg":
                    cols.append(outs[m[1]])
                else:
                    v, n = kvs[m[1]]
                    cols.append((v[lead_rows], n[lead_rows] | ~gvalid))
            return gvalid, cols
        meta = []
        for oc, m in zip(self.plan.schema.columns, out_map):
            decode = decodes[m[1]] if m[0] == "gb" else None
            meta.append((oc.ret_type, decode))
        return _TView(emit, nb, meta)

    def close(self):
        _close_node(self.child)


class _ScalarAggNode:
    """Global (no GROUP BY) aggregation over any device view — one HK1
    masked reduction, one output row at slot 0 of a minimal bucket.
    Keeps scalar aggregates above joins on the device, including FINAL
    partial-state merges from agg pushdown."""

    def __init__(self, child, specs, slots, out_map, plan):
        self.child = child
        self.specs = specs
        self.slots = slots
        self.out_map = out_map
        self.plan = plan

    @staticmethod
    def compile(plan: PhysicalHashAgg, ctx: _Ctx):
        if plan.group_by:
            return None
        got = _assemble_agg_specs(plan)
        if got is None:
            return None
        specs, slots = got
        out_map = _agg_out_map(plan)
        if out_map is None or any(m[0] != "agg" for m in out_map):
            return None
        child = _compile_node(plan.children[0], ctx)
        if child is None:
            return None
        return _ScalarAggNode(child, specs, slots, out_map, plan)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        tv = self.child.prepare(pb)
        if tv is None:
            return None
        ob = 16  # minimal bucket; the one result row sits at slot 0
        pt = ParamTable()
        prog, prog_lanes, keys = _spec_program(self.specs, pt)
        ip, fp = pb.params(pt)
        nb = tv.nb
        pb.key(("scalaragg", keys, tuple(self.slots), tuple(self.out_map),
                nb, len(tv.meta)))
        spec_kinds = [k for k, _ in self.specs]
        slots = self.slots
        out_map = self.out_map
        schema_cols = self.plan.schema.columns

        def emit(args):
            valid, pairs = tv.emit(args)
            pr = (args[ip], args[fp])
            lanes, lane_of = _spec_lanes(spec_kinds, prog, prog_lanes, pairs,
                                         pr, nb)
            red = kernels.masked_reduce(valid.contiguous(), lanes)
            # HK1's [n_valid, first, (value, count)...] as column 0 of a
            # table in HK2's layout: the shared per-spec semantics apply
            table = torch.zeros((int(red.shape[0]), ob), dtype=red.dtype,
                                device=red.device)
            table[:, 0] = red
            res = _spec_results(spec_kinds, lanes, lane_of, table)
            outs = _slot_outputs(res, slots)
            gvalid = kernels._arange(ob) == 0  # exactly one result row
            return gvalid, [outs[m[1]] for m in out_map]
        meta = [(oc.ret_type, None) for oc in schema_cols]
        return _TView(emit, ob, meta)

    def close(self):
        _close_node(self.child)


def _leafish(node) -> Optional[_ReplicaLeaf]:
    """The underlying replica leaf of a leaf/selection chain (selection
    preserves the schema, so column offsets map straight through)."""
    if isinstance(node, _ReplicaLeaf):
        return node
    if isinstance(node, _SelNode):
        return _leafish(node.child)
    return None


def _has_build_key_info(node, build_key) -> bool:
    if isinstance(node, _AggIndexNode):
        return node.key_slot() == build_key.index
    if isinstance(node, _ReplicaLeaf):
        return True  # bounds checked at prepare time
    if isinstance(node, _SelNode):
        return _has_build_key_info(node.child, build_key)
    if isinstance(node, _ProjNode):
        # identity output: row space unchanged, key lives at the child
        # slot the projection reads (a subquery's final projection)
        e = node.exprs[build_key.index]
        return isinstance(e, ExprColumn) \
            and _has_build_key_info(node.child, e)
    return False


def _prepare_build_key_info(node, build_key, pb: _PipeBuilder):
    """(lo, hi, input index of the device pos-table, table length) mapping
    build-key value -> build view row."""
    from .gpu_executors import _slot_id
    if isinstance(node, _AggIndexNode):
        got = node.build_key_info()
        if got is None:
            return None
        lo, hi, tbl = got
        rep = node.leaf.replica()
        sids = (_slot_id(node.leaf.ex, node.key_cols[0].index),)
        d = _dev_upload(rep, ("gi_postable_dev", sids), lambda: tbl)
        return lo, hi, pb.add(d), int(tbl.shape[0])
    if isinstance(node, _SelNode):
        return _prepare_build_key_info(node.child, build_key, pb)
    if isinstance(node, _ProjNode):
        e = node.exprs[build_key.index]
        if not isinstance(e, ExprColumn):
            return None
        return _prepare_build_key_info(node.child, e, pb)
    if isinstance(node, _ReplicaLeaf):
        rep = node.replica()
        if rep is None:
            return None
        sid = _slot_id(node.ex, build_key.index)
        if sid == "handle":
            kv, km = rep.handles, np.zeros(rep.n_rows, dtype=bool)
        else:
            kv, km = rep.columns[sid]
        got = _rep_pos_table(rep, sid, kv, km)
        if got is None:
            return None
        lo, hi, tbl = got
        d = _dev_upload(rep, ("postable_dev", sid), lambda: tbl)
        return lo, hi, pb.add(d), int(tbl.shape[0])
    return None


def _composite_spec(cols):
    """Multi-key composite lane: per-key (lo, hi, stride) such that
    comp = sum((k_i - lo_i) * stride_i) is a bijection over the cross
    range — the device-friendly replacement for a multi-column hash key.
    None when the combined dense range exceeds MAX_DENSE_RANGE."""
    los, his = [], []
    total = 1
    for kv, km in cols:
        nn = kv[~km]
        if len(nn):
            lo, hi = int(nn.min()), int(nn.max())
        else:
            lo = hi = 0
        span = hi - lo + 1
        if span <= 0 or total > MAX_DENSE_RANGE // span:
            return None
        total *= span
        los.append(lo)
        his.append(hi)
    strides = []
    st = 1
    for lo, hi in reversed(list(zip(los, his))):
        strides.append(st)
        st *= hi - lo + 1
    strides.reverse()
    comp = np.zeros(len(cols[0][0]), dtype=np.int64)
    null_any = np.zeros(len(cols[0][0]), dtype=bool)
    for (kv, km), lo, hi, stride in zip(cols, los, his, strides):
        comp += (np.clip(kv, lo, hi) - lo) * stride
        null_any |= km
    return los, his, strides, comp, null_any, total


class _SelNode:
    """Filter over a device view: conditions AND into the validity mask."""

    def __init__(self, child, conds, plan):
        self.child = child
        self.conds = conds
        self.plan = plan

    @staticmethod
    def compile(plan: PhysicalSelection, ctx: _Ctx):
        if not all(is_jittable(c) for c in plan.conditions):
            return None
        child = _compile_node(plan.children[0], ctx)
        if child is None:
            return None
        return _SelNode(child, plan.conditions, plan)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        tv = self.child.prepare(pb)
        if tv is None:
            return None
        pt = ParamTable()
        prog = compile_program(self.conds, (), pt)
        keys = tuple(stable_shape_key(c) for c in self.conds)
        ip, fp = pb.params(pt)
        nb = tv.nb
        pb.key(("sel", keys, nb, len(tv.meta)))

        def emit(args):
            valid, pairs = tv.emit(args)
            m, _ = kernels.expr_eval(prog, pairs, (args[ip], args[fp]), nb,
                                     mask_in=valid)
            return m, pairs
        return _TView(emit, tv.nb, tv.meta)

    def close(self):
        _close_node(self.child)


class _ProjNode:
    """Projection over a device view; string columns pass through as
    bare column references (codes + decode)."""

    def __init__(self, child, exprs, plan):
        self.child = child
        self.exprs = exprs
        self.plan = plan

    @staticmethod
    def compile(plan: PhysicalProjection, ctx: _Ctx):
        for e in plan.exprs:
            if is_jittable(e):
                continue
            if isinstance(e, ExprColumn) and e.eval_type is EvalType.STRING:
                continue
            return None
        child = _compile_node(plan.children[0], ctx)
        if child is None:
            return None
        return _ProjNode(child, plan.exprs, plan)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        tv = self.child.prepare(pb)
        if tv is None:
            return None
        pt = ParamTable()
        srcs = []   # per output: ("col", slot) | ("fn", program output)
        exprs = []
        keys = []
        meta = []
        for e, oc in zip(self.exprs, self.plan.schema.columns):
            if isinstance(e, ExprColumn):
                srcs.append(("col", e.index))
                keys.append(f"@{e.index}")
                meta.append((oc.ret_type, tv.meta[e.index][1]))
            else:
                srcs.append(("fn", len(exprs)))
                exprs.append(e)
                keys.append(stable_shape_key(e))
                meta.append((oc.ret_type, None))
        prog = compile_program((), exprs, pt)
        ip, fp = pb.params(pt)
        nb = tv.nb
        pb.key(("proj", tuple(keys), nb, len(tv.meta)))

        def emit(args):
            valid, pairs = tv.emit(args)
            got = kernels.expr_eval(prog, pairs, (args[ip], args[fp]),
                                    nb)[1] if exprs else []
            return valid, [pairs[j] if kind == "col" else got[j]
                           for kind, j in srcs]
        return _TView(emit, tv.nb, meta)

    def close(self):
        _close_node(self.child)


class _OrderNode:
    """TopN (static offset/count slice after the lexicographic order —
    valid rows sort first, so perm[offset : offset+count_bucket] IS the
    answer) or full Sort over a view, through HK4 (top-k mode for TopN).
    The row index breaks ties, so the result is the stable sort's.

    Under ``tidb_mesh_parallel`` a TopN runs distributed (K21 mesh, the
    reference's per-region TopN and root merge): each shard orders its
    row range and keeps its top (offset + count) candidates, the
    candidates gather, and a merge sort slices the final window.  The
    global row index breaks ties in both sorts, so the result is the
    single-device stable sort's, bit for bit."""

    def __init__(self, child, by, offset, count, plan, mesh=None):
        self.child = child
        self.by = by
        self.off = offset        # None = full sort
        self.count = count
        self.plan = plan
        self.mesh = mesh

    @staticmethod
    def compile(plan, ctx: _Ctx):
        for e, _ in plan.by:
            if is_jittable(e):
                continue
            if isinstance(e, ExprColumn) and e.eval_type is EvalType.STRING:
                continue
            return None
        child = _compile_node(plan.children[0], ctx)
        if child is None:
            return None
        off = count = None
        if isinstance(plan, PhysicalTopN):
            off, count = plan.offset, plan.count
        return _OrderNode(child, plan.by, off, count, plan, mesh=ctx.mesh)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        tv = self.child.prepare(pb)
        if tv is None:
            return None
        pt = ParamTable()
        srcs = []   # per key: ("col", slot) | ("fn", program output)
        exprs = []
        keys = []
        for e, desc in self.by:
            if isinstance(e, ExprColumn):
                srcs.append(("col", e.index))
                keys.append(f"@{e.index}:{desc}")
            else:
                srcs.append(("fn", len(exprs)))
                exprs.append(e)
                keys.append(f"{stable_shape_key(e)}:{desc}")
        prog = compile_program((), exprs, pt)
        descs = tuple(d for _, d in self.by)
        nb = tv.nb
        if self.off is None:
            off, kb = 0, nb
        else:
            off = min(self.off, nb)
            kb = min(kernels.bucket(max(self.count, 1)) + off, nb)
        count = self.count
        ip, fp = pb.params(pt)
        from ..parallel import dist
        if self.off is not None and dist.shardable(nb, self.mesh):
            return self._prepare_mesh(pb, tv, prog, srcs, bool(exprs),
                                      tuple(keys), descs, off, kb, count,
                                      ip, fp)
        pb.key(("order", tuple(keys), off, kb, count, nb, len(tv.meta)))
        top = self.off is not None

        def emit(args):
            valid, pairs = tv.emit(args)
            got = kernels.expr_eval(prog, pairs, (args[ip], args[fp]),
                                    nb)[1] if exprs else []
            kvs = [pairs[j] if kind == "col" else got[j]
                   for kind, j in srcs]
            # the reference's _sort_ops order: NULL first ascending and
            # last descending, invalid rows last, ties by row
            perm = kernels.lex_order(kernels.sort_lanes(kvs, descs, valid),
                                     nb, kb if top else None)
            take = perm[off:kb]
            out_valid = valid[take]
            if count is not None:
                # valid rows sort first, so the taken valid rows are a
                # prefix; cap it at `count`
                out_valid = out_valid & (kernels._arange(kb - off) < count)
            outs = [(v[take], m[take]) for v, m in pairs]
            return out_valid, outs
        return _TView(emit, kb - off, tv.meta)

    def _prepare_mesh(self, pb, tv, prog, srcs, has_fn, key_ids, descs,
                      off, kb, count, ip, fp):
        """K21 mesh: per-shard top-(offset + count) and the merge.  One
        HK4 launch orders every shard's row range at once (the shard id
        leads the lanes, the row index — the global row — breaks ties),
        each shard's first kc rows are its candidates (a gather of
        indices), and a second HK4 launch orders the n * kc candidates
        with the global row index as the last key."""
        n = int(self.mesh.n_shards)
        nb = tv.nb
        per = nb // n
        kc = min(kb, per)  # per-shard candidate count
        pb.key(("order_mesh", key_ids, off, kb, count, nb, len(tv.meta), n,
                kc))

        def emit(args):
            valid, pairs = tv.emit(args)
            got = kernels.expr_eval(prog, pairs, (args[ip], args[fp]),
                                    nb)[1] if has_fn else []
            kvs = [pairs[j] if kind == "col" else got[j]
                   for kind, j in srcs]
            perm = kernels.lex_order(
                [kernels.shard_lane(n, per)]
                + kernels.sort_lanes(kvs, descs, valid), nb)
            cand = perm.reshape(n, per)[:, :kc].reshape(-1)
            g_valid = valid[cand]
            g_kvs = [(v[cand], m[cand]) for v, m in kvs]
            perm2 = kernels.lex_order(
                kernels.sort_lanes(g_kvs, descs, g_valid) + [cand],
                n * kc, kb)
            take = cand[perm2[off:kb]]
            out_valid = valid[take]
            if count is not None:
                out_valid = out_valid & (kernels._arange(kb - off) < count)
            return out_valid, [(v[take], m[take]) for v, m in pairs]
        return _TView(emit, kb - off, tv.meta)

    def close(self):
        _close_node(self.child)


class _LimitNode:
    def __init__(self, child, plan):
        self.child = child
        self.plan = plan

    @staticmethod
    def compile(plan: PhysicalLimit, ctx: _Ctx):
        child = _compile_node(plan.children[0], ctx)
        if child is None:
            return None
        return _LimitNode(child, plan)

    def prepare(self, pb: _PipeBuilder) -> Optional[_TView]:
        tv = self.child.prepare(pb)
        if tv is None:
            return None
        pt = ParamTable()
        pt.add_int(self.plan.offset)
        pt.add_int(self.plan.offset + self.plan.count)
        ip, fp = pb.params(pt)
        pb.key(("limit", tv.nb))

        def emit(args):
            valid, pairs = tv.emit(args)
            lims = args[ip]
            # glue that only counts: each valid row's rank
            rank = torch.cumsum(valid.to(torch.int64), 0)
            return valid & (rank > lims[0]) & (rank <= lims[1]), pairs
        return _TView(emit, tv.nb, tv.meta)

    def close(self):
        _close_node(self.child)


def _close_node(node):
    if node is not None and hasattr(node, "close"):
        node.close()


def _compile_node(plan, ctx: _Ctx):
    """Compile a plan subtree to a device node, or wrap it as a host
    leaf.  Returns None only for structural impossibilities at the
    ROOT of the requested subtree (callers fall back entirely)."""
    node = _compile_device(plan, ctx)
    if node is not None:
        return node
    return _HostLeaf.compile(plan, ctx)


def _compile_device(plan, ctx: _Ctx):
    if isinstance(plan, PhysicalTableReader):
        return _ReplicaLeaf.compile(plan, ctx)
    if isinstance(plan, PhysicalHashAgg):
        if not plan.group_by:
            return _ScalarAggNode.compile(plan, ctx)
        node = _AggIndexNode.compile(plan, ctx)
        if node is None:
            node = _SortGroupNode.compile(plan, ctx)
        return node
    if isinstance(plan, PhysicalHashJoin):
        return _JoinNode.compile(plan, ctx)
    if isinstance(plan, PhysicalSelection):
        return _SelNode.compile(plan, ctx)
    if isinstance(plan, PhysicalProjection):
        return _ProjNode.compile(plan, ctx)
    if isinstance(plan, (PhysicalTopN, PhysicalSort)):
        return _OrderNode.compile(plan, ctx)
    if isinstance(plan, PhysicalLimit):
        return _LimitNode.compile(plan, ctx)
    return None


def _contains_join(plan) -> bool:
    if isinstance(plan, PhysicalHashJoin) \
            and not isinstance(plan, PhysicalMergeJoin):
        return True
    return any(_contains_join(c) for c in plan.children)


def _contains_grouped_agg(plan) -> bool:
    if isinstance(plan, PhysicalHashAgg) and plan.group_by:
        return True
    return any(_contains_grouped_agg(c) for c in plan.children)


# =========================================================================
# materialization: host chunk from the packed download
# =========================================================================

def _to_chunk(host_pairs, meta) -> Chunk:
    cols = []
    for (v, m), (ret_type, decode) in zip(host_pairs, meta):
        if decode is not None:
            card = len(decode)
            safe = np.where(m | (v < 0) | (v >= card), 0, v)
            out = np.asarray(decode)[safe].astype(object)
            out[m] = None
            cols.append(CCol.from_numpy(ret_type, out, m))
        else:
            vv = v
            if ret_type.eval_type is EvalType.REAL \
                    and vv.dtype != np.float64:
                vv = vv.astype(np.float64)
            cols.append(CCol.from_numpy(ret_type, vv, m))
    return Chunk.from_columns(cols)


def _as_i64(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 \
        else t.to(torch.int64)


def _from_i64(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    if dtype == torch.float64:
        return a.view(np.float64)
    return a != 0 if dtype == torch.bool else a


# =========================================================================
# executor wrapper
# =========================================================================

#: nominal per-row pricing of the spill probe where a table has no
#: measured width (the reference's)
_NOMINAL_ROW_BYTES = 17


def _plan_base_table_id(plan) -> int:
    """Table id of the single base table feeding ``plan`` (0 when the
    subtree is not scan-rooted)."""
    node = plan
    for _ in range(32):
        scan = getattr(node, "scan", None) or \
            getattr(node, "table_scan", None)
        if scan is not None:
            node = scan
        info = getattr(node, "table_info", None)
        if info is not None:
            return int(info.id)
        kids = getattr(node, "children", None)
        if not kids or len(kids) != 1:
            return 0
        node = kids[0]
    return 0


class DevPipeExec:
    """Volcano-compatible wrapper: compiles the subtree at open(), runs
    the pipeline once at first next().  Runs the per-operator executors
    instead where the plan's shape routes there (see the module
    docstring); never after an exception."""

    def __init__(self, plan, fallback_builder: Callable):
        self.plan = plan
        self.schema = plan.schema
        self.children = []
        self._fallback_builder = fallback_builder
        self._fallback = None
        self._node = None
        self._done = False

    def field_types(self):
        return [c.ret_type for c in self.plan.schema.columns]

    def open(self, ctx):
        self.ctx = ctx
        self._done = False
        self._node = None
        if not self._enabled(ctx) or self._spill_pressure(ctx):
            # spill pressure: the pipeline holds whole tables resident and
            # has no spill path; the per-operator gates decide
            self._open_fallback(ctx)
            return
        mesh = mesh_if_enabled(ctx.session_vars)
        if mesh is not None and not _contains_join(self.plan) \
                and _contains_grouped_agg(self.plan):
            # aggregate-only pipelines under tidb_mesh_parallel ride the
            # per-operator tier's sharded aggregate (the partial merge
            # over the mesh); the pipeline's aggregate nodes are
            # single-device.  Join pipelines and TopNs keep their mesh
            # modes here.
            self._open_fallback(ctx)
            return
        cctx = _Ctx(ctx, mesh=mesh)
        try:
            self._node = _compile_device(self.plan, cctx)
        except BaseException:
            for ex in cctx.opened:
                ex.close()
            raise
        if self._node is None:
            self._open_fallback(ctx)

    def _spill_pressure(self, ctx) -> bool:
        """Would any operator under here spill?  The per-operator tier's
        decision, priced per node with the same per-row costs (join: both
        sides x _JOIN_ROW_BYTES; everything else: the table's measured row
        width, else the nominal price)."""
        from ..obs import memprof
        from .gpu_executors import _JOIN_ROW_BYTES, _would_spill
        storage = getattr(ctx, "storage", None)

        def est_of(p) -> float:
            return float(getattr(p, "stats_row_count", 0.0) or 0.0)

        def row_bytes(p) -> int:
            tid = _plan_base_table_id(p)
            if tid <= 0:
                return _NOMINAL_ROW_BYTES
            return memprof.measured_row_bytes(tid, _NOMINAL_ROW_BYTES,
                                              storage=storage)

        def max_bytes(p) -> float:
            if isinstance(p, PhysicalHashJoin) \
                    and not isinstance(p, PhysicalMergeJoin):
                b = sum(est_of(c) for c in p.children) * _JOIN_ROW_BYTES
            else:
                b = est_of(p) * row_bytes(p)
            for c in getattr(p, "children", ()):
                b = max(b, max_bytes(c))
            return b

        return _would_spill(max_bytes(self.plan))

    @staticmethod
    def _enabled(ctx) -> bool:
        """Auto mode takes the pipeline on the card (the reference: off
        its CPU backend); tidb_devpipe=1 forces it, 0 turns it off."""
        raw = ctx.session_vars.get("tidb_devpipe", -1)
        mode = -1 if raw is None else int(raw)
        if mode == 0:
            return False
        if mode == 1:
            return True
        return kernels.backend() == "cuda"

    def _open_fallback(self, ctx):
        self._fallback = self._fallback_builder(self.plan)
        qobs = getattr(self, "_obs_qobs", None)
        if qobs is not None:
            # the per-operator tree is built lazily (after instrument_tree
            # walked the executor tree): instrument it with the same scope
            from ..obs.runtime_stats import instrument_tree
            instrument_tree(self._fallback, qobs)
        self._fallback.open(ctx)

    def next(self) -> Optional[Chunk]:
        if self._fallback is not None:
            return self._fallback.next()
        if self._done:
            return None
        self._done = True
        out = self._run_pipeline()
        if out is None:
            # a node's prepare declined (dirty transaction, key range over
            # MAX_DENSE_RANGE): the per-operator executors take the plan
            _close_node(self._node)
            self._node = None
            self._open_fallback(self.ctx)
            return self._fallback.next()
        return out if out.num_rows() else None

    def _run_pipeline(self) -> Optional[Chunk]:
        """Prepare the node tree (host work + input collection), then run
        the whole pipeline as one counted call.  Small outputs fold the
        result packing into the same call: one dispatch, one D2H."""
        pb = _PipeBuilder()
        tv = self._node.prepare(pb)
        if tv is None:
            return None
        inputs = pb.run_inputs()
        nb = tv.nb
        ncols = len(tv.meta)
        small = nb <= kernels.SMALL_PACK
        # the input dtype/shape signature joins the key as a structural
        # backstop: a node key that under-pins its closure could otherwise
        # share a registered pipeline whose pack schema is another layout
        sig = tuple((str(getattr(a, "dtype", type(a))),
                     tuple(getattr(a, "shape", ())))
                    for a in inputs)
        key = ("pipe", small, tuple(pb.kparts), sig)
        if small:
            def build_small():
                schema: list = []
                emit = tv.emit

                def mega(args):
                    valid, cols = emit(args)
                    flat = [valid]
                    for v, m in cols:
                        flat.append(v)
                        flat.append(m)
                    return kernels.pack_arrays(schema, flat)
                _note_compiled(pb.kparts)
                return kernels.counted_launch(mega), schema
            fn, schema = progcache.get(key, build_small)
            vals = kernels.unpack_flat(fn(inputs), schema)
            keep = np.nonzero(vals[0])[0]
            host = [(vals[1 + 2 * i][keep], vals[2 + 2 * i][keep])
                    for i in range(ncols)]
        else:
            def build_big():
                emit = tv.emit

                def mega(args):
                    valid, cols = emit(args)
                    return [valid] + [x for vm in cols for x in vm]
                _note_compiled(pb.kparts)
                return kernels.counted_launch(mega)
            fn = progcache.get(key, build_big)
            res = fn(inputs)
            valid, items = res[0], list(res[1:])
            # HK2's present-segment compaction over the view's rows
            # (presence = validity, then every lane as int64 bits): the
            # count and the first rows come back in one transfer
            table = torch.stack([valid.to(torch.int64)]
                                + [_as_i64(x) for x in items])
            rows = kernels.present_rows(table, nb)
            host = [(_from_i64(rows[2 * i], items[2 * i].dtype),
                     _from_i64(rows[2 * i + 1], items[2 * i + 1].dtype))
                    for i in range(ncols)]
        return _to_chunk(host, tv.meta)

    def drain(self) -> List[list]:
        rows = []
        while True:
            _interrupt.check()
            _fail.inject("execSlowNext")
            chk = self.next()
            if chk is None:
                break
            rows.extend(chk.to_rows())
        return rows

    def close(self):
        if self._fallback is not None:
            self._fallback.close()
        _close_node(self._node)
