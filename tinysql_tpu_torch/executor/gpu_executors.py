"""GPU executor tier: the device operators of the port.

The port of tinysql_tpu/executor/tpu_executors.py, with its ``TPU*Exec``
classes renamed ``GPU*Exec``: HashAgg / HashJoin / Sort / TopN /
Projection / Selection registered behind the same volcano interface as
the CPU tier.  They marshal chunk columns to torch tensors on the
session's device (replica columns are uploaded once per replica version
and memoized there), run the ops/kernels.py operator families — whose
cores are the hand-written CUDA kernels HK1-HK4 — and materialize the
results back.

String group/sort keys and string filters ride order-preserving dictionary
codes built on the host (np.unique), so TPC-H-style char keys still take
the device path.

Plans with a join or a grouped aggregate go to the device pipeline tier
(executor/devpipe.py) first, which runs them on CUDA by default
(``tidb_devpipe``) and hands the shapes it does not take to these
operators.

A table above ``tidb_device_block_rows`` runs block-wise: HashAgg reduces
row blocks and carries partial states on the host, HashJoin streams its
probe side in blocks against the resident build keys, TopN carries its
candidates across blocks, and a full Sort orders on the host (the
reference's route for it).  Staging runs on devpipe.BlockPipeline.

Not ported yet, and failing loudly instead of falling back: the
memory-adaptive spill route (ROADMAP queue 1, item 6) and the
multi-device mesh tier (item 10).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import fail
from ..chunk import Chunk, Column as CCol, MAX_CHUNK_SIZE
from ..expression import Column as ExprColumn, vectorized_filter
from ..expression.aggregation import (AGG_AVG, AGG_COUNT, AGG_FIRST_ROW,
                                      AGG_MAX, AGG_MIN, AGG_SUM)
from ..mytypes import EvalType
from ..ops import batching, kernels, progcache
from ..ops.exprjit import ExprProgram, ParamTable, code_cmp, compile_program
from ..planner.physical import (PhysicalHashAgg, PhysicalHashJoin,
                                PhysicalProjection, PhysicalSelection,
                                PhysicalSort, PhysicalTopN)
from .executors import Executor, build_executor

_SPILL_TODO = ("memory-adaptive spill execution is not ported yet: "
               "ROADMAP queue 1, item 6")
_MESH_TODO = ("the multi-device mesh tier (tidb_mesh_parallel) is not "
              "ported yet: ROADMAP queue 1, item 10")


def _drain_chunk(ex: Executor, fields) -> Chunk:
    first = ex.next()
    if first is None:
        return Chunk(fields, cap=MAX_CHUNK_SIZE)
    nxt = ex.next()
    if nxt is None:
        # single-chunk children (every device-tier operator) hand their
        # output over without a copy — this also keeps DeviceColumn
        # (late-materialization) chunks on device
        return first.compact()
    out = Chunk(fields, cap=MAX_CHUNK_SIZE)
    out.append_chunk(first)
    out.append_chunk(nxt)
    while True:
        chk = ex.next()
        if chk is None:
            break
        out.append_chunk(chk)
    return out


def _block_budget(session_vars) -> int:
    try:
        return int(session_vars.get("tidb_device_block_rows", 0) or 0)
    except Exception:
        return 0


def _check_mesh(ctx) -> None:
    """The reference shards over a device mesh under tidb_mesh_parallel;
    the port has no mesh tier yet."""
    try:
        on = int(ctx.session_vars.get("tidb_mesh_parallel", 0) or 0)
    except (TypeError, ValueError):
        on = 0
    if on:
        raise NotImplementedError(_MESH_TODO)


def _est_rows_of(plan_child) -> float:
    return float(getattr(plan_child, "stats_row_count", 0.0) or 0.0)


def _would_spill(est_bytes: float) -> bool:
    """The reference's spill decision (ops/spill.would_spill), side-effect
    free: the spillForceAll failpoint, a crossed soft watermark, or a
    planner estimate above the watermark headroom."""
    from ..utils import memory as _memory
    if fail.is_armed("spillForceAll"):
        return True
    tracker = _memory.current()
    if tracker is None or tracker.quota <= 0:
        return False
    return tracker.spill_requested() or (
        tracker.spill_watermark > 0 and est_bytes > tracker.headroom())


def _spill_gate(ctx, est_rows: float, actual_rows: int,
                row_bytes: int) -> None:
    """Where the reference would spill, the port raises — the partitioned
    route is not ported."""
    if _would_spill(int(max(est_rows, float(actual_rows), 0)
                        * max(row_bytes, 1))):
        raise NotImplementedError(_SPILL_TODO)


#: per-row pricing for the join's spill estimate (the reference's)
_JOIN_ROW_BYTES = 36


def _mask_compact_threshold() -> float:
    """Below this selectivity, compacting beats masking: on the card
    masked full-table kernels win (stable bucket shapes); on the CPU the
    extra rows are pure cost."""
    return 0.3 if kernels.backend() == "cuda" else 0.75


def _take_replica_masked(ex: Executor, extra_conds=None):
    """Single owner of the raw-replica intake: (chunk, mask, replica) with
    scan filters plus `extra_conds` folded into one mask (None when no
    conditions), or (None, None, None) when the child cannot serve raw."""
    from .executors import TableReaderExec
    if not isinstance(ex, TableReaderExec):
        return None, None, None
    chk, filters, rep = ex.take_raw_replica()
    if chk is None:
        return None, None, None
    conds = list(filters) + list(extra_conds or [])
    if not conds:
        return chk, None, rep
    return chk, _fold_filter_masks(ex, rep, chk, conds), rep


def _fold_filter_masks(ex, rep, chk, conds):
    """AND-fold host masks for `conds`: string compares ride dictionary
    codes, the residual goes through vectorized_filter."""
    mask = None
    residual = []
    for c in conds:
        m = _string_cmp_mask(ex, rep, chk, c)
        if m is None:
            residual.append(c)
        else:
            mask = m if mask is None else (mask & m)
    if residual:
        rm = vectorized_filter(residual, chk)
        mask = rm if mask is None else (mask & rm)
    return mask


_STR_CMP_OPS = {"=", "!=", "<", "<=", ">", ">="}


def _parse_string_cmp(chk, cond):
    """Recognize `string Column <op> string Constant` (either order).
    Returns (col, op, value) with the op flipped for constant-first, or
    None."""
    from ..expression import Column as ExprColumn, Constant, ScalarFunction
    from ..mytypes import EvalType as ET
    if not (isinstance(cond, ScalarFunction)
            and cond.name in _STR_CMP_OPS and len(cond.args) == 2):
        return None
    a, b = cond.args
    flip = False
    if isinstance(b, ExprColumn) and isinstance(a, Constant):
        a, b = b, a
        flip = True
    if not (isinstance(a, ExprColumn) and isinstance(b, Constant)):
        return None
    if a.eval_type is not ET.STRING or not isinstance(b.value, str):
        return None
    if chk.columns[a.index].values().dtype.kind != "U":
        return None
    op = cond.name
    if flip:
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
              "=": "=", "!=": "!="}[op]
    return a, op, b.value


def _build_device_mask(ex, rep, chk, conds):
    """Scan filters as conditions of an HK7 program over the fused
    kernels' dev_cols.  Returns (conds, key, needed): conditions for
    exprjit.compile_program (a jittable expression, or ("codecmp", slot,
    op, lo, hi, card): a string compare as an int compare over the
    slot's dictionary codes, K14), their shape key, and the set of (slot
    index, "codes" | "full") the program reads — or None when some
    condition cannot run on the device (host mask)."""
    from ..ops.exprjit import is_jittable, stable_shape_key
    items = []
    keys = []
    needed = set()
    for cond in conds:
        sc = _parse_string_cmp(chk, cond)
        if sc is not None:
            col, op, val = sc
            idx = col.index
            got = _rep_string_dict(rep, _slot_id(ex, idx), chk, idx)
            if got is None:
                return None
            _codes, card, _, uniques = got
            lo = int(np.searchsorted(uniques, val, side="left"))
            hi = int(np.searchsorted(uniques, val, side="right"))
            items.append(("codecmp", idx, op, lo, hi, card))
            keys.append(f"strcmp@{idx}:{op}")
            needed.add((idx, "codes"))
        elif is_jittable(cond):
            items.append(cond)
            keys.append(stable_shape_key(cond))
            for c in cond.collect_columns():
                needed.add((c.index, "full"))
        else:
            return None
    return items, tuple(keys), needed


def rep_string_codes(rep, sid, v, null):
    """Ordered dictionary codes for a string replica column, memoized per
    replica version: (codes int64 [n] with NULL -> card, card, base=0,
    uniques).  ONE builder for every consumer of the ("keycodes", ...)
    memo slot (device group keys, device masks, CPU string filters)."""
    def build():
        safe = np.where(null, "", v)
        uniques, codes = np.unique(safe.astype(str), return_inverse=True)
        codes = np.where(null, len(uniques), codes).astype(np.int64)
        return codes, len(uniques), 0, uniques
    return rep.memo(("keycodes", sid, True, False), build)


def _rep_string_dict(rep, sid, chk, idx):
    col = chk.columns[idx]
    return rep_string_codes(rep, sid, col.values(), col.null_mask())


def _slot_id(ex, idx: int):
    """Stable replica-memo id for a schema slot (column id or the
    handle)."""
    ci = ex._decode_cols[idx]
    return ci.id if ci is not None else "handle"


#: the dictionary-code compare ladder (K14): one implementation for
#: host filters and HK7's plain version
_code_cmp = code_cmp


def _string_cmp_mask(ex, rep, chk, cond):
    """Try to evaluate `cond` (string Column vs string Constant compare)
    through dictionary codes; returns a bool mask or None."""
    sc = _parse_string_cmp(chk, cond)
    if sc is None:
        return None
    a, op, val = sc
    codes, card, _, uniques = _rep_string_dict(rep, _slot_id(ex, a.index),
                                               chk, a.index)
    lo = int(np.searchsorted(uniques, val, side="left"))
    hi = int(np.searchsorted(uniques, val, side="right"))
    return _code_cmp(op, codes, lo, hi, card)


def _compact_if_selective(chk: Chunk, mask):
    """Selective filters compact (less kernel work); permissive ones stay
    masked (stable bucket shapes).  String columns compact LAZILY
    (LazyTakeColumn)."""
    from ..chunk.column import LazyTakeColumn
    if (mask is not None and mask.size
            and mask.mean() < _mask_compact_threshold()):
        sel = np.nonzero(mask)[0]
        cols = []
        for c in chk.columns:
            v = c._data
            if v is not None and (v.dtype == object or v.dtype.kind == "U"):
                cols.append(LazyTakeColumn(c, sel))
            else:
                cols.append(c.take(sel))
        return Chunk.from_columns(cols), None
    if mask is not None and not mask.size:
        return chk, None  # empty chunk: nothing to mask
    return chk, mask


def _child_input(ex: Executor) -> Chunk:
    """Materialize a child's full output: TableReaders on the columnar
    replica hand over zero-copy column views (filters applied by selection
    compaction) instead of slicing + re-appending chunk by chunk."""
    chk, mask, _rep = _take_replica_masked(ex)
    if chk is not None:
        if mask is not None:
            chk.set_sel(np.nonzero(mask)[0])
            chk = chk.compact()
        return chk
    return _drain_chunk(ex, ex.field_types()).compact()


def _agg_program(specs, arg_exprs, mask_conds, pt: ParamTable):
    """ONE HK7 program for a fused aggregate: the filter conditions AND-ed
    into the valid mask and, per spec with an argument, its lane (COUNT
    keeps only the NULL mask; ("mask", slot) is a column's NULL mask).
    Returns (program, per spec its output index or None, the shape-keyed
    program_key); constants ride ``pt``."""
    from ..ops.exprjit import stable_shape_key
    outs = []
    lane_of = []
    pk_parts = []
    for (func, has_arg), a in zip(specs, arg_exprs):
        if not has_arg or a is None:
            lane_of.append(None)
            pk_parts.append("-")
            continue
        if isinstance(a, tuple):
            outs.append(("nullof", a[1]))
            pk_parts.append(f"mask@{a[1]}")
        elif func == "count":
            outs.append(("null", a))
            pk_parts.append(f"null:{stable_shape_key(a)}")
        else:
            outs.append(a)
            pk_parts.append(stable_shape_key(a))
        lane_of.append(len(outs) - 1)
    prog = compile_program(mask_conds, outs, pt, mask=True)
    return prog, lane_of, tuple(pk_parts)


def _device_arg_ok(e, chk) -> bool:
    """Can HK7 evaluate aggregate argument ``e`` over the chunk: a
    jittable tree whose columns are int64 / float64 lanes."""
    from ..ops.exprjit import is_jittable
    if not is_jittable(e):
        return False
    for c in e.collect_columns():
        v = chk.columns[c.index].values()
        want = np.float64 if c.eval_type is EvalType.REAL else np.int64
        if v.dtype != want:
            return False
    return True


def _device_args(chk, n: int, arg_cols, dev_args):
    """The deferred argument lanes of the generic aggregate path as ONE
    HK7 launch over the chunk's referenced columns (uploaded padded to
    the row bucket); returns ``arg_cols`` with each deferred entry
    replaced by its device (values, NULL) pair."""
    nb = kernels.bucket(max(n, 1))
    outs = [o for _, o in dev_args]
    slots = sorted({c.index for o in outs
                    for c in (o[1] if isinstance(o, tuple) else o)
                    .collect_columns()})
    cols = [None] * len(chk.columns)
    for i in slots:
        c = chk.columns[i]
        cols[i] = (kernels.h2d_pad(c.values(), nb),
                   kernels.h2d_pad(c.null_mask(), nb, True))
    pt = ParamTable()
    prog = compile_program((), outs, pt)
    _, lanes = kernels.expr_eval(prog, cols, kernels._params_dev(
        pt.arrays()), nb, n_rows=n)
    got = list(arg_cols)
    for (j, _), pair in zip(dev_args, lanes):
        got[j] = pair
    return got


def _composite_key_lanes(lkeys, lchk, rkeys, rchk):
    """Multi-key equi-join keys -> ONE int64 lane per side via JOINT
    factorization (np.unique over both sides' stacked key tuples): equal
    tuples get equal codes, distinct tuples distinct codes.  A tuple with
    ANY NULL component never equi-matches (null mask OR)."""
    def stack(keys, chk):
        pairs = [e.vec_eval(chk) for e in keys]
        vals = np.stack([np.asarray(v).astype(np.int64, copy=False)
                         for v, _ in pairs], axis=1)
        null = np.zeros(len(vals), dtype=bool)
        for _, m in pairs:
            null |= np.asarray(m)
        return vals, null
    lv, lnull = stack(lkeys, lchk)
    rv, rnull = stack(rkeys, rchk)
    both = np.concatenate([lv, rv], axis=0)
    # one key column at a time: 1-D integer sorts (np.unique over rows
    # sorts a structured view, several times slower).  Each step's codes
    # are dense ranks below len(both), so code * card + rank stays
    # inside int64
    inv = np.zeros(len(both), dtype=np.int64)
    for j in range(both.shape[1]):
        _, rank = np.unique(both[:, j], return_inverse=True)
        card = int(rank.max()) + 1 if len(rank) else 1
        _, inv = np.unique(inv * card + rank.ravel(), return_inverse=True)
    inv = np.asarray(inv, dtype=np.int64).ravel()
    return (inv[:len(lv)], lnull), (inv[len(lv):], rnull)


def _encode_key(e, chk: Chunk) -> Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]:
    """Evaluate a group/sort key over the chunk -> (codes, null, decode).
    Strings become order-preserving dictionary codes; decode maps code ->
    original value (None for numerics)."""
    v, null = e.vec_eval(chk)
    if v.dtype == object or v.dtype.kind == "U":
        safe = np.where(null, "", v)
        uniques, codes = np.unique(safe.astype(str), return_inverse=True)
        return codes.astype(np.int64), null, uniques
    if v.dtype == np.int64 and getattr(e.ret_type, "is_unsigned", False):
        # unsigned values live two's-complement-wrapped in the int64
        # buffer; XOR with the sign bit maps unsigned order onto signed
        # int64 order (bijective, so it's equally valid as a group key)
        v = v ^ np.int64(-2**63)
    return v, null, None


def _dev_memo(rep, kind: str, sid, nb: int, build):
    """Replica-memoized device tensor, keyed by the device too (sessions
    on different devices may share one storage)."""
    return rep.memo((kind, sid, nb, str(kernels.device())), build)


class GPUHashAggExec(Executor):
    """Group-by as a device segment reduction (HK2) and global aggregates
    as a device masked reduction (HK1)."""

    def __init__(self, plan: PhysicalHashAgg, child: Executor):
        super().__init__(plan.schema, [child])
        self.plan = plan
        self._done = False

    def open(self, ctx):
        super().open(ctx)
        self._done = False

    def _raw_replica_input(self):
        """The child is a TableReader serving from the columnar replica:
        take the FULL table as a zero-copy chunk view and turn the scan
        filters into a valid mask."""
        chk, mask, _rep = _take_replica_masked(self.children[0])
        if chk is None:
            return None, None
        # low-selectivity GROUPED aggregates work over a compacted input;
        # scalar aggregates keep the fused mask
        if self.plan.group_by:
            chk, mask = _compact_if_selective(chk, mask)
        return chk, mask

    @staticmethod
    def _try_segment_layout(keys, n: int):
        """If every group key has known small cardinality (dictionary codes
        for strings; narrow value range for ints), lay the keys out as one
        composite segment id.  Returns (gid, cards, bases, total) or None.
        Each key gets one extra bin for NULL."""
        if n == 0:
            return None
        cards = []
        bases = []
        effs = []
        total = 1
        for v, null, decode in keys:
            if decode is not None:
                card = len(decode)
                eff = np.where(null, card, v)
                base = 0
            elif v.dtype == np.int64:
                nn = v[~null]
                if len(nn) == 0:
                    card, base = 0, 0
                    eff = np.full(n, 0, dtype=np.int64)
                else:
                    vmin, vmax = int(nn.min()), int(nn.max())
                    card = vmax - vmin + 1
                    if card > kernels.seg_limit(n):
                        return None
                    base = vmin
                    eff = np.where(null, card, v - vmin)
            else:
                return None  # float keys: sort-based path
            total *= card + 1
            if total > kernels.seg_limit(n):
                return None
            cards.append(card)
            bases.append(base)
            effs.append(eff.astype(np.int64))
        gid = np.zeros(n, dtype=np.int64)
        for eff, card in zip(effs, cards):
            gid = gid * (card + 1) + eff
        return gid, cards, bases, total

    # ---- fully fused device path ------------------------------------------
    def _try_fused_device(self):
        """Device-resident padded columns (memoized on the replica), the
        filter mask and the aggregate arguments evaluated on the device,
        one hand-kernel reduction.  Returns an output Chunk or None to fall
        back to the generic path."""
        from .executors import TableReaderExec
        from ..ops.exprjit import is_jittable
        plan = self.plan
        child = self.children[0]
        if not isinstance(child, TableReaderExec):
            return None
        rep = getattr(child, "_replica", None)
        if rep is None or child.scan.pushed_agg is not None:
            return None
        from ..expression import Column as ExprColumn, Constant

        # ---- eligibility + spec/arg-program assembly --------------------
        specs: List[Tuple[str, bool]] = []
        arg_exprs: List = []      # jittable expr | ("mask", slot) | None
        slots: List[tuple] = []
        from ..expression.aggregation import AggMode
        for d in plan.aggs:
            if d.distinct:
                return None
            if d.mode is AggMode.FINAL and d.name == AGG_COUNT:
                a = d.args[0]
                if not is_jittable(a):
                    return None
                # sum0: merged COUNT is 0 over empty input, never NULL
                specs.append(("sum0", True))
                arg_exprs.append(a)
                slots.append(("dev", len(specs) - 1))
            elif d.mode is AggMode.FINAL and d.name == AGG_AVG:
                a0, a1 = d.args
                if not (is_jittable(a0) and is_jittable(a1)):
                    return None
                if a0.eval_type is not EvalType.REAL:
                    from ..expression.builtins import new_function
                    a0 = new_function("cast_real", [a0])
                specs.append(("sum", True))
                arg_exprs.append(a0)
                specs.append(("sum", True))
                arg_exprs.append(a1)
                slots.append(("avg", len(specs) - 2, len(specs) - 1))
            elif d.name == AGG_COUNT:
                a = d.args[0]
                if isinstance(a, Constant) and a.value is not None:
                    specs.append(("count_star", False))
                    arg_exprs.append(None)
                    slots.append(("dev", len(specs) - 1))
                elif isinstance(a, ExprColumn):
                    specs.append(("count", True))
                    arg_exprs.append(("mask", a.index))
                    slots.append(("dev", len(specs) - 1))
                elif is_jittable(a):
                    specs.append(("count", True))
                    arg_exprs.append(a)
                    slots.append(("dev", len(specs) - 1))
                else:
                    return None
            elif d.name == AGG_SUM:
                a = d.args[0]
                if not is_jittable(a):
                    return None
                if (d.ret_type.eval_type is EvalType.REAL
                        and a.eval_type is not EvalType.REAL):
                    from ..expression.builtins import new_function
                    a = new_function("cast_real", [a])
                specs.append(("sum", True))
                arg_exprs.append(a)
                slots.append(("dev", len(specs) - 1))
            elif d.name == AGG_AVG:
                a = d.args[0]
                if not is_jittable(a):
                    return None
                from ..expression.builtins import new_function
                ar = a if a.eval_type is EvalType.REAL \
                    else new_function("cast_real", [a])
                specs.append(("sum", True))
                arg_exprs.append(ar)
                specs.append(("count", True))
                arg_exprs.append(a)
                slots.append(("avg", len(specs) - 2, len(specs) - 1))
            elif d.name in (AGG_MAX, AGG_MIN):
                a = d.args[0]
                if not is_jittable(a):
                    return None
                if (a.eval_type is EvalType.INT
                        and getattr(a.ret_type, "is_unsigned", False)):
                    return None  # unsigned order map: generic path handles
                specs.append((("max" if d.name == AGG_MAX else "min"), True))
                arg_exprs.append(a)
                slots.append(("dev_mm", len(specs) - 1, False))
            elif d.name == AGG_FIRST_ROW:
                if not isinstance(d.args[0], ExprColumn):
                    return None
                slots.append(("first", d.args[0]))
            else:
                return None

        # group keys must be plain Columns (codes memoized on the replica)
        for e in plan.group_by:
            if not isinstance(e, ExprColumn):
                return None

        chk, filters, rep = child.take_raw_replica()
        if chk is None:
            return None  # nothing consumed: reader bails identically
        n = chk.full_rows()
        nb = kernels.bucket(max(n, 1))
        # stable per-slot ids: replica memos are shared across queries with
        # different column pruning, so slot INDEXES must never key them
        slot_ids = [ci.id if ci is not None else "handle"
                    for ci in child._decode_cols]

        # ---- per-key codes (memoized per replica) -----------------------
        key_layouts = []
        for e in plan.group_by:
            lay = self._rep_key_codes(rep, e, chk, slot_ids[e.index])
            if lay is None:
                child._replica = rep  # un-consume for the fallback path
                return None
            key_layouts.append(lay)
        n_segments = 1
        for _, card, _, _ in key_layouts:
            n_segments *= card + 1
        if n_segments > kernels.seg_limit(n) and plan.group_by:
            child._replica = rep
            return None

        # ---- block-wise execution: a table above the device buffer
        # budget streams through the card in row blocks; partial states
        # carry on the host between blocks
        budget = _block_budget(self.ctx.session_vars)
        if budget > 0 and n > budget:
            out = self._fused_blockwise(chk, rep, child, filters, specs,
                                        arg_exprs, slots, key_layouts,
                                        n_segments, n, budget)
            if out is not None:
                return out
            child._replica = rep
            return None

        # ---- filter mask: HK7 conditions when every one lowers
        # (constants as runtime params); host numpy + upload otherwise.
        # ONE program (and ParamTable) serves the mask AND the aggregate
        # arguments.
        dev_mask = _build_device_mask(child, rep, chk, filters)
        if dev_mask is None:
            fmask = _fold_filter_masks(child, rep, chk, filters) \
                if filters else None
            mask_conds, mask_prog_key, mask_needed = [], ("hostmask",), set()
        else:
            mask_conds, mask_prog_key, mask_needed = dev_mask
            fmask = None

        # ---- device columns (memoized per replica + bucket + device) ----
        needed = set(mask_needed)
        for a in arg_exprs:
            if isinstance(a, tuple):
                needed.add((a[1], "mask"))
            elif a is not None:
                for c in a.collect_columns():
                    needed.add((c.index, "full"))
        dev_cols = [None] * len(chk.columns)
        for idx, kind in needed:
            col = chk.columns[idx]
            v = col.values()
            m = col.null_mask()
            sid = slot_ids[idx]
            if kind == "codes":
                # string filter rides dictionary codes; the value half of
                # the slot carries the code column
                codes = _rep_string_dict(rep, sid, chk, idx)[0]
                dv = _dev_memo(rep, "devcodes", sid, nb,
                               lambda c=codes: kernels.h2d_pad(c, nb))
            elif v.dtype == object or v.dtype.kind == "U":
                if kind == "full":
                    child._replica = rep
                    return None  # string values in a compute expr
                dv = None
            else:
                dv = _dev_memo(rep, "devv", sid, nb,
                               lambda v=v: kernels.h2d_pad(v, nb))
            dn = _dev_memo(rep, "devn", sid, nb,
                           lambda m=m: kernels.h2d_pad(m, nb, True))
            if dev_cols[idx] is None or dv is not None:
                dev_cols[idx] = (dv, dn)

        pt = ParamTable()
        prog, lane_of, program_key = _agg_program(specs, arg_exprs,
                                                  mask_conds, pt)
        params = pt.arrays()

        if dev_mask is not None:
            mask_spec = ("dev", mask_prog_key)
        else:
            mask = np.zeros(nb, dtype=bool)
            mask[:n] = fmask if fmask is not None else True
            mask_spec = ("host", kernels.h2d(mask))

        _check_mesh(self.ctx)
        if not plan.group_by:
            out_keys = []
            # batchable: THE single-shot dispatch cross-query
            # micro-batching coalesces (ops/batching.py)
            out_aggs, first_orig = kernels.fused_scalar_aggregate(
                dev_cols, specs, prog, lane_of, n, nb, mask_spec,
                program_key=program_key, params=params, batchable=True)
        else:
            gid_dev = _dev_memo(
                rep, "gid_dev", tuple(slot_ids[e.index]
                                      for e in plan.group_by), nb,
                lambda: kernels.h2d_pad(
                    self._compose_gid(key_layouts, n), nb))
            if self._can_device_passthrough(plan, slots, key_layouts) \
                    and not batching.active():
                # a live batch round prefers the batchable fused path
                # below: members must park (collect) and consume
                # (replay) along the SAME route, and the keep variant's
                # per-member device assembly cannot ride a stacked
                # dispatch
                ids, live, out_aggs_d, np_, ob = \
                    kernels.fused_segment_aggregate_keep(
                        dev_cols, gid_dev, n_segments, specs, prog, lane_of,
                        n, mask_spec, program_key=program_key,
                        params=params)
                return self._assemble_device_output(
                    plan, slots, key_layouts, ids, live, out_aggs_d, np_)
            present, out_aggs, first_orig = \
                kernels.fused_segment_aggregate(
                    dev_cols, gid_dev, n_segments, specs, prog, lane_of, n,
                    mask_spec, program_key=program_key, params=params,
                    batchable=True)
            out_keys = self._decode_present(present, key_layouts)
        return self._assemble_output(chk, plan, slots, out_keys, out_aggs,
                                     first_orig,
                                     [l[3] for l in key_layouts])

    def _fused_blockwise(self, chk, rep, child, filters, specs,
                         arg_exprs, slots, key_layouts, n_segments: int,
                         n: int, budget: int):
        """Block-wise fused aggregation: row blocks of ``budget`` rows
        upload transiently (not memoized on the replica: the table is the
        one that does not fit), HK7 + HK2 (grouped) or HK7 + HK1 (scalar)
        reduce each block on the card, and per-segment partial states
        (sum / count add, min / max fold, first-row min, presence union)
        carry on the host between blocks, in block order.

        Staging (slice, pad, upload) runs through a BlockPipeline:
        inline by default, and at tidb_pipeline_depth > 0 on its thread
        and side stream while the card reduces the previous block and
        this thread folds its partials, with the same fold order and so
        the same result."""
        from .devpipe import BlockPipeline, pipeline_depth
        fmask = _fold_filter_masks(child, rep, chk, filters) \
            if filters else None
        pt = ParamTable()
        prog, lane_of, program_key = _agg_program(specs, arg_exprs, [], pt)
        params = pt.arrays()
        needed = set()
        for a in arg_exprs:
            if isinstance(a, tuple):
                needed.add((a[1], "mask"))
            elif a is not None:
                for c in a.collect_columns():
                    needed.add((c.index, "full"))
        # eligibility before the pipeline starts: a string column in a
        # compute expression leaves the whole path, never one block
        for idx, kind in needed:
            v = chk.columns[idx].values()
            if kind == "full" and (v.dtype == object or v.dtype.kind == "U"):
                return None
        gid_full = self._compose_gid(key_layouts, n) if key_layouts \
            else None
        ns = n_segments if key_layouts else 1
        bb = kernels.bucket(budget)
        seen = np.zeros(ns, dtype=bool)
        first_acc = np.full(ns, np.iinfo(np.int64).max, dtype=np.int64)
        acc: list = [None] * len(specs)

        def ensure_acc(i, kind, dtype):
            if acc[i] is not None:
                return acc[i]
            if kind in ("count_star", "count", "sum", "sum0"):
                av = np.zeros(ns, dtype=dtype)
            elif kind == "min":
                av = np.full(ns, np.inf if dtype == np.float64
                             else np.iinfo(np.int64).max, dtype=dtype)
            else:
                av = np.full(ns, -np.inf if dtype == np.float64
                             else np.iinfo(np.int64).min, dtype=dtype)
            acc[i] = (av, np.ones(ns, dtype=bool))
            return acc[i]

        def stage(start):
            """Host half of one block: slice, pad, upload."""
            end = min(start + budget, n)
            m_rows = end - start
            dev_cols = [None] * len(chk.columns)
            for idx, kind in needed:
                col = chk.columns[idx]
                v = col.values()
                m_ = col.null_mask()
                if v.dtype == object or v.dtype.kind == "U":
                    dv = None  # mask-only slot (COUNT over a string col)
                else:
                    dv = kernels.h2d_pad(v[start:end], bb)
                dn = kernels.h2d_pad(m_[start:end], bb, True)
                if dev_cols[idx] is None or dv is not None:
                    dev_cols[idx] = (dv, dn)
            bmask = np.zeros(bb, dtype=bool)
            bmask[:m_rows] = fmask[start:end] if fmask is not None \
                else True
            mask_spec = ("host", kernels.h2d(bmask))
            gid_b = kernels.h2d_pad(gid_full[start:end], bb) \
                if key_layouts else None
            return start, m_rows, dev_cols, mask_spec, gid_b

        t_pipe = time.time()
        dispatch_s = drain_s = 0.0
        pipe = BlockPipeline(stage, range(0, n, budget),
                             depth=pipeline_depth(self.ctx.session_vars))
        for start, m_rows, dev_cols, mask_spec, gid_b in pipe:
            t0 = time.time()
            if key_layouts:
                present, outs, first = kernels.fused_segment_aggregate(
                    dev_cols, gid_b, ns, specs, prog, lane_of, m_rows,
                    mask_spec, program_key=program_key, params=params)
            else:
                # scalar contract: zero-or-one-row arrays; an empty block
                # contributes nothing
                outs, first = kernels.fused_scalar_aggregate(
                    dev_cols, specs, prog, lane_of, m_rows, bb, mask_spec,
                    program_key=program_key, params=params)
                present = np.zeros(len(first), dtype=np.int64)
            dispatch_s += time.time() - t0
            t0 = time.time()
            if len(present) == 0:
                continue
            seen[present] = True
            first_acc[present] = np.minimum(first_acc[present],
                                            np.asarray(first) + start)
            for i, ((v_, m_), (kind, _)) in enumerate(zip(outs, specs)):
                v_ = np.asarray(v_)
                live = ~np.asarray(m_, dtype=bool)
                if not live.any():
                    continue
                av, am = ensure_acc(i, kind, v_.dtype)
                ids = np.asarray(present)[live]
                vv = v_[live]
                if kind in ("count_star", "count", "sum", "sum0"):
                    av[ids] += vv
                elif kind == "min":
                    av[ids] = np.minimum(av[ids], vv)
                else:
                    av[ids] = np.maximum(av[ids], vv)
                am[ids] = False
            drain_s += time.time() - t0
        ps = pipe.stats()
        kernels.pipe_record(blocks=ps["blocks"], stage_s=ps["stage_s"],
                            dispatch_s=dispatch_s, drain_s=drain_s,
                            wall_s=time.time() - t_pipe,
                            depth_hwm=ps["depth_hwm"])
        if self.plan.group_by:
            present_ids = np.nonzero(seen)[0]
        else:
            # a scalar aggregate over zero rows still returns one row
            # (COUNT = 0, SUM = NULL)
            present_ids = np.arange(1)
            if not seen[0]:
                first_acc[0] = 0
        out_aggs = []
        for i, (kind, _) in enumerate(specs):
            if acc[i] is None:
                dt = np.int64 if kind != "sum" else np.float64
                av = np.zeros(ns, dtype=dt)
                am = np.ones(ns, dtype=bool)
                if kind in ("count_star", "count", "sum0"):
                    am = np.zeros(ns, dtype=bool)  # COUNT of nothing = 0
                acc[i] = (av, am)
            av, am = acc[i]
            if kind in ("count_star", "count", "sum0"):
                am = np.zeros_like(am)  # counts are never NULL
            out_aggs.append((av[present_ids], am[present_ids]))
        out_keys = self._decode_present(present_ids, key_layouts) \
            if key_layouts else []
        first_orig = np.where(
            first_acc[present_ids] == np.iinfo(np.int64).max, 0,
            first_acc[present_ids])
        return self._assemble_output(chk, self.plan, slots, out_keys,
                                     out_aggs, first_orig,
                                     [l[3] for l in key_layouts])

    @staticmethod
    def _rep_key_codes(rep, e, chk, slot_id):
        """(codes np[int64], card, base, decode) memoized on the replica,
        keyed by the column's stable id (NOT the query-local offset)."""
        idx = e.index
        col = chk.columns[idx]
        v = col.values()
        null = col.null_mask()
        is_string = v.dtype == object or v.dtype.kind == "U"
        uns = (not is_string and v.dtype == np.int64
               and getattr(e.ret_type, "is_unsigned", False))
        if is_string:
            # shared with the filter rewrite: one dictionary per column
            return _rep_string_dict(rep, slot_id, chk, idx)

        def build():
            w = (v ^ np.int64(-2**63)) if uns else v
            if w.dtype != np.int64:
                return None
            nn = w[~null]
            if len(nn) == 0:
                return (np.zeros(len(w), dtype=np.int64), 0, 0, None)
            vmin, vmax = int(nn.min()), int(nn.max())
            card = vmax - vmin + 1
            if card > kernels.seg_limit(len(w)):
                return None
            codes = np.where(null, card, w - vmin).astype(np.int64)
            return codes, card, vmin, None
        return rep.memo(("keycodes", slot_id, is_string, uns), build)

    @staticmethod
    def _compose_gid(key_layouts, n: int) -> np.ndarray:
        gid = np.zeros(n, dtype=np.int64)
        for codes, card, _, _ in key_layouts:
            gid = gid * (card + 1) + codes
        return gid

    @staticmethod
    def _decode_present(present, key_layouts):
        out_keys = []
        strides = []
        s = 1
        for _, card, _, _ in reversed(key_layouts):
            strides.append(s)
            s *= card + 1
        strides.reverse()
        for (codes, card, base, decode), stride in zip(key_layouts, strides):
            code = (present // stride) % (card + 1)
            is_null = code == card
            vals = np.where(is_null, 0, code + base)
            out_keys.append((vals.astype(np.int64), is_null))
        return out_keys

    def next(self) -> Optional[Chunk]:
        if self._done:
            return None
        self._done = True
        plan = self.plan
        if plan.group_by:
            # per-row partition payload: gid + rid + each arg's pair
            _spill_gate(self.ctx, _est_rows_of(plan.children[0]), 0,
                        16 + sum(9 for _ in plan.aggs) * 2)
        fused = self._try_fused_device()
        if fused is not None:
            return fused
        chk, filter_mask = self._raw_replica_input()
        if chk is None:
            chk = _drain_chunk(self.children[0],
                               self.children[0].field_types()).compact()
        n = chk.full_rows()

        # ---- keys (dictionary-encode strings) -------------------------
        keys = [_encode_key(e, chk) for e in plan.group_by]
        key_cols = [(v, m) for v, m, _ in keys]

        # ---- agg specs --------------------------------------------------
        # device does count/sum/min/max; avg = sum+count pair;
        # first_row is gathered host-side by representative row id
        specs: List[Tuple[str, bool]] = []
        arg_cols: List[Tuple[np.ndarray, np.ndarray]] = []
        slots: List[tuple] = []

        dev_args: List[tuple] = []  # (arg index, HK7 program output)

        def add_arg(e, cast_real=False, order_map=False,
                    null_only=False) -> bool:
            """Returns True when the arg was XOR-sign-bit mapped (unsigned
            min/max ordering) so the caller can un-map the result.  A
            jittable argument over numeric columns is left to ONE HK7
            launch for all of them (_device_args)."""
            uns = (e.eval_type is EvalType.INT
                   and getattr(e.ret_type, "is_unsigned", False))
            if _device_arg_ok(e, chk) and not (order_map and uns):
                if cast_real and e.eval_type is not EvalType.REAL:
                    from ..expression.builtins import new_function
                    e = new_function("cast_real", [e])
                dev_args.append((len(arg_cols), ("null", e) if null_only
                                 else e))
                arg_cols.append(None)
                return False
            v, m = e.vec_eval(chk)
            if null_only or v.dtype == object or v.dtype.kind == "U":
                # COUNT only consumes the null mask; string values (and any
                # non-numeric dtype) must not reach the device
                v = np.zeros(len(m), dtype=np.int64)
            was_mapped = False
            if cast_real and v.dtype != np.float64:
                r = v.astype(np.float64)
                if uns and v.dtype == np.int64:
                    # unwrap wrapped uint64 into its real value
                    r = np.where(v < 0, r + 2.0**64, r)
                v = r
            elif order_map and uns and v.dtype == np.int64:
                # min/max compare on device: XOR maps unsigned order onto
                # signed int64 order; un-mapped in agg_result
                v = v ^ np.int64(-2**63)
                was_mapped = True
            arg_cols.append((v, m))
            return was_mapped

        from ..expression.aggregation import AggMode
        for d in plan.aggs:
            # FINAL mode merges PARTIAL states (agg pushdown through join)
            if d.mode is AggMode.FINAL and d.name == AGG_COUNT:
                specs.append(("sum0", True))  # merged COUNT: 0, not NULL
                add_arg(d.args[0])
                slots.append(("dev", len(specs) - 1))
            elif d.mode is AggMode.FINAL and d.name == AGG_AVG:
                specs.append(("sum", True))
                add_arg(d.args[0], cast_real=True)
                specs.append(("sum", True))
                add_arg(d.args[1])
                slots.append(("avg", len(specs) - 2, len(specs) - 1))
            elif d.name == AGG_COUNT:
                from ..expression import Constant
                a = d.args[0]
                if isinstance(a, Constant) and a.value is not None:
                    specs.append(("count_star", False))
                    slots.append(("dev", len(specs) - 1))
                else:
                    specs.append(("count", True))
                    add_arg(a, null_only=True)
                    slots.append(("dev", len(specs) - 1))
            elif d.name == AGG_SUM:
                specs.append(("sum", True))
                add_arg(d.args[0],
                        cast_real=d.ret_type.eval_type is EvalType.REAL)
                slots.append(("dev", len(specs) - 1))
            elif d.name == AGG_AVG:
                specs.append(("sum", True))
                add_arg(d.args[0], cast_real=True)
                specs.append(("count", True))
                add_arg(d.args[0], null_only=True)
                slots.append(("avg", len(specs) - 2, len(specs) - 1))
            elif d.name in (AGG_MAX, AGG_MIN):
                specs.append((("max" if d.name == AGG_MAX else "min"), True))
                was_mapped = add_arg(d.args[0], order_map=True)
                slots.append(("dev_mm", len(specs) - 1, was_mapped))
            elif d.name == AGG_FIRST_ROW:
                slots.append(("first", d.args[0]))
            else:  # pragma: no cover — enforcer gates
                raise ValueError(d.name)

        if dev_args:
            arg_cols = _device_args(chk, n, arg_cols, dev_args)
        _check_mesh(self.ctx)
        if not plan.group_by:
            out_keys = []
            out_aggs, first_orig = kernels.scalar_aggregate(
                specs, arg_cols, n, filter_mask=filter_mask)
        else:
            seg = self._try_segment_layout(keys, n)
            if seg is not None:
                # known small cardinality: sort-free segment reductions
                gid, cards, bases, n_segments = seg
                _spill_gate(self.ctx, _est_rows_of(plan.children[0]), n,
                            16 + 18 * len(arg_cols))
                present, out_aggs, first_orig = \
                    kernels.segment_group_aggregate(
                        gid, n_segments, specs, arg_cols, n,
                        filter_mask=filter_mask)
                out_keys = []
                strides = []
                s = 1
                for c in reversed(cards):
                    strides.append(s)
                    s *= c + 1
                strides.reverse()
                for i, (c, base) in enumerate(zip(cards, bases)):
                    code = (present // strides[i]) % (c + 1)
                    is_null = code == c
                    vals = np.where(is_null, 0, code + base)
                    out_keys.append((vals.astype(np.int64), is_null))
            else:
                # sort-based grouping (float keys / huge cardinality)
                out_keys, out_aggs, first_orig = kernels.group_aggregate(
                    key_cols, specs, arg_cols, n, filter_mask=filter_mask)
        return self._assemble_output(chk, plan, slots, out_keys, out_aggs,
                                     first_orig, [d for _, _, d in keys])

    def _can_device_passthrough(self, plan, slots, key_layouts) -> bool:
        """Late-materialization gate: the aggregate's output chunk stays
        device-resident (DeviceColumn) when every output can be produced
        by tensor ops — numeric group keys without a string decode table
        or unsigned order-map, and dev/avg/min-max slots."""
        if not plan.group_by:
            return False
        try:
            if int(self.ctx.session_vars.get(
                    "tidb_device_passthrough", 1) or 0) == 0:
                return False
        except Exception:
            pass
        for sl in slots:
            if sl[0] == "dev" or sl[0] == "avg":
                continue
            if sl[0] == "dev_mm" and not sl[2]:
                continue
            return False
        for lay, e in zip(key_layouts, plan.group_by):
            if lay[3] is not None:  # string dictionary decode
                return False
            if getattr(e.ret_type, "is_unsigned", False):
                return False
        return True

    def _assemble_device_output(self, plan, slots, key_layouts, ids, live,
                                out_aggs, np_):
        """Device-resident output chunk (K15, one HK7 launch): decode group
        ids back to key values and finish the slots (avg divide, REAL
        cast), producing bucket-padded (values, null) pairs wrapped as
        DeviceColumns.  Nothing lands on host until a host consumer
        asks."""
        from ..chunk import DeviceColumn
        strides = []
        s = 1
        for _, card, _, _ in reversed(key_layouts):
            strides.append(s)
            s *= card + 1
        strides.reverse()
        lay = [(card, base, stride) for (_, card, base, _), stride
               in zip(key_layouts, strides)]
        slot_sig = []
        for src, idx in plan.output_map:
            if src == "agg":
                sl = slots[idx]
                real = (plan.aggs[idx].ret_type.eval_type
                        is EvalType.REAL)
                slot_sig.append((sl[0], sl[1],
                                 sl[2] if sl[0] == "avg" else None, real))
            else:
                slot_sig.append(("gb", idx, None, False))
        ob = int(ids.shape[0])
        key = ("devout", ob, len(key_layouts), tuple(slot_sig),
               tuple(str(v.dtype) for v, _ in out_aggs))
        # K15 as ONE HK7 program: slot 0 the group ids, slot 1 their
        # liveness, then each aggregate's (values, NULL) pair; the key
        # layouts (stride, card, base) ride the parameter table
        pt = ParamTable()
        xp = ExprProgram()
        for kind, i, extra, real in slot_sig:
            if kind == "gb":
                card, base, stride = lay[i]
                r = xp.key_decode(xp.load(0, "i"), xp.load(1, "b"), stride,
                                  card, base, pt)
            elif kind == "avg":
                s_dt = "f" if out_aggs[i][0].dtype == torch.float64 else "i"
                r = xp.avg(xp.load(2 + i, s_dt), xp.load(2 + extra, "i"))
            else:  # dev / dev_mm (unsigned excluded by the gate)
                v = out_aggs[i][0]
                r = xp.load(2 + i, "f" if v.dtype == torch.float64 else "i")
                if real:
                    r = xp.to_real(r)
            xp.store(r)
        run = progcache.get(key, lambda: kernels.counted_launch(
            lambda cols, params: kernels.expr_eval(xp, cols, params, ob)[1]))
        outs = run([(ids, None), (live, None)] + list(out_aggs),
                   kernels._params_dev(pt.arrays()))
        cols = []
        for (src, idx), (v, m) in zip(plan.output_map, outs):
            ft = (plan.aggs[idx].ret_type if src == "agg"
                  else plan.group_by[idx].ret_type)
            col = DeviceColumn(ft, v.contiguous(), m.contiguous(), np_)
            cols.append(col)
        return Chunk.from_columns(cols)

    def _assemble_output(self, chk, plan, slots, out_keys, out_aggs,
                         first_orig, decodes):
        """Materialize the output chunk from kernel results (shared by the
        fused, segment, scalar, and sort-based aggregation paths)."""
        ng = len(first_orig)

        # empty input + no GROUP BY: single default row (COUNT=0, SUM=NULL)
        if ng == 0 and not plan.group_by:
            from .aggfuncs import new_state
            out = Chunk(self.field_types(), cap=1)
            states = [new_state(d) for d in plan.aggs]
            row = []
            for src, idx in plan.output_map:
                row.append(states[idx].result() if src == "agg" else None)
            out.append_row(row)
            return out

        def agg_result(i: int) -> CCol:
            d = plan.aggs[i]
            slot = slots[i]
            if slot[0] in ("dev", "dev_mm"):
                v, m = out_aggs[slot[1]]
                if slot[0] == "dev_mm" and slot[2]:
                    v = v ^ np.int64(-2**63)  # undo unsigned order map
                if d.ret_type.eval_type is EvalType.REAL \
                        and v.dtype != np.float64:
                    v = v.astype(np.float64)
                return CCol.from_numpy(d.ret_type, v, m)
            if slot[0] == "avg":
                sv, sm = out_aggs[slot[1]]
                cv, _ = out_aggs[slot[2]]
                cnt = np.maximum(cv, 1)
                return CCol.from_numpy(d.ret_type, sv / cnt, sm | (cv == 0))
            # first_row: gather by representative row id (any type)
            col_expr = slot[1]
            v, m = col_expr.vec_eval(chk)
            return CCol.from_numpy(d.ret_type, v[first_orig], m[first_orig])

        def gb_result(i: int) -> CCol:
            decode = decodes[i]
            e = plan.group_by[i]
            if decode is not None:
                vals = np.empty(ng, dtype=object)
                kvals = out_keys[i][0]
                for r in range(ng):
                    vals[r] = str(decode[kvals[r]])  # np.str_ -> str
                return CCol.from_numpy(e.ret_type, vals, out_keys[i][1])
            kv, km = out_keys[i]
            if (kv.dtype == np.int64 and e.eval_type is EvalType.INT
                    and getattr(e.ret_type, "is_unsigned", False)):
                kv = kv ^ np.int64(-2**63)  # undo the unsigned order map
            return CCol.from_numpy(e.ret_type, kv, km)

        cols = []
        for src, idx in plan.output_map:
            cols.append(agg_result(idx) if src == "agg" else gb_result(idx))
        return Chunk.from_columns(cols)


class GPUHashJoinExec(Executor):
    """Equi-join matched by HK3: a key -> row table (dense or hashed) for
    a unique build side, a sorted build side with binary-search runs for
    any multiplicity."""

    def __init__(self, plan: PhysicalHashJoin, left: Executor,
                 right: Executor):
        super().__init__(plan.schema, [left, right])
        self.plan = plan
        self._done = False

    def open(self, ctx):
        super().open(ctx)
        self._done = False

    def _side_input(self, i: int, side_conds):
        """(chunk, mask, replica): replica-backed readers keep RAW rows
        with scan and side filters folded into a mask; other children
        materialize compacted with side conds applied."""
        ex = self.children[i]
        chk, mask, rep = _take_replica_masked(ex, side_conds)
        if chk is not None:
            chk, mask = _compact_if_selective(chk, mask)
            return chk, mask, (rep if mask is not None else None)
        chk = _child_input(ex)
        if side_conds:
            m = vectorized_filter(side_conds, chk)
            chk.set_sel(np.nonzero(m)[0])
            chk = chk.compact()
        return chk, None, None

    def next(self) -> Optional[Chunk]:
        if self._done:
            return None
        self._done = True
        plan = self.plan
        if plan.tp in ("semi", "anti"):
            return self._semi_next()
        outer = plan.tp == "left"
        # Outer join: ON-clause left conds decide MATCHING (failing outer
        # rows null-extend), so they must NOT fold into lvalid.  Instead
        # poison the key null-mask: a NULL key matches nothing, and the
        # outer path emits unmatched valid rows once with right index -1.
        on_left = plan.left_conditions if outer else []
        right_unique = getattr(plan, "right_unique", False)
        left_unique = getattr(plan, "left_unique", False)
        est = _est_rows_of(plan.children[0]) + _est_rows_of(
            plan.children[1])
        _spill_gate(self.ctx, est, 0, _JOIN_ROW_BYTES)
        lchk, lmask, lrep = self._side_input(
            0, [] if on_left else plan.left_conditions)
        rchk, rmask, rrep = self._side_input(1, plan.right_conditions)
        _spill_gate(self.ctx, est, lchk.full_rows() + rchk.full_rows(),
                    _JOIN_ROW_BYTES)
        probe_side = 1 if (left_unique and plan.tp == "inner"
                           and not right_unique) else 0
        # block-wise probe streaming: when the PROBE side exceeds
        # tidb_device_block_rows, its key column uploads per block against
        # the build keys resident on the card; the probe column never
        # uploads whole.  Multi-key joins ride one composite lane built
        # over both sides whole, so they do not stream.
        budget = _block_budget(self.ctx.session_vars)
        probe_chk = lchk if probe_side == 0 else rchk
        composite = len(plan.left_keys) > 1
        stream = (budget > 0 and probe_chk.full_rows() > budget
                  and not composite)
        if not stream:
            _check_mesh(self.ctx)
        from .devpipe import BlockPipeline, pipeline_depth
        depth = pipeline_depth(self.ctx.session_vars)

        def keys_of(side, expr, chk, rep):
            if stream and side == probe_side:
                v, m = expr.vec_eval(chk)  # host: no whole-column upload
                return np.asarray(v), np.asarray(m)
            return self._key_arrays(expr, chk, rep, side)

        if composite:
            # multi-key equi-joins ride ONE composite int64 lane (joint
            # factorization over both sides — collision-free)
            (lk, lnull), (rk, rnull) = _composite_key_lanes(
                plan.left_keys, lchk, plan.right_keys, rchk)
        else:
            lk, lnull = keys_of(0, plan.left_keys[0], lchk, lrep)
            rk, rnull = keys_of(1, plan.right_keys[0], rchk, rrep)
        if on_left:
            on_mask = vectorized_filter(on_left, lchk)
            # poison only the NULL mask (values may stay device-resident);
            # a padded device mask re-lands on host, padding rows are
            # already null=True
            lnull = kernels.d2h(lnull) if isinstance(lnull, torch.Tensor) \
                else np.asarray(lnull)
            if lnull.shape[0] != on_mask.shape[0]:
                fail_m = np.zeros(lnull.shape[0], dtype=bool)
                fail_m[:on_mask.shape[0]] = ~on_mask
                lnull = lnull | fail_m
            else:
                lnull = lnull | ~on_mask

        def stream_match(fn, pk, pn, n_probe, pmask, bkey, n_build, bmask,
                         **kw):
            """``fn`` per probe block of ``budget`` rows with the block's
            validity slice; probe indices re-base by the block start and
            concatenate in block order (so every staging depth gives
            the same bytes).  At depth > 0 the staging thread uploads the
            next block's padded key while the current block's match
            runs."""
            nbb = kernels.bucket(max(n_build, 1))
            bkey = tuple(kernels._dev_key(a, nbb, fill)
                         for a, fill in zip(bkey, (0, True)))

            def stage(s_):
                e_ = min(s_ + budget, n_probe)
                m = e_ - s_
                blk = kernels.bucket(max(m, 1))
                kv = kernels.h2d_pad(pk[s_:e_], blk)
                kn = kernels.h2d_pad(pn[s_:e_], blk, True)
                pm = None if pmask is None else pmask[s_:e_]
                return s_, (kv, kn), m, pm

            pis, bis = [], []
            t_pipe = time.time()
            dispatch_s = 0.0
            pipe = BlockPipeline(stage, range(0, n_probe, budget),
                                 depth=depth)
            for s_, kpair, m, pm in pipe:
                t0 = time.time()
                pi_b, bi_b = fn(kpair, m, bkey, n_build, lvalid=pm,
                                rvalid=bmask, **kw)
                dispatch_s += time.time() - t0
                pis.append(pi_b + s_)
                bis.append(bi_b)
            ps = pipe.stats()
            kernels.pipe_record(blocks=ps["blocks"], stage_s=ps["stage_s"],
                                dispatch_s=dispatch_s,
                                wall_s=time.time() - t_pipe,
                                depth_hwm=ps["depth_hwm"])
            if not pis:
                z = np.empty(0, dtype=np.int64)
                return z, z
            return np.concatenate(pis), np.concatenate(bis)

        if right_unique:
            # unique build side: no expansion, no size sync
            if stream:
                li, ri = stream_match(
                    kernels.unique_join_match, lk, lnull, lchk.full_rows(),
                    lmask, (rk, rnull), rchk.full_rows(), rmask,
                    outer=outer)
            else:
                li, ri = kernels.unique_join_match(
                    (lk, lnull), lchk.full_rows(), (rk, rnull),
                    rchk.full_rows(), outer=outer, lvalid=lmask,
                    rvalid=rmask)
        elif left_unique and plan.tp == "inner":
            if stream:
                ri, li = stream_match(
                    kernels.unique_join_match, rk, rnull, rchk.full_rows(),
                    rmask, (lk, lnull), lchk.full_rows(), lmask,
                    outer=False)
            else:
                ri, li = kernels.unique_join_match(
                    (rk, rnull), rchk.full_rows(), (lk, lnull),
                    lchk.full_rows(), outer=False, lvalid=rmask,
                    rvalid=lmask)
        elif stream:
            li, ri = stream_match(
                kernels.join_match, lk, lnull, lchk.full_rows(), lmask,
                (rk, rnull), rchk.full_rows(), rmask, outer=outer)
        else:
            li, ri = kernels.join_match((lk, lnull), lchk.full_rows(),
                                        (rk, rnull), rchk.full_rows(),
                                        outer=outer, lvalid=lmask,
                                        rvalid=rmask)
        # gather output columns — LAZILY for inner joins: a parent join
        # or TopN composes the index chain and each payload column lands
        # once, at the final (smallest) cardinality
        from ..chunk.column import LazyTakeColumn
        unmatched = ri < 0
        ri_safe = np.where(unmatched, 0, ri)
        lazy = plan.tp != "left" and not unmatched.any()
        cols: List[CCol] = []
        for c in lchk.columns:
            cols.append(LazyTakeColumn(c, li) if lazy else c.take(li))
        for c in rchk.columns:
            if lazy:
                cols.append(LazyTakeColumn(c, ri_safe))
                continue
            taken = c.take(ri_safe)
            if unmatched.any():
                taken.null_mask()[unmatched] = True
            cols.append(taken)
        out = Chunk.from_columns(cols)
        if plan.other_conditions:
            mask = vectorized_filter(plan.other_conditions, out)
            if plan.tp == "left":
                keep = self._outer_fixup(li, ri, mask, lchk, out)
                out.set_sel(np.nonzero(keep)[0])
            else:
                out.set_sel(np.nonzero(mask)[0])
            out = out.compact()
        return out if out.num_rows() else None

    def _outer_fixup(self, li, ri, mask, lchk, out) -> np.ndarray:
        """LEFT JOIN + other-conditions: a left row keeps exactly its
        passing matches, or one NULL-extended row if none pass."""
        n_left = lchk.num_rows()
        passing = np.zeros(n_left, dtype=bool)
        matched_rows = ri >= 0
        np.logical_or.at(passing, li[matched_rows & mask], True)
        keep = np.zeros(len(li), dtype=bool)
        keep |= matched_rows & mask
        no_pass = ~passing
        seen = set()
        for idx in range(len(li)):
            l = li[idx]
            if no_pass[l] and l not in seen:
                seen.add(l)
                keep[idx] = True
                for c in out.columns[len(lchk.columns):]:
                    c.null_mask()[idx] = True
        return keep

    def _semi_next(self) -> Optional[Chunk]:
        """Semi / anti join: a membership test over the build (subquery)
        side (kernels.semi_join_match), emitting surviving LEFT rows."""
        from ..chunk.column import LazyTakeColumn
        plan = self.plan
        anti = plan.tp == "anti"
        null_aware = anti and getattr(plan, "null_aware", False)
        est = _est_rows_of(plan.children[0]) + _est_rows_of(
            plan.children[1])
        _spill_gate(self.ctx, est, 0, _JOIN_ROW_BYTES)
        lchk, lmask, lrep = self._side_input(0, plan.left_conditions)
        rchk, rmask, rrep = self._side_input(1, plan.right_conditions)
        _spill_gate(self.ctx, est, lchk.full_rows() + rchk.full_rows(),
                    _JOIN_ROW_BYTES)
        _check_mesh(self.ctx)
        if len(plan.left_keys) > 1:
            (lk, lnull), (rk, rnull) = _composite_key_lanes(
                plan.left_keys, lchk, plan.right_keys, rchk)
        else:
            lk, lnull = self._key_arrays(plan.left_keys[0], lchk, lrep, 0)
            rk, rnull = self._key_arrays(plan.right_keys[0], rchk, rrep, 1)
        li = kernels.semi_join_match(
            (lk, lnull), lchk.full_rows(), (rk, rnull), rchk.full_rows(),
            anti=anti, null_aware=null_aware, lvalid=lmask, rvalid=rmask)
        if len(li) == 0:
            return None
        cols: List[CCol] = [LazyTakeColumn(c, li) for c in lchk.columns]
        return Chunk.from_columns(cols)

    def _key_arrays(self, key_expr, chk, rep, side):
        """Join key (values, null) — for a bare Column over an uncompacted
        replica, PADDED device tensors memoized on the replica (no
        re-upload per query); device-resident for a DeviceColumn child (an
        aggregate output that never landed on host); numpy otherwise."""
        from ..chunk import DeviceColumn
        from ..expression import Column as ExprColumn
        from .executors import TableReaderExec
        if isinstance(key_expr, ExprColumn):
            col = chk.columns[key_expr.index]
            if isinstance(col, DeviceColumn) and col._data is None:
                return col.device_pair()
        if rep is not None and isinstance(key_expr, ExprColumn):
            child = self.children[side]
            if isinstance(child, TableReaderExec):
                ci = child._decode_cols[key_expr.index]
                sid = ci.id if ci is not None else "handle"
                nb = kernels.bucket(max(chk.full_rows(), 1))
                col = chk.columns[key_expr.index]
                v = col.values()
                m = col.null_mask()
                if v.dtype != object and v.dtype.kind != "U":
                    dv = _dev_memo(rep, "devv", sid, nb,
                                   lambda v=v: kernels.h2d_pad(v, nb))
                    dn = _dev_memo(rep, "devn", sid, nb,
                                   lambda m=m: kernels.h2d_pad(m, nb, True))
                    return dv, dn
        return key_expr.vec_eval(chk)


class GPUSortExec(Executor):
    def __init__(self, plan: PhysicalSort, child: Executor):
        super().__init__(plan.schema, [child])
        self.plan = plan
        self._out = None

    def open(self, ctx):
        super().open(ctx)
        self._out = None

    def next(self) -> Optional[Chunk]:
        if self._out is None:
            chk = _child_input(self.children[0])
            n = chk.num_rows()
            if n == 0:
                self._out = iter([])
            else:
                keys = [(_encode_key(e, chk)[:2]) for e, _ in self.plan.by]
                descs = [d for _, d in self.plan.by]
                row_bytes = sum(np.asarray(v).dtype.itemsize + 1
                                for v, _ in keys) + 8
                _spill_gate(self.ctx, _est_rows_of(self.plan.children[0]),
                            n, row_bytes)
                budget = _block_budget(self.ctx.session_vars)
                if budget > 0 and n > budget:
                    # above the device budget a full ORDER BY sorts on the
                    # host (same order): uploading every key whole would
                    # break tidb_device_block_rows
                    perm = kernels.host_sort_permutation(keys, descs, n)
                else:
                    _check_mesh(self.ctx)
                    perm = kernels.sort_permutation(keys, descs, n)
                chk.set_sel(perm)
                self._out = iter([chk.compact()])
        return next(self._out, None)


class GPUTopNExec(Executor):
    def __init__(self, plan: PhysicalTopN, child: Executor):
        super().__init__(plan.schema, [child])
        self.plan = plan
        self._out = None

    def open(self, ctx):
        super().open(ctx)
        self._out = None

    def next(self) -> Optional[Chunk]:
        if self._out is None:
            chk = _child_input(self.children[0])
            n = chk.num_rows()
            if n == 0:
                self._out = iter([])
            else:
                keys = [(_encode_key(e, chk)[:2]) for e, _ in self.plan.by]
                descs = [d for _, d in self.plan.by]
                k = self.plan.offset + self.plan.count
                row_bytes = sum(np.asarray(v).dtype.itemsize + 1
                                for v, _ in keys) + 8
                _spill_gate(self.ctx, _est_rows_of(self.plan.children[0]),
                            n, row_bytes)
                budget = _block_budget(self.ctx.session_vars)
                if budget > 0 and n > budget:
                    perm = self._blockwise_topk(keys, descs, n, k, budget)
                else:
                    _check_mesh(self.ctx)
                    perm = kernels.top_k(keys, descs, n, k)
                sel = perm[self.plan.offset:]
                chk.set_sel(sel)
                self._out = iter([chk.compact()] if len(sel) else [])
        return next(self._out, None)


    @staticmethod
    def _blockwise_topk(keys, descs, n: int, k: int,
                        budget: int) -> np.ndarray:
        """Block-wise top-k: each block of ``budget`` rows yields its own
        top-k candidates (HK4 over one block), the carried candidates
        merge with each block's winners (HK4 over at most 2k rows), and
        the last merge's first k are the answer — TopN's partial state
        carried across blocks."""
        if 2 * k > budget:
            # the <= 2k candidate pools would themselves exceed the
            # device budget: the selection runs on the host
            return np.asarray(
                kernels.host_sort_permutation(keys, descs, n)[:k])
        cand = np.empty(0, dtype=np.int64)
        for s_ in range(0, n, budget):
            e_ = min(s_ + budget, n)
            bkeys = [(v[s_:e_], m[s_:e_]) for v, m in keys]
            ids = np.asarray(kernels.top_k(bkeys, descs, e_ - s_,
                                           k)) + s_
            pool = np.concatenate([cand, ids])
            pkeys = [(v[pool], m[pool]) for v, m in keys]
            order = np.asarray(kernels.top_k(pkeys, descs, len(pool), k))
            cand = pool[order]
        return cand


class GPUProjectionExec(Executor):
    """Projection expressions as one HK7 launch per chunk (K16); an output
    that only names an input column is that column's upload."""

    def __init__(self, plan: PhysicalProjection, child: Executor):
        super().__init__(plan.schema, [child])
        self.plan = plan
        self._computed = [e for e in plan.exprs
                          if not isinstance(e, ExprColumn)]
        self._fn = None
        self._prog = None
        self._params = None

    def _compiled(self):
        if self._fn is None:
            from ..ops.exprjit import stable_shape_key
            key = ("proj",) + tuple(stable_shape_key(e)
                                    for e in self._computed)
            pt = ParamTable()
            prog = self._prog = compile_program((), self._computed, pt)
            self._params = kernels._params_dev(pt.arrays())

            def build():
                def program(cols, params, n):
                    return kernels.expr_eval(prog, cols, params, n)[1]
                return kernels.counted_launch(program)
            self._fn = progcache.get(key, build)
        return self._fn

    def next(self) -> Optional[Chunk]:
        chk = self.children[0].next()
        if chk is None:
            return None
        chk = chk.compact()
        if not chk.columns:
            # zero-column (TableDual) input: host numpy path handles
            # virtual row counts; nothing to gain on device
            from ..chunk import Column as HostCol
            cols = []
            for e, oc in zip(self.plan.exprs, self.plan.schema.columns):
                v, m = e.vec_eval(chk)
                cols.append(HostCol.from_numpy(oc.ret_type, v, m))
            return Chunk.from_columns(cols)
        slots = {e.index for e in self.plan.exprs
                 if isinstance(e, ExprColumn)}
        fn = self._compiled() if self._computed else None
        if fn is not None:
            slots |= {s for s, _ in self._prog.inputs}
        cols = _marshal(chk, slots)
        got = iter(fn(cols, self._params, chk.num_rows())
                   if fn is not None else ())
        outs = [cols[e.index] if isinstance(e, ExprColumn) else next(got)
                for e in self.plan.exprs]
        host = kernels.d2h_many([x for vm in outs for x in vm])
        out_cols = []
        for i, oc in enumerate(self.plan.schema.columns):
            out_cols.append(CCol.from_numpy(oc.ret_type, host[2 * i],
                                            host[2 * i + 1]))
        return Chunk.from_columns(out_cols)


class GPUSelectionExec(Executor):
    """Filters as one HK7 launch per chunk (K16); the mask comes back in
    one counted pull."""

    def __init__(self, plan: PhysicalSelection, child: Executor):
        super().__init__(plan.schema, [child])
        self.plan = plan
        self._fn = None
        self._prog = None
        self._params = None

    def _compiled(self):
        if self._fn is None:
            from ..ops.exprjit import stable_shape_key
            key = ("filter",) + tuple(stable_shape_key(c)
                                      for c in self.plan.conditions)
            pt = ParamTable()
            prog = self._prog = compile_program(self.plan.conditions, (),
                                                pt, mask=True)
            self._params = kernels._params_dev(pt.arrays())

            def build():
                def program(cols, params, n):
                    return kernels.expr_eval(prog, cols, params, n)[0]
                return kernels.counted_launch(program)
            self._fn = progcache.get(key, build)
        return self._fn

    def next(self) -> Optional[Chunk]:
        while True:
            chk = self.children[0].next()
            if chk is None:
                return None
            chk = chk.compact()
            if chk.num_rows() == 0:
                continue
            if not chk.columns:
                mask = vectorized_filter(self.plan.conditions, chk)
            else:
                fn = self._compiled()
                mask = kernels.d2h(fn(
                    _marshal(chk, {s for s, _ in self._prog.inputs}),
                    self._params, chk.num_rows()))
            if not mask.any():
                continue
            chk.set_sel(np.nonzero(mask)[0])
            return chk.compact()


def _marshal(chk: Chunk, slots=None):
    """Chunk columns -> device (values, null) pairs, for the slots in
    ``slots`` (every slot when None; None elsewhere).  String columns are
    never touched by device exprs (enforcer), but must still occupy their
    index slot — pass zeros."""
    out = []
    n = chk.num_rows()
    for i, c in enumerate(chk.columns):
        if slots is not None and i not in slots:
            out.append(None)
            continue
        v = c.values()
        if v.dtype == object or v.dtype.kind == "U":
            out.append((torch.zeros(n, dtype=torch.int64,
                                    device=kernels.device()),
                        kernels.h2d(c.null_mask())))
        else:
            out.append((kernels.h2d(v), kernels.h2d(c.null_mask())))
    return out


def build_gpu_executor(plan) -> Optional[Executor]:
    """GPU-tier builder.  Subtrees containing a supported join or a
    grouped aggregate run as a device pipeline (executor/devpipe.py), with
    the per-operator executors where the pipeline routes the plan; lone
    operators use the per-op executors (whose fused paths are already
    single-call)."""
    from .devpipe import DevPipeExec, _contains_grouped_agg, _contains_join
    if _contains_join(plan) or _contains_grouped_agg(plan):
        return DevPipeExec(plan, _build_gpu_op)
    return _build_gpu_op(plan)


def _build_gpu_op(plan) -> Optional[Executor]:
    ex = _build_gpu_op_inner(plan)
    if ex is not None and getattr(ex, "_obs_plan", None) is None:
        ex._obs_plan = plan  # per-operator stats key (obs/runtime_stats)
    return ex


def _build_gpu_op_inner(plan) -> Optional[Executor]:
    if isinstance(plan, PhysicalHashAgg):
        return GPUHashAggExec(plan, build_executor(plan.children[0], True))
    if isinstance(plan, PhysicalHashJoin):
        return GPUHashJoinExec(plan, build_executor(plan.children[0], True),
                               build_executor(plan.children[1], True))
    if isinstance(plan, PhysicalTopN):
        return GPUTopNExec(plan, build_executor(plan.children[0], True))
    if isinstance(plan, PhysicalSort):
        return GPUSortExec(plan, build_executor(plan.children[0], True))
    if isinstance(plan, PhysicalProjection):
        return GPUProjectionExec(plan,
                                 build_executor(plan.children[0], True))
    if isinstance(plan, PhysicalSelection):
        return GPUSelectionExec(plan, build_executor(plan.children[0], True))
    return None
