"""Device enforcer: decide which physical operators run on TPU.

The north-star planner capability (BASELINE.json): a device dimension on
physical plans — the analogue of the reference's copTask/rootTask split
(planner/core/task.go:42,364) where the question is "where does this subtree
execute".  TPU operators are admitted when their hot loop is expressible as
device kernels:

- HashAgg: agg args numeric (device segment-reduce); group keys numeric OR
  plain string Columns (order-preserving dictionary codes built host-side).
- HashJoin: numeric equi-keys — one pair (sort+searchsorted kernel) or
  several plain signed-int columns (devpipe composite lanes).
- Sort/TopN: keys numeric or plain string Columns (dictionary codes).
- Projection/Selection: every expression lowers through ops/exprjit.

Everything else falls back to the CPU tier (numpy-vectorized volcano
executors) — mirroring the reference's own Vectorized()==false fallback
(projection.go:92-93).
"""
from __future__ import annotations

from typing import Optional

from ..expression import Column, Expression
from ..expression.aggregation import (AGG_AVG, AGG_COUNT, AGG_FIRST_ROW,
                                      AGG_MAX, AGG_MIN, AGG_SUM)
from ..mytypes import EvalType
from ..ops.exprjit import is_jittable
from .physical import (PhysicalHashAgg, PhysicalHashJoin,
                       PhysicalMergeJoin, PhysicalPlan, PhysicalProjection,
                       PhysicalSelection, PhysicalSort, PhysicalTopN)

_TPU_AGGS = {AGG_COUNT, AGG_SUM, AGG_AVG, AGG_MAX, AGG_MIN, AGG_FIRST_ROW}


def _key_ok(e: Expression) -> bool:
    """Group/sort key: device-jittable numeric, or a bare string column
    (dictionary-encoded host-side with order-preserving codes)."""
    if is_jittable(e):
        return True
    return isinstance(e, Column) and e.eval_type is EvalType.STRING


def _agg_ok(d) -> bool:
    if d.name not in _TPU_AGGS or d.distinct:
        return False
    if d.name == AGG_FIRST_ROW:
        return isinstance(d.args[0], Column)  # gathered host-side by row id
    if d.name == AGG_COUNT:
        from ..expression import Constant
        a = d.args[0]
        return isinstance(a, (Column, Constant)) or is_jittable(a)
    return all(is_jittable(a) for a in d.args)


def _input_rows(p: PhysicalPlan) -> float:
    """Estimated input size of the operator's hot loop (derive_stats ran
    before placement, so children carry estimates)."""
    if not p.children:
        return 0.0
    return max(c.stats_row_count for c in p.children)


def tpu_admissibility(p: PhysicalPlan) -> Optional[str]:
    """CAPABILITY check alone: None when `p`'s hot loop is expressible as
    device kernels, else the reason it is not.  The ONE definition shared
    by the enforcer (place_devices) and the plan-device invariant checker
    (analysis/plan_device.py) — placement and verification can never
    drift apart.  Cost gating (min_rows) is deliberately not part of
    admissibility: cost only shrinks the TPU set, never makes an
    inadmissible operator legal."""
    if isinstance(p, PhysicalMergeJoin):
        return "MergeJoin is a sorted-stream operator: CPU tier only"
    if isinstance(p, PhysicalHashAgg):
        for e in p.group_by:
            if not _key_ok(e):
                return (f"group key {e.key()!r} is neither device-jittable"
                        " nor a plain string column")
        for d in p.aggs:
            if not _agg_ok(d):
                return (f"aggregate {d.name}({', '.join(a.key() for a in d.args)})"
                        f"{' distinct' if d.distinct else ''} has no"
                        " device kernel")
        return None
    if isinstance(p, PhysicalHashJoin):
        def _uns(e):
            return (e.eval_type is EvalType.INT
                    and getattr(e.ret_type, "is_unsigned", False))
        if p.tp in ("semi", "anti"):
            # device membership test (sort + searchsorted): numeric keys
            # (multi-key rides the composite factorization lane), no
            # per-pair residual evaluation
            if p.other_conditions:
                return ("semi/anti residual conditions need per-pair"
                        " evaluation: CPU tier only")
            if not p.left_keys:
                return "cartesian semi/anti join has no device kernel"
            if len(p.left_keys) == 1:
                lk, rk = p.left_keys[0], p.right_keys[0]
                if not (is_jittable(lk) and is_jittable(rk)):
                    return "join keys not device-jittable"
                if _uns(lk) != _uns(rk):
                    return ("mixed-signedness int keys need per-pair"
                            " compare semantics the membership kernel"
                            " lacks")
                return None
            for k in list(p.left_keys) + list(p.right_keys):
                if not (isinstance(k, Column)
                        and k.eval_type is EvalType.INT
                        and not _uns(k)):
                    return ("multi-key semi/anti join needs plain"
                            " signed-int columns (composite lane)")
            return None
        if p.tp not in ("inner", "left"):
            return f"{p.tp} join has no device kernel"
        if not p.left_keys:
            return "cartesian join has no device kernel"
        if len(p.left_keys) == 1:
            lk, rk = p.left_keys[0], p.right_keys[0]
            if not (is_jittable(lk) and is_jittable(rk)):
                return "join keys not device-jittable"
            if _uns(lk) != _uns(rk):
                return ("mixed-signedness int keys need per-pair compare"
                        " semantics the sort+searchsorted kernel lacks")
            return None
        for k in list(p.left_keys) + list(p.right_keys):
            if not (isinstance(k, Column)
                    and k.eval_type is EvalType.INT
                    and not _uns(k)):
                return ("multi-key join needs plain signed-int columns"
                        " (devpipe composite lanes)")
        return None
    if isinstance(p, (PhysicalSort, PhysicalTopN)):
        for e, _ in p.by:
            if not _key_ok(e):
                return (f"sort key {e.key()!r} is neither device-jittable"
                        " nor a plain string column")
        return None
    if isinstance(p, PhysicalProjection):
        for e in p.exprs:
            if not is_jittable(e):
                return f"projection expr {e.key()!r} not device-jittable"
        return None
    if isinstance(p, PhysicalSelection):
        for c in p.conditions:
            if not is_jittable(c):
                return f"filter condition {c.key()!r} not device-jittable"
        return None
    return f"{p.op_name()} has no device lowering"


def mesh_admissible(p: PhysicalPlan) -> Optional[str]:
    """CAPABILITY gate for the sharded operator tier (ops/shardops.py +
    kernels.fused_segment_aggregate_sharded): None when a TPU-admitted
    operator also has a partition-parallel kernel family, else the
    reason it runs single-device under a live mesh.  Checked on top of
    tpu_admissibility — sharding never admits an operator the device
    tier rejected."""
    if isinstance(p, PhysicalHashAgg):
        return None  # partial->final merge covers scalar and grouped
    if isinstance(p, PhysicalHashJoin):
        if len(p.left_keys) != 1:
            return ("multi-key joins ride the devpipe composite lane"
                    " unsharded")
        return None
    if isinstance(p, (PhysicalSort, PhysicalTopN)):
        if len(p.by) != 1:
            return ("multi-key order has no single total-order score"
                    " lane to merge ranks over")
        return None
    return f"{p.op_name()} has no sharded kernel family"


def _mesh_join_strategy(p: PhysicalHashJoin, n_shards: int) -> None:
    """estRows-driven broadcast-vs-shuffle cost compare for mesh joins
    (reference GetCost pattern, planner/core/task.go:146; VERDICT r4
    next-4): broadcasting replicates the build side to every shard
    (bytes x n_shards over ICI), shuffling moves each row of BOTH sides
    exactly once (all_to_all).  ANALYZE stats feed the row estimates
    through derive_stats; tidb_broadcast_build_max_rows remains a manual
    override at execution time.

    The build side mirrors the EXECUTOR's choice (devpipe _JoinNode
    compile / tpu_executors probe_side): left only when left-unique inner
    and not right-unique; right otherwise."""
    build_side = (0 if (getattr(p, "left_unique", False)
                        and p.tp == "inner"
                        and not getattr(p, "right_unique", False)
                        and len(p.left_keys) == 1)
                  else 1)
    build = p.children[build_side]
    probe = p.children[1 - build_side]
    rb = max(getattr(build, "stats_row_count", 0.0), 1.0)
    rp = max(getattr(probe, "stats_row_count", 0.0), 1.0)
    wb = 8.0 * max(len(build.schema.columns), 1)
    wp = 8.0 * max(len(probe.schema.columns), 1)
    broadcast_bytes = rb * wb * n_shards
    shuffle_bytes = rb * wb + rp * wp
    p.mesh_cost = {"broadcast_bytes": broadcast_bytes,
                   "shuffle_bytes": shuffle_bytes}
    # a build side estimated above the per-device broadcast budget never
    # broadcasts regardless of relative cost — replicating it to every
    # shard is the memory blow-up the budget exists to prevent (and the
    # executor re-checks against the ACTUAL runtime row count).  One
    # definition of the budget: the sysvar default.
    from ..session.session import DEFAULT_SYSVARS
    over_budget = rb > float(
        DEFAULT_SYSVARS["tidb_broadcast_build_max_rows"])
    p.mesh_strategy = ("shuffle" if over_budget
                       or shuffle_bytes < broadcast_bytes
                       else "broadcast")


def place_devices(p: PhysicalPlan, enabled: bool = True,
                  min_rows: float = 0.0,
                  mesh_shards: int = 0) -> PhysicalPlan:
    """Decide placement per operator: CAPABILITY (kernel expressible) AND
    COST (estimated input rows >= min_rows — an XLA compile is never worth
    it for a handful of rows; reference task.go prices the cop/root
    boundary the same way, tidb_tpu_min_rows carries the threshold).
    With a live mesh (mesh_shards >= 2) joins additionally get a
    broadcast-vs-shuffle strategy from the cost model."""
    for c in p.children:
        place_devices(c, enabled, min_rows, mesh_shards)
    if not enabled:
        return p
    big = _input_rows(p) >= min_rows
    if isinstance(p, (PhysicalHashAgg, PhysicalHashJoin, PhysicalSort,
                      PhysicalTopN, PhysicalProjection,
                      PhysicalSelection)):
        p.use_tpu = big and tpu_admissibility(p) is None
        if (isinstance(p, PhysicalHashJoin) and p.use_tpu
                and mesh_shards >= 2):
            _mesh_join_strategy(p, mesh_shards)
        # estRows-driven shard count for the sharded operator tier: a
        # power-of-two <= device count through dist.shard_bucket (the
        # sanctioned mesh-shape launder), annotated only when an actual
        # estimate exists — 1 means "degenerate, stay single-device",
        # absent means "no planner opinion, the executor's runtime row
        # gate decides alone"
        if p.use_tpu and mesh_shards >= 2 and mesh_admissible(p) is None:
            est = _input_rows(p)
            if est > 0:
                from ..parallel import dist
                p.mesh_shards = dist.shard_bucket(est, mesh_shards)
    return p
