"""Pass 2 — plan-device invariant checker (PD2xx).

Walks PHYSICAL plans after placement and verifies the device enforcer's
invariants, using the same `tpu_admissibility` predicate the enforcer
itself places with (planner/device.py) so checker and placement cannot
drift:

- PD201: an operator marked `use_tpu` whose hot loop is NOT expressible
  as device kernels (admissibility violation — the premature-placement
  bug class of "Premature Dimensional Collapse", PAPERS.md).
- PD202: a `use_tpu` operator that derive_stats never costed — placement
  ran before estimation, so the min-rows cost gate compared garbage.
- PD203: malformed mesh join strategy (strategy outside
  broadcast/shuffle, strategy without its cost record, or strategy on a
  non-TPU node).
- PD204: `use_tpu` on an operator class with no device lowering at all
  (readers, limits, duals — the device never scans KV).
- PD205: EXPLAIN device annotation inconsistent with placement (the
  rendered task column must say `tpu` exactly when the node is placed on
  the TPU tier).
- PD206: malformed CPU-fallback edge: a child that is not a physical
  operator or lost its schema — the materialization boundary between
  tiers needs both.
- PD207: malformed mesh shard annotation: `mesh_shards` that is not a
  power of two, exceeds the live device count, or sits on an operator
  the sharded tier cannot run (checked with the same `mesh_admissible`
  predicate place_devices annotates with, so checker and placement
  cannot drift).

Runs two ways: as an opt-in runtime verifier inside the optimizer
(`verify_plan`, gated by the `tidb_qlint_verify` sysvar), and directly
over any plan (`check_plan`). The offline corpus mode over the SQL tests
comes with the static lint passes, ROADMAP queue 1, item 11.
"""
from __future__ import annotations

from typing import List, Optional

from .diag import Diagnostic, register_rules

register_rules({
    "PD201": "TPU placement violates kernel admissibility",
    "PD202": "TPU placement without a derived row estimate",
    "PD203": "malformed mesh join strategy",
    "PD204": "TPU placement on an operator with no device lowering",
    "PD205": "EXPLAIN device annotation inconsistent with placement",
    "PD206": "malformed CPU-fallback edge (non-operator or schema-less child)",
    "PD207": "malformed mesh shard annotation (non-power-of-two, over the "
             "device count, or on a mesh-inadmissible operator)",
})

_DEVICE_OPS = ("PhysicalHashAgg", "PhysicalHashJoin", "PhysicalSort",
               "PhysicalTopN", "PhysicalProjection", "PhysicalSelection")


class PlanDeviceError(Exception):
    """Raised by the opt-in runtime verifier on the first bad plan."""

    def __init__(self, diags: List[Diagnostic]):
        self.diags = diags
        super().__init__("; ".join(d.format() for d in diags))


def _node_path(path: List[str]) -> str:
    return "/".join(path) or "<root>"


def _live_device_count() -> Optional[int]:
    """The mesh's shard count (parallel/dist.py): ``TINYSQL_MESH_SHARDS``
    when set, else the CUDA device count when CUDA is already initialised;
    None offline (the checker must not initialise CUDA just to validate
    an annotation)."""
    from ..parallel import dist
    try:
        n = dist.env_shards()
    except ValueError:
        return None
    if n is not None:
        return n
    import sys
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.device_count())
    except Exception:
        return None


def check_plan(p, path: Optional[List[str]] = None,
               where: str = "<plan>") -> List[Diagnostic]:
    """All PD2xx checks over one placed physical plan tree."""
    from ..planner.device import mesh_admissible, tpu_admissibility
    from ..planner.physical import PhysicalPlan
    path = (path or []) + [p.op_name()]
    out: List[Diagnostic] = []
    use_tpu = bool(getattr(p, "use_tpu", False))
    device_capable = any(type(p).__name__ == n or
                         any(b.__name__ == n for b in type(p).__mro__)
                         for n in _DEVICE_OPS)
    if use_tpu and not device_capable:
        out.append(Diagnostic(
            "PD204", f"{_node_path(path)}: use_tpu on {p.op_name()}, "
            "which has no device lowering", where))
    elif use_tpu:
        reason = tpu_admissibility(p)
        if reason is not None:
            out.append(Diagnostic(
                "PD201", f"{_node_path(path)}: placed on TPU but "
                f"inadmissible — {reason}", where))
        if not getattr(p, "has_estimate", False):
            out.append(Diagnostic(
                "PD202", f"{_node_path(path)}: placed on TPU with no "
                "derived row estimate (derive_stats must run before "
                "place_devices)", where))
    strategy = getattr(p, "mesh_strategy", None)
    if strategy is not None:
        if strategy not in ("broadcast", "shuffle"):
            out.append(Diagnostic(
                "PD203", f"{_node_path(path)}: mesh_strategy "
                f"{strategy!r} not in broadcast/shuffle", where))
        if not use_tpu:
            out.append(Diagnostic(
                "PD203", f"{_node_path(path)}: mesh_strategy on a "
                "non-TPU node", where))
        cost = getattr(p, "mesh_cost", None)
        if not (isinstance(cost, dict) and "broadcast_bytes" in cost
                and "shuffle_bytes" in cost):
            out.append(Diagnostic(
                "PD203", f"{_node_path(path)}: mesh_strategy without "
                "its broadcast/shuffle cost record", where))
    ms = getattr(p, "mesh_shards", None)
    if ms is not None:
        ms = int(ms)
        if ms < 1 or (ms & (ms - 1)) != 0:
            out.append(Diagnostic(
                "PD207", f"{_node_path(path)}: mesh_shards {ms} is not "
                "a power of two — shard_bucket only mints power-of-two "
                "shard counts", where))
        if not use_tpu:
            out.append(Diagnostic(
                "PD207", f"{_node_path(path)}: mesh_shards on a "
                "non-TPU node — the sharded tier only runs placed "
                "operators", where))
        else:
            reason = mesh_admissible(p)
            if reason is not None:
                out.append(Diagnostic(
                    "PD207", f"{_node_path(path)}: mesh_shards on a "
                    f"mesh-inadmissible operator — {reason}", where))
        ndev = _live_device_count()
        if ndev is not None and ms > ndev:
            out.append(Diagnostic(
                "PD207", f"{_node_path(path)}: mesh_shards {ms} "
                f"exceeds the {ndev} live device(s)", where))
    for c in p.children:
        if not isinstance(c, PhysicalPlan) or c.schema is None:
            out.append(Diagnostic(
                "PD206", f"{_node_path(path)}: child "
                f"{type(c).__name__} is not a schema-bearing physical "
                "operator — the tier boundary cannot materialize it",
                where))
            continue
        out.extend(check_plan(c, path, where))
    return out


def _explain_tasks(p) -> List[tuple]:
    """(op_name, rendered_task, node) rows in explain_text order."""
    from ..planner.explain import explain_text
    from ..planner.physical import PhysicalTableReader
    rows = explain_text(p)
    nodes: List[object] = []

    def walk(n):
        nodes.append(n)
        if isinstance(n, PhysicalTableReader):
            nodes.append(n.scan)
        for c in n.children:
            walk(c)
    walk(p)
    return [(r[0].strip(), r[2], n) for r, n in zip(rows, nodes)]


def check_explain_consistency(p, where: str = "<plan>") -> List[Diagnostic]:
    """PD205: the EXPLAIN task column must render `tpu` exactly for
    placed nodes (scans render `cop`, everything else `root`)."""
    out: List[Diagnostic] = []
    for name, task, node in _explain_tasks(p):
        if node is None:
            continue
        placed = bool(getattr(node, "use_tpu", False))
        from ..planner.physical import (PhysicalTableReader,
                                        PhysicalTableScan)
        if isinstance(node, (PhysicalTableScan,)):
            expect = "cop"
        elif isinstance(node, PhysicalTableReader):
            expect = "root"
        else:
            expect = "tpu" if placed else "root"
        if task != expect:
            out.append(Diagnostic(
                "PD205", f"EXPLAIN renders task {task!r} for {name} "
                f"but placement implies {expect!r}", where))
        if placed and "(TPU)" not in name and expect == "tpu":
            out.append(Diagnostic(
                "PD205", f"EXPLAIN name {name!r} lacks the (TPU) "
                "marker for a TPU-placed node", where))
    return out


def verify_plan(p, where: str = "<plan>") -> None:
    """Opt-in runtime verifier (tidb_qlint_verify): raise on the first
    invariant violation instead of executing a mis-placed plan."""
    diags = check_plan(p, where=where) + check_explain_consistency(p, where)
    if diags:
        raise PlanDeviceError(diags)
