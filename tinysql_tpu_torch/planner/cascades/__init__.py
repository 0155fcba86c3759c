"""Cascades optimizer framework (reference: planner/cascades + memo +
implementation, SURVEY §2.3): memo-based exploration with pattern-matched
transformation rules, then cost-driven winner extraction sharing the
System-R physical tail.  Enabled per-session with
SET @@tidb_enable_cascades_planner = 1."""
from .optimize import find_best_plan

__all__ = ["find_best_plan"]
