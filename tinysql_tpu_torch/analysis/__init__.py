"""qlint, the part the session needs at run time: the diagnostic core
(`diag.py`) and the plan-device checks (`plan_device.py`, PD2xx), which
the optimizer runs as the opt-in runtime verifier (`tidb_qlint_verify`).

The static passes over the source tree (trace-safety, lock-, obs- and
fail-discipline, concurrency, device-flow) are not ported yet: they are
ROADMAP queue 1, item 11, and are exported here once they are retargeted
to torch idioms.
"""
from .diag import (Diagnostic, Severity, SourceFile, format_diagnostics,
                   gather_sources)
from .plan_device import PlanDeviceError, check_plan, verify_plan

__all__ = [
    "Diagnostic", "Severity", "SourceFile", "format_diagnostics",
    "gather_sources", "check_plan", "verify_plan", "PlanDeviceError",
]
