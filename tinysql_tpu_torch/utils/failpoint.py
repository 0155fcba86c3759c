"""Back-compat shim over the ``tinysql_tpu.fail`` registry.

The original failpoint library grew into a full package (``fail/`` —
catalogue, env/sysvar arming, action verbs, hit counters); existing
call sites and tests keep this module's surface.  New code should import
``tinysql_tpu.fail`` directly.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

from .. import fail

disable_point = fail.disarm
disable_all = fail.disarm_all
inject = fail.inject
eval = fail.eval_point       # noqa: A001 - mirrors failpoint.Eval


@contextlib.contextmanager
def enable(name: str, value: Any = True,
           exc: Optional[Exception] = None, times: int = -1):
    """The OLD positional signature — (name, value, exc, times) — which
    ``fail.armed`` no longer matches (it grew sleep/panic between exc
    and times); aliasing it would silently rebind a positional ``times``
    as a sleep duration."""
    with fail.armed(name, value=value, exc=exc, times=times):
        yield


def enable_point(name: str, value: Any = True,
                 exc: Optional[Exception] = None, times: int = -1) -> None:
    fail.arm(name, value=value, exc=exc, times=times)


def enable_times(name: str, value: Any = True,
                 exc: Optional[Exception] = None, times: int = 1) -> None:
    fail.arm(name, value=value, exc=exc, times=times)
