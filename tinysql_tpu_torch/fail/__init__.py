"""Failpoint fault-injection registry (reference: pingcap/failpoint —
`fail.Enable("github.com/pingcap/tidb/store/tikv/rpcServerBusy", ...)`,
SURVEY §5.3).

Every resilience seam in the engine declares a NAMED failpoint (the
catalogue lives in ``fail/points.py``; qlint FP502 rejects inject sites
whose name is not registered there).  Disarmed failpoints are zero-cost:
``inject``/``eval`` check one module-level dict for emptiness and
return — no lock, no allocation — so production paths pay a dict
truthiness test per seam.

Arming, three ways:

- programmatic (tests): ``with fail.armed("commitError", exc=IOError()):``
- environment: ``TINYSQL_FAILPOINTS="copTaskError=2*error(boom);
  devpipeStageError=sleep(0.01)"`` parsed on first use;
- sysvar: ``SET tidb_failpoints = 'kernelDispatchError=error(lost)'``
  (session layer calls :func:`configure`; empty string disarms all).

Actions (the pingcap/failpoint verbs): ``error(msg)`` raises
:class:`Injected`, ``sleep(seconds)`` delays, ``panic`` raises the
:class:`Panic` BaseException (models a process crash — ordinary
``except Exception`` recovery must NOT swallow it), ``return(value)``
makes ``eval`` yield the value.  An optional ``N*`` prefix fires the
action N times then disarms.  Programmatic arming can attach an
arbitrary exception instance instead (``exc=RegionError(...)``) so kv
retry ladders see their own typed errors.

Every fire bumps a per-name hit counter, exported to /metrics as
``tinysql_failpoint_hits_total{name=...}`` and fanned into the active
per-query observability scope (obs/context.py) as ``failpoint_hits``.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Optional

__all__ = [
    "Injected", "Panic", "register", "catalogue", "arm", "disarm",
    "disarm_all", "armed", "inject", "eval_point", "is_armed", "hits",
    "reset_hits", "configure", "parse_spec",
]


class Injected(RuntimeError):
    """The generic typed error an ``error(...)`` action raises."""

    def __init__(self, name: str, msg: str = ""):
        super().__init__(f"failpoint {name} injected" + (f": {msg}" if msg
                                                         else ""))
        self.failpoint = name


class Panic(BaseException):
    """Models a process crash (pingcap/failpoint's panic action): rides
    BaseException so recovery paths that catch ``Exception`` do not
    accidentally 'survive' a crash they are supposed to be killed by."""

    def __init__(self, name: str):
        super().__init__(f"failpoint {name} panic")
        self.failpoint = name


class _Action:
    __slots__ = ("kind", "value", "exc", "times")

    def __init__(self, kind: str, value: Any = True,
                 exc: Optional[BaseException] = None, times: int = -1):
        self.kind = kind          # error | sleep | panic | return
        self.value = value
        self.exc = exc
        self.times = times        # remaining fires; -1 = unlimited


_mu = threading.Lock()
#: name -> registered description (THE catalogue; points.py populates it)
_CATALOG: Dict[str, str] = {}
#: armed points only — emptiness is the disarmed fast path
_ACTIVE: Dict[str, _Action] = {}
#: name -> total fires since process start (or reset_hits)
_HITS: Dict[str, int] = {}
_ENV_LOADED = False


def register(name: str, description: str = "") -> str:
    """Declare a failpoint.  Arming an unregistered name is an error —
    the catalogue is what the chaos suite enumerates to prove every
    seam degrades cleanly."""
    with _mu:
        _CATALOG[name] = description
    return name


def catalogue() -> Dict[str, str]:
    _load_env_once()
    with _mu:
        return dict(_CATALOG)


def hits() -> Dict[str, int]:
    with _mu:
        return dict(_HITS)


def reset_hits() -> None:
    with _mu:
        _HITS.clear()


def arm(name: str, value: Any = True, exc: Optional[BaseException] = None,
        sleep: Optional[float] = None, panic: bool = False,
        times: int = -1) -> None:
    """Arm ``name``.  Precedence: exc > panic > sleep > return-value."""
    if name not in _CATALOG:
        raise ValueError(f"unregistered failpoint {name!r} — declare it in "
                         "tinysql_tpu/fail/points.py")
    if exc is not None:
        act = _Action("error", exc=exc, times=times)
    elif panic:
        act = _Action("panic", times=times)
    elif sleep is not None:
        act = _Action("sleep", value=float(sleep), times=times)
    else:
        act = _Action("return", value=value, times=times)
    with _mu:
        _ACTIVE[name] = act


def disarm(name: str) -> None:
    with _mu:
        _ACTIVE.pop(name, None)


def disarm_all() -> None:
    with _mu:
        _ACTIVE.clear()


@contextlib.contextmanager
def armed(name: str, value: Any = True,
          exc: Optional[BaseException] = None,
          sleep: Optional[float] = None, panic: bool = False,
          times: int = -1):
    """Scoped arming.  A previously armed action for the same name
    (env/sysvar arming, an outer ``armed`` block) is RESTORED on exit,
    not clobbered — the with-block is an override, not a disarm."""
    with _mu:
        prev = _ACTIVE.get(name)
    arm(name, value=value, exc=exc, sleep=sleep, panic=panic, times=times)
    try:
        yield
    finally:
        with _mu:
            if prev is not None:
                _ACTIVE[name] = prev
            else:
                _ACTIVE.pop(name, None)


def _consume(name: str) -> Optional[_Action]:
    with _mu:
        act = _ACTIVE.get(name)
        if act is None:
            return None
        if act.times == 0:
            _ACTIVE.pop(name, None)
            return None
        if act.times > 0:
            act.times -= 1
            if act.times == 0:
                _ACTIVE.pop(name, None)
        _HITS[name] = _HITS.get(name, 0) + 1
    # per-query attribution (no-op without an active statement scope)
    try:
        from ..obs import context as _obs
        _obs.record("failpoint_hits", 1)
    except Exception:
        pass
    return act


def eval_point(name: str) -> Any:
    """Fire ``name`` if armed: raises for error/panic actions, sleeps for
    sleep actions, returns the armed value for return actions; None when
    disarmed (the zero-cost path)."""
    if not _ACTIVE and _ENV_LOADED:
        return None
    _load_env_once()
    if not _ACTIVE:
        return None
    act = _consume(name)
    if act is None:
        return None
    if act.kind == "error":
        if act.exc is None:
            raise Injected(name)
        # fresh instance per fire: re-raising the ONE stored exception
        # would grow its shared __traceback__ on every retry (pinning
        # each frame's locals) and let concurrent pool workers mutate
        # it under each other
        raise _fresh_exc(act.exc)
    if act.kind == "panic":
        raise Panic(name)
    if act.kind == "sleep":
        time.sleep(act.value)  # qlint: disable=FP501 -- the sleep ACTION is the injected fault itself, not a retry path
        return True
    return act.value


def is_armed(name: str) -> bool:
    """Side-effect-free probe: is ``name`` currently armed with fires
    remaining?  Unlike :func:`eval_point` it consumes nothing from a
    counted (``N*``) arming, bumps no hit counters, and never
    raises/sleeps — for decision probes that must not perturb the
    arming they observe."""
    if not _ACTIVE and _ENV_LOADED:
        return False
    _load_env_once()
    with _mu:
        act = _ACTIVE.get(name)
        return act is not None and act.times != 0


def _fresh_exc(exc: BaseException) -> BaseException:
    """A per-fire copy of an armed exception (attributes preserved,
    traceback cleared); falls back to the original when uncopyable."""
    import copy
    try:
        new = copy.copy(exc)
        new.__traceback__ = None
        return new
    except Exception:
        return exc


def inject(name: str) -> None:
    """Statement-position form of :func:`eval_point` (discards the
    return value)."""
    eval_point(name)


# ---- spec strings (env var / sysvar) --------------------------------------

def parse_spec(spec: str) -> Dict[str, _Action]:
    """``name=action`` terms separated by ``;``.  Actions:
    ``error(msg)`` | ``sleep(seconds)`` | ``panic`` | ``return(value)``,
    optionally prefixed ``N*`` to fire N times.  Values for return() are
    parsed as int, then float, else kept as string."""
    out: Dict[str, _Action] = {}
    for term in spec.split(";"):
        term = term.strip()
        if not term:
            continue
        name, _, action = term.partition("=")
        name = name.strip()
        action = action.strip()
        if not name or not action:
            raise ValueError(f"bad failpoint term {term!r} "
                             "(want name=action)")
        if name not in _CATALOG:
            raise ValueError(f"unregistered failpoint {name!r}")
        times = -1
        if "*" in action.split("(")[0]:
            n, _, action = action.partition("*")
            times = int(n.strip())
            action = action.strip()
        verb, _, rest = action.partition("(")
        arg = rest[:-1] if rest.endswith(")") else rest
        verb = verb.strip().lower()
        if verb == "error":
            out[name] = _Action("error", exc=Injected(name, arg),
                                times=times)
        elif verb == "sleep":
            out[name] = _Action("sleep", value=float(arg), times=times)
        elif verb == "panic":
            out[name] = _Action("panic", times=times)
        elif verb == "return":
            val: Any = True
            if arg:
                for conv in (int, float):
                    try:
                        val = conv(arg)
                        break
                    except ValueError:
                        val = arg
            out[name] = _Action("return", value=val, times=times)
        else:
            raise ValueError(f"unknown failpoint action {verb!r}")
    return out


def configure(spec: str) -> None:
    """Replace ALL armed points with the parsed ``spec`` (the sysvar
    entry point: ``SET tidb_failpoints = '...'``; empty disarms all).
    The env spec is consumed FIRST so a later lazy load cannot silently
    resurrect points this call disarmed (or merge on top of it)."""
    global _ENV_LOADED
    _load_env_once()
    _ENV_LOADED = True
    acts = parse_spec(spec or "")
    with _mu:
        _ACTIVE.clear()
        _ACTIVE.update(acts)


def _load_env_once() -> None:
    """TINYSQL_FAILPOINTS env activation, applied once per process on the
    first catalogue/eval touch (after points.py registered the names)."""
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    spec = os.environ.get("TINYSQL_FAILPOINTS", "")
    if not spec:
        return
    try:
        acts = parse_spec(spec)
    except ValueError:
        import logging
        logging.getLogger("tinysql_tpu").warning(
            "ignoring malformed TINYSQL_FAILPOINTS=%r", spec, exc_info=True)
        return
    with _mu:
        for k, v in acts.items():
            _ACTIVE.setdefault(k, v)


# the catalogue must exist before any inject site fires
from . import points  # noqa: E402,F401  (registration side effects)
