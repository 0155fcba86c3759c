"""Per-SERVER schema-cache domain (reference: domain/domain.go —
`Domain.InfoSchema` :242 / `Reload` :264 / the lease-driven reload loop
:319) plus the in-proc schema-version registry that feeds the DDL
syncer barrier (reference: ddl/util/syncer.go — each server publishes
the schema version it has loaded; the DDL owner waits for every live
server to catch up before the next F1 state transition).

In the reference the registry and the watch channel live in etcd; this
in-process build keeps them on the shared storage object (SURVEY §2.6:
"host RPC + plain function calls replace gRPC in the single-process
teaching build") — same protocol, no sockets.  Each `Server` owns one
Domain; embedded sessions without a Domain keep the always-fresh lazy
reload and never enter the registry.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..catalog.infoschema import InfoSchema
from ..catalog.meta import Meta


def _registry_of(storage) -> Dict[str, "Domain"]:
    reg = getattr(storage, "_domain_registry", None)
    if reg is None:
        reg = storage._domain_registry = {}
    return reg


class Domain:
    def __init__(self, storage, server_id: Optional[str] = None,
                 lease_s: float = 0.0, background: bool = False):
        """lease_s=0: every info_schema() call re-checks the stored
        version (embedded default — always fresh).  lease_s>0: the cache
        is trusted for that long, like the reference's schema lease; pair
        with background=True to reload from a ticker thread the way
        domain.go:319 does."""
        self.storage = storage
        self.server_id = server_id or f"server-{id(self):x}"
        self.lease_s = lease_s
        self._is: Optional[InfoSchema] = None
        self._loaded_at = 0.0
        self._mu = threading.RLock()
        self._closed = threading.Event()
        self._ticker: Optional[threading.Thread] = None
        self._ddl = None
        _registry_of(storage)[self.server_id] = self
        self.reload()
        if background and lease_s > 0:
            self._ticker = threading.Thread(
                target=self._reload_loop, daemon=True,
                name=f"domain-reload-{self.server_id}")
            self._ticker.start()
            # owner duty loop (reference: ddl_worker.go:112 — the owner's
            # background worker drains jobs OTHER servers enqueued; without
            # it a non-owner's DDL would stall until the lease lapses)
            self._owner_loop = threading.Thread(
                target=self._ddl_owner_loop, daemon=True,
                name=f"ddl-owner-{self.server_id}")
            self._owner_loop.start()

    # ---- reference Domain.InfoSchema ------------------------------------
    def info_schema(self) -> InfoSchema:
        with self._mu:
            stale = (self._is is None
                     or time.monotonic() - self._loaded_at >= self.lease_s)
            if stale:
                self.reload()
            return self._is

    # ---- reference Domain.Reload ----------------------------------------
    def reload(self) -> None:
        with self._mu:
            txn = self.storage.begin()
            try:
                ver = Meta(txn).schema_version()
            finally:
                txn.rollback()
            if self._is is None or self._is.version != ver:
                self._is = InfoSchema.load(self.storage)
            self._loaded_at = time.monotonic()

    def loaded_version(self) -> int:
        with self._mu:
            return self._is.version if self._is is not None else -1

    def _reload_loop(self) -> None:
        while not self._closed.wait(self.lease_s / 2):
            try:
                self.reload()
            except Exception:
                pass  # storage being torn down; next tick retries

    def _ddl_owner_loop(self) -> None:
        while not self._closed.wait(max(self.lease_s, 0.02)):
            try:
                ddl = self.ddl()
                if ddl.owner.campaign():
                    ddl.worker.run_pending(owner=ddl.owner)
                    # the GC safepoint trigger rides the owner duty loop
                    # (reference: the gc worker leader): exactly one
                    # server per storage advances the safepoint, paced
                    # by storage.maybe_run_gc itself
                    self._maybe_gc()
            except Exception:
                pass

    def _maybe_gc(self) -> None:
        """Invoke mvcc GC when the GLOBAL ``tidb_gc_safepoint`` sysvar
        arms a retention window (seconds; 0 = disabled)."""
        run = getattr(self.storage, "maybe_run_gc", None)
        if run is None:
            return
        g = getattr(self.storage, "_global_vars", None) or {}
        retention = g.get("tidb_gc_safepoint", 0)
        if retention:
            run(retention)

    def ddl(self):
        """Per-server DDL facade whose owner manager campaigns under
        this server's identity (reference: ddl owned by the domain,
        domain.go:474 Init starts ddl with the owner manager)."""
        with self._mu:
            if self._ddl is None:
                # closed domains must not mint NEW facades: close() has
                # already taken its retire snapshot under this lock, so
                # a facade created now would campaign unretired and its
                # ownership could only lapse by TTL
                if self._closed.is_set():
                    raise RuntimeError(
                        f"domain {self.server_id} is closed")
                from ..ddl.ddl import DDL
                from ..ddl.owner import OwnerManager
                self._ddl = DDL(self.storage,
                                owner=OwnerManager(self.storage,
                                                   self.server_id))
            return self._ddl

    def close(self) -> None:
        # ordering closes the race with ddl(): _closed is set BEFORE the
        # locked snapshot, so any facade created earlier is visible here
        # and retired, and any ddl() still waiting on _mu sees _closed
        # and refuses to mint a facade that would campaign unretired
        self._closed.set()
        with self._mu:
            ddl = self._ddl
        if ddl is not None:
            # clean shutdown resigns DDL ownership (reference:
            # owner.Manager ResignOwner on server close) so surviving
            # servers take over immediately, not after the lease TTL
            try:
                ddl.owner.retire()
            except Exception:
                pass
        _registry_of(self.storage).pop(self.server_id, None)


def shared_domain(storage) -> "Domain":
    """The storage's always-fresh (lease 0) embedded domain — the default
    for sessions constructed without a per-server Domain.  Lease-0
    domains are exempt from the syncer barrier (they cannot serve stale
    schema) and share ONE owner identity so embedded DDL participates in
    the same election as server DDL."""
    d = getattr(storage, "_shared_domain", None)
    if d is None or d._closed.is_set():
        d = storage._shared_domain = Domain(storage, "embedded-shared",
                                            lease_s=0.0)
    return d


def wait_schema_synced(storage, version: int, timeout_s: float = 1.0,
                       poll_s: float = 0.002) -> bool:
    """The syncer barrier (reference: ddl/util/syncer.go
    OwnerCheckAllVersions): block until every registered live domain has
    loaded `version` or newer.  Times out like the reference does when a
    server lags past the lease — safe because the schema VALIDATOR
    (2PC commit-time version re-check) aborts any transaction that
    committed against a schema the DDL has since moved past."""
    deadline = time.monotonic() + timeout_s
    while True:
        domains = list(_registry_of(storage).values())
        # lease-0 domains re-check the stored version on EVERY access, so
        # they can never serve a stale schema — treat as always synced
        if all(d.loaded_version() >= version for d in domains
               if not d._closed.is_set() and d.lease_s > 0):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll_s)
