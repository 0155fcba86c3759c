"""DDL owner election (reference: owner/manager.go:46 — campaign on an
etcd election with a leased key; owner/mock.go for single-node).

In-proc analogue: a leased (owner_id, expires_at) slot on the shared
storage object guarded by one lock — the same campaign/renew/retire
protocol without etcd.  Exactly one live manager is owner at a time;
ownership lapses when the lease expires (crashed owner) and any other
campaigner takes over.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Tuple


def _slot(storage):
    s = getattr(storage, "_ddl_owner_slot", None)
    if s is None:
        s = storage._ddl_owner_slot = {"lock": threading.Lock(),
                                       "owner": None}  # (id, expires_at)
    return s


class OwnerManager:
    def __init__(self, storage, owner_id: Optional[str] = None,
                 ttl_s: float = 1.0):
        self.storage = storage
        self.owner_id = owner_id or f"ddl-owner-{id(self):x}"
        self.ttl_s = ttl_s

    def campaign(self) -> bool:
        """Try to become (or stay) owner; renews the lease on success."""
        s = _slot(self.storage)
        now = time.monotonic()
        with s["lock"]:
            cur: Optional[Tuple[str, float]] = s["owner"]
            if cur is None or cur[1] <= now or cur[0] == self.owner_id:
                s["owner"] = (self.owner_id, now + self.ttl_s)
                return True
            return False

    def is_owner(self) -> bool:
        s = _slot(self.storage)
        now = time.monotonic()
        with s["lock"]:
            cur = s["owner"]
            return (cur is not None and cur[0] == self.owner_id
                    and cur[1] > now)

    def retire(self) -> None:
        """Resign ownership (reference: manager.ResignOwner)."""
        s = _slot(self.storage)
        with s["lock"]:
            if s["owner"] is not None and s["owner"][0] == self.owner_id:
                s["owner"] = None


class MockOwner(OwnerManager):
    """Always-owner single-node manager (reference: owner/mock.go)."""

    def campaign(self) -> bool:
        return True

    def is_owner(self) -> bool:
        return True
