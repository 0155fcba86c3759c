"""Domain layer: per-server schema cache + version registry + syncer
barrier (reference: domain/ + ddl/util/syncer.go)."""
from .domain import Domain, shared_domain, wait_schema_synced

__all__ = ["Domain", "shared_domain", "wait_schema_synced"]
