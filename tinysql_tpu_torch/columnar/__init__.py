"""Columnar replica store (TPU-first analytics fast path)."""
from .store import (ColumnarStore, ColumnarTable, bulk_load,
                    bump_table_version, ensure_row_store, hydrate_from_scan,
                    replica_for_read, replica_from_numpy,
                    store_of, table_data_version)

__all__ = ["ColumnarStore", "ColumnarTable", "bulk_load",
           "bump_table_version", "ensure_row_store", "hydrate_from_scan",
           "replica_for_read", "replica_from_numpy",
           "store_of", "table_data_version"]
