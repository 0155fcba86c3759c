"""Schema catalog: model, meta storage, autoid, table abstraction
(reference: parser/model, meta/, table/)."""
from .model import (SchemaState, JobState, ActionType, ColumnInfo,
                    IndexColumn, IndexInfo, TableInfo, DBInfo, Job)
from .meta import Meta
from .autoid import Allocator
from .table import Table, Index, DuplicateKeyError

__all__ = [
    "SchemaState", "JobState", "ActionType", "ColumnInfo", "IndexColumn",
    "IndexInfo", "TableInfo", "DBInfo", "Job", "Meta", "Allocator",
    "Table", "Index", "DuplicateKeyError",
]
