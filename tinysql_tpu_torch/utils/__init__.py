"""Cross-cutting utilities (reference: util/*)."""
from . import failpoint

__all__ = ["failpoint"]
