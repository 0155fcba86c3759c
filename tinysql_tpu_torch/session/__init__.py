"""Session / statement lifecycle (reference: session/)."""
from .session import Session, ResultSet, SessionError, new_session

__all__ = ["Session", "ResultSet", "SessionError", "new_session"]
