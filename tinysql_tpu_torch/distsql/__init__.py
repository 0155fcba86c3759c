"""Distributed query layer: coprocessor pushdown over the region-sharded
store (reference: distsql/ + store/tikv/coprocessor.go + the mocktikv cop
interpreter, SURVEY §2.6/§2.7)."""
from .client import CopClient, select
from .request import DAGRequest, ScanInfo

__all__ = ["CopClient", "DAGRequest", "ScanInfo", "select"]
