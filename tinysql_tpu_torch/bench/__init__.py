"""Benchmarks (BASELINE.json configs): TPC-H Q1/Q3/Q6 + operator micros."""
from . import tpch

__all__ = ["tpch"]
