"""ctypes binding for the native runtime library (native/tinysql_native.cpp):
memcomparable batch codec + the int64 join hash table.

Loads native/libtinysql_native.so, building it with g++ on first use if
missing.  Every caller must handle `lib() is None` (no toolchain): the
pure-python paths remain the semantic reference.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_lib = None
_tried = False
_mu = threading.Lock()

_SO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "native", "libtinysql_native.so")


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _mu:
        if _tried:
            return _lib
        try:
            src = os.path.join(os.path.dirname(_SO), "tinysql_native.cpp")
            stale = (os.path.exists(_SO) and os.path.exists(src)
                     and os.path.getmtime(src) > os.path.getmtime(_SO))
            if not os.path.exists(_SO) or stale:
                import importlib.util
                spec = importlib.util.spec_from_file_location(
                    "tsnative_build",
                    os.path.join(os.path.dirname(_SO), "build.py"))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                mod.build()
            l = ctypes.CDLL(_SO)
            l.mc_encode_batch.restype = ctypes.c_int
            l.mc_encode_bytes.restype = ctypes.c_int64
            l.mc_decode_bytes.restype = ctypes.c_int64
            l.i64ht_build.restype = ctypes.c_void_p
            l.i64ht_probe.restype = ctypes.c_int64
            l.i64ht_free.restype = None
            _lib = l
        except Exception:
            _lib = None
        _tried = True
        return _lib


# ---- batch memcomparable encode -------------------------------------------

_KIND = {"int": 0, "uint": 1, "float": 2}


def mc_encode_column(values: np.ndarray, kind: str) -> Optional[np.ndarray]:
    """Encode an int64/uint64/float64 column into n rows of 9 key bytes
    (flag + big-endian payload).  Returns uint8 [n, 9] or None if the
    native library is unavailable."""
    l = lib()
    if l is None:
        return None
    v = np.ascontiguousarray(values)
    n = len(v)
    out = np.empty((n, 9), dtype=np.uint8)
    rc = l.mc_encode_batch(
        v.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n),
        ctypes.c_int(_KIND[kind]), out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


# ---- join hash table -------------------------------------------------------

class I64HashTable:
    """Build-once probe-many int64 hash table (util/mvmap analogue).
    Falls back to None when the native library is unavailable."""

    def __init__(self, keys: np.ndarray, valid: Optional[np.ndarray] = None):
        l = lib()
        assert l is not None
        self._l = l
        self._keys = np.ascontiguousarray(keys, dtype=np.int64)
        self._valid = (np.ascontiguousarray(valid, dtype=np.uint8)
                       if valid is not None else None)
        self._h = l.i64ht_build(
            self._keys.ctypes.data_as(ctypes.c_void_p),
            self._valid.ctypes.data_as(ctypes.c_void_p)
            if self._valid is not None else None,
            ctypes.c_int64(len(self._keys)))

    @staticmethod
    def try_build(keys: np.ndarray,
                  valid: Optional[np.ndarray] = None
                  ) -> Optional["I64HashTable"]:
        return I64HashTable(keys, valid) if lib() is not None else None

    def probe(self, keys: np.ndarray,
              valid: Optional[np.ndarray] = None):
        """Returns (match_row_ids, per_probe_counts): the build row ids
        matching each probe key, concatenated in probe order."""
        k = np.ascontiguousarray(keys, dtype=np.int64)
        va = (np.ascontiguousarray(valid, dtype=np.uint8)
              if valid is not None else None)
        n = len(k)
        counts = np.empty(n, dtype=np.int32)
        cap = max(n, 64)
        while True:
            out = np.empty(cap, dtype=np.int64)
            total = self._l.i64ht_probe(
                ctypes.c_void_p(self._h),
                k.ctypes.data_as(ctypes.c_void_p),
                va.ctypes.data_as(ctypes.c_void_p) if va is not None
                else None,
                ctypes.c_int64(n),
                out.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int64(cap),
                counts.ctypes.data_as(ctypes.c_void_p))
            if total <= cap:
                return out[:total], counts
            cap = int(total)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self._l.i64ht_free(ctypes.c_void_p(h))
            except Exception:
                pass
            self._h = None
