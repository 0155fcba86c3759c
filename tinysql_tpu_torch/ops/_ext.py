"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled on its own by ``nvcc`` into a shared library with
a plain C interface (sm_90a, -O3) and loaded with ctypes: no PyTorch
headers are involved, so a build takes seconds, not the minutes a
``torch/extension.h`` translation unit costs.  The compiles run in
parallel at first use; the libraries land in ``tinysql_tpu_torch/_build/``
(listed in .gitignore) under a hash of the sources, so a later process of
the same checkout loads them without rebuilding.

A failed build raises: no caller falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Optional

SOURCES = ("masked_reduce", "segment_reduce", "equi_join", "lex_order",
           "csr_reduce", "dense_probe", "expr_eval", "csr_expand",
           "run_bounds", "semi_pick", "shard_merge", "shard_join",
           "shard_exchange", "shard_rank")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
#: flags of one source beside NVCC_FLAGS: HK7 must round after every
#: float operation as the plain torch version does, so nvcc may not
#: contract a*b+c into a fused multiply-add there
SOURCE_FLAGS = {"expr_eval": ["-fmad=false"]}

_mu = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: wall seconds of the last build (0.0 when the libraries were loaded
#: from an earlier build of the same sources)
BUILD_INFO = {"build_s": 0.0, "built": False, "dir": ""}

_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int

_SIGNATURES = {
    "masked_reduce": {
        "hk1_masked_reduce": (_int, [_vp, _i64, _vp, _vp, _vp, _vp]),
        "hk1b_masked_reduce": (_int, [_vp, _i64, _i64, _vp, _vp, _vp, _vp,
                                      _vp]),
    },
    "segment_reduce": {
        "hk2_scratch_bytes": (_i64, [_i64, _i64, _int]),
        "hk2_segment_reduce": (_int, [_vp, _vp, _i64, _i64, _vp, _vp, _vp,
                                      _vp]),
        "hk2_present_pass": (_int, [_vp, _int, _i64, _int, _int, _i64, _vp,
                                    _vp, _vp, _vp, _vp]),
        "hk2_present_pad": (_int, [_vp, _int, _i64, _i64, _i64, _vp, _vp]),
        "hk2b_scratch_bytes": (_i64, [_i64, _i64, _i64, _int]),
        "hk2b_segment_reduce": (_int, [_vp, _vp, _i64, _i64, _i64, _vp, _vp,
                                       _vp, _vp, _vp]),
    },
    "equi_join": {
        "hk3_build_stats": (_int, [_vp, _vp, _vp, _i64, _vp, _vp]),
        "hk3_unique_pick": (_int, [_vp, _vp, _vp, _i64, _vp, _vp, _vp, _i64,
                                   _int, _vp, _vp, _i64, _vp, _vp]),
        "hk3_unique_match": (_int, [_vp, _vp, _vp, _i64, _vp, _vp, _vp,
                                    _i64, _vp, _vp, _i64, _vp, _vp]),
        "hk3_mult_count": (_int, [_vp, _vp, _vp, _i64, _vp, _vp, _vp, _int,
                                  _vp, _vp, _vp, _vp, _vp, _vp]),
        "hk3_mult_expand": (_int, [_vp, _i64, _vp, _vp, _vp, _vp, _int, _i64,
                                   _vp, _vp, _vp]),
    },
    "lex_order": {
        "hk4_scratch_bytes": (_i64, [_int, _i64, _i64]),
        "hk4_lex_order": (_int, [_vp, _int, _i64, _i64, _vp, _vp, _vp]),
    },
    "csr_reduce": {
        "hk5_scratch_bytes": (_i64, [_i64, _int]),
        "hk5_csr_reduce": (_int, [_vp, _vp, _vp, _i64, _i64, _i64, _vp, _vp,
                                  _vp, _vp]),
    },
    "dense_probe": {
        "hk6_dense_probe": (_int, [_vp, _vp, _i64, _i64, _i64, _vp, _i64,
                                   _vp, _i64, _int, _vp, _vp, _int, _vp,
                                   _vp]),
    },
    "expr_eval": {
        "hk7_expr_eval": (_int, [_vp, _int, _int, _vp, _vp, _vp, _vp, _vp,
                                 _vp, _i64, _i64, _vp]),
        "hk7b_expr_eval": (_int, [_vp, _int, _int, _vp, _vp, _vp, _vp, _i64,
                                  _vp, _i64, _vp, _i64, _vp, _i64, _i64,
                                  _i64, _vp]),
    },
    "csr_expand": {
        "hk8_scratch_words": (_i64, [_i64, _i64, _i64, _int]),
        "hk8_csr_expand": (_int, [_vp, _i64, _i64, _vp, _i64, _vp, _vp, _i64,
                                  _i64, _i64, _vp, _vp, _i64, _int, _i64,
                                  _int, _vp, _vp, _int, _vp, _vp]),
    },
    "run_bounds": {
        "hk9_run_bounds": (_int, [_vp, _i64, _vp, _vp, _vp, _vp, _vp, _vp,
                                  _vp, _vp]),
    },
    "semi_pick": {
        "hk10_semi_pick": (_int, [_vp, _vp, _vp, _i64, _vp, _vp, _i64, _int,
                                  _int, _vp, _vp, _vp]),
    },
    "shard_merge": {
        "hk11_shard_merge": (_int, [_vp, _int, _int, _i64, _int, _int, _vp,
                                    _i64, _i64, _vp, _vp]),
    },
    "shard_join": {
        "hk12_shard_probe": (_int, [_vp, _vp, _i64, _vp, _vp, _vp, _i64,
                                    _int, _int, _vp, _vp, _vp]),
        "hk12_shard_count": (_int, [_vp, _vp, _i64, _int, _vp, _i64, _vp,
                                    _vp, _vp]),
    },
    "shard_exchange": {
        "hk13_scratch_words": (_i64, [_i64, _int, _int]),
        "hk13_exchange": (_int, [_vp, _i64, _i64, _int, _i64, _vp, _vp,
                                 _int, _vp]),
        "hk13_partition_count": (_int, [_vp, _vp, _i64, _int, _int, _vp,
                                        _vp]),
        "hk13_partition_scatter": (_int, [_vp, _vp, _i64, _int, _int, _i64,
                                          _vp, _vp, _vp, _vp]),
    },
    "shard_rank": {
        "hk14_shard_rank": (_int, [_vp, _vp, _i64, _i64, _int, _i64, _vp,
                                   _vp, _vp, _vp]),
    },
}


def _nvcc() -> str:
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base:
            p = os.path.join(base, "bin", "nvcc")
            if os.path.exists(p):
                return p
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or /usr/local/cuda)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()[:16]


def build(out_dir: Optional[str] = None) -> str:
    """Compile every source in parallel (one nvcc each, all started
    together).  Returns the directory holding the libraries."""
    out_dir = out_dir or os.path.join(BUILD_DIR, _source_hash())
    if all(os.path.exists(os.path.join(out_dir, f"lib{s}.so"))
           for s in SOURCES):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for s in SOURCES:
        tmp = os.path.join(out_dir, f"lib{s}.so.tmp{os.getpid()}")
        cmd = [nvcc] + NVCC_FLAGS + SOURCE_FLAGS.get(s, []) + [
            "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{s}.cu")]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    errors = []
    for s, (p, tmp) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{s}.cu (rc {p.returncode}):\n"
                          f"{out.decode(errors='replace')}")
        else:
            os.replace(tmp, os.path.join(out_dir, f"lib{s}.so"))
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    BUILD_INFO["build_s"] = time.perf_counter() - t0
    BUILD_INFO["built"] = True
    return out_dir


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (building all at first
    use)."""
    got = _LIBS.get(name)
    if got is not None:
        return got
    with _mu:
        if not _LIBS:
            d = build()
            BUILD_INFO["dir"] = d
            for s in SOURCES:
                cdll = ctypes.CDLL(os.path.join(d, f"lib{s}.so"))
                for fn, (res, args) in _SIGNATURES[s].items():
                    f = getattr(cdll, fn)
                    f.restype = res
                    f.argtypes = args
                _LIBS[s] = cdll
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a nonzero status from a C entry point (a refused launch or
    a bad argument never runs, and a synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: status {rc}")
