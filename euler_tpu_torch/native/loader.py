"""ctypes binding for the port's native host core (csrc/euler_core.cc).

The port's own loader over its own source: it compiles
``euler_tpu_torch/csrc/euler_core.cc`` with g++ into
``build/euler_tpu_torch/`` beside the package on first use, and binds the
three host builders the graph store needs (the CSR build and the two
alias-table builders) and the edge-list parser of the streaming
converter. The source ships inside the package, so a missing one is a
broken install and ``get_lib()`` raises ``FileNotFoundError``. When g++
fails, ``get_lib()`` returns None and the callers fall back to their numpy
implementations; ``available()`` says which path is in use.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from euler_tpu_torch._build import PACKAGE_DIR, build_shared_library

SRC = os.path.join(PACKAGE_DIR, "csrc", "euler_core.cc")
_CMD = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def get_lib():
    """Load (compiling if needed) the native core; None when g++ fails.

    Raises ``FileNotFoundError`` when the package's source is missing.
    """
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        if not os.path.exists(SRC):
            raise FileNotFoundError(
                f"the port's native core source is missing: {SRC}")
        _tried = True
        try:
            lib = ctypes.CDLL(build_shared_library(SRC, "euler_core", _CMD))
        except (OSError, subprocess.SubprocessError):
            return None
        i64, i32, f32 = (np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
                         for dt in (np.int64, np.int32, np.float32))
        lib.etpu_build_csr.restype = ctypes.c_int
        lib.etpu_build_csr.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32, i32, i32, f32, i64, i64, i32, f32, f32, f32]
        lib.etpu_build_alias.restype = ctypes.c_int
        lib.etpu_build_alias.argtypes = [ctypes.c_int64, f32, f32, i32]
        lib.etpu_build_group_alias.restype = ctypes.c_int
        lib.etpu_build_group_alias.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64, f32, f32, i32]
        lib.etpu_parse_edge_list.restype = ctypes.c_int64
        lib.etpu_parse_edge_list.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i32, i32, f32, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native core compiled and loaded, False when g++
    failed (the numpy path is in use)."""
    return get_lib() is not None


def build_csr_native(n, n_et, src, dst, etype, ew, eid=None):
    """Native equivalent of convert.build_csr; the same tuple, or None when
    the library is unavailable or failed."""
    lib = get_lib()
    if lib is None:
        return None
    m = len(src)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    etype = np.ascontiguousarray(etype, np.int32)
    ew = np.ascontiguousarray(ew, np.float32)
    group_ptr = np.empty(n * n_et + 1, np.int64)
    perm = np.empty(m, np.int64)
    col = np.empty(m, np.int32)
    w_sorted = np.empty(m, np.float32)
    w_cumsum = np.empty(m, np.float32)
    gws = np.empty(n * n_et, np.float32)
    rc = lib.etpu_build_csr(n, n_et, m, src, dst, etype, ew,
                            group_ptr, perm, col, w_sorted, w_cumsum, gws)
    if rc != 0:
        return None
    if eid is None:
        eid = np.arange(m, dtype=np.int32)
    gp = group_ptr.astype(np.int32) if group_ptr[-1] <= 2**31 - 1 \
        else group_ptr
    return (gp, col, w_sorted, w_cumsum,
            np.asarray(eid)[perm].astype(np.int32), perm)


def build_alias_native(weights):
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(weights, np.float32)
    n = len(w)
    prob = np.empty(n, np.float32)
    alias = np.empty(n, np.int32)
    if lib.etpu_build_alias(n, w, prob, alias) != 0:
        return None
    return prob, alias


def build_group_alias_native(group_ptr, weights):
    """Per-CSR-group alias tables; None when the native core is absent."""
    lib = get_lib()
    if lib is None:
        return None
    gp = np.ascontiguousarray(group_ptr, np.int64)
    w = np.ascontiguousarray(weights, np.float32)
    m = len(w)
    prob = np.empty(m, np.float32)
    alias = np.empty(m, np.int32)
    if lib.etpu_build_group_alias(len(gp) - 1, m, gp, w, prob, alias) != 0:
        return None
    return prob, alias


def parse_edge_list_native(buf: bytes):
    """Parse "src<sep>dst[<sep>w]" text (bytes) -> (src, dst, w) int32/
    int32/f32 arrays in file order, or None without the native core.
    Skips '#' comments and malformed lines, the contract of the Python
    loop in graph.stream_convert.convert_edge_list (reference:
    euler_tpu/native/loader.py:139-154)."""
    lib = get_lib()
    if lib is None:
        return None
    cap = buf.count(b"\n") + 1
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    n = lib.etpu_parse_edge_list(buf, len(buf), src, dst, w, cap)
    if n < 0:
        return None
    return src[:n], dst[:n], w[:n]
