"""ctypes loader for the native host core (port of `tlfea/native.py`).

The source is the port's own copy, `tlfea_torch/csrc/native.cpp` (of
`native/tlfea_native.cpp`): greedy first-fit colouring and padded incidence
lists, the setup-time hot paths of large meshes (the NumPy functions of
`tlfea_torch.utils.coloring` take minutes at 100k elements). It is built at
first use with `g++ -O2 -shared -fPIC` into `tlfea_torch/_build/`, under a
name that carries the source's hash, and loaded with ctypes. Without a
compiler, `load()` returns None and `utils.coloring` takes its NumPy
functions, as the JAX package does; `BUILD_ERROR` then says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

__all__ = ["load", "available", "greedy_color", "build_incidence", "library_path"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "native.cpp")
_BUILD = os.path.join(_PKG, "_build")
_lib = None
_tried = False
BUILD_ERROR: str | None = None


def library_path() -> str:
    """Where the shared library of the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"libtlfea_native_{digest}.so")


def _compile(path: str) -> bool:
    """g++ into a temporary file beside `path`, then an atomic rename, so
    processes that build at once never load a half-written library."""
    global BUILD_ERROR
    gxx = shutil.which("g++")
    if gxx is None:
        BUILD_ERROR = "no g++ on PATH"
        return False
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        res = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            BUILD_ERROR = f"g++ failed ({res.returncode}): {res.stderr.strip()[-2000:]}"
            return False
        os.replace(tmp, path)
        return True
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """The loaded library, built first if needed; None without a compiler."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not os.path.exists(path) and not _compile(path):
        return None
    lib = ctypes.CDLL(path)
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    lib.tlfea_greedy_color.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    lib.tlfea_greedy_color.restype = ctypes.c_int32
    lib.tlfea_max_incidence.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.tlfea_max_incidence.restype = ctypes.c_int32
    lib.tlfea_build_incidence.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p,
                                          ctypes.c_int32, i32p, u8p]
    lib.tlfea_build_incidence.restype = ctypes.c_int32
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def greedy_color(conn: np.ndarray, n_coef: int) -> np.ndarray | None:
    """First-fit greedy colouring in natural node order -> (n_coef,) int64;
    None without the library."""
    lib = load()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    colors = np.empty(n_coef, dtype=np.int32)
    n = lib.tlfea_greedy_color(n_coef, conn.shape[0], conn.shape[1], conn, colors)
    if n < 0:
        raise ValueError("native coloring failed (bad connectivity)")
    return colors.astype(np.int64)


def build_incidence(conn: np.ndarray, n_coef: int):
    """Padded (element, local index) incidence lists -> (inc (n_coef,
    max_inc, 2) int32, mask (n_coef, max_inc) bool); None without the
    library."""
    lib = load()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    max_inc = lib.tlfea_max_incidence(n_coef, conn.shape[0], conn.shape[1], conn)
    if max_inc < 0:
        raise ValueError("native incidence failed (bad connectivity)")
    max_inc = max(int(max_inc), 1)
    inc = np.zeros((n_coef, max_inc, 2), dtype=np.int32)
    mask = np.zeros((n_coef, max_inc), dtype=np.uint8)
    rc = lib.tlfea_build_incidence(n_coef, conn.shape[0], conn.shape[1], conn, max_inc, inc, mask)
    if rc != 0:
        raise ValueError("native incidence overflow")
    return inc, mask.astype(bool)
