"""Host C++ helpers of the package, compiled with g++ at first use.

``edt_squared_cpp``: the exact O(n)-per-axis Euclidean distance transform of
``csrc/edt.cpp`` (Felzenszwalb lower envelope), the big-map transform of
``models.esdf.esdf_from_occupancy(method="native")``.  The library is built
into ``build/`` beside this file under a name keyed by a hash of the source
and the flags, first to a name of the process's own and then renamed into
place, so parallel processes never load a half-written file.  OpenMP is
tried first and dropped when the compiler refuses it.  Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
EDT_SRC = os.path.join(_HERE, "csrc", "edt.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
_BASE_FLAGS = ["-O3", "-shared", "-fPIC"]

_edt_lib: Optional[ctypes.CDLL] = None


def _edt_path() -> str:
    h = hashlib.sha256(" ".join(_BASE_FLAGS).encode())
    with open(EDT_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libedt_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    base = ["g++"] + _BASE_FLAGS + ["-o", tmp, EDT_SRC]
    try:
        try:
            subprocess.run(base[:1] + ["-fopenmp"] + base[1:], check=True,
                           capture_output=True, timeout=300)
        except subprocess.CalledProcessError:
            subprocess.run(base, check=True, capture_output=True,
                           timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_edt() -> ctypes.CDLL:
    """The EDT library, compiled if it is not there.  Raises OSError,
    FileNotFoundError or subprocess.CalledProcessError when it cannot be
    built or loaded."""
    global _edt_lib
    if _edt_lib is not None:
        return _edt_lib
    path = _edt_path()
    if not os.path.exists(path):
        _compile(path)
    lib = ctypes.CDLL(path)
    lib.mtg_edt_sq.restype = ctypes.c_int
    lib.mtg_edt_sq.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    _edt_lib = lib
    return lib


def edt_available() -> bool:
    """Whether the EDT library builds and loads here."""
    try:
        load_edt()
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def edt_squared_cpp(mask: np.ndarray) -> np.ndarray:
    """Exact squared EDT (voxel units) to the nearest True voxel of a 3-D
    mask, float32; rows or planes with no such voxel come back +inf."""
    lib = load_edt()
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 3:
        raise ValueError("edt_squared_cpp expects a 3-D mask")
    out = np.empty(mask.shape, dtype=np.float32)
    status = lib.mtg_edt_sq(mask.shape[0], mask.shape[1], mask.shape[2],
                            mask.ravel(), out.ravel())
    if status != 0:
        raise RuntimeError(f"mtg_edt_sq failed with status {status}")
    return out
