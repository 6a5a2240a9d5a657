"""Builds the package's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled on first use with ``nvcc`` for sm_90a into ``build/`` beside this
file, keyed by a hash of every file under ``csrc/`` and the compiler flags,
then loaded with ``ctypes``.  Nothing is built or looked for at import time:
the host-only tests import every module on machines without a CUDA toolkit.

``build_log(name)`` returns what the compiler printed (``-Xptxas -v``:
registers, shared memory and spills per kernel) for the library in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of nvcc: $PATH, then $CUDA_HOME, then the toolkit's usual
    place.  Raises RuntimeError when there is none."""
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME and in "
        "/usr/local/cuda): the CUDA kernels of this package are built from "
        "source at first use and cannot run without it")


def _sources_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC_DIR)):
        if fn.endswith((".cu", ".cuh", ".h")):
            h.update(fn.encode())
            with open(os.path.join(CSRC_DIR, fn), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if it is not there.

    Raises RuntimeError with the compiler's output when the build fails.
    """
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, name + ".cu")
    if not os.path.isfile(src):
        raise RuntimeError(f"no such kernel source: {src}")
    tag = _sources_hash()
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    log_path = os.path.join(BUILD_DIR, f"lib{name}_{tag}.log")
    info = {"library": so_path, "built": False, "seconds": 0.0}
    if not os.path.isfile(so_path):
        nvcc = find_nvcc()
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {src}:\n"
                f"{' '.join(cmd)}\n{out}")
        with open(log_path, "w") as fh:
            fh.write(" ".join(cmd) + "\n" + out)
        os.replace(tmp, so_path)        # atomic: concurrent processes agree
        info["built"] = True
    info["log"] = log_path
    lib = ctypes.CDLL(so_path)
    _LIBS[name] = lib
    _INFO[name] = info
    return lib


def build_info(name: str) -> Optional[dict]:
    """{"library", "built", "seconds", "log"} of a loaded library, or None
    if ``load(name)`` has not run in this process."""
    return _INFO.get(name)


def build_log(name: str) -> str:
    """Compiler output of the library ``load(name)`` is using ("" if the
    log is missing)."""
    info = _INFO.get(name)
    if not info or not os.path.isfile(info["log"]):
        return ""
    with open(info["log"]) as fh:
        return fh.read()
