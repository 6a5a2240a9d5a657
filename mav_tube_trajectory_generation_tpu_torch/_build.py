"""Builds the package's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled on first use with ``nvcc`` for sm_90a into ``build/`` beside this
file (``prebuild`` compiles several at once, one nvcc each), keyed by a hash
of every file under ``csrc/`` and the compiler flags, then loaded with
``ctypes``.  Nothing is built or looked for at import time:
the host-only tests import every module on machines without a CUDA toolkit.

``build_log(name)`` returns what the compiler printed (``-Xptxas -v``:
registers, shared memory and spills per kernel) for the library in use.

A variant is the same source built with preprocessor macros defined
(``variant(name, defines)``): ``chip_smoke.py`` builds its negative
controls and ``stage_profile.py`` its phase counters that way.  A variant is
kept apart from the library of its name; whoever uses it hands it to the
wrappers by putting it in ``_LIBS[name]`` for as long as it needs it.
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

#: Every kernel source of the package (``csrc/<name>.cu``); ``prebuild()``
#: builds them all.
SOURCES = ("admm_stage", "gram_band", "gt_matvec", "ipm_eval", "ipm_pipe",
           "ipm_solve")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_VARIANTS: Dict[str, ctypes.CDLL] = {}
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


class _Job:
    """One library on its way: paths, and the running nvcc if it has to be
    built."""

    def __init__(self, name: str, defines=()):
        src = os.path.join(CSRC_DIR, name + ".cu")
        if not os.path.isfile(src):
            raise RuntimeError(f"no such kernel source: {src}")
        tag = _sources_hash()
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.name = name
        self.key = _key(name, defines)
        self.src = src
        stem = "_".join([f"lib{name}"] + list(defines) + [tag])
        self.so_path = os.path.join(BUILD_DIR, stem + ".so")
        self.log_path = os.path.join(BUILD_DIR, stem + ".log")
        self.tmp = f"{self.so_path}.{os.getpid()}.tmp"
        self.proc = None
        self.cmd = None
        self.t0 = 0.0
        if not os.path.isfile(self.so_path):
            self.cmd = ([find_nvcc()] + NVCC_FLAGS
                        + [f"-D{d}" for d in defines] + ["-o", self.tmp, src])
            self.t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                self.cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)

    def finish(self) -> ctypes.CDLL:
        info = {"library": self.so_path, "built": False, "seconds": 0.0,
                "log": self.log_path}
        if self.proc is not None:
            out, _ = self.proc.communicate()
            info["seconds"] = time.perf_counter() - self.t0
            if self.proc.returncode != 0:
                if os.path.exists(self.tmp):
                    os.remove(self.tmp)
                raise RuntimeError(
                    f"nvcc failed ({self.proc.returncode}) for {self.src}:\n"
                    f"{' '.join(self.cmd)}\n{out}")
            with open(self.log_path, "w") as fh:
                fh.write(" ".join(self.cmd) + "\n" + out)
            os.replace(self.tmp, self.so_path)  # atomic: processes agree
            info["built"] = True
        lib = ctypes.CDLL(self.so_path)
        if self.key == self.name:
            _LIBS[self.name] = lib
        else:
            _VARIANTS[self.key] = lib
        _INFO[self.key] = info
        return lib


def _key(name: str, defines=()) -> str:
    return "+".join((name,) + tuple(defines))


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if it is not there.

    Raises RuntimeError with the compiler's output when the build fails.
    """
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    return _Job(name).finish()


def variant(name: str, defines) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` built with the macros ``defines``
    (e.g. ``("IPM_PIPE_PROFILE",)``), built if it is not there.  It does
    not take the place of ``load(name)``'s library."""
    lib = _VARIANTS.get(_key(name, defines))
    if lib is not None:
        return lib
    return _Job(name, tuple(defines)).finish()


def prebuild(names=SOURCES, variants=()) -> float:
    """Builds and loads several libraries (by default every one of
    ``SOURCES``), and the variants ``variants`` ([(name, defines)]), one
    nvcc each, all started together.  Returns the wall-clock seconds it
    took.  Raises RuntimeError with the compiler's output if any build fails
    (after all have ended)."""
    t0 = time.perf_counter()
    jobs = [_Job(n) for n in dict.fromkeys(names) if n not in _LIBS]
    wanted = {_key(n, d): (n, tuple(d)) for n, d in variants}
    jobs += [_Job(n, d) for k, (n, d) in wanted.items() if k not in _VARIANTS]
    errors = []
    for job in jobs:
        try:
            job.finish()
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n\n".join(errors))
    return time.perf_counter() - t0


def build_info(name: str, defines=()) -> Optional[dict]:
    """{"library", "built", "seconds", "log"} of a loaded library (or
    variant), or None if it has not been loaded in this process."""
    return _INFO.get(_key(name, defines))


def build_log(name: str, defines=()) -> str:
    """Compiler output of the library ``load(name)`` is using, or of a
    variant ("" if the log is missing)."""
    info = _INFO.get(_key(name, defines))
    if not info or not os.path.isfile(info["log"]):
        return ""
    with open(info["log"]) as fh:
        return fh.read()
