"""Build the CUDA sources under ``csrc/`` with nvcc and load them via ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``_build/<name>-<hash>.so``, where the hash covers the source
and the nvcc flags — so a changed source rebuilds, and a checkout builds
everything it needs on first use.  ``build_all`` starts one nvcc per source
at once and waits for all of them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fps", "ballquery", "gather", "pack_probe")

# -Xptxas -v reports registers/spills per kernel into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}-{tag}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (proc or None, tmp_path, so_path, log_path)."""
    src, so = _paths(name)
    if os.path.exists(so):
        return None, None, so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = so[:-3] + ".log"
    with open(log, "w") as logf:
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=logf, stderr=subprocess.STDOUT)
    return proc, tmp, so, log


def _finish(name: str, proc, tmp, so, log) -> None:
    if proc is None:
        return
    rc = proc.wait()
    if rc != 0:
        os.unlink(tmp)
        with open(log) as f:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(rc={rc}):\n{f.read()}")
    os.replace(tmp, so)          # atomic: concurrent builders never see half a file


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source in parallel (one nvcc each); return the
    build logs' text by name (empty for a library that was already built)."""
    names = list(names)
    started = {n: _start(n) for n in names}
    logs = {}
    for n in names:
        _finish(n, *started[n])
        log = started[n][3]
        if log is not None:
            with open(log) as f:
                logs[n] = f.read()
        else:
            logs[n] = ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
