"""Build the CUDA sources under ``csrc/`` with nvcc and load them via ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``_build/<name>-<hash>.so``, where the hash covers the source
and the nvcc flags — so a changed source rebuilds, and a checkout builds
everything it needs on first use.  ``build_all`` starts one nvcc per source
at once and waits for all of them.  Nothing here runs at import time.

Processes may build at once (the ranks of a mesh, spawned together, each
load the kernels at first use): a builder holds an exclusive ``flock`` on
``<name>-<hash>.lock`` from the check for the library to its rename, and a
process that waited for it finds the library built.  nvcc writes into a
temporary library and a temporary log, which are renamed into place, the
log first; the lock file stays (the kernel drops the lock of a process
that dies).

``bind`` and ``launch`` are the launch path every wrapper shares: the typed
C function is resolved once per process, and a call costs the argument
conversions, one read of the current stream's raw handle, and the call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Sequence

import torch

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
    Returns (proc or None, tmp_path, so_path, log_path, lock); the log of
    the build that made the library stays beside it.  While nvcc runs this
    process holds the source's build lock (``_finish`` releases it)."""
    src, so = _paths(name)
    log = so[:-3] + ".log"
    if os.path.exists(so):
        return None, None, so, log, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    lock = open(so[:-3] + ".lock", "a")
    tmp = None
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):          # built while this process waited
            lock.close()
            return None, None, so, log, None
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        with open(tmp[:-3] + ".log", "w") as logf:
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=logf, stderr=subprocess.STDOUT)
    except BaseException:
        for path in ((tmp, tmp[:-3] + ".log") if tmp else ()):
            if os.path.exists(path):
                os.unlink(path)
        lock.close()
        raise
    return proc, tmp, so, log, lock


def _finish(name: str, proc, tmp, so, log, lock) -> None:
    if proc is None:
        return
    try:
        rc = proc.wait()
        tmp_log = tmp[:-3] + ".log"
        if rc != 0:
            with open(tmp_log) as f:
                text = f.read()
            os.unlink(tmp)
            os.unlink(tmp_log)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(rc={rc}):\n{text}")
        # atomic renames: a library that exists has its whole log beside it
        os.replace(tmp_log, log)
        os.replace(tmp, so)
    finally:
        lock.close()


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source in parallel (one nvcc each); return the
    build logs' text by name (for a library that was already built, the log
    of the build that made it; empty if that log is gone)."""
    names = list(names)
    started = {n: _start(n) for n in names}
    logs = {}
    for n in names:
        _finish(n, *started[n])
        log = started[n][3]
        if os.path.exists(log):
            with open(log) as f:
                logs[n] = f.read()
        else:
            logs[n] = ""
    return logs


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_resources(log: str) -> List[Dict]:
    """What ``ptxas -v`` reports per kernel in a build log: the mangled
    name, registers per thread, static shared memory and spill bytes."""
    kernels: List[Dict] = []
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            kernels.append(dict(name=entry.group(1)))
            continue
        if not kernels:
            continue
        spill, used = _SPILL.search(line), _USED.search(line)
        if spill:
            kernels[-1].update(stack=int(spill.group(1)),
                               spill_stores=int(spill.group(2)),
                               spill_loads=int(spill.group(3)))
        if used:
            smem = _SMEM.search(line)
            kernels[-1].update(registers=int(used.group(1)),
                               smem=int(smem.group(1)) if smem else 0)
    return kernels


def sass(name: str) -> str:
    """The SASS of the built library of ``csrc/<name>.cu``, as ``cuobjdump
    -sass`` (beside nvcc) prints it."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", _paths(name)[1]], check=True,
                          capture_output=True, text=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def bind(name: str, function: str, argtypes: Sequence,
         restype=ctypes.c_int):
    """The C function ``function`` of ``csrc/<name>.cu`` with its argument
    and result types set.  Wrappers keep the result in a module variable, so
    the library is looked up once."""
    fn = getattr(load(name), function)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def _stream_handle(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# The handle of PyTorch's current stream on a device; PyTorch's own reading
# of it, where it has one, builds no Stream object.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _stream_handle)


def launch(fn, device: torch.device, *args) -> None:
    """Call the bound launch function ``fn(*args, stream)`` on ``device``'s
    current stream, without synchronising; raise if it returns a CUDA error
    (its ``cudaGetLastError()``)."""
    index = device.index               # a tensor's device always has one
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error {err}")
