"""Native host data plane (C++ via ctypes; copy of ``scan2cap_tpu/native``).

The per-sample hot loops of the dataset (``data/dataset.py``) run in a
small C++ library, ``dataplane.cc``, built with g++ at first use into
``scan2cap_torch/_build/dataplane-<hash>.so``, where the hash covers the
source and the flags: a changed source rebuilds, and a second process of
the same checkout loads the library the first one built.  Every entry
point has a numpy fallback with the same result, taken when no library can
be built or loaded, or when ``SCAN2CAP_NATIVE=0``.  This is host code, not
a kernel: the card never sees it.

API (all numpy in/out, f32):
  sample_gather(points, choices)      -> gathered rows
  augment_points(pc, flip_yz, flip_xz, rot, trans) -> pc (xyz cols updated)
  point_votes(xyz, instance_labels, care) -> (votes (M,3), mask (M,))
  available()                         -> bool (library loaded)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "dataplane.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_THREADS = max(2, (os.cpu_count() or 4) // 2)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library built from this source and these flags lies."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"dataplane-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    # build to a unique temporary file and rename it: a concurrent process
    # never loads half a library
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp],
                             capture_output=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SCAN2CAP_NATIVE", "1") == "0":
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64, i32, f32p, i32p, u8p = (ctypes.c_int64, ctypes.c_int32,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_uint8))
        lib.s2c_sample_gather.argtypes = [f32p, i32p, f32p, i64, i64,
                                          ctypes.c_int]
        lib.s2c_augment_points.argtypes = [f32p, i64, i64, ctypes.c_int,
                                           ctypes.c_int, f32p, f32p,
                                           ctypes.c_int]
        lib.s2c_point_votes.argtypes = [f32p, i64, i32p, u8p, i64, i32,
                                        f32p, f32p]
        lib.s2c_point_votes.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sample_gather(points: np.ndarray, choices: np.ndarray) -> np.ndarray:
    """points (N, C) f32, choices (M,) int -> (M, C) f32."""
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    if lib is None:
        return points[choices]
    idx = np.ascontiguousarray(choices, np.int32)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= len(points)):
        # the numpy fallback's failure: points[choices] raises IndexError
        # where the native copy would read out of bounds
        raise IndexError(
            f"sample_gather: choices out of range [0, {len(points)}) "
            f"(min {int(idx.min())}, max {int(idx.max())})")
    out = np.empty((idx.shape[0], points.shape[1]), np.float32)
    lib.s2c_sample_gather(
        _fptr(points), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _fptr(out), out.shape[0], out.shape[1], _THREADS)
    return out


def augment_points(pc: np.ndarray, flip_yz: bool, flip_xz: bool,
                   rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply flips + rotation (x' = x @ rot.T) + translation to the xyz
    columns of pc (M, C) f32.  Returns pc (modified copy)."""
    pc = np.ascontiguousarray(pc, np.float32).copy()
    lib = _load()
    if lib is None:
        xyz = pc[:, :3]
        if flip_yz:
            xyz[:, 0] = -xyz[:, 0]
        if flip_xz:
            xyz[:, 1] = -xyz[:, 1]
        pc[:, :3] = xyz @ np.asarray(rot, np.float32).T \
            + np.asarray(trans, np.float32)
        return pc
    r = np.ascontiguousarray(rot, np.float32)
    t = np.ascontiguousarray(trans, np.float32)
    lib.s2c_augment_points(_fptr(pc), pc.shape[0], pc.shape[1],
                           int(flip_yz), int(flip_xz), _fptr(r), _fptr(t),
                           _THREADS)
    return pc


def point_votes(xyz: np.ndarray, instance_labels: np.ndarray,
                care: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Votes to instance centers, gated by the instance's FIRST point's care
    flag (lib/dataset.py:427-442 semantics).

    xyz (M, >=3) f32; instance_labels (M,) int; care (M,) bool-like.
    Returns (votes (M, 3) f32, mask (M,) f32)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    inst = np.ascontiguousarray(instance_labels, np.int32)
    care_u8 = np.ascontiguousarray(care, np.uint8)
    lib = _load()
    m = xyz.shape[0]
    if lib is not None:
        id_cap = int(inst.max(initial=0)) + 1 if m else 1
        votes = np.empty((m, 3), np.float32)
        mask = np.empty((m,), np.float32)
        rc = lib.s2c_point_votes(
            _fptr(xyz), xyz.shape[1],
            inst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            care_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            m, id_cap, _fptr(votes), _fptr(mask))
        if rc == 0:
            return votes, mask
    # numpy fallback: the reference's O(instances * M) loop
    votes = np.zeros((m, 3), np.float32)
    mask = np.zeros((m,), np.float32)
    for i_instance in np.unique(inst):
        ind = np.where(inst == i_instance)[0]
        if i_instance < 0 or not care_u8[ind[0]]:
            continue
        x = xyz[ind, :3]
        center = 0.5 * (x.min(0) + x.max(0))
        votes[ind] = center - x
        mask[ind] = 1.0
    return votes, mask
