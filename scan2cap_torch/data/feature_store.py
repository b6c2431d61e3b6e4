"""A feature database that numpy alone reads and writes.

The JAX package keeps its feature databases in HDF5: the GT-box features of
``scripts/extract_gt_features.py`` (keys ``"{epoch}|{scene_id}_gt_ids"``,
``_features``, ``_bbox_corners``, ``_gt_corners``), the VoteNet proposals of
``scripts/extract_votenet_features.py`` (``"0|{scene_id}_object_ids"``,
``_features``, ``_bbox_corners``, ``_gt_ids``, ``_gt_corners``) and the
multiview features (one (P, 128) float32 array per ``scene_id``), and the
2D baselines' databases of ``scan2cap_tpu/twod/preprocessing.py``, one
HDF5 group per sample (``"{sample_id}/g_feat"``, ``/t_feat`` and, where
there are context boxes, ``/c_feats``) with a file attribute
``extractor_backend``.  The port keeps the same keys (a group's datasets
by their paths), dtypes and shapes in an uncompressed ``.npz``: a zip of
``.npy`` members, one per key, which plain ``np.load`` also reads.  The
file's attributes are members under ``__attrs__/`` (a string as a 0-d
unicode array), so ``np.load`` reads them back too; ``keys()`` leaves them
out and ``attrs`` gives them by name.

``FeatureStoreWriter(path)`` appends one array at a time, so an extraction
never holds its database in memory; ``set_attr(name, value)`` writes a
file attribute.  ``open_feature_store(path)`` returns a read-only mapping
(``keys()``, ``in``, ``[key]`` -> ``np.ndarray``, ``read_into(key, out)``
for a caller's buffer, and ``attrs``).  Its reads use ``os.pread``
at each member's offset, found once from the zip's directory, so threads
share one handle without a seek between them.

A path ending in ``.hdf5`` or ``.h5`` goes through ``h5py``, imported then;
where it is missing the error names the converter,
``python -m scan2cap_torch.scripts.convert_feature_db``.
"""

from __future__ import annotations

import ast
import os
import struct
import threading
import zipfile
from typing import Dict, Tuple

import numpy as np

HDF5_SUFFIXES = (".hdf5", ".h5")
CONVERTER = "python -m scan2cap_torch.scripts.convert_feature_db"
# the fixed part of a zip member's local header, and its two name and extra
# field lengths (APPNOTE 4.3.7)
_LOCAL_HEADER = struct.Struct("<4s2B4HL2L2H")
_LOCAL_MAGIC = b"PK\x03\x04"
# the members that hold the file's attributes
ATTRS_PREFIX = "__attrs__/"


def _attr_value(value):
    """An attribute as read back: a string as ``str``, bytes decoded, a
    0-d number as its Python scalar, any other array as it is."""
    if isinstance(value, bytes):
        return value.decode()
    arr = np.asarray(value)
    if arr.ndim == 0 and arr.dtype.kind in "US":
        v = arr[()]
        return v.decode() if isinstance(v, bytes) else str(v)
    if arr.ndim == 0:
        return arr[()].item()
    return arr


def is_hdf5(path: str) -> bool:
    return str(path).endswith(HDF5_SUFFIXES)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"h5py is needed to read or write an HDF5 feature database; "
            f"convert it to the port's .npz store on a machine that has "
            f"h5py: {CONVERTER} SRC.hdf5 DST.npz") from e
    return h5py


class FeatureStoreWriter:
    """``with FeatureStoreWriter(path) as w: w[key] = array``.

    Each assignment writes its array to the file at once.  A key is written
    once (as an HDF5 dataset is created once)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._keys = set()
        if is_hdf5(self.path):
            self._h5 = _h5py().File(self.path, "w")
            self._zip = None
        else:
            self._h5 = None
            self._zip = zipfile.ZipFile(self.path, "w", zipfile.ZIP_STORED,
                                        allowZip64=True)

    def __setitem__(self, key: str, value) -> None:
        if key in self._keys:
            raise KeyError(f"{key!r} is already in {self.path}")
        arr = np.asarray(value)
        if arr.dtype.hasobject:
            raise TypeError(f"{key!r}: object arrays are not stored")
        if self._h5 is not None:
            self._h5[key] = arr
        else:
            # force_zip64: a member's size is not known before it is written
            with self._zip.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
        self._keys.add(key)

    def set_attr(self, name: str, value) -> None:
        """A file attribute (HDF5's ``attrs[name] = value``)."""
        if self._h5 is not None:
            self._h5.attrs[name] = value
            return
        with self._zip.open(ATTRS_PREFIX + name + ".npy", "w",
                            force_zip64=True) as f:
            np.lib.format.write_array(f, np.asarray(value),
                                      allow_pickle=False)

    def close(self) -> None:
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        if self._zip is not None:
            self._zip.close()
            self._zip = None

    def __enter__(self) -> "FeatureStoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NpzFeatureStore:
    """Read-only mapping over an uncompressed ``.npz`` feature store."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            with zipfile.ZipFile(self.path) as zf:
                infos = zf.infolist()
            # member name -> offset of its local header; a member's data
            # starts after that header, whose extra field may differ from
            # the directory's
            self._members: Dict[str, int] = {}
            attr_names = []
            for info in infos:
                if not info.filename.endswith(".npy"):
                    continue
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(f"{self.path}: {info.filename} is "
                                     f"compressed; the store is not")
                self._members[info.filename[:-4]] = info.header_offset
                if info.filename.startswith(ATTRS_PREFIX):
                    attr_names.append(info.filename[:-4])
        except BaseException:
            os.close(self._fd)
            raise
        # key -> (dtype, shape, fortran_order, data offset); filled on first
        # read (a race fills it twice with the same value)
        self._layout: Dict[str, Tuple] = {}
        self.attrs = {name[len(ATTRS_PREFIX):]: _attr_value(self[name])
                      for name in attr_names}
        for name in attr_names:
            del self._members[name]

    def _pread(self, n: int, offset: int) -> bytes:
        out = os.pread(self._fd, n, offset)
        if len(out) != n:
            raise EOFError(f"{self.path}: {n} bytes at {offset} cut short")
        return out

    def layout(self, key: str) -> Tuple[np.dtype, Tuple[int, ...], bool, int]:
        """(dtype, shape, fortran_order, offset of the data in the file)."""
        got = self._layout.get(key)
        if got is not None:
            return got
        header = self._members[key]
        fields = _LOCAL_HEADER.unpack(self._pread(_LOCAL_HEADER.size, header))
        if fields[0] != _LOCAL_MAGIC:
            raise ValueError(f"{self.path}: no zip member header for {key!r}")
        start = header + _LOCAL_HEADER.size + fields[-2] + fields[-1]
        # the .npy header (format versions 1 to 3)
        magic = self._pread(8, start)
        if magic[:6] != b"\x93NUMPY":
            raise ValueError(f"{self.path}: {key!r} is no .npy member")
        major = magic[6]
        if major == 1:
            hlen = struct.unpack("<H", self._pread(2, start + 8))[0]
            body = start + 10
        else:
            hlen = struct.unpack("<I", self._pread(4, start + 8))[0]
            body = start + 12
        text = self._pread(hlen, body).decode("utf8" if major == 3
                                              else "latin1")
        meta = ast.literal_eval(text)
        got = (np.dtype(np.lib.format.descr_to_dtype(meta["descr"])),
               tuple(meta["shape"]), bool(meta["fortran_order"]),
               body + hlen)
        self._layout[key] = got
        return got

    def _read(self, offset: int, out: np.ndarray) -> np.ndarray:
        view = memoryview(out.reshape(-1).view(np.uint8))
        done = 0
        while done < len(view):
            n = os.preadv(self._fd, [view[done:]], offset + done)
            if n <= 0:
                raise EOFError(f"{self.path}: cut short at {offset + done}")
            done += n
        return out

    def read_into(self, key: str, out: np.ndarray) -> np.ndarray:
        """Read the array ``key`` into ``out`` (C-contiguous, of its shape
        and dtype) and return ``out``."""
        dtype, shape, fortran, offset = self.layout(key)
        if (out.shape != shape or out.dtype != dtype
                or not out.flags.c_contiguous or fortran):
            raise ValueError(f"{key!r} is {shape} {dtype}"
                             f"{' (Fortran order)' if fortran else ''}; "
                             f"got a buffer {out.shape} {out.dtype}")
        return self._read(offset, out)

    def __getitem__(self, key: str) -> np.ndarray:
        dtype, shape, fortran, offset = self.layout(key)
        if fortran:         # its bytes are the C-order transpose
            return self._read(offset, np.empty(shape[::-1], dtype)).T
        return self._read(offset, np.empty(shape, dtype))

    def shape(self, key: str) -> Tuple[int, ...]:
        return self.layout(key)[1]

    def dtype(self, key: str) -> np.dtype:
        return self.layout(key)[0]

    def keys(self):
        return self._members.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._members

    def __len__(self) -> int:
        return len(self._members)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover
        fd = getattr(self, "_fd", -1)
        if fd >= 0:
            os.close(fd)


class H5FeatureStore:
    """The same mapping over an HDF5 file (``h5py``)."""

    def __init__(self, path: str):
        self.path = str(path)
        h5py = _h5py()
        self._db = h5py.File(self.path, "r", libver="latest", swmr=True)
        self.attrs = {k: _attr_value(v) for k, v in self._db.attrs.items()}
        # every dataset by its path, a group's too ("sample/g_feat")
        self._keys = []
        self._db.visititems(
            lambda name, obj: self._keys.append(name)
            if isinstance(obj, h5py.Dataset) else None)

    def __getitem__(self, key: str) -> np.ndarray:
        return np.asarray(self._db[key])

    def read_into(self, key: str, out: np.ndarray) -> np.ndarray:
        self._db[key].read_direct(out)
        return out

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(self._db[key].shape)

    def dtype(self, key: str) -> np.dtype:
        return self._db[key].dtype

    def keys(self):
        return list(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._db

    def __len__(self) -> int:
        return len(self._keys)

    def close(self) -> None:
        self._db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_feature_store(path: str):
    """A read-only mapping over the feature database at ``path``: the
    ``.npz`` store, or an HDF5 file through ``h5py``."""
    if is_hdf5(path):
        return H5FeatureStore(path)
    return NpzFeatureStore(path)


class LazyStore:
    """One store handle per dataset, opened at the first read under a lock:
    the Loader's worker threads race through ``get``."""

    def __init__(self, path: str):
        self.path = path
        self._store = None
        self._lock = threading.Lock()

    def get(self):
        if self._store is None:
            with self._lock:
                if self._store is None:
                    self._store = open_feature_store(self.path)
        return self._store
