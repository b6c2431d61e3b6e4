"""Convert a feature database between HDF5 and the port's ``.npz`` store:
``python -m scan2cap_torch.scripts.convert_feature_db SRC DST``.

Either side may be HDF5 (``.hdf5`` / ``.h5``, read or written through
``h5py``) or the store (any other suffix; ``data/feature_store.py``).  Every
key, a dataset inside a group by its path (``"{sample_id}/g_feat"``), is
copied with its dtype, shape and bytes unchanged, and so is every file
attribute (the 2D databases' ``extractor_backend``), so a database that
the JAX package's extractors or its 2D ``--prep`` wrote, or the released
``enet_feats_maxpool.hdf5`` of multiview features, becomes a store that the
port reads where ``h5py`` is missing, and back.  Needs ``h5py`` when
either side is HDF5.
"""

from __future__ import annotations

import argparse


def convert(src: str, dst: str) -> int:
    """Copy every key of ``src`` into a new database ``dst``; returns the
    number of keys."""
    from scan2cap_torch.data.feature_store import (FeatureStoreWriter,
                                                   open_feature_store)
    with open_feature_store(src) as db, FeatureStoreWriter(dst) as out:
        for name, value in db.attrs.items():
            out.set_attr(name, value)
        keys = sorted(db.keys())
        for key in keys:
            out[key] = db[key]
    return len(keys)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="the database to read")
    p.add_argument("dst", help="the database to write (replaced)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    n = convert(args.src, args.dst)
    print(f"wrote {n} keys to {args.dst}")
    return n


if __name__ == "__main__":
    main()
