"""Cached packed read store (-R 1, the default).

Counterpart of real_tpu/io/readstore.py and of the reference's binary
pattern rewrite (TemporaryFile.hpp / ReorderFastA.hpp / ReorderFastQ.hpp):
the read file is parsed once and kept as raw .npy arrays (codes,
qualities, ids, offsets) in a store directory next to the input, so later
runs skip text parsing and map the arrays from disk. The store version,
its path rule and its file layout are real_tpu's, so a store written by
either package loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional

import numpy as np

from real_tpu_torch.io.reads import IdView, ReadSet, parse_reads
from real_tpu_torch.utils import spans

STORE_VERSION = 3

_ARRAYS = ("lengths", "codes_flat", "offsets", "quals_flat",
           "ids_blob", "ids_off")


def _store_path(path: str) -> str:
    st = os.stat(path)
    key = hashlib.sha1(
        f"{os.path.abspath(path)}-{st.st_size}-{st.st_mtime_ns}-"
        f"{STORE_VERSION}".encode()).hexdigest()[:16]
    return os.path.join(os.path.dirname(os.path.abspath(path)),
                        f".{os.path.basename(path)}.{key}.realstore")


def save(rs: ReadSet, path: str) -> str:
    """One raw .npy per array in a store directory: raw .npy files load as
    memory maps at once and page in on first touch. meta.npz is written
    last and marks the store complete."""
    store = _store_path(path)
    os.makedirs(store, exist_ok=True)
    ids = (rs.ids if isinstance(rs.ids, IdView)
           else IdView.from_strings(list(rs.ids)))
    arrays = dict(lengths=rs.lengths, codes_flat=rs.codes_flat,
                  offsets=rs.offsets,
                  quals_flat=(rs.quals_flat if rs.quals_flat is not None
                              else np.zeros(0, np.int8)),
                  ids_blob=ids.blob, ids_off=ids.off)
    for name, a in arrays.items():
        np.save(os.path.join(store, name + ".npy"), a)
    np.savez(os.path.join(store, "meta.npz"),
             has_quals=np.array([rs.quals_flat is not None]),
             fastq=np.array([rs.fastq]),
             quality_offset=np.array([rs.quality_offset]))
    return store


def load(path: str) -> Optional[ReadSet]:
    """The stored read set of `path`, or None when there is no complete,
    readable store for the file as it is now (the caller then parses)."""
    store = _store_path(path)
    meta_p = os.path.join(store, "meta.npz")
    if not os.path.exists(meta_p):
        return None
    try:
        meta = np.load(meta_p)
        z = {name: np.load(os.path.join(store, name + ".npy"),
                           mmap_mode="r") for name in _ARRAYS}
        return ReadSet(
            ids=IdView(z["ids_blob"], z["ids_off"]),
            lengths=z["lengths"], codes_flat=z["codes_flat"],
            offsets=z["offsets"],
            quals_flat=z["quals_flat"] if bool(meta["has_quals"][0])
            else None,
            fastq=bool(meta["fastq"][0]),
            quality_offset=int(meta["quality_offset"][0]))
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None     # a damaged or half-written store: parse anew


@spans.traced("parse.reads")
def parse_reads_cached(path: str, quality_offset: int = 0,
                       rewrite: bool = True,
                       use_native: bool = True) -> ReadSet:
    """parse_reads with the on-disk store (-R semantics; stdin is never
    stored)."""
    if path == "-" or not rewrite:
        return parse_reads(path, quality_offset, use_native)
    rs = load(path)
    if rs is not None and (quality_offset in (0, rs.quality_offset)):
        return rs
    rs = parse_reads(path, quality_offset, use_native)
    try:
        save(rs, path)
    except OSError:
        pass   # a read-only directory: the store is best-effort
    return rs
