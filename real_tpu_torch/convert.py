"""Carry real_tpu's state into the port: the packed text and the index.

real_tpu keeps them as JAX arrays; given as numpy arrays (np.asarray of
each field), they become the port's tensors with the same bits — uint32
tables as int32 bit patterns (text/packed.py). The tests feed the
identical index to both packages' match steps this way, so a matcher
difference cannot hide behind an index-order difference (within equal
signatures the list order is free).
"""

from __future__ import annotations

import numpy as np

from real_tpu_torch.index.build import SignatureIndex
from real_tpu_torch.text.packed import PackedText, as_i32_tensor

_TABLES = ("words", "nbits", "ncum", "frag_offsets", "nb16", "ncum16")


def packed_text_from_numpy(fields: dict, device) -> PackedText:
    """`fields`: a PackedText's fields (dataclasses.asdict of real_tpu's
    PackedText with its arrays as numpy)."""
    kw = {k: as_i32_tensor(np.asarray(fields[k]), device) for k in _TABLES}
    return PackedText(n=int(fields["n"]), ranges=list(fields["ranges"]),
                      allt32=bool(fields["allt32"]),
                      allt64=bool(fields["allt64"]),
                      has_n=bool(fields["has_n"]), **kw)


def index_from_numpy(sig: np.ndarray, pos: np.ndarray, bb: np.ndarray,
                     bucket_bits: int, seedl: int, device) -> SignatureIndex:
    """A narrow SignatureIndex from its flat sig (uint32), pos and bb."""
    return SignatureIndex(sig=as_i32_tensor(np.asarray(sig), device),
                          pos=as_i32_tensor(np.asarray(pos), device),
                          bb=as_i32_tensor(np.asarray(bb), device),
                          seedl=seedl, bucket_bits=bucket_bits)
