"""Carry real_tpu's state into the port: the packed text and the index.

real_tpu keeps them as JAX arrays; given as numpy arrays (np.asarray of
each field), they become the port's tensors with the same bits — uint32
tables as int32 bit patterns (text/packed.py). The tests feed the
identical index to both packages' match steps this way, so a matcher
difference cannot hide behind an index-order difference (within equal
signatures the list order is free).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from real_tpu_torch.index.build import SignatureIndex
from real_tpu_torch.index.signatures import i64_to_planes, planes_to_i64
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
                     bucket_bits: int, seedl: int, device,
                     sig_hi: Optional[np.ndarray] = None) -> SignatureIndex:
    """A SignatureIndex from real_tpu's flat arrays: sig (uint32), pos and
    bb, and for wide seeds (seedl > 32) the high plane sig_hi, which is
    joined with sig into the port's one int64 pattern per entry."""
    if (sig_hi is not None) != (seedl > 32):
        raise ValueError("sig_hi goes with wide seeds (seedl > 32) only")
    if sig_hi is None:
        sig_t = as_i32_tensor(np.asarray(sig), device)
    else:
        sig_t = torch.from_numpy(
            planes_to_i64(np.asarray(sig_hi), np.asarray(sig))).to(device)
    return SignatureIndex(sig=sig_t,
                          pos=as_i32_tensor(np.asarray(pos), device),
                          bb=as_i32_tensor(np.asarray(bb), device),
                          seedl=seedl, bucket_bits=bucket_bits)


def index_to_numpy(index: SignatureIndex) -> dict:
    """The other way: real_tpu's field names and dtypes (sig uint32, the
    low plane when wide; sig_hi uint32 or None; pos and bb int32)."""
    sig = index.sig.cpu().numpy()
    if index.seedl > 32:
        sig_hi, sig = i64_to_planes(sig)
    else:
        sig_hi, sig = None, sig.view(np.uint32)
    return dict(sig=sig, sig_hi=sig_hi, pos=index.pos.cpu().numpy(),
                bb=index.bb.cpu().numpy(), seedl=index.seedl,
                bucket_bits=index.bucket_bits)
