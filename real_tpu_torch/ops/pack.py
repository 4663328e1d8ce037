"""The packed text's tables and flags from the genome's base codes.

`pack_text(codes, device)` turns a text's uint8 base codes (0..4, as
io/fasta.py parse_genome returns them) into the tables of
text/packed.py PackedText (words, nbits, ncum, nb16, ncum16; int32 tensors
with real_tpu's uint32 bit patterns) and its flags (has_n, allt32,
allt64), on `device`:

  CUDA  the codes are copied to the card (span `genome.upload`) and
        csrc/pack_text.cu derives the tables there, torch.cumsum scanning
        the N counts (span `genome.pack`): one launch set a text, counted
        in pack_text.launches. A text over CHUNK_BASES is uploaded and
        packed in chunks, so that its codes never take more than
        CHUNK_BASES bytes of the card; the buffer is freed before
        pack_text returns. The flags come back in one small
        copy at the end, the pack's one synchronisation. A failed build or
        launch raises: nothing falls back to the host.
  CPU   pack_tables_ref, the plain NumPy version, packs on the host (span
        `genome.pack`) and the tables become tensors (span
        `genome.upload`).

pack_tables_ref is real_tpu's text/packed.py build_packed_text's host
pack; the CPU tests hold it against real_tpu, chip_smoke.py holds the
kernel against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from real_tpu_torch import bitpack
from real_tpu_torch.index.signatures import PAIR_SEGMENTS, SigConfig
from real_tpu_torch.ops import cuda_build
from real_tpu_torch.utils import spans

KERNEL = "pack_text"
# bases of codes on the card at once: a multiple of 32, so that every
# chunk starts on an nbits word
CHUNK_BASES = 1 << 29
# flags[0] bits set by csrc/pack_text.cu
_HAS_N, _ALLT32, _ALLT64 = 1, 2, 4

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "pack_text_chunk": ([_P, _I64, _I64, _I64, _P, _I64, _P, _P, _P, _P, _P],
                        ctypes.c_int),
    "pack_text_finish": ([_P, _I64, _I64, _P, _P], ctypes.c_int),
}
_bound = {}


class PackedTables(NamedTuple):
    """A text's tables (numpy arrays from pack_tables_ref, int32 tensors
    from pack_text) and flags."""
    words: object      # [ceil(n/16) + 2] 16 bases a word, MSB-first
    nbits: object      # [ceil(n/32) + 2] N bitmap, 32 bases a word
    ncum: object       # [len(nbits) + 1] N count before each nbits word
    nb16: object       # [2 len(nbits)] nbits' 16-bit halves, high first
    ncum16: object     # [2 len(nbits) + 1] N count before each half
    has_n: bool
    allt32: bool
    allt64: bool


def pack_tables_ref(codes: np.ndarray) -> PackedTables:
    """The plain version: the tables and flags packed on the host, uint32
    (words, nbits, nb16) and int32 (ncum, ncum16) numpy arrays."""
    words = bitpack.pack_2bit(codes, pad_words=2)
    nbits = bitpack.pack_bitmap(codes > 3, pad_words=2)
    ncum = bitpack.bitmap_cum_popcount(nbits)
    nw = len(nbits)
    nb16 = np.empty(2 * nw, dtype=np.uint32)
    nb16[0::2] = nbits >> np.uint32(16)
    nb16[1::2] = nbits & np.uint32(0xFFFF)
    ncum16 = np.zeros(2 * nw + 1, dtype=np.int64)
    ncum16[1:] = np.cumsum(np.bitwise_count(nb16))
    has_n = bool(ncum16[-1] > 0)
    return PackedTables(words, nbits, ncum, nb16, ncum16.astype(np.int32),
                        has_n, _has_all_t_pair(codes, 32),
                        _has_all_t_pair(codes, 64))


def _run_all(x: np.ndarray, w: int) -> np.ndarray:
    """r[i] = x[i] & x[i+1] & ... & x[i+w-1] by dyadic folding (w a power
    of two); len(r) = len(x) - w + 1."""
    step = 1
    while step < w:
        x = x[:-step] & x[step:]
        step *= 2
    return x


def _has_all_t_pair(codes: np.ndarray, seedl: int) -> bool:
    """True when some window's pair signature equals the 0xFFFFFFFF
    sentinel — i.e. a genuine all-T segment pair exists. Only a
    full-width pair reaches the sentinel: seedl == 32 (narrow) or
    seedl == 64 (wide)."""
    w = seedl // 4
    x = codes == 3
    if len(x) < seedl:
        return False
    seg_t = _run_all(x, w)                 # seg_t[i]: codes[i:i+w] all T
    if not seg_t.any():
        return False
    offs = SigConfig(seedl).seg_offsets
    nwin = len(codes) - seedl + 1
    for a, b in PAIR_SEGMENTS:
        sa = seg_t[offs[a]:offs[a] + nwin]
        sb = seg_t[offs[b]:offs[b] + nwin]
        if bool(np.any(sa & sb)):
            return True
    return False


def _entry(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(cuda_build.load(KERNEL), name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
        _bound[name] = fn
    return fn


def _call(name: str, *args) -> None:
    rc = _entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _as_i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32)).to(device)


def pack_text(codes: np.ndarray, device) -> PackedTables:
    """The tables and flags of a text of uint8 base codes (1-D, C
    contiguous) as int32 tensors on `device`: a CUDA device launches the
    kernel, the CPU takes pack_tables_ref; anything else raises."""
    if not isinstance(codes, np.ndarray) or codes.dtype != np.uint8:
        raise TypeError("pack_text: codes must be a uint8 numpy array, got "
                        f"{getattr(codes, 'dtype', type(codes).__name__)}")
    if codes.ndim != 1 or not codes.flags.c_contiguous:
        raise ValueError("pack_text: codes must be 1-D and C contiguous")
    dev = torch.device(device)
    if dev.type == "cpu":
        with spans.span("genome.pack"):
            ref = pack_tables_ref(codes)
        with spans.span("genome.upload"):
            return ref._replace(**{f: _as_i32(getattr(ref, f), dev)
                                   for f in PackedTables._fields[:5]})
    if dev.type != "cuda":
        raise ValueError(f"pack_text: device {dev} is neither CUDA nor the "
                         "CPU")
    with torch.cuda.device(dev):
        return _pack_on_card(codes, dev)


def _pack_on_card(codes: np.ndarray, dev: torch.device) -> PackedTables:
    n = codes.shape[0]
    t, flags = empty_tables(n, dev)
    host = torch.from_numpy(codes)
    chunk = min(n, CHUNK_BASES)
    buf = torch.empty(-(-chunk // 32) * 32, dtype=torch.uint8, device=dev)
    for lo in range(0, max(n, 1), CHUNK_BASES):
        m = min(CHUNK_BASES, n - lo)
        with spans.span("genome.upload"):
            if m:
                buf[:m].copy_(host[lo:lo + m])
        with spans.span("genome.pack"):
            launch_chunk(t, n, buf, lo, m, flags)
    del buf
    with spans.span("genome.pack"):
        launch_finish(t, n, flags)
        pack_text.launches += 1
        bits = int(flags.item())
    return t._replace(has_n=bool(bits & _HAS_N),
                      allt32=bool(bits & _ALLT32),
                      allt64=bool(bits & _ALLT64))


def empty_tables(n: int, dev: torch.device):
    """(the tables of a text of n bases, uninitialised, on the card;
    the kernels' flags word, zeroed)."""
    nw = -(-n // 32) + 2                            # nbits words, pads too
    t = PackedTables(
        words=torch.empty(-(-n // 16) + 2, dtype=torch.int32, device=dev),
        nbits=torch.empty(nw, dtype=torch.int32, device=dev),
        ncum=torch.empty(nw + 1, dtype=torch.int32, device=dev),
        nb16=torch.empty(2 * nw, dtype=torch.int32, device=dev),
        ncum16=torch.empty(2 * nw + 1, dtype=torch.int32, device=dev),
        has_n=False, allt32=False, allt64=False)
    return t, torch.zeros(1, dtype=torch.int32, device=dev)


def launch_chunk(t: PackedTables, n: int, buf: torch.Tensor, lo: int,
                 m: int, flags: torch.Tensor) -> None:
    """Pack bases [lo, lo + m) of the text, uploaded at the start of `buf`
    (lo a multiple of 32), into t's tables; the chunk that reaches n also
    writes the pads."""
    j0 = lo // 32
    jcount = t.nbits.numel() - j0 if lo + m >= n else m // 32
    _call("pack_text_chunk", buf.data_ptr(), m, j0, jcount,
          t.words.data_ptr(), t.words.numel(), t.nbits.data_ptr(),
          t.nb16.data_ptr(), t.ncum16.data_ptr(), flags.data_ptr(),
          _stream(buf.device))


def launch_finish(t: PackedTables, n: int, flags: torch.Tensor) -> None:
    """After every chunk: the all-T flags ORed into flags[0], the N counts
    scanned in place into ncum16 (int32 stays int32 in place) and ncum
    copied from its even entries."""
    _call("pack_text_finish", t.words.data_ptr(), t.words.numel(), n,
          flags.data_ptr(), _stream(t.words.device))
    t.ncum16[1:].cumsum_(0)
    t.ncum.copy_(t.ncum16[::2])


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# launch sets since the last reset, one a text packed on the card; read and
# reset with the match's kernels by ops/gather.py launch_counts and
# reset_launch_counts (-metrics kernel_launches)
pack_text.launches = 0
