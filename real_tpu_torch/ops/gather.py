"""The match step's table fetches: the window gather and its two fused forms.

Counterpart of real_tpu/ops/pallas_gather.py (gather_word_windows over the
Pallas kernel _window_call), which serves three call sites of real_tpu's
find_survivors: the two adjacent bucket bounds of each probe, the K1
tier-1 list signatures of each probe, and the kw+1 text words covering
each survivor window. Here each site's fetch happens inside the kernel
that consumes it (csrc/gather_windows.cu, three entry points):

  gather_word_windows  w consecutive words at n starts, the generic gather
                       (the bisection path's bucket bounds)
  probe_candidates     bucket bounds -> candidate range -> tier-1
                       signatures -> lane validity, per probe; one entry
                       for 32-bit signatures, one for wide (64-bit) ones
  verify_windows       text words -> funnel shift -> XOR with the read ->
                       masked mismatch counts, per survivor lane

On CUDA tensors a wrapper launches its kernel or raises; the plain PyTorch
version (`*_ref`) beside it serves CPU tensors only. Unlike real_tpu there
is no size gate: the v5e-tuned thresholds of use_pallas_gather do not
apply to this card.

32-bit tables are int32 bit patterns; probe signatures, read words and
positions are the int64 tensors the match step computes (text/packed.py).
A wide signature list (seedl 36..64) is an int64 table of 64-bit patterns
and its probes are int64 patterns too (index/signatures.py); real_tpu
fetches those lanes with jnp.take because its Pallas kernel is 32-bit
only, here the wide lookup has its own kernel entry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from real_tpu_torch.index.signatures import (NUM_LISTS,
                                             logical_shift_right)
from real_tpu_torch.ops import cuda_build
from real_tpu_torch.text.packed import (MASK32, i32_bits,
                                        pair_mismatch_count, u32)

KERNEL = "gather_windows"
MAX_KW = 16                      # verify_windows: reads up to 256 bases
NUM_PROBES = 2 * NUM_LISTS

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "gather_windows_i32": [_P, _I64, _P, _I64, _INT, _P, _P],
    "probe_candidates_i32": [_P, _I64, _P, _I64, _P, _P, _I64, _INT, _INT,
                             _P, _P, _P, _P, _P],
    "probe_candidates_i64": [_P, _I64, _P, _I64, _P, _P, _I64, _INT, _INT,
                             _P, _P, _P, _P, _P],
    "verify_windows_i32": [_P, _I64, _P, _P, _P, _P, _I64, _INT, _INT,
                           _P, _P, _P, _P, _P, _P, _P],
}
_bound = {}


def _launch(entry: str, device: torch.device, *args) -> None:
    """Launch the C entry point `entry` (built and bound on first use) on
    `device`'s current stream; raises if the launch is refused."""
    fn = _bound.get(entry)
    if fn is None:
        fn = getattr(cuda_build.load(KERNEL), entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _bound[entry] = fn
    index = device.index
    current = torch.cuda.current_device()
    if index is None:
        index = current
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw_stream(index) if raw_stream is not None \
        else torch.cuda.current_stream(index).cuda_stream
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def _all_on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain version serves
    them), False when all are on one CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: tensors on {sorted(str(d) for d in devices)}; all "
            "must be on one CUDA device (or the CPU)")
    return False


def _check_table(name: str, what: str, t: torch.Tensor,
                 dtype=torch.int32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous() or t.numel() < 1:
        raise ValueError(f"{name}: {what} must be a non-empty contiguous "
                         "1-D table")


def _check(name: str, what: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name}: {what} must be {dtype} {tuple(shape)}, "
                        f"got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# the generic window gather
# ---------------------------------------------------------------------------

def gather_word_windows_ref(words: torch.Tensor, idx: torch.Tensor,
                            w: int) -> List[torch.Tensor]:
    """Plain version: pad the table with w zeros, clamp the start to
    [0, mw-1], and stack w index lookups. Returns w tensors shaped like
    idx, of the table's dtype."""
    mw = words.shape[0]
    padded = torch.cat([words, words.new_zeros(w)])
    p = idx.to(torch.int64).clamp(0, mw - 1)
    return [padded[p + k] for k in range(w)]


def gather_word_windows(words: torch.Tensor, idx: torch.Tensor,
                        w: int) -> List[torch.Tensor]:
    """words[clamp(idx, 0, mw-1) + k] for k in range(w), zero past the
    table end, as a list of w tensors shaped like idx — the same contract
    as real_tpu.ops.pallas_gather.gather_word_windows.

    `words` is a 1-D int32 table (32-bit bit patterns); `idx` int32 start
    offsets of any shape. CPU tensors take gather_word_windows_ref; CUDA
    tensors launch the kernel, and anything else raises."""
    name = "gather_word_windows"
    if _all_on_cpu(name, words, idx):
        return gather_word_windows_ref(words, idx, w)
    _check_table(name, "words", words)
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if w < 1:
        raise ValueError(f"{name}: w={w} must be >= 1")
    flat = idx.contiguous()
    n = flat.numel()
    out = torch.empty((w, *idx.shape), dtype=torch.int32,
                      device=words.device)
    if n:
        _launch("gather_windows_i32", words.device, words.data_ptr(),
                words.numel(), flat.data_ptr(), n, w, out.data_ptr())
        gather_word_windows.launches += 1
        gather_word_windows.launches_by_w[w] = \
            gather_word_windows.launches_by_w.get(w, 0) + 1
    return list(out.unbind(0))


# ---------------------------------------------------------------------------
# probe -> candidate range -> tier-1 lanes
# ---------------------------------------------------------------------------

def probe_candidates_ref(index_sig: torch.Tensor, index_bb: torch.Tensor,
                         probe_sig: torch.Tensor, read_valid: torch.Tensor,
                         bucket_shift: int, k1: int):
    """Plain version of probe_candidates: real_tpu's find_survivors from
    the bucket lookup to the tier-1 lane validity (bsearch_steps == 0),
    indexed by probe instead of by list. An int64 index_sig is a wide
    list: 64-bit patterns, a logical shift for the bucket key, lanes
    returned as int64 (real_tpu's two jnp.take planes joined)."""
    wide = index_sig.dtype == torch.int64
    M = index_sig.shape[0] // NUM_LISTS
    nbuck = index_bb.shape[0] // NUM_LISTS
    lists = torch.arange(NUM_PROBES, dtype=torch.int64,
                         device=probe_sig.device) % NUM_LISTS     # [12]
    h = logical_shift_right(probe_sig, bucket_shift) if wide \
        else probe_sig >> bucket_shift
    lo, hi = gather_word_windows_ref(
        index_bb, (h + lists * nbuck).to(torch.int32), 2)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    # clamp every range end to the list's real-entry count: sentinels sort
    # after every real entry (an all-T probe would otherwise see them all)
    real_end = index_bb[nbuck - 1 + lists * nbuck].to(torch.int64)
    hi = torch.minimum(hi, real_end)
    begin = lo
    count = torch.clamp(hi - begin, max=2 * M)                    # [B, 12]
    # Tier-1 lanes past the clipped start read neighbour-list entries; all
    # of them have lane >= count and in_range masks them.
    start = torch.clamp(begin, 0, M - 1) + lists * M
    lane_sig = torch.stack(gather_word_windows_ref(
        index_sig, start.to(torch.int32), k1), dim=-1)            # [B, 12, k1]
    lane = torch.arange(k1, dtype=torch.int64, device=probe_sig.device)
    eq = (lane_sig if wide else u32(lane_sig)) == probe_sig[..., None]
    in_range = lane[None, None, :] < count[..., None]
    cand = in_range & eq & read_valid[:, None, None]
    return begin.to(torch.int32), count.to(torch.int32), lane_sig, cand


def probe_candidates(index_sig: torch.Tensor, index_bb: torch.Tensor,
                     probe_sig: torch.Tensor, read_valid: torch.Tensor,
                     bucket_shift: int, k1: int):
    """Candidate ranges and tier-1 lanes of a batch's probes against one
    index shard, from the bucket table alone (no bisection).

    index_sig [6*M] and index_bb int32 [6*nbuck] are the flat sorted
    lists and bucket tables; probe_sig int64 [B, 12] holds the probe
    signatures (probe = strand*6 + list); read_valid bool [B];
    bucket_shift = signature bits below the bucket key; 1 <= k1 <= 4.
    Narrow lists are int32 bit patterns with unsigned probe values and
    0 <= bucket_shift <= 32; wide lists (seedl 36..64) are int64 bit
    patterns with probes of the same form and 1 <= bucket_shift <= 63.

    Returns, probe-major: begin int32 [B, 12] (first list entry of the
    probe's bucket), count int32 [B, 12] (entries to the bucket's end,
    clamped to the list's real entries; may be <= 0), lane_sig [B, 12, k1]
    of the list's dtype (bit patterns of the k1 list signatures from the
    clipped begin, zero past the table end) and cand bool [B, 12, k1] =
    lane < count & lane signature == probe & read_valid.

    CPU tensors take probe_candidates_ref; CUDA tensors launch the kernel,
    and anything else raises."""
    name = "probe_candidates"
    if _all_on_cpu(name, index_sig, index_bb, probe_sig, read_valid):
        return probe_candidates_ref(index_sig, index_bb, probe_sig,
                                    read_valid, bucket_shift, k1)
    wide = index_sig.dtype == torch.int64
    _check_table(name, "index_sig", index_sig,
                 torch.int64 if wide else torch.int32)
    _check_table(name, "index_bb", index_bb)
    if index_sig.numel() % NUM_LISTS or index_bb.numel() % NUM_LISTS \
            or index_sig.numel() >= 2**31:
        raise ValueError(f"{name}: tables must hold {NUM_LISTS} equal lists "
                         "of fewer than 2^31 entries in all")
    B = read_valid.shape[0]
    _check(name, "probe_sig", probe_sig, torch.int64, (B, NUM_PROBES))
    _check(name, "read_valid", read_valid, torch.bool, (B,))
    lo_shift, hi_shift = (1, 63) if wide else (0, 32)
    if not 1 <= k1 <= 4 or not lo_shift <= bucket_shift <= hi_shift:
        raise ValueError(f"{name}: k1={k1} must be in 1..4 and bucket_shift="
                         f"{bucket_shift} in {lo_shift}..{hi_shift}")
    probe_sig, read_valid = probe_sig.contiguous(), read_valid.contiguous()
    dev = index_sig.device
    begin = torch.empty((B, NUM_PROBES), dtype=torch.int32, device=dev)
    count = torch.empty((B, NUM_PROBES), dtype=torch.int32, device=dev)
    lane_sig = torch.empty((B, NUM_PROBES, k1), dtype=index_sig.dtype,
                           device=dev)
    cand = torch.empty((B, NUM_PROBES, k1), dtype=torch.bool, device=dev)
    if B:
        _launch("probe_candidates_i64" if wide else "probe_candidates_i32",
                dev, index_sig.data_ptr(),
                index_sig.numel() // NUM_LISTS, index_bb.data_ptr(),
                index_bb.numel() // NUM_LISTS, probe_sig.data_ptr(),
                read_valid.data_ptr(), B * NUM_PROBES, bucket_shift, k1,
                begin.data_ptr(), count.data_ptr(), lane_sig.data_ptr(),
                cand.data_ptr())
        probe_candidates.launches += 1
        probe_candidates.launches_wide += int(wide)
    return begin, count, lane_sig, cand


# ---------------------------------------------------------------------------
# survivor window -> shifted text words -> mismatch counts
# ---------------------------------------------------------------------------

def _tail_masks(patl: int, nw: int) -> np.ndarray:
    masks = np.full(nw, 0xFFFFFFFF, dtype=np.uint32)
    tail = patl - 16 * (nw - 1) if nw else 0
    if nw and tail < 16:
        masks[nw - 1] = np.uint32(0xFFFFFFFF) << np.uint32(32 - 2 * tail)
    return masks


def _seed_masks(patl: int, seedl: int, nw: int):
    """Per-word 2-bit masks selecting the SEED region of the window:
    straight hits carry the seed at window start [0, seedl); reverse hits
    at the end [patl-seedl, patl) (RestMatch.hpp:84-89)."""
    def region(a, b):
        out = np.zeros(nw, dtype=np.uint32)
        for w in range(nw):
            w0, w1 = 16 * w, 16 * w + 16
            s, e = max(a, w0), min(b, w1)
            if s < e:
                m = ((np.uint64(1) << np.uint64(2 * (e - s))) - np.uint64(1))
                out[w] = np.uint32(m << np.uint64(2 * (w1 - e)))
        return out
    return region(0, seedl), region(patl - seedl, patl)


@functools.lru_cache(maxsize=None)
def window_masks(patl: int, seedl: int) -> Tuple[np.ndarray, ...]:
    """(tail, seed_straight, seed_reverse): uint32 [kw] masks of a patl-base
    window's words, kw = ceil(patl / 16)."""
    kw = (patl + 15) // 16
    return (_tail_masks(patl, kw), *_seed_masks(patl, seedl, kw))


def verify_windows_ref(words: torch.Tensor, pos: torch.Tensor,
                       inv: torch.Tensor, words_s: torch.Tensor,
                       words_r: torch.Tensor, patl: int, seedl: int):
    """Plain version of verify_windows: real_tpu's _extract_windows (the
    kw+1 aligned words covering each window from one window gather, then a
    funnel shift; AutoTextArray::getTextWord, AutoTextArray.hpp:122-125)
    and find_survivors' XOR + 2-bit pair popcount loop."""
    kw = (patl + 15) // 16
    p = pos.to(torch.int64)
    sh = (p & 15) << 1
    w = [u32(x) for x in
         gather_word_windows_ref(words, (p >> 4).to(torch.int32), kw + 1)]
    # w >> (32 - sh) is 0 for sh == 0: int64 shifts by 32 are defined
    tw = [((w[i] << sh) & MASK32) | (w[i + 1] >> (32 - sh))
          for i in range(kw)]
    masks, smask_s, smask_r = window_masks(patl, seedl)
    patw = torch.where(inv[..., None], words_r[:, None, :],
                       words_s[:, None, :])      # [B, S, KW]
    totalk = torch.zeros_like(p)
    seedk = torch.zeros_like(p)
    for i in range(kw):
        x = (tw[i] ^ patw[..., i]) & int(masks[i])
        totalk = totalk + pair_mismatch_count(x)
        sm = torch.where(inv, int(smask_r[i]), int(smask_s[i]))
        seedk = seedk + pair_mismatch_count(x & sm)
    return (torch.stack([i32_bits(t) for t in tw]),
            totalk.to(torch.int32), seedk.to(torch.int32))


def verify_windows(words: torch.Tensor, pos: torch.Tensor,
                   inv: torch.Tensor, words_s: torch.Tensor,
                   words_r: torch.Tensor, patl: int, seedl: int):
    """The patl-base text window at each survivor lane's position against
    the lane's read, as packed words and mismatch counts.

    words int32 [mw] is the 2-bit packed text (16 bases per word,
    MSB-first); pos int64 [B, S] base offsets (within int32; the window's
    first word index is clamped to [0, mw-1] and words past the table end
    read 0 — those bits lie beyond pos+patl, which the tail mask and
    fragment containment keep out of every result); inv bool [B, S]
    selects the read's reverse-complement words; words_s, words_r int64
    [B, kw] are the read's packed words (unsigned values).

    Returns tw int32 [kw, B, S] (bit patterns of the kw window words),
    totalk int32 [B, S] (mismatching bases within the read length) and
    seedk int32 [B, S] (those inside the strand's seed region).

    CPU tensors take verify_windows_ref; CUDA tensors launch the kernel,
    and anything else raises."""
    name = "verify_windows"
    if _all_on_cpu(name, words, pos, inv, words_s, words_r):
        return verify_windows_ref(words, pos, inv, words_s, words_r, patl,
                                  seedl)
    kw = (patl + 15) // 16
    if not 1 <= kw <= MAX_KW or not 0 < seedl <= patl:
        raise ValueError(f"{name}: patl={patl} must be in 1..{16 * MAX_KW} "
                         f"and seedl={seedl} in 1..patl")
    _check_table(name, "words", words)
    if pos.dim() != 2:
        raise ValueError(f"{name}: pos must be [B, S], got "
                         f"{tuple(pos.shape)}")
    B, S = pos.shape
    _check(name, "pos", pos, torch.int64, (B, S))
    _check(name, "inv", inv, torch.bool, (B, S))
    _check(name, "words_s", words_s, torch.int64, (B, kw))
    _check(name, "words_r", words_r, torch.int64, (B, kw))
    pos, inv = pos.contiguous(), inv.contiguous()
    words_s, words_r = words_s.contiguous(), words_r.contiguous()
    dev = words.device
    tw = torch.empty((kw, B, S), dtype=torch.int32, device=dev)
    totalk = torch.empty((B, S), dtype=torch.int32, device=dev)
    seedk = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B * S:
        tail, seed_s, seed_r = (m.ctypes.data for m in
                                window_masks(patl, seedl))
        _launch("verify_windows_i32", dev, words.data_ptr(), words.numel(),
                pos.data_ptr(), inv.data_ptr(), words_s.data_ptr(),
                words_r.data_ptr(), B * S, S, kw, tail, seed_s, seed_r,
                tw.data_ptr(), totalk.data_ptr(), seedk.data_ptr())
        verify_windows.launches += 1
    return tw, totalk, seedk


# kernel launches since the last reset, one count per entry point
# (chip_smoke.py proves the main path went through each kernel with these);
# launches_by_w splits the generic gather's by window width, launches_wide
# counts those of probe_candidates' launches that took the 64-bit entry
gather_word_windows.launches = 0
gather_word_windows.launches_by_w = {}
probe_candidates.launches = 0
probe_candidates.launches_wide = 0
verify_windows.launches = 0


def launch_counts() -> dict:
    """The launch counts of the three entry points since the last reset."""
    return {"probe_candidates": probe_candidates.launches,
            "probe_candidates_wide": probe_candidates.launches_wide,
            "verify_windows": verify_windows.launches,
            "gather_word_windows": gather_word_windows.launches}


def reset_launch_counts() -> None:
    gather_word_windows.launches = 0
    gather_word_windows.launches_by_w = {}
    probe_candidates.launches = 0
    probe_candidates.launches_wide = 0
    verify_windows.launches = 0
