"""The per-(read-batch x index-shard) match step, matchUnique and matchAll.

Counterpart of real_tpu/engine/matchstep.py (see its module docstring for
the design): probes, candidate ranges from the bucket table (optionally
bisected to the exact equal range), stable compaction of the valid lanes
to <= S survivors per read in reference merge order, the window fetch,
XOR+popcount verification, f64 scoring, and then either the
UpdateUniqueInfo automaton fold (matchUnique) or the compaction of every
deduplicated hit for the host (matchAll, compact_hits). Each step keeps
real_tpu's order-defining operations: the stable argsort compaction, the
stable (probe, pos) sort of the compacted lanes, and the fold over
survivors in lane order — scores mode can observe it (engine/monoid.py of
real_tpu).

The three table fetches are CUDA kernels on the card (ops/gather.py):
probe_candidates takes each probe from its bucket bounds to its tier-1
lane validity, verify_windows takes each survivor lane from its text words
to its mismatch counts, and the generic window gather serves the bucket
bounds of the bisection path. The scoring and the fold are one more
(ops/scorefold.py score_fold), one launch a step; score_survivors and
fold_unique below are their plain loops, which CPU tensors take.

32-bit values are int64 tensors holding the unsigned value; 32-bit tables
are int32 bit patterns (text/packed.py). Wide signatures (seedl 36..64) are
int64 bit patterns in the index and in the probes alike, compared through
index/signatures.unsigned_order wherever real_tpu compares its (hi, lo)
planes: the bucket key, both bisections, the lane K-1 overflow tests and
the re-check after bisection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from real_tpu_torch.index.signatures import (NUM_LISTS, SigConfig,
                                             read_segments, read_segments_rc,
                                             unsigned_order)
from real_tpu_torch.ops.gather import (gather_word_windows,
                                       probe_candidates, verify_windows)
from real_tpu_torch.ops.scorefold import score_fold
from real_tpu_torch.scoring.scoring import ScoreTables
from real_tpu_torch.text.packed import is_dontcare_free, u32

POS_SENTINEL = 0x7FFFFFFF

# automaton states (UniqueMatchInfo.hpp:71-78)
NO_MATCH, STRAIGHT, REVERSE, GAPPED, NON_UNIQUE = 0, 1, 2, 3, 4


class MatchState(NamedTuple):
    """Per-read best-hit state (UniqueMatchInfo as struct-of-arrays)."""
    st: torch.Tensor      # int32 [B]
    pos: torch.Tensor     # int32 [B]
    frag: torch.Tensor    # int32 [B]
    fileid: torch.Tensor  # int32 [B]
    errs: torch.Tensor    # int32 [B]
    score: torch.Tensor   # float32 [B]


def initial_state(batch: int, device) -> MatchState:
    def z():
        return torch.zeros(batch, dtype=torch.int32, device=device)
    return MatchState(
        st=z(), pos=z(), frag=z(), fileid=z(), errs=z(),
        # UniqueMatchInfo<true> ctor: -FLT_MAX (UniqueMatchInfo.hpp:191)
        score=torch.full((batch,), -float(np.finfo(np.float32).max),
                         dtype=torch.float32, device=device))


class Survivors(NamedTuple):
    """Compacted verified hits of one step, in reference merge order."""
    valid: torch.Tensor   # bool [B, S]
    inv: torch.Tensor     # bool [B, S]
    pos: torch.Tensor     # int32 [B, S]
    frag: torch.Tensor    # int32 [B, S]
    k: torch.Tensor       # int32 [B, S]
    score: torch.Tensor   # float32 [B, S]
    overflow: torch.Tensor  # bool [B] — capped candidates/survivors dropped


# ---------------------------------------------------------------------------
# probe construction
# ---------------------------------------------------------------------------

def compute_probes(codes: torch.Tensor, seedl: int) -> torch.Tensor:
    """Probe signatures [B, 12] (int64: unsigned values for seedl <= 32,
    64-bit patterns for wide seeds); probes 0..5 are straight lists
    s0..s5, probes 6..11 reverse-complement — the probe order of
    UniqueMatcher::match (matchUniqueImplementation.cpp:416-488)."""
    sc = SigConfig(seedl)
    m = read_segments(codes[:, :seedl], seedl)
    im = read_segments_rc(codes, seedl)   # segments of RC(read)[0:seedl]
    return torch.stack(sc.compose_pairs(m) + sc.compose_pairs(im), dim=1)


def _pack_rows(c: torch.Tensor, nw: int) -> torch.Tensor:
    b, l = c.shape
    pad = nw * 16 - l
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
    shifts = 2 * (15 - torch.arange(16, device=c.device))
    return ((c & 3).reshape(b, nw, 16) << shifts).sum(dim=2)


def pack_read_words(codes: torch.Tensor):
    """Full-read 2-bit packed words, straight and reverse-complement: 16
    bases per word, MSB-first, zero-padded tail — the genome's packing, so
    verification is a pure XOR+popcount (RestMatch.hpp:39-81 widened to the
    whole read). Returns ([B, KW], [B, KW]) unsigned values in int64."""
    patl = codes.shape[1]
    kw = (patl + 15) // 16
    c = codes.to(torch.int64)
    rc = (3 - c.flip(1)) & 3
    return _pack_rows(c, kw), _pack_rows(rc, kw)


# ---------------------------------------------------------------------------
# candidate generation + verification
# ---------------------------------------------------------------------------

def _stored_sigs(index_sig: torch.Tensor, idx: torch.Tensor,
                 wide: bool) -> torch.Tensor:
    """index_sig[idx] in the probes' form: the unsigned value of a narrow
    int32 pattern, the int64 pattern itself when wide."""
    return index_sig[idx] if wide else u32(index_sig[idx])


def _ordered(sig: torch.Tensor, wide: bool) -> torch.Tensor:
    """Keys whose `<` is the signatures' unsigned order."""
    return unsigned_order(sig) if wide else sig


def _bisected_ranges(index_sig, index_bb, probe_sig, sc: SigConfig,
                     bucket_bits: int, steps: int):
    """(begin, count) int64 [B, 12] of each probe's exact equal range: the
    bucket range refined by two bisections of `steps` steps. An unconverged
    bisection returns the conservative side (see real_tpu's
    find_survivors)."""
    B = probe_sig.shape[0]
    M = index_sig.shape[0] // NUM_LISTS
    nbuck = index_bb.shape[0] // NUM_LISTS
    lists = torch.arange(NUM_LISTS, dtype=torch.int64,
                         device=probe_sig.device)

    def to_list_major(a):    # [B, 12] -> [6, 2B] (strand-major per list)
        return a.T.reshape(2, NUM_LISTS, B).permute(1, 0, 2) \
            .reshape(NUM_LISTS, 2 * B)

    def to_probe_major(a):   # [6, 2B] -> [B, 12], probe = strand*6 + list
        return a.reshape(NUM_LISTS, 2, B).permute(2, 1, 0).reshape(B, -1)

    by_list = to_list_major(probe_sig)
    h = sc.bucket_key_bits(by_list, bucket_bits)
    by_list = _ordered(by_list, sc.wide)
    lo, hi = gather_word_windows(
        index_bb, (h + (lists * nbuck)[:, None]).to(torch.int32), 2)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    # clamp every range end to the list's real-entry count: sentinels sort
    # after every real entry (an all-T probe would otherwise see them all)
    real_end = index_bb[nbuck - 1 + lists * nbuck][:, None].to(torch.int64)
    hi = torch.minimum(hi, real_end)
    list_base = (lists * M)[:, None]

    def bisect(gt: bool):
        l, h2 = lo, hi
        for _ in range(steps):
            mid = (l + h2) >> 1
            v = _ordered(_stored_sigs(
                index_sig, torch.clamp(mid, max=M - 1) + list_base,
                sc.wide), sc.wide)
            live = l < h2
            go_right = ((v <= by_list) if gt else (v < by_list)) & live
            l, h2 = (torch.where(go_right, mid + 1, l),
                     torch.where(~go_right & live, mid, h2))
        return l, h2
    begin = bisect(False)[0]
    end = bisect(True)[1]
    count = torch.clamp(end - begin, max=2 * M)          # [6, 2B]
    return to_probe_major(begin), to_probe_major(count)


def find_survivors(
        index_sig, index_pos, index_bb,            # flat [6*M] + buckets
        words, nbits, ncum, frag_offsets,          # text tables
        codes, read_valid,                         # [B, L] uint8, [B] bool
        *, seedl: int, seedkmax: int, totalkmax: int,
        cand_cap: int, survivor_cap: int,
        bsearch_steps: int = 0, text_has_n: bool = True):
    """All verified hits of the batch against this index shard, compacted
    to <= survivor_cap per read in reference merge order. Returns
    (Survivors, window words int32 [kw, B, S], verify_windows' bit
    patterns). real_tpu/engine/matchstep.py find_survivors documents the
    design; this is the same computation."""
    B, patl = codes.shape
    K, S = cand_cap, survivor_cap
    restlen = patl - seedl
    M = index_sig.shape[0] // NUM_LISTS       # flat [6*M] list layout
    dev = codes.device

    sc = SigConfig(seedl)
    probe_sig = compute_probes(codes, seedl)          # [B, 12]
    words_s, words_r = pack_read_words(codes)

    # ---- phase 1: candidate ranges from the bucket table -------------------
    # bucket width is read back from the table: 2^bits + 1 entries per list
    nbuck = index_bb.shape[0] // NUM_LISTS
    bucket_bits = (nbuck - 1).bit_length() - 1
    bucket_shift = sc.bucket_shift_bits(bucket_bits)
    probe_ord = _ordered(probe_sig, sc.wide)

    if bsearch_steps:
        begin_pm, count_pm = _bisected_ranges(
            index_sig, index_bb, probe_sig, sc, bucket_bits, bsearch_steps)
        overflow = (count_pm > K).any(dim=1)
        lane = torch.arange(K, dtype=torch.int64, device=dev)
        cand_valid = (lane[None, None, :] < count_pm[..., None]) \
            & read_valid[:, None, None]                  # [B, 12, K]
    else:
        # two-tier lanes: tier 1 takes K1 consecutive list signatures per
        # probe from its bucket's start, all inside one kernel
        # (ops/gather.py probe_candidates); probes whose bucket exceeds K1
        # get a slot in a D-slot list and fetch their remaining lanes
        # there.
        K1 = K if K <= 4 else 4
        begin_pm, count_pm, lane_sig, cand1 = probe_candidates(
            index_sig, index_bb, probe_sig, read_valid, bucket_shift, K1)
        if K1 == K:
            cand_valid = cand1
            last = lane_sig[..., K - 1]
            last_le = _ordered(last if sc.wide else u32(last),
                               sc.wide) <= probe_ord
            overflow = ((count_pm > K) & last_le).any(dim=1)
        else:
            deep = count_pm > K1                          # [B, 12]
            probe_list = (torch.arange(2 * NUM_LISTS, dtype=torch.int64,
                                       device=dev) % NUM_LISTS) * M
            D = max(B // 2, 512)
            flat_deep = deep.reshape(-1)
            nprobe = flat_deep.shape[0]
            ar = torch.arange(nprobe, dtype=torch.int64, device=dev)
            dkey = torch.sort(torch.where(flat_deep, ar, nprobe)).values[:D]
            got_slot = dkey < nprobe
            pidx = torch.clamp(dkey, max=nprobe - 1)
            # slotless rows scatter into a spare row nprobe that is cut
            # off below (real_tpu's mode="drop"); clipping them onto row
            # nprobe-1 would race against that probe's real value
            pidx_w = torch.where(got_slot, pidx, nprobe)
            pbegin = begin_pm.reshape(-1)[pidx]
            pcount = count_pm.reshape(-1)[pidx]
            plbase = probe_list[pidx % (2 * NUM_LISTS)]
            psig = probe_sig.reshape(-1)[pidx]
            lane2 = K1 + torch.arange(K - K1, dtype=torch.int64, device=dev)
            didx = torch.clamp(pbegin[:, None] + lane2, 0, M - 1) \
                + plbase[:, None]                         # [D, K-K1]
            dsig = _stored_sigs(index_sig, didx, sc.wide)
            eq2 = (dsig == psig[:, None]) & got_slot[:, None]
            dlast_le = _ordered(dsig[:, K - K1 - 1], sc.wide) \
                <= _ordered(psig, sc.wide)
            eq2 &= lane2[None, :] < pcount[:, None]

            def scatter(rows_shape, values):
                out = torch.zeros((nprobe + 1,) + rows_shape,
                                  dtype=torch.bool, device=dev)
                out[pidx_w] = values
                return out[:nprobe]

            cand2 = scatter((K - K1,), eq2).reshape(B, 2 * NUM_LISTS, K - K1)
            cand2 &= read_valid[:, None, None]
            cand_valid = torch.cat([cand1, cand2], dim=2)
            # overflow: deep probe without a slot, or a still-deeper
            # bucket whose lane K-1 hasn't passed the probe
            over_deep = scatter((), (pcount > K) & dlast_le)
            no_slot = flat_deep & ~scatter((), got_slot)
            overflow = (over_deep | no_slot).reshape(
                B, 2 * NUM_LISTS).any(dim=1)

    # ---- compaction to S survivors in merge order --------------------------
    nlane = 2 * NUM_LISTS * K
    order = torch.arange(nlane, dtype=torch.int64, device=dev)[None, :]
    fl_valid = cand_valid.reshape(B, -1)
    key = torch.where(fl_valid, order, nlane)
    perm = torch.argsort(key, dim=1, stable=True)[:, :S]  # [B, S]

    overflow = overflow | (fl_valid.sum(dim=1) > S)

    s_valid = torch.gather(fl_valid, 1, perm)
    s_probe = perm // K                                  # [B, S] probe id
    s_lane = perm - s_probe * K
    s_inv = s_probe >= NUM_LISTS
    s_list = torch.where(s_inv, s_probe - NUM_LISTS, s_probe)

    # one position gather per survivor lane; with bisection the stored
    # signature is re-checked (an unconverged bisection over-approximates)
    s_idx = torch.gather(begin_pm, 1, s_probe) + s_lane
    flat = s_list * M + torch.clamp(s_idx, 0, M - 1)
    cand_rpos = index_pos[flat].to(torch.int64)          # [B, S]
    if bsearch_steps:
        s_valid &= _stored_sigs(index_sig, flat, sc.wide) \
            == torch.gather(probe_sig, 1, s_probe)

    # reverse-complement hits place the indexed seed at the END of the
    # window: pos = rpos - restlen (RestMatch.hpp:84-89)
    matchoffset = torch.where(s_inv, restlen, 0)
    s_pos = cand_rpos - matchoffset
    s_valid &= (cand_rpos != POS_SENTINEL) & (cand_rpos >= matchoffset)

    # reference merge order on the compacted lanes: probe 0..11 major,
    # ascending text position within a probe — real_tpu's stable two-key
    # (okey, s_pos) sort as one composed int64 key (s_pos fits int32)
    okey = torch.where(s_valid, s_probe, 2 * NUM_LISTS)
    o = torch.argsort((okey << 32) + (s_pos + 2**31), dim=1, stable=True)
    s_pos = torch.gather(s_pos, 1, o)
    s_valid = torch.gather(s_valid, 1, o)
    s_inv = torch.gather(s_inv, 1, o)

    # ---- phase 2: text verification on the compacted [B, S] ---------------
    posc = torch.clamp(s_pos, min=0)

    # fragment containment (RangeVector::isPositionValid, RangeVector.hpp:63)
    offs = frag_offsets.to(torch.int64)
    nfrag = offs.shape[0] - 1
    if nfrag <= 512:
        s_frag = (offs[1:-1][None, None, :] <= posc[..., None]).sum(dim=-1)
    else:
        s_frag = torch.searchsorted(offs, posc.reshape(-1).contiguous(),
                                    right=True).reshape(posc.shape) - 1
    s_frag = torch.clamp(s_frag, 0, nfrag - 1)
    s_valid &= (s_pos + patl) <= offs[s_frag + 1]

    # N-freedom over the whole window (AutoTextArray::isDontCareFree)
    if text_has_n:
        s_valid &= is_dontcare_free(nbits, ncum, posc, patl)

    # full-window Hamming distance: XOR + 2-bit pair popcount; the
    # seed-region-masked count reproduces diffcountpair (match.hpp:386)
    tw, totalk, seedk = verify_windows(words, posc, s_inv, words_s, words_r,
                                       patl, seedl)
    s_valid &= (seedk <= seedkmax) & (totalk <= totalkmax)

    surv = Survivors(valid=s_valid, inv=s_inv, pos=s_pos.to(torch.int32),
                     frag=s_frag.to(torch.int32), k=totalk,
                     score=torch.zeros(s_pos.shape, dtype=torch.float32,
                                       device=dev),
                     overflow=overflow)
    return surv, tw


# ---------------------------------------------------------------------------
# scoring of survivors
# ---------------------------------------------------------------------------

def score_survivors(surv: Survivors, tw: torch.Tensor,
                    codes: torch.Tensor, quals: Optional[torch.Tensor],
                    tables: ScoreTables) -> Survivors:
    """score = f32(1.0 + sum_i LL[ref_i, read_i, q_i]) accumulated in f64
    one position at a time, in base order (ComputeScore.hpp:47-191) —
    real_tpu's 'f64' mode; a tree sum could round differently at an f32
    boundary. Read codes outside 0..3 (N reads, never valid) score as
    their low bits; quals=None is FASTA's constant 30. The plain version
    of ops/scorefold.py score_fold's score half (CPU tensors)."""
    B, S = surv.pos.shape
    patl = codes.shape[1]
    kw = tw.shape[0]
    dev = codes.device
    if quals is None:
        quals = torch.full(codes.shape, 30, dtype=torch.int8, device=dev)

    # unpack candidate window text codes from the already-gathered words
    shifts = 2 * (15 - torch.arange(16, device=dev))
    tws = u32(tw).permute(1, 2, 0)                           # [B, S, kw]
    ref = ((tws[..., None] >> shifts) & 3).reshape(B, S, kw * 16)[..., :patl]

    c = codes.to(torch.int64) & 3
    rc = 3 - c.flip(1)
    inv = surv.inv[..., None]
    pat = torch.where(inv, rc[:, None, :], c[:, None, :])
    q = torch.where(inv, quals.flip(1)[:, None, :], quals[:, None, :])
    q = torch.clamp(q.to(torch.int64), 0, 63)
    ll = tables.ll_on(dev)
    contrib = ll[(ref << 8) | (pat << 6) | q]                # [B, S, patl]
    total = torch.full((B, S), 1.0, dtype=torch.float64, device=dev)
    for i in range(patl):
        total = total + contrib[..., i]
    return surv._replace(score=total.to(torch.float32))


# ---------------------------------------------------------------------------
# best-hit automaton fold
# ---------------------------------------------------------------------------

def fold_unique(state: MatchState, surv: Survivors, fileid: int,
                epsilon: float, *, scores: bool) -> MatchState:
    """Sequential UpdateUniqueInfo automaton over survivors in merge order
    (matchUniqueImplementation.cpp:97-160 no-scores / :179-248 scores).
    The plain version of ops/scorefold.py score_fold's fold half (CPU
    tensors)."""
    dev = state.st.device
    # a fill on the device, not a copy from the host (which would wait for
    # the device's stream)
    eps = torch.full((), float(np.float32(epsilon)), dtype=torch.float32,
                     device=dev)
    st, pos, frag, fid, errs, score = state
    for j in range(surv.valid.shape[1]):
        cvalid, cinv = surv.valid[:, j], surv.inv[:, j]
        cpos, cfrag = surv.pos[:, j], surv.frag[:, j]
        ck, cscore = surv.k[:, j], surv.score[:, j]
        is_open = (st == NO_MATCH) | (st == GAPPED)
        is_hit = (st == STRAIGHT) | (st == REVERSE)
        is_nu = st == NON_UNIQUE
        diff = (cpos != pos) | (cfrag != frag) | (fid != fileid)
        if scores:
            better = cscore > score + eps
            within = cscore > score - eps
            take = cvalid & (is_open | ((is_hit | is_nu) & better))
            tie = cvalid & is_hit & ~better & within & diff
        else:
            better = ck < errs
            take = cvalid & (is_open | ((is_hit | is_nu) & better))
            tie = cvalid & is_hit & (ck == errs) & diff
        hit_st = torch.where(cinv, REVERSE, STRAIGHT).to(torch.int32)
        st = torch.where(take, hit_st,
                         torch.where(tie, NON_UNIQUE, st).to(torch.int32))
        pos = torch.where(take, cpos, pos)
        frag = torch.where(take, cfrag, frag)
        fid = torch.where(take, fileid, fid).to(torch.int32)
        errs = torch.where(take, ck, errs)
        if scores:
            score = torch.where(take, cscore, score)
    return MatchState(st=st, pos=pos, frag=frag, fileid=fid, errs=errs,
                      score=score)


# ---------------------------------------------------------------------------
# matchAll: device compaction of a step's hits
# ---------------------------------------------------------------------------

class CompactHits(NamedTuple):
    """A step's verified matchAll hits compacted to an [H] prefix, so that
    four packed arrays, not [B, S] x 7 mostly-invalid lanes, cross to the
    host."""
    pos: torch.Tensor      # int32 [H]
    m1: torch.Tensor       # int32 [H] = (row << 4) | k
    m2: torch.Tensor       # int32 [H] = (frag << 1) | inv
    score: torch.Tensor    # float32 [H]
    count: torch.Tensor    # int32 [] — true hit count (may exceed H)
    overflow: torch.Tensor  # bool [B] — per-read cap overflow, OR'd over
    #                         every read when count > H


def compact_hits(surv: Survivors, cap: int) -> CompactHits:
    """Compact a step's valid survivor lanes to an [H] prefix
    (real_tpu/engine/matchstep.py compact_hits).

    Order inside the prefix is free: the host sorts and dedups all hits
    (driver._sort_dedup_hits). If more than H lanes are valid, every read
    of the batch is flagged overflow and the driver reruns them all.

    A locus found through several lists gives identical duplicate lanes
    (same read, pos and strand, hence the same k, frag and score); they
    are dropped here so the count is ~unique hits. Two routes by lane
    count: a pairwise [B, S, S] mask for S <= 16, and for the wide rerun
    ladder (S up to 128) a per-row sort with adjacent-duplicate removal."""
    B, S = surv.valid.shape
    H = min(cap, B * S)
    dev = surv.valid.device
    if S <= 16:
        same = ((surv.pos[:, :, None] == surv.pos[:, None, :])
                & (surv.inv[:, :, None] == surv.inv[:, None, :])
                & surv.valid[:, :, None] & surv.valid[:, None, :])
        ar = torch.arange(S, device=dev)
        earlier = (ar[None, :] < ar[:, None])[None]
        dup = (same & earlier).any(dim=2)
        pos_s, inv_s = surv.pos, surv.inv.to(torch.int32)
        k_s, frag_s, score_s = surv.k, surv.frag, surv.score
        v = surv.valid & ~dup
    else:
        # one int64 key per lane: invalid, then pos (the sentinel on
        # invalid lanes), then inv. real_tpu sorts the same three keys
        # unstably; lanes with equal keys are duplicates of one another
        # and agree in k, frag and score too, so which one survives is
        # unobservable and the sort need not be stable.
        inv64 = surv.inv.to(torch.int64)
        pkey = torch.where(surv.valid, surv.pos.to(torch.int64),
                           POS_SENTINEL)
        key = ((~surv.valid).to(torch.int64) << 33) | (pkey << 1) | inv64
        o = torch.argsort(key, dim=1)
        key_s = torch.gather(key, 1, o)
        valid_s = torch.gather(surv.valid, 1, o)
        pos_s = torch.gather(surv.pos, 1, o)
        inv_s = torch.gather(inv64, 1, o).to(torch.int32)
        k_s = torch.gather(surv.k, 1, o)
        frag_s = torch.gather(surv.frag, 1, o)
        score_s = torch.gather(surv.score, 1, o)
        prev_same = torch.zeros_like(valid_s)
        prev_same[:, 1:] = (key_s[:, 1:] == key_s[:, :-1]) & valid_s[:, 1:]
        v = valid_s & ~prev_same
    v = v.reshape(-1)
    row = torch.arange(B * S, dtype=torch.int32, device=dev) // S
    m1 = (row << 4) | torch.clamp(k_s.reshape(-1), 0, 15)
    m2 = (frag_s.reshape(-1) << 1) | inv_s.reshape(-1)
    # valid lanes first, in lane order (real_tpu's stable sort on ~valid)
    sel = torch.argsort((~v).to(torch.uint8), stable=True)[:H]
    count = v.sum().to(torch.int32)
    return CompactHits(pos=pos_s.reshape(-1)[sel], m1=m1[sel], m2=m2[sel],
                       score=score_s.reshape(-1)[sel], count=count,
                       overflow=surv.overflow | (count > H))


# ---------------------------------------------------------------------------
# full step
# ---------------------------------------------------------------------------

def scored_survivors(index_sig, index_pos, index_bb,
                     words, nbits, ncum, frag_offsets,
                     codes, quals, read_valid,
                     *, tables: ScoreTables = None, seedl: int,
                     seedkmax: int, totalkmax: int, cand_cap: int,
                     survivor_cap: int, scores: bool,
                     bsearch_steps: int = 0,
                     text_has_n: bool = True) -> Survivors:
    """The scored survivors of one (read batch x index shard): find, then
    score (real_tpu/engine/matchstep.py scored_survivors). quals=None
    means FASTA constant quality 30 (Pattern.hpp:42-45); `tables` is None
    when scores=False. Reads whose candidates exceed the caps are flagged
    in Survivors.overflow for the driver's rerun."""
    surv, tw = find_survivors(
        index_sig, index_pos, index_bb,
        words, nbits, ncum, frag_offsets,
        codes, read_valid,
        seedl=seedl, seedkmax=seedkmax, totalkmax=totalkmax,
        cand_cap=cand_cap, survivor_cap=survivor_cap,
        bsearch_steps=bsearch_steps, text_has_n=text_has_n)
    if scores:
        surv, _ = score_fold(surv, tw=tw, codes=codes, quals=quals,
                             tables=tables)
    return surv


def match_step(index_sig, index_pos, index_bb,
               words, nbits, ncum, frag_offsets,
               codes, quals, read_valid,
               state: MatchState, fileid: int, epsilon: float,
               *, tables: ScoreTables = None, seedl: int, seedkmax: int,
               totalkmax: int, cand_cap: int, survivor_cap: int,
               scores: bool, matchall: bool = False, bsearch_steps: int = 0,
               text_has_n: bool = True):
    """One (read batch x index shard) step: find the survivors, then score
    them and fold them into the automaton in one score_fold call. Returns
    (new_state, survivors) for matchUnique and (state, CompactHits) for
    matchAll (matchall=True skips the automaton, and `state` may be None:
    the hits go to the host for dedup and printing,
    matchAllImplementation.cpp:99-185)."""
    surv, tw = find_survivors(
        index_sig, index_pos, index_bb, words, nbits, ncum, frag_offsets,
        codes, read_valid, seedl=seedl, seedkmax=seedkmax,
        totalkmax=totalkmax, cand_cap=cand_cap, survivor_cap=survivor_cap,
        bsearch_steps=bsearch_steps, text_has_n=text_has_n)
    score_in = dict(tw=tw, codes=codes, quals=quals, tables=tables) \
        if scores else {}
    if matchall:
        if scores:
            surv, _ = score_fold(surv, **score_in)
        # hit capacity scales with the survivor cap: escalated reruns on
        # repeat-rich genomes legitimately return hundreds of hits per read
        B, S = surv.valid.shape
        return state, compact_hits(surv, cap=max(2 * B, B * S // 2))
    surv, state = score_fold(surv, state, fileid=fileid, epsilon=epsilon,
                             scores=scores, **score_in)
    return state, surv
