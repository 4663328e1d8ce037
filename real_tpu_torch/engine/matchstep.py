"""The per-(read-batch x index-shard) match step, matchUnique.

Counterpart of real_tpu/engine/matchstep.py (see its module docstring for
the design): probes, candidate ranges from the bucket table (optionally
bisected to the exact equal range), stable compaction of the valid lanes
to <= S survivors per read in reference merge order, the window fetch,
XOR+popcount verification, f64 scoring and the UpdateUniqueInfo automaton
fold. Each step keeps real_tpu's order-defining operations: the stable
argsort compaction, the stable (probe, pos) sort of the compacted lanes,
and the fold over survivors in lane order — scores mode can observe it
(engine/monoid.py of real_tpu).

The window gather (ops/gather.py, a CUDA kernel on the card) serves the
three slice fetches: bucket bounds (w=2), tier-1 lane signatures (w=K1)
and the text words under each survivor window (w=kw+1).

32-bit values are int64 tensors holding the unsigned value; 32-bit tables
are int32 bit patterns (text/packed.py).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from real_tpu_torch.index.signatures import (NUM_LISTS, SigConfig,
                                             read_segments, read_segments_rc)
from real_tpu_torch.ops.gather import gather_word_windows
from real_tpu_torch.scoring.scoring import ScoreTables
from real_tpu_torch.text.packed import (MASK32, is_dontcare_free,
                                        pair_mismatch_count, u32)

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
    """Probe signatures [B, 12] (unsigned values in int64); probes 0..5 are
    straight lists s0..s5, probes 6..11 reverse-complement — the probe
    order of UniqueMatcher::match (matchUniqueImplementation.cpp:416-488)."""
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


# ---------------------------------------------------------------------------
# candidate generation + verification
# ---------------------------------------------------------------------------

def _extract_windows(words: torch.Tensor, pos: torch.Tensor,
                     nw: int) -> List[torch.Tensor]:
    """nw consecutive 16-base words at arbitrary base offsets pos >= 0
    (AutoTextArray::getTextWord, AutoTextArray.hpp:122-125): the nw+1
    aligned words covering each window come from one window gather, then a
    funnel shift. Words past the table end read 0 (the kernel's contract);
    those bits lie beyond pos+patl, which the tail masks and fragment
    containment keep out of every result."""
    p = pos.to(torch.int64)
    sh = (p & 15) << 1
    w = [u32(x) for x in
         gather_word_windows(words, (p >> 4).to(torch.int32), nw + 1)]
    return [((w[i] << sh) & MASK32) | (w[i + 1] >> (32 - sh))
            for i in range(nw)]


def find_survivors(
        index_sig, index_pos, index_bb,            # flat [6*M] + buckets
        words, nbits, ncum, frag_offsets,          # text tables
        codes, read_valid,                         # [B, L] uint8, [B] bool
        *, seedl: int, seedkmax: int, totalkmax: int,
        cand_cap: int, survivor_cap: int,
        bsearch_steps: int = 0, text_has_n: bool = True):
    """All verified hits of the batch against this index shard, compacted
    to <= survivor_cap per read in reference merge order. Returns
    (Survivors, window words). real_tpu/engine/matchstep.py find_survivors
    documents the design; this is the same computation."""
    B, patl = codes.shape
    K, S = cand_cap, survivor_cap
    restlen = patl - seedl
    kw = (patl + 15) // 16
    M = index_sig.shape[0] // NUM_LISTS       # flat [6*M] list layout
    dev = codes.device
    lists = torch.arange(NUM_LISTS, dtype=torch.int64, device=dev)

    sc = SigConfig(seedl)
    probe_sig = compute_probes(codes, seedl)          # [B, 12]
    words_s, words_r = pack_read_words(codes)

    def to_list_major(a):    # [B, 12] -> [6, 2B] (strand-major per list)
        return a.T.reshape(2, NUM_LISTS, B).permute(1, 0, 2) \
            .reshape(NUM_LISTS, 2 * B)

    def to_probe_major(a):   # [6, 2B] -> [B, 12], probe = strand*6 + list
        return a.reshape(NUM_LISTS, 2, B).permute(2, 1, 0).reshape(B, -1)

    # ---- phase 1: candidate ranges from the bucket table -------------------
    # bucket width is read back from the table: 2^bits + 1 entries per list
    nbuck = index_bb.shape[0] // NUM_LISTS
    bucket_bits = (nbuck - 1).bit_length() - 1
    by_list = to_list_major(probe_sig)
    h = by_list >> sc.bucket_shift_bits(bucket_bits)
    lo, hi = gather_word_windows(
        index_bb, (h + (lists * nbuck)[:, None]).to(torch.int32), 2)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    # clamp every range end to the list's real-entry count: sentinels sort
    # after every real entry (an all-T probe would otherwise see them all)
    real_end = index_bb[nbuck - 1 + lists * nbuck][:, None].to(torch.int64)
    hi = torch.minimum(hi, real_end)
    list_base = (lists * M)[:, None]
    if bsearch_steps:
        # exact equal range by two bisections; an unconverged bisection
        # returns the conservative side (see real_tpu's find_survivors)
        def bisect(gt: bool):
            l, h2 = lo, hi
            for _ in range(bsearch_steps):
                mid = (l + h2) >> 1
                v = u32(index_sig[torch.clamp(mid, max=M - 1) + list_base])
                live = l < h2
                go_right = ((v <= by_list) if gt else (v < by_list)) & live
                l, h2 = (torch.where(go_right, mid + 1, l),
                         torch.where(~go_right & live, mid, h2))
            return l, h2
        begin = bisect(False)[0]
        end = bisect(True)[1]
    else:
        begin, end = lo, hi

    count = torch.clamp(end - begin, max=2 * M)          # [6, 2B]
    begin_pm = to_probe_major(begin)                     # [B, 12]
    count_pm = to_probe_major(count)
    lane = torch.arange(K, dtype=torch.int64, device=dev)

    if bsearch_steps:
        overflow = (count > K).reshape(NUM_LISTS * 2, B).any(dim=0)
        cand_valid = (lane[None, None, :] < count_pm[..., None]) \
            & read_valid[:, None, None]                  # [B, 12, K]
    else:
        # two-tier lanes: tier 1 fetches K1 consecutive list signatures
        # per probe with the window gather; probes whose bucket exceeds K1
        # get a slot in a D-slot list and fetch their remaining lanes
        # there. Tier-1 lanes past the clipped start read neighbour-list
        # entries; all of them have lane >= count and in_range1 masks them.
        probe_list = (torch.arange(2 * NUM_LISTS, dtype=torch.int64,
                                   device=dev) % NUM_LISTS) * M
        K1 = K if K <= 4 else 4
        lane1 = torch.arange(K1, dtype=torch.int64, device=dev)
        start = torch.clamp(begin_pm, 0, M - 1) + probe_list[None, :]
        lane_sig = torch.stack(
            [u32(x) for x in gather_word_windows(
                index_sig, start.to(torch.int32), K1)], dim=-1)
        eq1 = lane_sig == probe_sig[..., None]
        in_range1 = lane1[None, None, :] < count_pm[..., None]
        cand1 = in_range1 & eq1 & read_valid[:, None, None]
        if K1 == K:
            cand_valid = cand1
            last_le = lane_sig[..., K - 1] <= probe_sig
            overflow = ((count_pm > K) & last_le).any(dim=1)
        else:
            deep = count_pm > K1                          # [B, 12]
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
            dsig = u32(index_sig[didx])
            eq2 = (dsig == psig[:, None]) & got_slot[:, None]
            dlast_le = dsig[:, K - K1 - 1] <= psig
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
        s_valid &= u32(index_sig[flat]) == torch.gather(probe_sig, 1, s_probe)

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
    tw = _extract_windows(words, posc, kw)       # kw x [B, S]
    masks = _tail_masks(patl, kw)
    smask_s, smask_r = _seed_masks(patl, seedl, kw)
    patw = torch.where(s_inv[..., None], words_r[:, None, :],
                       words_s[:, None, :])      # [B, S, KW]
    totalk = torch.zeros_like(s_pos)
    seedk = torch.zeros_like(s_pos)
    for w in range(kw):
        x = (tw[w] ^ patw[..., w]) & int(masks[w])
        totalk = totalk + pair_mismatch_count(x)
        sm = torch.where(s_inv, int(smask_r[w]), int(smask_s[w]))
        seedk = seedk + pair_mismatch_count(x & sm)
    s_valid &= (seedk <= seedkmax) & (totalk <= totalkmax)

    surv = Survivors(valid=s_valid, inv=s_inv, pos=s_pos.to(torch.int32),
                     frag=s_frag.to(torch.int32), k=totalk.to(torch.int32),
                     score=torch.zeros(s_pos.shape, dtype=torch.float32,
                                       device=dev),
                     overflow=overflow)
    return surv, tw


# ---------------------------------------------------------------------------
# scoring of survivors
# ---------------------------------------------------------------------------

def score_survivors(surv: Survivors, tw: List[torch.Tensor],
                    codes: torch.Tensor, quals: torch.Tensor,
                    tables: ScoreTables) -> Survivors:
    """score = f32(1.0 + sum_i LL[ref_i, read_i, q_i]) accumulated in f64
    one position at a time, in base order (ComputeScore.hpp:47-191) —
    real_tpu's 'f64' mode; a tree sum could round differently at an f32
    boundary. Read codes outside 0..3 (N reads, never valid) score as
    their low bits."""
    B, S = surv.pos.shape
    patl = codes.shape[1]
    kw = len(tw)
    dev = codes.device

    # unpack candidate window text codes from the already-gathered words
    shifts = 2 * (15 - torch.arange(16, device=dev))
    tws = torch.stack(tw, dim=-1)                            # [B, S, kw]
    ref = ((tws[..., None] >> shifts) & 3).reshape(B, S, kw * 16)[..., :patl]

    c = codes.to(torch.int64) & 3
    rc = 3 - c.flip(1)
    inv = surv.inv[..., None]
    pat = torch.where(inv, rc[:, None, :], c[:, None, :])
    q = torch.where(inv, quals.flip(1)[:, None, :], quals[:, None, :])
    q = torch.clamp(q.to(torch.int64), 0, 63)
    ll = torch.from_numpy(tables.ll_f64()).to(dev)
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
    (matchUniqueImplementation.cpp:97-160 no-scores / :179-248 scores)."""
    dev = state.st.device
    eps = torch.tensor(np.float32(epsilon), dtype=torch.float32, device=dev)
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
# full step
# ---------------------------------------------------------------------------

def match_step(index_sig, index_pos, index_bb,
               words, nbits, ncum, frag_offsets,
               codes, quals, read_valid,
               state: MatchState, fileid: int, epsilon: float,
               *, tables: ScoreTables = None, seedl: int, seedkmax: int,
               totalkmax: int, cand_cap: int, survivor_cap: int,
               scores: bool, bsearch_steps: int = 0,
               text_has_n: bool = True):
    """One (read batch x index shard) matchUnique step. Returns
    (new_state, survivors). quals=None means FASTA constant quality 30
    (Pattern.hpp:42-45); `tables` is None when scores=False. Reads whose
    candidates exceed the caps are flagged in Survivors.overflow for the
    driver's rerun."""
    if quals is None:
        quals = torch.full(codes.shape, 30, dtype=torch.int8,
                           device=codes.device)
    surv, tw = find_survivors(
        index_sig, index_pos, index_bb,
        words, nbits, ncum, frag_offsets,
        codes, read_valid,
        seedl=seedl, seedkmax=seedkmax, totalkmax=totalkmax,
        cand_cap=cand_cap, survivor_cap=survivor_cap,
        bsearch_steps=bsearch_steps, text_has_n=text_has_n)
    if scores:
        surv = score_survivors(surv, tw, codes, quals, tables)
    return fold_unique(state, surv, fileid, epsilon, scores=scores), surv
