"""The port's fused fetch entries (real_tpu_torch/ops/gather.py
probe_candidates and verify_windows) against the intermediate arrays of
real_tpu.engine.matchstep.find_survivors.

real_tpu does not return its intermediates, so the tests re-run its lines
with its own functions on the same numpy-seeded inputs: the bucket lookup
and tier-1 lanes as find_survivors computes them on the CPU (jnp.take), the
tier-1 lanes once more through the Pallas window gather in TPU interpret
mode, and the window words and mismatch counts from find_survivors' own
results (tw, Survivors.k) plus its seed-mask popcount. Every comparison is
exact (integers and bit patterns)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.engine import matchstep as j_ms
from real_tpu.index import build as j_build
from real_tpu.index.signatures import SigConfig as JSigConfig
from real_tpu.ops import pallas_gather
from real_tpu.text import packed as j_packed
from real_tpu_torch import convert
from real_tpu_torch.engine import matchstep as t_ms
from real_tpu_torch.ops import gather
from real_tpu_torch.tools import fusedcases, simulate

B, N, SEEDL = 256, 20000, 32
ALL_T = (7000, 7200)
PARAMS = [(patl, K, genome) for patl in (36, 50, 100) for K in (4, 8)
          for genome in ("n_runs", "all_t")]


@functools.lru_cache(maxsize=None)
def _text_and_index(genome):
    """One small genome, packed and indexed by real_tpu and carried across
    to the port: (codes, jax text, jax index, torch text, torch index)."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, N).astype(np.uint8)
    codes[5000:5300] = codes[9000:9300]          # a repeat: multi-hit reads
    if genome == "n_runs":
        codes[3000:3040] = 4
        codes[12000:12003] = 4
        codes[rng.random(N) < 0.002] = 4
    else:
        codes[ALL_T[0]:ALL_T[1]] = 3             # real all-T signatures
        codes[15000:15010] = 4                   # and sentinels beside them
    ranges = [("f0", 0), ("f1", N // 2), ("terminal", N)]
    jt = j_packed.build_packed_text(codes, ranges)
    ji = j_build.build_index(jt, SEEDL, bucket_bits=12)
    fields = {f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fields.items()}
    tt = convert.packed_text_from_numpy(fields, "cpu")
    ti = convert.index_from_numpy(np.asarray(ji.sig), np.asarray(ji.pos),
                                  np.asarray(ji.bb), ji.bucket_bits, SEEDL,
                                  "cpu")
    return codes, jt, ji, tt, ti


def _batch(codes, patl, genome):
    """[B, patl] base codes (reads of both strands with 3% errors) and the
    valid mask; some rows stay empty and invalid."""
    rds = simulate.generate_reads(codes, B - 24, patl, 0.03, False,
                                  seed=patl + len(genome))
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    batch = np.zeros((B, patl), np.uint8)
    for i, r in enumerate(rds):
        batch[i] = lut[np.frombuffer(r.seq.encode(), np.uint8)]
    n = len(rds)
    if genome == "all_t":
        # an all-T read (its probes equal the sentinel signature) and its
        # reverse complement, all A
        batch[n] = 3
        batch[n + 1] = 0
        n += 2
    valid = np.zeros(B, bool)
    valid[:n] = (batch[:n] <= 3).all(axis=1)
    return batch, valid


def _jax_probe_intermediates(ji, batch, valid, K):
    """find_survivors' lines from the bucket lookup to cand1 on the CPU
    (bsearch_steps == 0, narrow signatures), by probe."""
    _, probe_sig = j_ms.compute_probes(jnp.asarray(batch), SEEDL)
    M = ji.sig.shape[0] // 6
    nbuck = ji.bb.shape[0] // 6
    shift = JSigConfig(SEEDL).bucket_shift_bits(ji.bucket_bits)
    lists = jnp.arange(12, dtype=jnp.int32) % 6
    h = (probe_sig >> jnp.uint32(shift)).astype(jnp.int32)
    lo = jnp.take(ji.bb, h + lists * nbuck)
    hi = jnp.take(ji.bb, h + 1 + lists * nbuck)
    hi = jnp.minimum(hi, ji.bb[nbuck - 1 + lists * nbuck])
    count = jnp.minimum(hi - lo, jnp.int32(2 * M))
    K1 = min(K, 4)
    lane1 = jnp.arange(K1, dtype=jnp.int32)
    idxs = jnp.clip(lo[..., None] + lane1, 0, M - 1) \
        + (lists * M)[None, :, None]
    lane_sig = jnp.take(ji.sig, idxs)
    cand1 = (lane1[None, None, :] < count[..., None]) \
        & (lane_sig == probe_sig[..., None]) \
        & jnp.asarray(valid)[:, None, None]
    start = jnp.clip(lo, 0, M - 1) + lists * M
    return dict(probe_sig=np.asarray(probe_sig), begin=np.asarray(lo),
                count=np.asarray(count), lane_sig=np.asarray(lane_sig),
                cand1=np.asarray(cand1), start=np.asarray(start),
                shift=shift, M=M, K1=K1)


def _port_probe(ti, batch, valid, shift, K1, fn=gather.probe_candidates_ref):
    probe_sig = t_ms.compute_probes(torch.from_numpy(batch), SEEDL)
    return probe_sig, fn(ti.sig, ti.bb, probe_sig, torch.from_numpy(valid),
                         shift, K1)


@pytest.mark.parametrize("patl,K,genome", PARAMS)
def test_probe_candidates_ref_equals_real_tpu(patl, K, genome):
    codes, _, ji, _, ti = _text_and_index(genome)
    batch, valid = _batch(codes, patl, genome)
    j = _jax_probe_intermediates(ji, batch, valid, K)
    probe_sig, (begin, count, lane_sig, cand) = _port_probe(
        ti, batch, valid, j["shift"], j["K1"])
    np.testing.assert_array_equal(probe_sig.numpy(),
                                  j["probe_sig"].astype(np.int64))
    assert begin.dtype == count.dtype == lane_sig.dtype == torch.int32
    assert cand.dtype == torch.bool
    np.testing.assert_array_equal(begin.numpy(), j["begin"])
    np.testing.assert_array_equal(count.numpy(), j["count"])
    np.testing.assert_array_equal(cand.numpy(), j["cand1"])
    # lane signatures: real_tpu's CPU path clamps begin + lane inside the
    # list where the window reads on into the next one; they agree on
    # every lane inside the list, which covers every lane < count
    lanes = j["start"][..., None] % j["M"] + np.arange(j["K1"])
    inside = lanes < j["M"]
    in_range = np.arange(j["K1"]) < j["count"][..., None]
    assert not (in_range & ~inside).any()
    np.testing.assert_array_equal(
        lane_sig.numpy().view(np.uint32)[inside], j["lane_sig"][inside])
    # the case exercises what it is named for
    assert j["cand1"][:, :6].any() and j["cand1"][:, 6:].any()  # both strands
    assert (j["count"] > j["K1"]).any() and (j["count"] == 0).any()
    assert not valid.all()
    if genome == "all_t":
        is_t = j["probe_sig"] == 0xFFFFFFFF
        assert is_t.any()
        # the clamp to the list's real entries keeps the sentinels out
        real_end = np.asarray(ji.bb).reshape(6, -1)[:, -1]
        ends = j["begin"] + j["count"]
        assert (ends[is_t] <= np.broadcast_to(
            real_end[np.arange(12) % 6], ends.shape)[is_t]).all()
        assert (j["count"][is_t] > 0).all()
    else:
        assert (np.asarray(ji.pos) == 0x7FFFFFFF).any()         # sentinels


def test_probe_candidates_lanes_equal_pallas_kernel_interpret(monkeypatch):
    """Tier-1 lanes, masked ones included, equal real_tpu's Pallas window
    gather (TPU interpret mode) at the same starts."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    codes, _, ji, _, ti = _text_and_index("all_t")
    batch, valid = _batch(codes, 50, "all_t")
    j = _jax_probe_intermediates(ji, batch, valid, 8)
    _, (_, _, lane_sig, _) = _port_probe(ti, batch, valid, j["shift"], 4)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    pallas_gather._window_call.cache_clear()
    try:
        out = pallas_gather.gather_word_windows(
            ji.sig, jnp.asarray(j["start"], dtype=jnp.int32), 4)
        pal = np.stack([np.asarray(o) for o in out], -1)
    finally:
        pallas_gather._window_call.cache_clear()
    np.testing.assert_array_equal(lane_sig.numpy().view(np.uint32), pal)
    assert (np.arange(4) >= j["count"][..., None]).any()     # masked lanes


def _jax_survivors(genome, patl, K):
    codes, jt, ji, tt, ti = _text_and_index(genome)
    batch, valid = _batch(codes, patl, genome)
    kw = dict(seedl=SEEDL, seedkmax=2, totalkmax=5, cand_cap=K,
              survivor_cap=K, bsearch_steps=0, text_has_n=jt.has_n)
    jsurv, jtw = j_ms.find_survivors(
        ji.sig, ji.pos, ji.bb, jt.words, jt.nbits, jt.ncum, jt.frag_offsets,
        jnp.asarray(batch), None, jnp.asarray(valid), **kw)
    return jt, tt, ti, batch, valid, kw, jsurv, jtw


@pytest.mark.parametrize("patl,K,genome", PARAMS)
def test_verify_windows_ref_equals_real_tpu(patl, K, genome):
    jt, tt, _, batch, _, _, jsurv, jtw = _jax_survivors(genome, patl, K)
    nw = (patl + 15) // 16
    jpos, jinv = np.asarray(jsurv.pos), np.asarray(jsurv.inv)
    jws, jwr = j_ms.pack_read_words(jnp.asarray(batch))
    tw, totalk, seedk = gather.verify_windows_ref(
        tt.words, torch.from_numpy(np.maximum(jpos, 0).astype(np.int64)),
        torch.from_numpy(jinv.copy()),
        torch.from_numpy(np.asarray(jws).astype(np.int64)),
        torch.from_numpy(np.asarray(jwr).astype(np.int64)), patl, SEEDL)
    assert tw.dtype == totalk.dtype == seedk.dtype == torch.int32
    assert tuple(tw.shape) == (nw, B, K)
    np.testing.assert_array_equal(
        tw.numpy().view(np.uint32), np.stack([np.asarray(w) for w in jtw]))
    np.testing.assert_array_equal(totalk.numpy(), np.asarray(jsurv.k))
    # seedk by real_tpu's own masks and popcount over its window words
    tail = j_ms._tail_masks(patl, nw)
    smask_s, smask_r = j_ms._seed_masks(patl, SEEDL, nw)
    jws, jwr = np.asarray(jws), np.asarray(jwr)
    want = np.zeros(jpos.shape, np.int32)
    for w in range(nw):
        patw = np.where(jinv, jwr[:, None, w], jws[:, None, w])
        x = (np.asarray(jtw[w]) ^ patw) & tail[w]
        sm = np.where(jinv, smask_r[w], smask_s[w]).astype(np.uint32)
        want += np.asarray(j_packed.pair_mismatch_count(
            jnp.asarray(x & sm))).astype(np.int32)
    np.testing.assert_array_equal(seedk.numpy(), want)
    # both strands, aligned and unaligned window starts, hits and misses
    jv = np.asarray(jsurv.valid)
    assert (jv & jinv).any() and (jv & ~jinv).any()
    assert (jpos[jv] % 16 == 0).any() and (jpos[jv] % 16 != 0).any()
    assert (want > 2).any() and (totalk.numpy()[jv] > 0).any()


@pytest.mark.parametrize("patl,K,genome", PARAMS)
def test_find_survivors_equals_real_tpu(patl, K, genome):
    """The port's find_survivors over the fused wrappers: every Survivors
    field and every window word, on all lanes."""
    _, tt, ti, batch, valid, kw, jsurv, jtw = _jax_survivors(genome, patl, K)
    tsurv, ttw = t_ms.find_survivors(
        ti.sig, ti.pos, ti.bb, tt.words, tt.nbits, tt.ncum, tt.frag_offsets,
        torch.from_numpy(batch), torch.from_numpy(valid), **kw)
    for f in t_ms.Survivors._fields:
        a, b = np.asarray(getattr(jsurv, f)), getattr(tsurv, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(ttw) == len(jtw)
    for a, b in zip(jtw, ttw):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a).astype(np.uint32),
                                      b.numpy().view(np.uint32))
    assert np.asarray(jsurv.valid).any()
    if genome == "all_t" or K == 4:
        assert np.asarray(jsurv.overflow).any()


@pytest.mark.parametrize("k1", [1, 2, 3, 4])
def test_probe_candidates_ref_on_hand_made_tables(k1):
    """The plain version against a per-probe numpy loop of the same rules,
    on tables with out-of-range bucket bounds."""
    rng = np.random.default_rng(k1)
    sig, bb, shift = fusedcases.edge_tables(rng)
    M, nbuck = sig.shape[1], bb.shape[1]
    probe, valid = fusedcases.edge_probes(rng, sig, 64)
    begin, count, lanes, cand = gather.probe_candidates_ref(
        torch.from_numpy(sig.view(np.int32).reshape(-1)),
        torch.from_numpy(bb.reshape(-1)), torch.from_numpy(probe),
        torch.from_numpy(valid), shift, k1)
    flat_sig = np.concatenate([sig.reshape(-1), np.zeros(k1, np.uint32)])
    flat_bb = bb.reshape(-1).astype(np.int64)
    for b in range(probe.shape[0]):
        for p in range(12):
            l = p % 6
            i = l * nbuck + (probe[b, p] >> shift)
            lo, hi = flat_bb[i], min(flat_bb[i + 1], bb[l, -1])
            start = min(max(lo, 0), M - 1) + l * M
            want = flat_sig[start:start + k1]
            assert begin[b, p] == lo and count[b, p] == min(hi - lo, 2 * M)
            np.testing.assert_array_equal(
                lanes[b, p].numpy().view(np.uint32), want)
            np.testing.assert_array_equal(
                cand[b, p].numpy(),
                (np.arange(k1) < hi - lo) & (want == probe[b, p]) & valid[b])
    assert cand.any() and (count < 0).any() and (begin >= M).any()


@pytest.mark.parametrize("patl", [16, 36, 50, 100, 256])
def test_verify_windows_ref_on_edge_positions(patl):
    """The plain version against a per-lane loop over unpacked bases:
    windows in the last text word, past the text end (zero words), and
    starts with pos % 16 == 0."""
    rng = np.random.default_rng(patl)
    mw, nb, s = 200, 12, 5
    nw = (patl + 15) // 16
    words, pos, inv, ws, wr = fusedcases.verify_inputs(rng, mw, nb, s, patl)
    tw, totalk, seedk = gather.verify_windows_ref(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(pos),
        torch.from_numpy(inv), torch.from_numpy(ws), torch.from_numpy(wr),
        patl, SEEDL if patl >= SEEDL else patl)
    seedl = min(SEEDL, patl)

    def bases(ww):
        return ((np.asarray(ww, np.uint64)[:, None]
                 >> (2 * (15 - np.arange(16, dtype=np.uint64)))) & 3) \
            .reshape(-1)
    text = np.concatenate([bases(words), np.zeros(16 * (nw + 2), np.uint64)])
    for b in range(nb):
        for j in range(s):
            p = min(pos[b, j], 16 * (mw - 1) + pos[b, j] % 16)
            win = text[p:p + 16 * nw]
            np.testing.assert_array_equal(
                bases(tw[:, b, j].numpy().view(np.uint32)), win)
            diff = (win != bases((wr if inv[b, j] else ws)[b]))[:patl]
            assert totalk[b, j] == diff.sum()
            seed = diff[patl - seedl:] if inv[b, j] else diff[:seedl]
            assert seedk[b, j] == seed.sum()


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(2)
    sig, bb, shift = fusedcases.edge_tables(rng)
    probe, valid = fusedcases.edge_probes(rng, sig, 32)
    args = (*fusedcases.tensors((sig, bb, probe, valid), "cpu"), shift, 4)
    vargs = (*fusedcases.tensors(
        fusedcases.verify_inputs(rng, 100, 8, 4, 50), "cpu"), 50, SEEDL)
    before = (gather.probe_candidates.launches,
              gather.verify_windows.launches)
    for fn, ref, a in ((gather.probe_candidates, gather.probe_candidates_ref,
                        args),
                       (gather.verify_windows, gather.verify_windows_ref,
                        vargs)):
        for g, r in zip(fn(*a), ref(*a)):
            assert g.dtype == r.dtype and torch.equal(g, r)
    assert before == (gather.probe_candidates.launches,
                      gather.verify_windows.launches)
    gather.reset_launch_counts()
    assert gather.probe_candidates.launches == 0
    assert gather.verify_windows.launches == 0
    assert gather.gather_word_windows.launches == 0


@pytest.mark.parametrize("moved", [0, 1, 2, 3])
def test_probe_candidates_never_sends_non_cpu_tensors_to_the_plain_version(
        moved):
    t = [torch.zeros(12, dtype=torch.int32), torch.zeros(12, dtype=torch.int32),
         torch.zeros((2, 12), dtype=torch.int64),
         torch.ones(2, dtype=torch.bool)]
    t[moved] = t[moved].to("meta")
    with pytest.raises(ValueError):
        gather.probe_candidates(*t, 8, 4)


@pytest.mark.parametrize("moved", [0, 1, 2, 3, 4])
def test_verify_windows_never_sends_non_cpu_tensors_to_the_plain_version(
        moved):
    t = [torch.zeros(20, dtype=torch.int32),
         torch.zeros((2, 3), dtype=torch.int64),
         torch.zeros((2, 3), dtype=torch.bool),
         torch.zeros((2, 4), dtype=torch.int64),
         torch.zeros((2, 4), dtype=torch.int64)]
    t[moved] = t[moved].to("meta")
    with pytest.raises(ValueError):
        gather.verify_windows(*t, 50, SEEDL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 2, 3, 4])
def test_probe_candidates_kernel_equals_plain_version_on_card(cuda_device,
                                                              k1):
    rng = np.random.default_rng(k1)
    sig, bb, shift = fusedcases.edge_tables(rng)
    probe, valid = fusedcases.edge_probes(rng, sig, 700)
    args = fusedcases.tensors((sig, bb, probe, valid), cuda_device)
    before = gather.probe_candidates.launches
    got = gather.probe_candidates(*args, shift, k1)
    torch.cuda.synchronize()
    assert gather.probe_candidates.launches == before + 1
    for g, r in zip(got, gather.probe_candidates_ref(*args, shift, k1)):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("patl", [16, 36, 50, 100, 256])
def test_verify_windows_kernel_equals_plain_version_on_card(cuda_device,
                                                            patl):
    rng = np.random.default_rng(patl)
    args = fusedcases.tensors(
        fusedcases.verify_inputs(rng, 3000, 300, 8, patl), cuda_device)
    before = gather.verify_windows.launches
    got = gather.verify_windows(*args, patl, min(SEEDL, patl))
    torch.cuda.synchronize()
    assert gather.verify_windows.launches == before + 1
    for g, r in zip(got, gather.verify_windows_ref(*args, patl,
                                                   min(SEEDL, patl))):
        assert g.dtype == r.dtype and torch.equal(g, r)
