"""Wide seeds (seedl 36..64) in the port against real_tpu's (hi, lo) plane
path, on the CPU. The port carries a wide signature as ONE int64 bit
pattern; real_tpu's planes are joined (hi << 32 | lo) before comparing.
Every comparison is exact: integers, bit patterns, record bytes.

pos: real_tpu's wide build is stable over its PHASE-MAJOR window order
(positions congruent mod 16 side by side), and so is the port's, so the
two lists are equal arrays, inside runs of equal signatures too (the
tests compare them as multisets per run and then as arrays, and assert
that such runs exist, where position order would differ)."""

import dataclasses
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.engine import matchstep as j_ms
from real_tpu.index import build as j_build
from real_tpu.index.signatures import SigConfig as JSigConfig
from real_tpu.scoring import scoring as j_scoring
from real_tpu.text import packed as j_packed
from real_tpu_torch import convert
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.cli.output import write_all_arrays, write_unique
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.engine import matchstep as t_ms
from real_tpu_torch.index import build as t_build
from real_tpu_torch.index.signatures import (SigConfig, i64_to_planes,
                                             logical_shift_right,
                                             planes_to_i64, unsigned_order)
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.ops import gather
from real_tpu_torch.scoring import scoring as t_scoring
from real_tpu_torch.tools import simulate
from tests import ab_util

B, PATL, N = 256, 100, 24000
ALL_T = (7000, 7200)


@functools.lru_cache(maxsize=None)
def _genome():
    """N runs, three fragments and an all-T stretch of 200 bases (real
    all-T pair signatures at seedl 64) beside sentinels."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, N).astype(np.uint8)
    codes[5000:5400] = codes[9000:9400]          # a repeat: multi-hit reads
    codes[3000:3040] = 4
    codes[rng.random(N) < 0.001] = 4
    codes[ALL_T[0]:ALL_T[1]] = 3
    ranges = [("f0", 0), ("f1", 8000), ("f2", 16000), ("terminal", N)]
    return codes, ranges


@functools.lru_cache(maxsize=None)
def _texts():
    codes, ranges = _genome()
    jt = j_packed.build_packed_text(codes, ranges)
    fields = {f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fields.items()}
    return jt, convert.packed_text_from_numpy(fields, "cpu")


@functools.lru_cache(maxsize=None)
def _indexes(seedl, bucket_bits):
    """real_tpu's wide index and the identical one carried to the port."""
    jt, _ = _texts()
    ji = j_build.build_index(jt, seedl, bucket_bits=bucket_bits)
    ti = convert.index_from_numpy(
        np.asarray(ji.sig), np.asarray(ji.pos), np.asarray(ji.bb),
        ji.bucket_bits, seedl, "cpu", sig_hi=np.asarray(ji.sig_hi))
    return ji, ti


def _batch(seedl, patl=PATL):
    codes, _ = _genome()
    rds = simulate.generate_reads(codes, B - 24, patl, 0.02, False,
                                  seed=seedl)
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    batch = np.zeros((B, patl), np.uint8)
    for i, r in enumerate(rds):
        batch[i] = lut[np.frombuffer(r.seq.encode(), np.uint8)]
    n = len(rds)
    batch[n] = 3                      # all T: the sentinel pattern at 64
    batch[n + 1] = 0                  # all A, its reverse complement
    n += 2
    valid = np.zeros(B, bool)
    valid[:n] = (batch[:n] <= 3).all(axis=1)
    return batch, valid


@pytest.mark.parametrize("seedl", [36, 48, 60, 64])
def test_compute_probes_equal_real_tpu_planes_joined(seedl):
    batch, _ = _batch(seedl)
    hi, lo = j_ms.compute_probes(jnp.asarray(batch), seedl)
    got = t_ms.compute_probes(torch.from_numpy(batch), seedl)
    assert got.dtype == torch.int64 and tuple(got.shape) == (B, 12)
    np.testing.assert_array_equal(
        got.numpy(), planes_to_i64(np.asarray(hi), np.asarray(lo)))
    if seedl == 64:
        assert (got.numpy() < 0).any()          # bit 63 set somewhere
        # the all-T read: the sentinel pattern straight, all A reversed
        assert (got.numpy()[B - 24, :6] == -1).all()
        assert (got.numpy()[B - 24, 6:] == 0).all()
    else:
        assert (got.numpy() >= 0).all()


def test_plane_conversions_round_trip_and_order():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    sig = planes_to_i64(hi, lo)
    hi2, lo2 = i64_to_planes(sig)
    np.testing.assert_array_equal(hi, hi2)
    np.testing.assert_array_equal(lo, lo2)
    # unsigned_order sorts like the (hi, lo) planes sort lexicographically
    order = np.lexsort((lo, hi))
    key = unsigned_order(torch.from_numpy(sig)).numpy()
    np.testing.assert_array_equal(np.sort(key), key[order])
    # the logical shift equals the planes' bucket key at every width
    for seedl, bits in ((36, 12), (48, 20), (64, 25), (64, 12)):
        sc = JSigConfig(seedl)
        mask = (1 << seedl) - 1
        u = sig.view(np.uint64) & np.uint64(mask)
        h, l = i64_to_planes(u.view(np.int64))
        want = np.asarray(sc.bucket_key_bits(h, l, bits)).astype(np.int64)
        got = SigConfig(seedl).bucket_key_bits(
            torch.from_numpy(u.view(np.int64)), bits).numpy()
        np.testing.assert_array_equal(got, want & ((1 << bits) - 1))
    assert logical_shift_right(torch.tensor([-1]), 63).item() == 1


def _assert_same_wide_index(ji, ti):
    d = convert.index_to_numpy(ti)
    assert ti.sig.dtype == torch.int64
    np.testing.assert_array_equal(d["sig"], np.asarray(ji.sig))
    np.testing.assert_array_equal(d["sig_hi"], np.asarray(ji.sig_hi))
    np.testing.assert_array_equal(d["bb"], np.asarray(ji.bb))
    assert ji.bucket_bits == ti.bucket_bits
    sig = ti.sig.numpy().reshape(6, -1)
    pos_j = np.asarray(ji.pos).reshape(6, -1)
    pos_t = d["pos"].reshape(6, -1)
    for j in range(6):
        oj = np.lexsort((pos_j[j], sig[j]))
        ot = np.lexsort((pos_t[j], sig[j]))
        np.testing.assert_array_equal(pos_j[j][oj], pos_t[j][ot],
                                      err_msg=f"list {j}")
    return (pos_j == pos_t).all()


@pytest.mark.parametrize("seedl", [48, 64])
@pytest.mark.parametrize("start,nwin", [(0, None), (4096, 10007)],
                         ids=["whole", "sub_range"])
def test_wide_build_index_equals_real_tpu(seedl, start, nwin):
    """A sub-range with start > 0 and a window count that is no multiple
    of 16: positions past start + nwin are sentinels on both sides."""
    jt, tt = _texts()
    assert jt.order_sentinels(seedl) == tt.order_sentinels(seedl) \
        == (seedl == 64)
    ji = j_build.build_index(jt, seedl, start=start, num_windows=nwin)
    ti = t_build.build_index(tt, seedl, start=start, num_windows=nwin)
    arrays_equal = _assert_same_wide_index(ji, ti)
    sig = ti.sig.numpy().reshape(6, -1)
    pos = ti.pos.numpy().reshape(6, -1)
    # the lists equal real_tpu's inside equal signatures too: both are
    # stable over the phase-major window order
    assert arrays_equal
    same = sig[:, 1:] == sig[:, :-1]
    phase_major = (pos & 15) * (1 << 27) + (pos >> 4)
    real = (pos[:, 1:] != 0x7FFFFFFF) & (pos[:, :-1] != 0x7FFFFFFF)
    assert (phase_major[:, 1:][same & real]
            > phase_major[:, :-1][same & real]).all()
    if nwin is None:
        # equal-signature runs exist (the all-T stretch, the repeat), and
        # there phase-major order differs from position order
        assert (pos[:, 1:][same & real] < pos[:, :-1][same & real]).any()
        if seedl == 64:
            allt = (sig[0] == -1) & (pos[0] != 0x7FFFFFFF)
            assert allt.any()               # real all-T entries ...
            last_real = np.flatnonzero(pos[0] != 0x7FFFFFFF).max()
            assert last_real == np.flatnonzero(allt).max()   # ... come last
            assert (pos[0][last_real + 1:] == 0x7FFFFFFF).all()
    else:
        assert (pos[:, nwin:] == 0x7FFFFFFF).all()
        assert ti.sig.shape[0] == 6 * 16 * (-(-nwin // 16))


CASES = {
    # seedl, bucket_bits, bsearch_steps, K, S, scores
    "l48_lanes": (48, 12, 0, 8, 8, True),
    "l48_tier1_only": (48, 12, 0, 4, 4, False),
    "l48_bisection": (48, 12, 8, 8, 8, True),
    "l64_lanes": (64, 12, 0, 8, 8, True),
    "l64_bisection": (64, 12, 8, 8, 8, False),
    "l64_occupancy1": (64, 0, 0, 8, 8, True),
    "l36_lanes": (36, 12, 0, 8, 8, False),
    "l60_bisection": (60, 12, 8, 8, 8, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_match_step_equals_real_tpu(case):
    """find_survivors (every Survivors field, every window word) and two
    match steps (the state) on the identical wide index."""
    seedl, bits, steps, K, S, scores = CASES[case]
    jt, tt = _texts()
    ji, ti = _indexes(seedl, bits)
    batch, valid = _batch(seedl)
    fs = dict(seedl=seedl, seedkmax=2, totalkmax=5, cand_cap=K,
              survivor_cap=S, bsearch_steps=steps, text_has_n=jt.has_n)
    jsurv, jtw = j_ms.find_survivors(
        ji.sig, ji.pos, ji.bb, jt.words, jt.nbits, jt.ncum, jt.frag_offsets,
        jnp.asarray(batch), None, jnp.asarray(valid),
        index_sig_hi=ji.sig_hi, **fs)
    tsurv, ttw = t_ms.find_survivors(
        ti.sig, ti.pos, ti.bb, tt.words, tt.nbits, tt.ncum, tt.frag_offsets,
        torch.from_numpy(batch), torch.from_numpy(valid), **fs)
    for f in t_ms.Survivors._fields:
        a, b = np.asarray(getattr(jsurv, f)), getattr(tsurv, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(ttw) == len(jtw)
    for a, b in zip(jtw, ttw):
        np.testing.assert_array_equal(np.asarray(a).astype(np.uint32),
                                      b.numpy().view(np.uint32))
    jv = np.asarray(jsurv.valid)
    assert (jv & np.asarray(jsurv.inv)).any()
    assert (jv & ~np.asarray(jsurv.inv)).any()

    j_tables = j_scoring.score_tables(j_scoring.Scoring()) if scores else None
    t_tables = t_scoring.score_tables(t_scoring.Scoring()) if scores else None
    eps = np.float32(5 / 70.0 * PATL)
    js, ts = j_ms.initial_state(B), t_ms.initial_state(B, "cpu")
    for fid in (0, 1):
        js, _ = j_ms.match_step(
            ji.sig, ji.pos, ji.bb, jt.words, jt.nbits, jt.ncum,
            jt.frag_offsets, jnp.asarray(batch), None, jnp.asarray(valid),
            js, jnp.int32(fid), eps, ji.sig_hi, tables=j_tables,
            score_mode="f64", matchall=False, scores=scores, **fs)
        ts, _ = t_ms.match_step(
            ti.sig, ti.pos, ti.bb, tt.words, tt.nbits, tt.ncum,
            tt.frag_offsets, torch.from_numpy(batch), None,
            torch.from_numpy(valid), ts, fid, eps, tables=t_tables,
            scores=scores, **fs)
        for f in t_ms.MatchState._fields:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    st = ts.st.numpy()
    assert (st == t_ms.NON_UNIQUE).any() and (st == t_ms.NO_MATCH).any()


def _jax_wide_probe_intermediates(ji, batch, valid, seedl, K1):
    """find_survivors' lines from the bucket lookup to cand1 for wide
    signatures (bsearch_steps == 0), by probe, planes joined."""
    sc = JSigConfig(seedl)
    hi, lo = j_ms.compute_probes(jnp.asarray(batch), seedl)
    M = ji.sig.shape[0] // 6
    nbuck = ji.bb.shape[0] // 6
    lists = jnp.arange(12, dtype=jnp.int32) % 6
    h = sc.bucket_key_bits(hi, lo, ji.bucket_bits).astype(jnp.int32)
    b_lo = jnp.take(ji.bb, h + lists * nbuck)
    b_hi = jnp.take(ji.bb, h + 1 + lists * nbuck)
    b_hi = jnp.minimum(b_hi, ji.bb[nbuck - 1 + lists * nbuck])
    count = jnp.minimum(b_hi - b_lo, jnp.int32(2 * M))
    lane1 = jnp.arange(K1, dtype=jnp.int32)
    idxs = jnp.clip(b_lo[..., None] + lane1, 0, M - 1) \
        + (lists * M)[None, :, None]
    lane_lo, lane_hi = jnp.take(ji.sig, idxs), jnp.take(ji.sig_hi, idxs)
    cand1 = (lane1[None, None, :] < count[..., None]) \
        & (lane_lo == lo[..., None]) & (lane_hi == hi[..., None]) \
        & jnp.asarray(valid)[:, None, None]
    start = np.asarray(jnp.clip(b_lo, 0, M - 1))
    return dict(begin=np.asarray(b_lo), count=np.asarray(count),
                lanes=planes_to_i64(np.asarray(lane_hi), np.asarray(lane_lo)),
                cand1=np.asarray(cand1), start=start, M=M)


@pytest.mark.parametrize("seedl", [36, 48, 64])
@pytest.mark.parametrize("K1", [1, 4])
def test_wide_probe_candidates_ref_equals_real_tpu(seedl, K1):
    ji, ti = _indexes(seedl, 12)
    batch, valid = _batch(seedl, patl=80)
    j = _jax_wide_probe_intermediates(ji, batch, valid, seedl, K1)
    probe = t_ms.compute_probes(torch.from_numpy(batch), seedl)
    shift = SigConfig(seedl).bucket_shift_bits(ti.bucket_bits)
    begin, count, lanes, cand = gather.probe_candidates_ref(
        ti.sig, ti.bb, probe, torch.from_numpy(valid), shift, K1)
    assert begin.dtype == count.dtype == torch.int32
    assert lanes.dtype == torch.int64 and cand.dtype == torch.bool
    np.testing.assert_array_equal(begin.numpy(), j["begin"])
    np.testing.assert_array_equal(count.numpy(), j["count"])
    np.testing.assert_array_equal(cand.numpy(), j["cand1"])
    inside = (j["start"][..., None] + np.arange(K1)) < j["M"]
    assert not ((np.arange(K1) < j["count"][..., None]) & ~inside).any()
    np.testing.assert_array_equal(lanes.numpy()[inside], j["lanes"][inside])
    assert j["cand1"][:, :6].any() and j["cand1"][:, 6:].any()
    assert (j["count"] > K1).any() and not valid.all()
    if seedl == 64:
        # signatures with bit 63 set: signed and unsigned order differ
        assert (probe.numpy() < 0).any() and (ti.sig.numpy() < 0).any()
        is_t = probe.numpy() == -1
        real_end = np.asarray(ji.bb).reshape(6, -1)[:, -1]
        ends = j["begin"] + j["count"]
        assert is_t.any() and (j["count"][is_t] > 0).all()
        assert (ends[is_t] <= np.broadcast_to(
            real_end[np.arange(12) % 6], ends.shape)[is_t]).all()
    # the wrapper on CPU tensors is the plain version and counts nothing
    before = (gather.probe_candidates.launches,
              gather.probe_candidates.launches_wide)
    for g, r in zip(gather.probe_candidates(ti.sig, ti.bb, probe,
                                            torch.from_numpy(valid), shift,
                                            K1), (begin, count, lanes, cand)):
        assert torch.equal(g, r)
    assert before == (gather.probe_candidates.launches,
                      gather.probe_candidates.launches_wide)


@pytest.mark.parametrize("seedl", [36, 48, 64])
@pytest.mark.parametrize("k1", [1, 3, 4])
def test_wide_probe_candidates_ref_on_hand_made_tables(seedl, k1):
    """The plain version against a per-probe loop over Python integers
    (unsigned by construction), on tables with out-of-range bucket bounds
    and, at seedl 64, signatures with the top bit set."""
    from real_tpu_torch.tools import fusedcases
    rng = np.random.default_rng(seedl + k1)
    sig, bb, shift = fusedcases.edge_tables_wide(rng, seedl)
    M, nbuck = sig.shape[1], bb.shape[1]
    probe, valid = fusedcases.edge_probes_wide(rng, sig, 48, seedl)
    begin, count, lanes, cand = gather.probe_candidates_ref(
        torch.from_numpy(sig.reshape(-1)), torch.from_numpy(bb.reshape(-1)),
        torch.from_numpy(probe), torch.from_numpy(valid), shift, k1)
    flat_sig = [int(x) for x in sig.view(np.uint64).reshape(-1)] + [0] * k1
    flat_bb = bb.reshape(-1).astype(np.int64)
    uprobe = probe.view(np.uint64)
    for b in range(probe.shape[0]):
        for p in range(12):
            l = p % 6
            i = l * nbuck + (int(uprobe[b, p]) >> shift)
            lo, hi = flat_bb[i], min(flat_bb[i + 1], bb[l, -1])
            start = min(max(lo, 0), M - 1) + l * M
            want = flat_sig[start:start + k1]
            assert begin[b, p] == lo and count[b, p] == min(hi - lo, 2 * M)
            got = [int(x) for x in lanes[b, p].numpy().view(np.uint64)]
            assert got == want
            np.testing.assert_array_equal(
                cand[b, p].numpy(),
                (np.arange(k1) < hi - lo)
                & np.array([w == int(uprobe[b, p]) for w in want])
                & valid[b])
    assert cand.any() and (count < 0).any() and (begin >= M).any()
    if seedl == 64:
        assert (sig[:, :-7] < 0).any() and (probe < 0).any()


def test_wide_probe_candidates_rejects_what_the_kernel_does_not_take():
    sig = torch.zeros(12, dtype=torch.int64, device="meta")
    bb = torch.zeros(12, dtype=torch.int32, device="meta")
    probe = torch.zeros((2, 12), dtype=torch.int64)
    with pytest.raises(ValueError):
        gather.probe_candidates(sig, bb, probe, torch.ones(2, dtype=bool),
                                20, 4)


@pytest.mark.parametrize("patl,seedl", [(64, 64), (75, 64), (75, 48),
                                        (100, 36), (50, 48), (130, 64)])
def test_seed_masks_span_the_seed_words(patl, seedl):
    """The seed-region masks of verify_windows when the seed spans 3 or 4
    words and when seedl == patl == 64: against a per-base loop, and equal
    to real_tpu's."""
    kw = (patl + 15) // 16
    tail, ms, mr = gather.window_masks(patl, seedl)
    js, jr = j_ms._seed_masks(patl, seedl, kw)
    np.testing.assert_array_equal(ms, js)
    np.testing.assert_array_equal(mr, jr)
    np.testing.assert_array_equal(tail, j_ms._tail_masks(patl, kw))

    def bases(mask):
        return ((mask.astype(np.uint64)[:, None]
                 >> (2 * (15 - np.arange(16, dtype=np.uint64)))) & 3) \
            .reshape(-1)
    pos = np.arange(16 * kw)
    np.testing.assert_array_equal(bases(ms) == 3, pos < seedl)
    np.testing.assert_array_equal(bases(mr) == 3,
                                  (pos >= patl - seedl) & (pos < patl))
    np.testing.assert_array_equal(bases(tail) == 3, pos < patl)
    # verify_windows_ref counts seed mismatches with them, both strands
    rng = np.random.default_rng(patl + seedl)
    text = rng.integers(0, 4, 16 * 40).astype(np.uint8)
    from real_tpu_torch import bitpack
    words = torch.from_numpy(
        bitpack.pack_2bit(text, pad_words=2).view(np.int32).copy())
    p = rng.integers(0, len(text) - patl, (6, 3))
    reads = text[p[:, 0][:, None] + np.arange(patl)].copy()
    flip = rng.random(reads.shape) < 0.2
    reads[flip] = (reads[flip] + 1) & 3
    ws, wr = t_ms.pack_read_words(torch.from_numpy(reads))
    inv = torch.from_numpy(rng.random((6, 3)) < 0.5)
    _, totalk, seedk = gather.verify_windows_ref(
        words, torch.from_numpy(p), inv, ws, wr, patl, seedl)
    rc = 3 - reads[:, ::-1]
    for b in range(6):
        for j in range(3):
            win = text[p[b, j]:p[b, j] + patl]
            diff = win != (rc[b] if inv[b, j] else reads[b])
            seed = diff[patl - seedl:] if inv[b, j] else diff[:seedl]
            assert totalk[b, j] == diff.sum() and seedk[b, j] == seed.sum()


def _port_records(genome, reads, seedl, unique, native=True):
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", seedl=seedl, batch_size=512,
                     match_unique=unique, native_host=native)
    rs = reads_io.parse_reads(reads, use_native=native)
    texts = driver.load_texts(cfg, "cpu")
    buf = io.StringIO()
    if unique:
        res = driver.run_match_unique(cfg, rs, texts, "cpu")
        n = write_unique(buf, rs, res, texts, True, native)
    else:
        res = driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True)
        n = write_all_arrays(buf, rs, res.cols, texts, True, native)
    assert n > 150
    return buf.getvalue()


@pytest.mark.parametrize("seedl", [48, 64])
@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_wide_records_equal_real_tpu(tmp_path, seedl, unique):
    """End to end at -l 48 and -l 64, both modes, through run_match_* and
    through the CLI with -native 1 and -native 0: bytes equal real_tpu's."""
    genome, reads = ab_util.make_inputs(tmp_path, n=24000, numpat=250,
                                        patlen=100, errprob=0.02,
                                        seed=40 + seedl)
    want = ab_util.run_ours(genome, reads, unique=unique, seedl=seedl,
                            use_mesh=False, index_shards=1)
    assert _port_records(genome, reads, seedl, unique) == want
    for native in ("1", "0"):
        out = tmp_path / f"cli{native}.txt"
        assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                            "-o", str(out), "-B", "512", "-R", "0",
                            "-native", native, "-l", str(seedl),
                            "-u", str(int(unique))]) == 0
        assert out.read_text() == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 2, 3, 4])
def test_wide_probe_candidates_kernel_equals_plain_version_on_card(
        cuda_device, k1):
    from real_tpu_torch.tools import fusedcases
    rng = np.random.default_rng(k1)
    sig, bb, shift = fusedcases.edge_tables_wide(rng, 64)
    probe, valid = fusedcases.edge_probes_wide(rng, sig, 700, 64)
    args = fusedcases.tensors((sig.reshape(-1), bb, probe, valid),
                              cuda_device)
    before = gather.probe_candidates.launches_wide
    got = gather.probe_candidates(*args, shift, k1)
    torch.cuda.synchronize()
    assert gather.probe_candidates.launches_wide == before + 1
    for g, r in zip(got, gather.probe_candidates_ref(*args, shift, k1)):
        assert g.dtype == r.dtype and torch.equal(g, r)
