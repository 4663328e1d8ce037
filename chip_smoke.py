#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (real_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's three paths through their entry points on CUDA and holds
every kernel of those paths against its plain PyTorch version:

  matchUnique  bench.py's size: a 4.6 Mbp random genome (E. coli scale),
               100,000 reads x 100 bp, errprob 0.02, seed 12345, k <= 5,
               scores on, batch 8192
  matchAll     the yeast configuration (benchmarks/scale.py "yeast"): a
               12 Mbp random genome (seed 1202), 1,000,000 reads x 50 bp
               FASTA (errprob 0.02, seed 1203), k <= 3, scores on, default
               batch 32,768
  gatherbench  the gather micro-benchmark (tools/gatherbench.py) at its
               default size and with a 110 MB table

Phases:

  1. card       device name and `nvidia-smi` name/power limit
  2. build      nvcc builds csrc/gather_windows.cu and csrc/gather_rowsum.cu
                for sm_90a, both at once (timed)
  3. data       both genomes and read sets from tools/simulate (timed;
                the yeast reads are made after phase 6)
  4. kernel     gather_windows bit-exact against gather_word_windows_ref at
                the three call shapes of each match path on its real
                tables; gather_rowsum bit-exact against gather_rowsum_ref
                at gatherbench's shape for w in 8, 1, 2, 4, 16 and on the
                matchUnique signature table (110 MB, past the 50 MB L2),
                with uint32 totals equal to take_sum's; then edge cases
                (idx < 0, = mw-1, >= mw, mw < w, top bit, int32 wrap)
  5. unique     load -> run_match_unique -> write_unique, warmup then
                timed; reads/s, phase seconds, overflow reruns, kernel
                launches by width (> 0 at every call site), truth recall
  6. parity     the port on the CPU over the first 2,048 reads: records
                byte-identical to the card's records for those reads
  7. matchall   load -> run_match_all(as_arrays=True) -> write_all_arrays,
                timed after a warmup on one batch-sized prefix; reads/s,
                records, phase seconds, overflow_rerun_reads,
                batch_hit_overflow_steps, kernel launches by width (> 0 at
                w = 5, 2, 4), truth share
  8. allparity  the port's matchAll on the CPU over the first 2,048 reads:
                records byte-identical to the card's for those reads, and
                every matchUnique record of the same CPU run among them
  9. gatherbench  the tool's JSON line at both table sizes; the kernel's
                launches counted over each run
 10. times      each kernel at each main-path shape: kernel, plain version
                and one torch yardstick (index_select for gather_windows,
                take_sum for gather_rowsum), device time (CUDA events
                around 10 calls queued behind a sleep kernel, median of 25)
                and host-inclusive time (the same without the sleep), and
                the bytes bound at 3.35 TB/s

Any failure raises (non-zero exit). Without CUDA, or without the rest of
the repository beside it, it exits non-zero before printing any result.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
L2_BYTES = 50 * 2**20
PARITY_READS = 2048


@dataclasses.dataclass
class PathCfg:
    """One match path's simulated data and run settings."""
    name: str
    genome_n: int
    genome_seed: int
    num_reads: int
    patl: int
    reads_seed: int
    totalkmax: int
    batch: int
    unique: bool
    truth_kmax: int          # reads with at most this many mutations count


UNIQUE = PathCfg("unique", 4_600_000, 12345, 100_000, 100, 12346, 5, 8192,
                 True, 5)
YEAST = PathCfg("matchall", 12_000_000, 1202, 1_000_000, 50, 1203, 3, 32768,
                False, 3)
ERRPROB = 0.02
GATHERBENCH = dict(m=2_920_000, n=262_144, w=8)
GATHER_SRC = "real_tpu_torch/csrc/gather_windows.cu"
GATHER_REPLACES = "real_tpu/ops/pallas_gather.py:71"
ROWSUM_SRC = "real_tpu_torch/csrc/gather_rowsum.cu"
ROWSUM_REPLACES = "benchmarks/pallasbench.py:101"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_phase(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] torch.cuda: {name} (count {torch.cuda.device_count()}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name, smi


def build_phase():
    from real_tpu_torch.ops import cuda_build
    names = ("gather_windows", "gather_rowsum")
    t = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        paths = list(ex.map(cuda_build.library_path, names))
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t:.2f}s (one nvcc per source, in parallel)")
    for n in names:
        for line in cuda_build.build_logs.get(n, "").splitlines():
            log(f"[build] {line}")


def make_genome(tmp: str, pc: PathCfg):
    """(genome path, genome codes) of one path."""
    from real_tpu_torch.io import fasta
    from real_tpu_torch.tools import simulate
    g = os.path.join(tmp, f"{pc.name}_genome.fa")
    with open(g, "w") as f:
        f.write(simulate.random_genome(pc.genome_n, seed=pc.genome_seed))
    return g, fasta.parse_genome(g)[0]


def make_reads(tmp: str, pc: PathCfg, codes):
    """(reads path, parity reads path, warmup reads path, truth reads) of
    one path."""
    from real_tpu_torch.tools import simulate
    t = time.perf_counter()
    truth = simulate.generate_reads(codes, pc.num_reads, pc.patl, ERRPROB,
                                    False, seed=pc.reads_seed)
    tr = time.perf_counter() - t
    paths = []
    for tag, rows in (("reads", truth), ("parity", truth[:PARITY_READS]),
                      ("warmup", truth[:pc.batch])):
        paths.append(os.path.join(tmp, f"{pc.name}_{tag}.fa"))
        simulate.write_reads(rows, paths[-1], False)
    log(f"[data] {pc.name}: {pc.num_reads} reads x {pc.patl} bp over "
        f"{pc.genome_n} bp in {time.perf_counter() - t:.1f}s "
        f"(generate_reads {tr:.1f}s)")
    return (*paths, truth)


def path_config(pc: PathCfg, g: str, r: str):
    from real_tpu_torch.config import RealConfig
    return RealConfig(textfilename=g, patternfilename=r, outputfilename="-",
                      batch_size=pc.batch, totalkmax=pc.totalkmax,
                      match_unique=pc.unique)


def path_index(cfg, texts, num_reads):
    from real_tpu_torch.engine import driver
    from real_tpu_torch.index.build import build_index, pick_bucket_bits
    nwin = texts[0].packed.n - cfg.seedl + 1
    return build_index(texts[0].packed, cfg.seedl, 0, nwin,
                       pick_bucket_bits(cfg.seedl, nwin, num_reads,
                                        cap=driver.BUCKET_BITS_CAP))


def site_inputs(torch, pc: PathCfg, text, index, rng):
    """(name, table, idx, w) at the three call shapes of the window gather
    on one match path (engine/matchstep.py), on that path's tables."""
    dev = text.words.device
    nwords = text.words.shape[0]
    B, S = pc.batch, 8
    a = rng.integers(0, (text.n - pc.patl) // 16, (B, S))
    nbuck = index.bb.shape[0] // 6
    b = rng.integers(0, nbuck - 1, (6, 2 * B)) \
        + (np.arange(6) * nbuck)[:, None]
    M = index.sig.shape[0] // 6
    c = rng.integers(0, M, (B, 12)) + (np.arange(12) % 6) * M
    kw = (pc.patl + 15) // 16
    assert a.max() < nwords

    def t(x):
        return torch.from_numpy(x.astype(np.int32)).to(dev)
    return [(f"{pc.name}/a_text_windows", text.words, t(a), kw + 1),
            (f"{pc.name}/b_bucket_bounds", index.bb, t(b), 2),
            (f"{pc.name}/c_tier1_lanes", index.sig, t(c), 4)]


def max_abs_err(torch, got, want) -> int:
    g = torch.stack([x.to(torch.int64) for x in got])
    r = torch.stack([x.to(torch.int64) for x in want])
    if g.shape != r.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(r.shape)}")
    return int((g - r).abs().max()) if g.numel() else 0


def _edge_tables(torch, rng, dev):
    """(mw, w, words, idx): K1's edge set over small tables."""
    edge_idx = np.array([-2**31, -5, -1, 0, 1, 2**31 - 1], np.int64)
    for mw, w in ((1, 1), (3, 8), (5, 8), (1000, 2), (1000, 4), (1000, 8),
                  (4097, 8)):
        words = torch.from_numpy(rng.integers(
            -2**31, 2**31, mw, dtype=np.int64).astype(np.int32)).to(dev)
        words[0] = -1                                   # top bit set
        idx = np.concatenate([edge_idx, [mw - 2, mw - 1, mw, mw + 1,
                                         mw + 1000],
                              rng.integers(-10, mw + 10, 319)])
        idx = torch.from_numpy(idx.astype(np.int32)).to(dev).reshape(-1, 11)
        yield mw, w, words, idx


def gather_kernel_phase(torch, sites, dev):
    from real_tpu_torch.ops.gather import (gather_word_windows,
                                           gather_word_windows_ref)
    errs = {}
    for name, table, idx, w in sites:
        got = gather_word_windows(table, idx, w)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, gather_word_windows_ref(table, idx, w))
        log(f"[kernel] gather_windows {name}: table {table.shape[0]} words, "
            f"idx {tuple(idx.shape)}, w={w}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"gather_windows disagrees at {name}")
        errs[name] = err
    for mw, w, words, idx in _edge_tables(torch, np.random.default_rng(7),
                                          dev):
        got = gather_word_windows(words, idx, w)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, gather_word_windows_ref(words, idx, w))
        if err != 0:
            raise AssertionError(f"gather_windows edge case mw={mw} w={w}")
    empty = gather_word_windows(words, torch.zeros((0, 3), dtype=torch.int32,
                                                   device=dev), 2)
    if len(empty) != 2 or empty[0].shape != (0, 3):
        raise AssertionError("gather_windows on empty idx")
    log("[kernel] gather_windows edge cases bit-exact (idx < 0, = mw-1, "
        ">= mw, mw < w, top-bit words, empty idx)")
    return errs


def rowsum_cases(torch, big_table, dev):
    """(name, table, idx, w) of gather_rowsum on the micro-benchmark's
    shapes: gatherbench's default inputs at w 8, 1, 2, 4, 16, and the
    matchUnique signature table (110 MB, past L2) at w 8."""
    from real_tpu_torch.tools import gatherbench
    table, idx = gatherbench.make_inputs(GATHERBENCH["m"], GATHERBENCH["n"],
                                         dev)
    rng = np.random.default_rng(11)
    mbig = big_table.shape[0]
    idx_big = torch.from_numpy(rng.integers(
        0, mbig - 256, GATHERBENCH["n"]).astype(np.int32)).to(dev)
    cases = [(f"{_l2_tag(table.numel())}/m{table.numel()}_w{w}", table, idx,
              w) for w in (8, 1, 2, 4, 16)]
    cases.append((f"{_l2_tag(mbig)}/m{mbig}_w8", big_table, idx_big, 8))
    return cases


def _l2_tag(words: int) -> str:
    return "fits_l2" if 4 * words <= L2_BYTES else "exceeds_l2"


def rowsum_kernel_phase(torch, cases, dev):
    from real_tpu_torch.ops.rowsum import gather_rowsum, gather_rowsum_ref
    from real_tpu_torch.text.packed import MASK32, u32
    from real_tpu_torch.tools.gatherbench import take_sum, window_index
    errs = {}
    for name, table, idx, w in cases:
        got = gather_rowsum(table, idx, w)
        torch.cuda.synchronize()
        err = max_abs_err(torch, [got], [gather_rowsum_ref(table, idx, w)])
        total = int(u32(got).sum()) & MASK32
        want = int(take_sum(table, window_index(idx, w)).sum()) & MASK32
        log(f"[kernel] gather_rowsum {name}: table {table.numel()} words "
            f"({table.numel() * 4 / 1e6:.1f} MB), n={idx.numel()}: "
            f"max_abs_err {err}, uint32 total {total} (take_sum {want})")
        if err != 0 or total != want:
            raise AssertionError(f"gather_rowsum disagrees at {name}")
        errs[name] = err
    rng = np.random.default_rng(13)
    for mw, w, words, idx in _edge_tables(torch, rng, dev):
        got = gather_rowsum(words, idx, w)
        torch.cuda.synchronize()
        if max_abs_err(torch, [got], [gather_rowsum_ref(words, idx, w)]):
            raise AssertionError(f"gather_rowsum edge case mw={mw} w={w}")
    # int32 wraparound: every lane sums w top-bit words
    words = torch.full((64,), -1, dtype=torch.int32, device=dev)
    words[::2] = -2**31
    idx = torch.arange(-3, 70, dtype=torch.int32, device=dev)
    for w in (2, 3, 16):
        got = gather_rowsum(words, idx, w)
        torch.cuda.synchronize()
        if max_abs_err(torch, [got], [gather_rowsum_ref(words, idx, w)]):
            raise AssertionError(f"gather_rowsum int32 wraparound w={w}")
    log("[kernel] gather_rowsum edge cases bit-exact (idx < 0, = mw-1, "
        ">= mw, mw < w, top-bit words, int32 wraparound)")
    return errs


def run_once(cfg, reads_path, device):
    """One timed pass of a path through its entry points: (read set,
    texts, result, record bytes, record count, phase seconds)."""
    from real_tpu_torch.cli.output import write_all_arrays, write_unique
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import reads as reads_io
    import torch
    ph = {}
    t0 = t = time.perf_counter()
    rs = reads_io.parse_reads(reads_path)
    ph["parse_reads"] = time.perf_counter() - t
    t = time.perf_counter()
    texts = driver.load_texts(cfg, device)
    ph["parse_pack_text"] = time.perf_counter() - t
    t = time.perf_counter()
    if cfg.match_unique:
        result = driver.run_match_unique(cfg, rs, texts, device)
    else:
        result = driver.run_match_all(cfg, rs, texts, device, as_arrays=True)
    if device == "cuda":
        torch.cuda.synchronize()
    ph["match"] = time.perf_counter() - t
    t = time.perf_counter()
    buf = io.BytesIO()
    if cfg.match_unique:
        records = write_unique(buf, rs, result, texts, cfg.scores)
    else:
        records = write_all_arrays(buf, rs, result.cols, texts, cfg.scores)
    ph["output"] = time.perf_counter() - t
    ph["total"] = time.perf_counter() - t0
    return rs, texts, result, buf.getvalue(), records, ph


def truth_share(pc: PathCfg, result, truth) -> float:
    """Share of reads with <= truth_kmax mutations reported at their true
    position: the unique hit (matchUnique) or one of the records
    (matchAll)."""
    tpos = np.array([tr.pos for tr in truth], np.int64)
    sel = np.array([tr.nmut <= pc.truth_kmax for tr in truth])
    if pc.unique:
        ok = np.isin(result.st, (1, 2)) & (result.pos == tpos)
    else:
        hit_keys = (result.pid << 32) | result.pos
        ok = np.isin((np.arange(len(truth), dtype=np.int64) << 32) | tpos,
                     hit_keys)
    return float(ok[sel].mean())


def path_phase(torch, pc: PathCfg, g, r, r_warm, truth, widths, dev):
    """Warmup, then the timed run with the kernel counts set to 0 just
    before it and read just after."""
    from real_tpu_torch.ops.gather import gather_word_windows, \
        reset_launch_counts
    tag = f"[{pc.name}]"
    cfg = path_config(pc, g, r)
    t = time.perf_counter()
    run_once(path_config(pc, g, r_warm), r_warm, dev)
    log(f"{tag} warmup run on {pc.batch} reads {time.perf_counter() - t:.2f}s")
    reset_launch_counts()
    rs, texts, result, blob, records, ph = run_once(cfg, r, dev)
    torch.cuda.synchronize()
    launches = dict(gather_word_windows.launches_by_w)
    total = gather_word_windows.launches
    log(f"{tag} {pc.num_reads} reads in {ph['total']:.3f}s = "
        f"{pc.num_reads / ph['total']:.1f} reads/s end to end "
        f"({records} records)")
    log(f"{tag} phases: " + " ".join(f"{k}={v:.3f}s" for k, v in ph.items()))
    m = result.metrics
    log(f"{tag} match phases: " + " ".join(
        f"{k}={v:.3f}s" for k, v in m["phase_s"].items()))
    log(f"{tag} overflow_rerun_reads: {m['overflow_rerun_reads']}"
        + ("" if pc.unique else
           f", batch_hit_overflow_steps: {m['batch_hit_overflow_steps']}"))
    log(f"{tag} gather_windows launches: {total} (by w: {launches})")
    for w in widths:
        if launches.get(w, 0) <= 0:
            raise AssertionError(f"{pc.name} path made no w={w} gather "
                                 "launch")
    if sum(launches.values()) != total:
        raise AssertionError("launch counts disagree")
    share = truth_share(pc, result, truth)
    log(f"{tag} truth share (reads with <= {pc.truth_kmax} mutations "
        f"reported at their true position): {share:.5f}")
    if share < 0.95:
        raise AssertionError(f"{pc.name} truth share {share} below 0.95")
    if pc.unique:
        scores = result.score[(result.st == 1) | (result.st == 2)]
    else:
        scores = result.score
    if not np.isfinite(scores).all():
        raise AssertionError(f"{pc.name}: non-finite score on a hit")
    return cfg, result, launches


def unique_parity_phase(cfg, r_small, result):
    from real_tpu_torch.cli.output import write_unique
    from real_tpu_torch.engine.driver import MatchResult
    t = time.perf_counter()
    rs2, texts_cpu, res_cpu, blob_cpu, unique_cpu, _ = run_once(
        cfg, r_small, "cpu")
    n = PARITY_READS
    card = MatchResult(st=result.st[:n], pos=result.pos[:n],
                       frag=result.frag[:n], fileid=result.fileid[:n],
                       errs=result.errs[:n], score=result.score[:n])
    buf = io.BytesIO()
    write_unique(buf, rs2, card, texts_cpu, cfg.scores)
    if unique_cpu == 0 or buf.getvalue() != blob_cpu:
        raise AssertionError("CPU records differ from the card's records")
    log(f"[parity] CPU run on {n} reads: {unique_cpu} records "
        f"byte-identical to the card's ({time.perf_counter() - t:.1f}s)")


def all_parity_phase(cfg, r_small, result):
    from real_tpu_torch.cli.output import write_all_arrays
    t = time.perf_counter()
    rs2, texts_cpu, _, blob_cpu, n_cpu, _ = run_once(cfg, r_small, "cpu")
    card = [c[result.pid < PARITY_READS] for c in result.cols]
    buf = io.BytesIO()
    write_all_arrays(buf, rs2, card, texts_cpu, cfg.scores)
    if n_cpu == 0 or buf.getvalue() != blob_cpu:
        raise AssertionError("CPU matchAll records differ from the card's")
    ucfg = dataclasses.replace(cfg, match_unique=True)
    _, _, _, blob_u, n_u, _ = run_once(ucfg, r_small, "cpu")
    all_set = set(blob_cpu.splitlines())
    if n_u == 0 or not set(blob_u.splitlines()) <= all_set:
        raise AssertionError("a matchUnique record is missing from matchAll")
    log(f"[allparity] CPU run on {PARITY_READS} reads: {n_cpu} matchAll "
        f"records byte-identical to the card's; all {n_u} matchUnique "
        f"records among them ({time.perf_counter() - t:.1f}s)")


def gatherbench_phase(big_m):
    """The tool's JSON line at both table sizes; kernel launches counted
    over each run."""
    from real_tpu_torch.ops.rowsum import gather_rowsum, reset_launch_counts
    from real_tpu_torch.tools import gatherbench
    launches = {}
    for m in (GATHERBENCH["m"], big_m):
        reset_launch_counts()
        out = gatherbench.main(["--m", str(m), "--n", str(GATHERBENCH["n"]),
                                "--w", str(GATHERBENCH["w"])])
        launches[_l2_tag(out["M"])] = gather_rowsum.launches
        if not (out["rowsum_ok"] and out["take_sum_ok"]):
            raise AssertionError(f"gatherbench totals disagree at m={m}")
        if gather_rowsum.launches <= 0:
            raise AssertionError("gatherbench made no gather_rowsum launch")
        log(f"[gatherbench] m={out['M']} ({out['M'] * 4 / 1e6:.1f} MB, "
            f"{'fits in' if out['M'] * 4 <= L2_BYTES else 'exceeds'} the "
            f"50 MB L2): gather_rowsum launches {gather_rowsum.launches}")
    return launches


def _bound_bytes(torch, table, idx, w, out_words, unit):
    """Each index read once, each output word written once, and `unit`
    bytes for every distinct table word (unit 4) or 32 B sector (unit 32)
    that the windows touch."""
    mw = table.shape[0]
    start = idx.to(torch.int64).clamp(0, mw - 1).reshape(-1)
    win = start[:, None] + torch.arange(w, device=idx.device)
    touched = win[win < mw] // (unit // 4)
    return 4 * idx.numel() + 4 * out_words \
        + unit * int(torch.unique(touched).numel())


def times_phase(torch, sites, errs, launches_by_path, rcases, rerrs,
                rlaunches):
    from real_tpu_torch.ops.gather import (gather_word_windows,
                                           gather_word_windows_ref)
    from real_tpu_torch.ops.rowsum import gather_rowsum, gather_rowsum_ref
    from real_tpu_torch.tools.cudatime import time_ms
    from real_tpu_torch.tools.gatherbench import take_sum, window_index
    out = []

    def row(name, src, repl, launches, err, n, w, mw, bytes_moved, kern,
            plain, lib, lib_name):
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ms, ms_wall = time_ms(kern)
        plain_ms, plain_wall = time_ms(plain)
        library_ms, library_wall = time_ms(lib)
        log(f"[times] {name}: n={n} w={w} table={mw} words, device us "
            f"(host-inclusive us): kernel {ms * 1e3:.2f} "
            f"({ms_wall * 1e3:.2f}), plain {plain_ms * 1e3:.2f} "
            f"({plain_wall * 1e3:.2f}), {lib_name} "
            f"{library_ms * 1e3:.2f} ({library_wall * 1e3:.2f}), bound "
            f"{bound_ms * 1e3:.3f} ({bytes_moved} B), launches {launches}")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": int(launches),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": library_ms, "host_ms": ms_wall})

    for name, table, idx, w in sites:
        path = name.split("/")[0]
        mw = table.shape[0]
        start = idx.to(torch.int64).clamp(0, mw - 1).reshape(-1)
        win = (start[:, None] + torch.arange(w, device=idx.device)) \
            .reshape(-1)
        padded = torch.cat([table, table.new_zeros(w)])
        row(f"gather_windows/{name}_w{w}", GATHER_SRC, GATHER_REPLACES,
            launches_by_path[path].get(w, 0), errs[name], idx.numel(), w, mw,
            _bound_bytes(torch, table, idx, w, idx.numel() * w, 4),
            lambda: gather_word_windows(table, idx, w),
            lambda: gather_word_windows_ref(table, idx, w),
            lambda: torch.index_select(padded, 0, win), "index_select")
    for name, table, idx, w in rcases:
        if w != GATHERBENCH["w"]:
            continue
        win = window_index(idx, w)
        row(f"gather_rowsum/{name}", ROWSUM_SRC, ROWSUM_REPLACES,
            rlaunches[name.split("/")[0]], rerrs[name], idx.numel(), w,
            table.numel(),
            _bound_bytes(torch, table, idx, w, idx.numel(), 32),
            lambda: gather_rowsum(table, idx, w),
            lambda: gather_rowsum_ref(table, idx, w),
            lambda: take_sum(table, win), "take_sum")
    return out


def drive(torch, dev) -> list:
    """Phases 3-10 on `dev`; returns the kernels' JSON entries."""
    from real_tpu_torch.engine import driver
    unique, yeast = UNIQUE, YEAST
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        gu, codes_u = make_genome(tmp, unique)
        ga, codes_a = make_genome(tmp, yeast)
        ru, ru_small, ru_warm, truth_u = make_reads(tmp, unique, codes_u)

        sites, big_table = [], None
        for pc, g in ((unique, gu), (yeast, ga)):
            cfg = path_config(pc, g, ru)
            texts = driver.load_texts(cfg, dev)
            index = path_index(cfg, texts, pc.num_reads)
            sites += site_inputs(torch, pc, texts[0].packed, index,
                                 np.random.default_rng(pc.genome_seed))
            if pc.unique:
                big_table = index.sig        # 27,599,904 words, 110 MB
        errs = gather_kernel_phase(torch, sites, dev)
        rcases = rowsum_cases(torch, big_table, dev)
        rerrs = rowsum_kernel_phase(torch, rcases, dev)

        # the yeast read set (a million Python objects) is made after the
        # matchUnique path, so that path's host phases run as before
        kw_u, kw_a = (unique.patl + 15) // 16, (yeast.patl + 15) // 16
        cfg_u, res_u, launches_u = path_phase(
            torch, unique, gu, ru, ru_warm, truth_u, (kw_u + 1, 2, 4), dev)
        unique_parity_phase(cfg_u, ru_small, res_u)
        del res_u, truth_u
        ra, ra_small, ra_warm, truth_a = make_reads(tmp, yeast, codes_a)
        cfg_a, res_a, launches_a = path_phase(
            torch, yeast, ga, ra, ra_warm, truth_a, (kw_a + 1, 2, 4), dev)
        all_parity_phase(cfg_a, ra_small, res_a)
        del res_a, truth_a
        rlaunches = gatherbench_phase(big_table.numel())
        return times_phase(
            torch, sites, errs, {unique.name: launches_u,
                                 yeast.name: launches_a},
            rcases, rerrs, rlaunches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import real_tpu_torch  # noqa: F401  (fails outside the repository)

    t_all = time.perf_counter()
    name, _ = card_phase(torch)
    build_phase()
    kernels = drive(torch, "cuda")
    log("kernels: gather_windows, gather_rowsum")
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
