#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (real_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's three paths through their entry points on CUDA and holds
every kernel of those paths (gather_windows, probe_candidates,
verify_windows, gather_rowsum) against its plain PyTorch version:

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
  2. build      nvcc builds csrc/gather_windows.cu (three entry points) and
                csrc/gather_rowsum.cu for sm_90a, both at once (timed)
  3. data       both genomes and read sets from tools/simulate (timed;
                the yeast reads are made after phase 6)
  4. kernel     gather_windows bit-exact against gather_word_windows_ref at
                the three fetch shapes of each match path on its real
                tables; probe_candidates and verify_windows bit-exact
                against their plain versions at each path's batch shape on
                its real tables (simulated reads of both strands) and on
                hand-made edge cases (all-T probes on the sentinel range,
                bucket bounds at M-1 and beyond, windows in the last text
                word and past it, pos % 16 == 0, invalid reads, k1 1..4,
                reads of 16..256 bases); gather_rowsum bit-exact against
                gather_rowsum_ref
                at gatherbench's shape for w in 8, 1, 2, 4, 16 and on the
                matchUnique signature table (110 MB, past the 50 MB L2),
                with uint32 totals equal to take_sum's; then edge cases
                (idx < 0, = mw-1, >= mw, mw < w, top bit, int32 wrap)
  5. unique     load -> run_match_unique -> write_unique, warmup then
                timed; reads/s, phase seconds, overflow reruns, launches
                of probe_candidates and verify_windows (> 0), truth
                recall; then the first batch once more with 4x caps, which
                takes the bisection path: gather_windows launches (> 0),
                records byte-identical to the timed run's
  6. parity     the port on the CPU over the first 2,048 reads: records
                byte-identical to the card's records for those reads
  7. matchall   load -> run_match_all(as_arrays=True) -> write_all_arrays,
                timed after a warmup on one batch-sized prefix; reads/s,
                records, phase seconds, overflow_rerun_reads,
                batch_hit_overflow_steps, launches of probe_candidates and
                verify_windows (> 0), truth share; then the bisection
                pass as in phase 5
  8. allparity  the port's matchAll on the CPU over the first 2,048 reads:
                records byte-identical to the card's for those reads, and
                every matchUnique record of the same CPU run among them
  9. gatherbench  the tool's JSON line at both table sizes; the kernel's
                launches counted over each run
 10. times      each kernel at each main-path shape: kernel, plain version
                and one torch yardstick (the chain of index_select calls
                that fetches the same words for the three match-step
                entries, take_sum for gather_rowsum), device time (CUDA
                events around 10 calls queued behind a sleep kernel,
                median of 25) and host-inclusive time (the same without
                the sleep), and the bytes bound at 3.35 TB/s: every input
                and output byte once, the tables by distinct 32 B sector

Any failure raises (non-zero exit). Without CUDA, or without the rest of
the repository beside it, it exits non-zero before printing any result.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
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
    # ptxas -v, one line per kernel: registers and spill bytes
    for n in names:
        kernel = None
        for line in cuda_build.build_logs.get(n, "").splitlines():
            m = re.search(r"Compiling entry function '\w*?(\d+)([a-z_]+_kernel)"
                          r"(?:ILi(\d+)E)?", line)
            if m:
                kernel = m.group(2) + (f"<{m.group(3)}>" if m.group(3) else "")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                log(f"[build] {n}.cu {kernel}: {m.group(1)} registers, "
                    f"{spills}")


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
    """(name, table, idx, w) at the three fetch shapes of one match path
    (engine/matchstep.py), on that path's tables."""
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


def fused_inputs(torch, pc: PathCfg, codes, text, index, rng):
    """(name, args) of probe_candidates and of verify_windows at one
    path's batch shape on its real tables: B reads cut from the genome
    with the read sets' error rate, half of them reverse-complemented,
    and S = 8 survivor lanes per read, of which lane 0 is the read's true
    window and the others lie anywhere in the text."""
    from real_tpu_torch.engine.matchstep import (compute_probes,
                                                 pack_read_words)
    from real_tpu_torch.index.signatures import SigConfig
    dev = text.words.device
    B, S, patl = pc.batch, 8, pc.patl
    true_pos = rng.integers(0, text.n - patl, B)
    reads = codes[true_pos[:, None] + np.arange(patl)]
    hit = rng.random(reads.shape) < ERRPROB
    reads = np.where(hit, (reads + rng.integers(1, 4, reads.shape)) & 3,
                     reads).astype(np.uint8)
    rev = rng.random(B) < 0.5
    reads[rev] = 3 - reads[rev][:, ::-1]
    reads = torch.from_numpy(reads).to(dev)
    valid = torch.from_numpy(rng.random(B) < 0.97).to(dev)
    shift = SigConfig(index.seedl).bucket_shift_bits(index.bucket_bits)
    pos = rng.integers(0, text.n - patl, (B, S))
    pos[:, 0] = true_pos
    pos[0, 1:3] = [0, 16 * 1000]
    inv = rng.random((B, S)) < 0.5
    inv[:, 0] = rev
    words_s, words_r = pack_read_words(reads)
    return [(f"{pc.name}/probe_candidates",
             (index.sig, index.bb, compute_probes(reads, index.seedl), valid,
              shift, 4)),
            (f"{pc.name}/verify_windows",
             (text.words, torch.from_numpy(pos).to(dev),
              torch.from_numpy(inv).to(dev), words_s, words_r, patl,
              index.seedl))]


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


def _fused_pair(name: str):
    from real_tpu_torch.ops import gather
    if name.endswith("probe_candidates"):
        return gather.probe_candidates, gather.probe_candidates_ref
    return gather.verify_windows, gather.verify_windows_ref


def _outputs_err(torch, got, want) -> int:
    """Largest absolute difference over a fused entry's outputs; shapes
    and dtypes must agree."""
    err = 0
    for g, r in zip(got, want):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tuple(g.shape)} {g.dtype} != "
                                 f"{tuple(r.shape)} {r.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - r.to(torch.int64))
                               .abs().max()))
    return err


def fused_kernel_phase(torch, cases, totalkmax, dev):
    """probe_candidates and verify_windows against their plain versions
    at the paths' shapes and on the hand-made edge cases. Returns
    ({name: max_abs_err}, {name: the kernel's outputs})."""
    from real_tpu_torch.tools import fusedcases
    errs, outs = {}, {}
    for name, args in cases:
        fn, ref = _fused_pair(name)
        got = fn(*args)
        torch.cuda.synchronize()
        err = _outputs_err(torch, got, ref(*args))
        if name.endswith("probe_candidates"):
            what = (f"{args[2].numel()} probes, k1={args[5]}: "
                    f"{int(got[3].sum())} matching lanes, "
                    f"{int((got[1] > args[5]).sum())} deep buckets")
        else:
            kmax = totalkmax[name.split("/")[0]]
            what = (f"{args[1].numel()} lanes, kw={got[0].shape[0]}: "
                    f"{int((got[1][:, 0] <= kmax).sum())} of "
                    f"{got[1].shape[0]} true windows within k <= {kmax}, "
                    f"{int((got[1][:, 1:] <= kmax).sum())} others")
        log(f"[kernel] {name}: {what}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
        errs[name], outs[name] = err, got
    rng = np.random.default_rng(17)
    for k1 in (1, 2, 3, 4):
        sig, bb, shift = fusedcases.edge_tables(rng)
        probe, valid = fusedcases.edge_probes(rng, sig, 700)
        for nb in (700, 0):
            args = (*fusedcases.tensors((sig, bb, probe[:nb], valid[:nb]),
                                        dev), shift, k1)
            fn, ref = _fused_pair("probe_candidates")
            got = fn(*args)
            torch.cuda.synchronize()
            if _outputs_err(torch, got, ref(*args)):
                raise AssertionError(f"probe_candidates edge case k1={k1}")
    for patl in (16, 36, 50, 100, 256):
        arrays = fusedcases.verify_inputs(rng, 3000, 300, 8, patl)
        for nb in (300, 0):
            cut = [arrays[0]] + [a[:nb] for a in arrays[1:]]
            args = (*fusedcases.tensors(cut, dev), patl, min(32, patl))
            fn, ref = _fused_pair("verify_windows")
            got = fn(*args)
            torch.cuda.synchronize()
            if _outputs_err(torch, got, ref(*args)):
                raise AssertionError(f"verify_windows edge case patl={patl}")
    log("[kernel] probe_candidates edge cases bit-exact (k1 1..4: all-T "
        "probes on the sentinel range, bucket bounds at M-1, M, beyond, "
        "negative and descending, top-bit signatures, invalid reads, empty "
        "batch); verify_windows edge cases bit-exact (reads of 16, 36, 50, "
        "100, 256 bases: pos 0, pos % 16 == 0, the last text word, past "
        "the text end, both strands, empty batch)")
    return errs, outs


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


def run_once(cfg, reads_path, device, caps=None):
    """One timed pass of a path through its entry points: (read set,
    texts, result, record bytes, record count, phase seconds). `caps`
    overrides the candidate and survivor caps of the first pass."""
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
        result = driver.run_match_unique(cfg, rs, texts, device,
                                         cand_cap=caps, survivor_cap=caps)
    else:
        result = driver.run_match_all(cfg, rs, texts, device, cand_cap=caps,
                                      survivor_cap=caps, as_arrays=True)
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


def path_phase(torch, pc: PathCfg, g, r, r_warm, truth, dev):
    """Warmup, then the timed run with the kernel counts set to 0 just
    before it and read just after."""
    from real_tpu_torch.ops import gather
    tag = f"[{pc.name}]"
    cfg = path_config(pc, g, r)
    t = time.perf_counter()
    run_once(path_config(pc, g, r_warm), r_warm, dev)
    log(f"{tag} warmup run on {pc.batch} reads {time.perf_counter() - t:.2f}s")
    gather.reset_launch_counts()
    rs, texts, result, blob, records, ph = run_once(cfg, r, dev)
    torch.cuda.synchronize()
    launches = {"probe_candidates": gather.probe_candidates.launches,
                "verify_windows": gather.verify_windows.launches}
    reruns = dict(gather.gather_word_windows.launches_by_w)
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
    log(f"{tag} launches: {launches}; gather_windows in the overflow "
        f"reruns, by w: {reruns}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{pc.name} path made no {name} launch")
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


BISECT_CAPS = 32        # past the two-tier path's limit of 16 (driver.py)


def bisection_phase(torch, pc: PathCfg, cfg, r_warm, result, launches, dev):
    """The path's first batch once more with 4x caps. Every step then
    bisects its candidate ranges and fetches the bucket bounds through
    gather_windows: counts set to 0 just before, read just after, and the
    records must equal the timed run's for those reads."""
    from real_tpu_torch.ops import gather
    t = time.perf_counter()
    gather.reset_launch_counts()
    rs, texts, _, blob, records, _ = run_once(cfg, r_warm, dev,
                                              caps=BISECT_CAPS)
    torch.cuda.synchronize()
    by_w = dict(gather.gather_word_windows.launches_by_w)
    launches["gather_windows"] = by_w.get(2, 0)
    log(f"[{pc.name}] bisection pass on {pc.batch} reads (caps "
        f"{BISECT_CAPS}): gather_windows launches by w: {by_w}, "
        f"probe_candidates {gather.probe_candidates.launches}, "
        f"verify_windows {gather.verify_windows.launches}; {records} "
        f"records ({time.perf_counter() - t:.1f}s)")
    if launches["gather_windows"] <= 0:
        raise AssertionError(f"{pc.name}: the bisection pass made no "
                             "gather_windows launch")
    if records == 0 or blob != card_records(cfg, rs, texts, result, pc.batch):
        raise AssertionError(f"{pc.name}: the bisection pass's records "
                             "differ from the timed run's")


def card_records(cfg, rs, texts, result, n) -> bytes:
    """The records of a card run's first n reads, written against `rs`,
    a read set of just those reads."""
    from real_tpu_torch.cli.output import write_all_arrays, write_unique
    from real_tpu_torch.engine.driver import MatchResult
    buf = io.BytesIO()
    if cfg.match_unique:
        card = MatchResult(st=result.st[:n], pos=result.pos[:n],
                           frag=result.frag[:n], fileid=result.fileid[:n],
                           errs=result.errs[:n], score=result.score[:n])
        write_unique(buf, rs, card, texts, cfg.scores)
    else:
        write_all_arrays(buf, rs, [c[result.pid < n] for c in result.cols],
                         texts, cfg.scores)
    return buf.getvalue()


def unique_parity_phase(cfg, r_small, result):
    t = time.perf_counter()
    rs2, texts_cpu, res_cpu, blob_cpu, unique_cpu, _ = run_once(
        cfg, r_small, "cpu")
    if unique_cpu == 0 or blob_cpu != card_records(cfg, rs2, texts_cpu,
                                                   result, PARITY_READS):
        raise AssertionError("CPU records differ from the card's records")
    log(f"[parity] CPU run on {PARITY_READS} reads: {unique_cpu} records "
        f"byte-identical to the card's ({time.perf_counter() - t:.1f}s)")


def all_parity_phase(cfg, r_small, result):
    t = time.perf_counter()
    rs2, texts_cpu, _, blob_cpu, n_cpu, _ = run_once(cfg, r_small, "cpu")
    if n_cpu == 0 or blob_cpu != card_records(cfg, rs2, texts_cpu, result,
                                              PARITY_READS):
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


def _sector_bytes(torch, table_len, start, w) -> int:
    """32 B for every distinct 32 B sector under the w-word windows at
    `start` (words past the table end touch nothing)."""
    win = start.reshape(-1)[:, None] + torch.arange(w, device=start.device)
    return 32 * int(torch.unique(win[win < table_len] // 8).numel())


def _bound_bytes(torch, table, idx, w, out_words) -> int:
    """A window gather's bytes: each index read once, each output word
    written once, and every distinct table sector its windows touch."""
    start = idx.to(torch.int64).clamp(0, table.shape[0] - 1)
    return 4 * idx.numel() + 4 * out_words \
        + _sector_bytes(torch, table.shape[0], start, w)


def _probe_reads(torch, args, begin):
    """(bucket-table word indices [2, B, 12], real-end indices [12],
    signature window starts [B, 12]) that probe_candidates reads."""
    index_sig, index_bb, probe_sig, _, shift, _ = args
    M, nbuck = index_sig.shape[0] // 6, index_bb.shape[0] // 6
    lists = torch.arange(12, device=probe_sig.device) % 6
    bi = ((probe_sig >> shift) + lists * nbuck).clamp(0, 6 * nbuck - 1)
    start = begin.to(torch.int64).clamp(0, M - 1) + lists * M
    return torch.stack([bi, bi + 1]), lists * nbuck + nbuck - 1, start


def _probe_bound_bytes(torch, args, out) -> int:
    """probe_candidates' bytes: probes (8 B) and validity (1 B per read)
    in; begin, count, k1 lane signatures and k1 flags out; the distinct
    sectors of the bucket table and of the signature lists."""
    index_sig, index_bb, probe_sig, valid, _, k1 = args
    bounds, real_end, start = _probe_reads(torch, args, out[0])
    words = torch.cat([bounds.reshape(-1), real_end])
    bb_bytes = 32 * int(torch.unique(
        words[words < index_bb.shape[0]] // 8).numel())
    nprobe = probe_sig.numel()
    return 8 * nprobe + valid.numel() + nprobe * (8 + 5 * k1) + bb_bytes \
        + _sector_bytes(torch, index_sig.shape[0], start, k1)


def _verify_starts(torch, args):
    words, pos = args[0], args[1]
    return (pos >> 4).clamp(0, words.shape[0] - 1)


def _verify_bound_bytes(torch, args, out) -> int:
    """verify_windows' bytes: position (8 B) and strand (1 B) per lane and
    both strands' read words in; kw window words and two counts per lane
    out; the distinct sectors of the text."""
    words, pos, _, words_s, words_r = args[:5]
    kw = out[0].shape[0]
    return 9 * pos.numel() + 8 * (words_s.numel() + words_r.numel()) \
        + pos.numel() * (4 * kw + 8) \
        + _sector_bytes(torch, words.shape[0],
                        _verify_starts(torch, args), kw + 1)


def _select_chain(torch, table, starts, w):
    """One index_select that fetches the w-word windows at `starts` from
    the zero-padded table: the library's way to the same words."""
    padded = torch.cat([table, table.new_zeros(w)])
    win = (starts.reshape(-1)[:, None]
           + torch.arange(w, device=starts.device)).reshape(-1)
    return lambda: torch.index_select(padded, 0, win)


def times_phase(torch, sites, errs, fused, ferrs, fouts, launches_by_path,
                rcases, rerrs, rlaunches):
    from real_tpu_torch.ops.gather import (gather_word_windows,
                                           gather_word_windows_ref)
    from real_tpu_torch.ops.rowsum import gather_rowsum, gather_rowsum_ref
    from real_tpu_torch.tools.cudatime import time_ms
    from real_tpu_torch.tools.gatherbench import take_sum, window_index
    out = []

    def row(name, src, repl, launches, err, shape, bytes_moved, kern, plain,
            lib, lib_name, on_a_path=True, plain_launches=10):
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ms, ms_wall = time_ms(kern)
        plain_ms, plain_wall = time_ms(plain, launches=plain_launches)
        library_ms, library_wall = time_ms(lib)
        log(f"[times] {name}: {shape}, device us (host-inclusive us): "
            f"kernel {ms * 1e3:.2f} ({ms_wall * 1e3:.2f}), plain "
            f"{plain_ms * 1e3:.2f} ({plain_wall * 1e3:.2f}), {lib_name} "
            f"{library_ms * 1e3:.2f} ({library_wall * 1e3:.2f}), bound "
            f"{bound_ms * 1e3:.3f} ({bytes_moved} B), launches {launches}"
            + ("" if on_a_path else " (a shape no path runs any more)"))
        if on_a_path:
            out.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": int(launches),
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": library_ms, "host_ms": ms_wall})

    # the generic gather serves the bucket bounds (w = 2) of the bisection
    # pass; the other two shapes are timed for comparison with the fused
    # entries that took them over
    for name, table, idx, w in sites:
        path = name.split("/")[0]
        start = idx.to(torch.int64).clamp(0, table.shape[0] - 1)
        row(f"gather_windows/{name}_w{w}", GATHER_SRC, GATHER_REPLACES,
            launches_by_path[path]["gather_windows"] if w == 2 else 0,
            errs[name], f"n={idx.numel()} w={w} table={table.shape[0]} words",
            _bound_bytes(torch, table, idx, w, idx.numel() * w),
            lambda: gather_word_windows(table, idx, w),
            lambda: gather_word_windows_ref(table, idx, w),
            _select_chain(torch, table, start, w), "index_select",
            on_a_path=w == 2)
    for name, args in fused:
        path, entry = name.split("/")
        fn, ref = _fused_pair(name)
        if entry == "probe_candidates":
            bounds, real_end, start = _probe_reads(torch, args,
                                                   fouts[name][0])
            chain = (_select_chain(torch, args[1], bounds[0], 2),
                     lambda: torch.index_select(args[1], 0, real_end),
                     _select_chain(torch, args[0], start, args[5]))
            nbytes = _probe_bound_bytes(torch, args, fouts[name])
            shape = (f"n={args[2].numel()} probes k1={args[5]} tables="
                     f"{args[1].shape[0]}+{args[0].shape[0]} words")
        else:
            kw = fouts[name][0].shape[0]
            chain = (_select_chain(torch, args[0],
                                   _verify_starts(torch, args), kw + 1),)
            nbytes = _verify_bound_bytes(torch, args, fouts[name])
            shape = (f"n={args[1].numel()} lanes kw={kw} table="
                     f"{args[0].shape[0]} words")
        row(f"{entry}/{path}", GATHER_SRC, GATHER_REPLACES,
            launches_by_path[path][entry], ferrs[name], shape, nbytes,
            lambda: fn(*args), lambda: ref(*args),
            lambda: [f() for f in chain], "index_select chain",
            plain_launches=1)     # hundreds of small kernels per call
    for name, table, idx, w in rcases:
        if w != GATHERBENCH["w"]:
            continue
        win = window_index(idx, w)
        row(f"gather_rowsum/{name}", ROWSUM_SRC, ROWSUM_REPLACES,
            rlaunches[name.split("/")[0]], rerrs[name],
            f"n={idx.numel()} w={w} table={table.numel()} words",
            _bound_bytes(torch, table, idx, w, idx.numel()),
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

        sites, fused, big_table = [], [], None
        for pc, g, codes in ((unique, gu, codes_u), (yeast, ga, codes_a)):
            cfg = path_config(pc, g, ru)
            texts = driver.load_texts(cfg, dev)
            index = path_index(cfg, texts, pc.num_reads)
            rng = np.random.default_rng(pc.genome_seed)
            sites += site_inputs(torch, pc, texts[0].packed, index, rng)
            fused += fused_inputs(torch, pc, codes, texts[0].packed, index,
                                  rng)
            if pc.unique:
                big_table = index.sig        # 27,599,904 words, 110 MB
        errs = gather_kernel_phase(torch, sites, dev)
        ferrs, fouts = fused_kernel_phase(
            torch, fused, {pc.name: pc.totalkmax for pc in (unique, yeast)},
            dev)
        rcases = rowsum_cases(torch, big_table, dev)
        rerrs = rowsum_kernel_phase(torch, rcases, dev)

        # the yeast read set (a million Python objects) is made after the
        # matchUnique path, so that path's host phases run as before
        cfg_u, res_u, launches_u = path_phase(
            torch, unique, gu, ru, ru_warm, truth_u, dev)
        bisection_phase(torch, unique, cfg_u, ru_warm, res_u, launches_u, dev)
        unique_parity_phase(cfg_u, ru_small, res_u)
        del res_u, truth_u
        ra, ra_small, ra_warm, truth_a = make_reads(tmp, yeast, codes_a)
        cfg_a, res_a, launches_a = path_phase(
            torch, yeast, ga, ra, ra_warm, truth_a, dev)
        bisection_phase(torch, yeast, cfg_a, ra_warm, res_a, launches_a, dev)
        all_parity_phase(cfg_a, ra_small, res_a)
        del res_a, truth_a
        rlaunches = gatherbench_phase(big_table.numel())
        return times_phase(
            torch, sites, errs, fused, ferrs, fouts,
            {unique.name: launches_u, yeast.name: launches_a},
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
    log("kernels: gather_windows, probe_candidates, verify_windows, "
        "gather_rowsum")
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
