#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (real_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ranks N     # (i) and (j) alone, a card per
                                        # rank; (l) too on 2N cards or more
    python3 chip_smoke.py --cells       # (k)'s runs of a cell per card alone
    python3 chip_smoke.py --grch        # phase (m) alone

Drives the port's four paths through their entry points on CUDA, holds
every kernel of those paths (gather_windows, probe_candidates in its 32-bit
and its 64-bit entry, verify_windows, gather_rowsum) against its plain
PyTorch version, and holds every entry of the native host library
(native/readpack.cpp) against its plain NumPy version:

  matchUnique  bench.py's size: a 4.6 Mbp random genome (E. coli scale),
               100,000 reads x 100 bp, errprob 0.02, seed 12345, k <= 5,
               scores on, batch 8192
  matchAll     the yeast configuration (benchmarks/scale.py "yeast"): a
               12 Mbp random genome (seed 1202), 1,000,000 reads x 50 bp
               FASTA (errprob 0.02, seed 1203), k <= 3, scores on, default
               batch 32,768
  chr21        the chr21 configuration (benchmarks/scale.py "chr21"): a
               46.7 Mbp random genome (seed 2103), 1,000,000 reads x 75 bp
               FASTQ (errprob 0.02, seed 2104), k <= 4, matchUnique with
               scores, default batch 32,768; nothing cut. Run (a) as it
               comes (the planner decides shards and read residency), (b)
               in 3 forced shards with the reads streamed, (c) under a
               memory budget of ~4 GB that makes the planner split, (d) as
               (b) with a checkpoint, stopped after unit 1 and resumed, (e)
               with wide seeds (-l 48, -l 64) on the first 262,144 reads
  gatherbench  the gather micro-benchmark (tools/gatherbench.py) at its
               default size and with a 110 MB table

and then, outside every timed run above, the flags and modules around the
main path: (f) chr21 (a) through the CLI under -trace and -metrics, (h)
the matchUnique genome split over two .fa files of one -t directory, in
both modes, (i) the matchUnique path as two ranks sharing the card,
with and without -exchange, and (j) index shards across ranks: the
matchUnique, yeast matchAll, chr21 and chr21 -l 48 paths as mesh ranks
sharing the card (python -m real_tpu_torch.parallel.multihost -mesh),
(k) the in-process mesh: the same paths as one process driving a grid of
cells on the card (RealConfig.mesh_devices), and (l) ranks that each drive
such a mesh over their read slice (real_tpu's multi-host design): two
ranks sharing the card, two cells each (multihost.run_rank); then the
driver entry points of tools/graft_entry.py, and (m) the genome-scale
path:

  grch         benchmarks/scale.py "grch" (tools/gendata.py GRCH): a
               3,100,000,000 bp random genome in one FASTA of 24
               fragments (seed 55), 2,000,000 reads x 100 bp FASTA
               (errprob 0.02, seed 56), k <= 5, matchUnique with scores;
               nothing cut. The file splits into two sub-texts past 2^31
               bases, and the planner shards them beyond the card

With --ranks N it runs phases 1-2, the matchUnique data, phase (i) and the
matchUnique -shards 2 mesh of (j) alone, as N ranks on N cards (one each;
a 2 x 2 grid at N = 4); it needs N cards. On a machine of at least 2N
cards it then runs (l)'s matchUnique -shards 2 and chr21 -shards 2 as N
ranks, each meshing the cards multihost.rank_cells gives it (phase (i)
pins a card per rank there). With --cells it runs phases 1-2,
the matchUnique and chr21 paths on cuda:0 alone, then (k)'s runs of one
cell per card and the CLI's default mesh of every card against them, and
dryrun_multichip over every card; it needs more than one card. With
--grch it runs phases 1-2 and (m) alone, then (m)'s kernel times.

Phases:

  1. card       device name and `nvidia-smi` name/power limit
  2. build      nvcc builds csrc/gather_windows.cu (three entry points) and
                csrc/gather_rowsum.cu for sm_90a and the host compiler
                builds native/readpack.cpp, all at once (timed)
  3. data       both genomes and read sets from tools/simulate (timed;
                the yeast reads are made after phase 6)
  4. kernel     gather_windows bit-exact against gather_word_windows_ref at
                the three fetch shapes of each match path on its real
                tables; probe_candidates and verify_windows bit-exact
                against their plain versions at each path's batch shape on
                its real tables (simulated reads of both strands; the
                chr21 tables also at seedl 48 and 64, through the 64-bit
                entry) and on hand-made edge cases (all-T probes on the
                sentinel range, bucket bounds at M-1 and beyond, invalid
                reads, k1 1..4, and the same through the 64-bit entry at
                seedl 36, 48 and 64, where the all-T probe is the sentinel
                and half the signatures have the top bit set; windows in
                the last text word and past it, pos % 16 == 0, reads of
                16..256 bases); gather_rowsum bit-exact against
                gather_rowsum_ref
                at gatherbench's shape for w in 8, 1, 2, 4, 16 and on the
                matchUnique signature table (110 MB, past the 50 MB L2),
                with uint32 totals equal to take_sum's; then edge cases
                (idx < 0, = mw-1, >= mw, mw < w, top bit, int32 wrap, mw
                not a multiple of 4, windows that end at mw, a table base
                that is not 16 B aligned, w 1, 3, 5, 8, 16)
  5. unique     load -> run_match_unique -> write_unique through the
                native host entries (reads parsed anew, as with -R 0),
                warmup then timed; reads/s, phase seconds, overflow reruns,
                launches
                of probe_candidates and verify_windows (> 0), truth
                recall; then the first batch once more with 4x caps, which
                takes the bisection path: gather_windows launches (> 0),
                records byte-identical to the timed run's; then the read
                store (-R 1): seconds to write it and to load it again
     native     after each path's timed run, every native entry against
                its plain version on that path's own data, seconds of
                both: read parser and genome parser (arrays equal), row
                packer on the path's first plan, record formatter on the
                full result (bytes equal) and, for matchAll, radix_argsort3
                on the run's hit columns in sorted order and in a seeded
                shuffle (permutation equal to three stable argsorts)
  6. parity     the port on the CPU with the plain host versions
                (native_host off) over the first 2,048 reads: records
                byte-identical to the card's records for those reads
  7. matchall   load -> run_match_all(as_arrays=True) -> write_all_arrays,
                timed after a warmup on one batch-sized prefix; reads/s,
                records, phase seconds, overflow_rerun_reads,
                batch_hit_overflow_steps, launches of probe_candidates and
                verify_windows (> 0), truth share; then the bisection
                pass as in phase 5
  8. allparity  the port's matchAll on the CPU, plain host versions, over
                the first 2,048 reads:
                records byte-identical to the card's for those reads, and
                every matchUnique record of the same CPU run among them
  9. chr21      (a) warmup, then the timed default run with its [native]
                block and read store as in phase 5; the shard plan, units,
                the source's mode and the peak of
                torch.cuda.max_memory_allocated over the bytes live before
                the run, beside the card's total; truth share >= 0.95;
                launches of both fused entries > 0; a bisection pass. (b)
                -shards 3 with a resident-read budget of 1 byte: 3 units,
                93 streamed batches, records byte-identical to (a)'s. (c)
                -f chosen so that fracmem x total is ~4 GB: more than one
                shard planned, records byte-identical to (a)'s, peak at or
                under the budget. (d) (b) with -ckpt, stopped by an
                exception from a hook on the match step after unit 1, then
                run again: 1 unit skipped, (a)'s bytes. (d2) (c) with -ckpt,
                stopped after unit 1, then run under a -f of ~8 GB, which
                plans another shard count: the checkpoint is ignored with
                "fingerprint mismatch", no unit skipped, (a)'s bytes. (e)
                -l 48 and -l 64 on the first 262,144 reads: launches of
                the 64-bit probe_candidates entry > 0, truth share, and
                CPU parity (plain host versions) on the first 2,048 reads
 10. flags    (f) chr21 (a) through the CLI with -R 0, -trace and
                -metrics: records byte-identical to (a)'s; from the exported
                Chrome trace, the union of the kernel, memcpy and memset
                intervals over the traced window (the device busy share)
                and the kernels by device time, which must include
                probe_candidates and verify_windows; the metrics file's
                phase seconds and reads/s. (h) a -t directory of two .fa files holding the matchUnique
                genome's halves, both modes on the card (units, records,
                fileid 1 reached) and the port on the CPU with the plain
                host versions on the first 2,048 reads: records
                byte-identical. (i) the matchUnique path with -shards 3 as
                one CLI process and as two ranks of
                `python -m real_tpu_torch.parallel.multihost` on the card
                (gloo, a file store, -f halved, a timeout each), without
                and with -exchange: the rank-order concatenation
                byte-identical to the one process's records and to phase
                5's; each rank's card, seconds and metrics;
                torch.cuda.device_count(). (j) the mesh: ranks of
                `python -m real_tpu_torch.parallel.multihost -mesh` sharing
                the card (gloo, -f 0.75 / ranks per card, a timeout each):
                matchUnique -shards 1 as 2 ranks (a 2 x 1 grid), -shards
                2 as 4 ranks (2 x 2), -shards 4 as 2 ranks (1 x 2, two
                passes), yeast matchAll -shards 2, chr21 -shards 2 and
                chr21 -l 48 -shards 2 on the 262,144 wide reads as 2 ranks
                (1 x 2); each concatenation byte-identical to the one
                process's records of its path (phases 5, 7, 9 (a) and (e));
                every rank's card, grid coordinates, launches of
                probe_candidates (the 64-bit entry at -l 48) and
                verify_windows (> 0), wall_s, phase seconds with
                mesh_gather, and seconds from start to exit; beside the
                first run, whether gloo's all_gather takes CUDA tensors.
                (k) the in-process mesh: the driver with
                RealConfig.mesh_devices = ["cuda:0"] x n (one process, n
                cells sharing the card, -f 0.75): matchUnique -shards 1 on
                2 cells (2 x 1), -shards 2 on 4 (2 x 2), -shards 8 on 4
                (1 x 4, two passes), yeast matchAll, chr21 and chr21 -l 48
                -shards 2 on 2 cells (1 x 2); each run's records
                byte-identical to its path's one-device records, launches
                of probe_candidates (the 64-bit entry at -l 48) and
                verify_windows (> 0) on every cell, every card's peak
                under -f of it; wall_s, host ms per batch step,
                mesh_gather and the gathers beside the path's one-device
                run and (j)'s rank mesh of the grid; before them, no
                call of a matchUnique step, a matchAll step or a mesh row
                step may synchronize with the host (set_sync_debug_mode
                "error"). With more than one
                card also matchUnique -shards 4 and chr21 -shards 2 with
                a cell per card, and the CLI with no device flag (the
                default mesh of every card). (l) ranks that each drive a
                local mesh: two ranks of multihost.run_rank in processes
                of their own, each with RealConfig.mesh_devices =
                ["cuda:0"] x 2 over its read slice (gloo, -f 0.75 / 2, a
                timeout each): matchUnique -shards 1 (2 x 1 per rank) and
                -shards 2 (1 x 2), yeast matchAll, chr21 at full size and
                chr21 -l 48 on the 262,144 wide reads, each -shards 2 (1 x
                2); each concatenation byte-identical to its path's
                one-device records; every rank's cells, grid and launches
                of probe_candidates (the 64-bit entry at -l 48) and
                verify_windows (> 0) on every cell, each rank's peak per
                card under its -f; each rank's wall_s and seconds from
                start to exit beside (j)'s rank mesh and (k)'s in-process
                mesh of the grid
 11. graft      tools/graft_entry.py: entry()'s match step on cuda:0,
                its state equal to the same step's on the CPU;
                dryrun_multichip(1)
 12. grch       (m): host MemAvailable and free disk against what the
                phase needs (raises when short); the data from
                tools/gendata.py, timed; (m-a) python -m
                real_tpu_torch.cli.main -u 1 -q 1 -k 5 -metrics in a
                process of its own, nothing forced: two sub-texts, the
                plan per sub-text (shards, build mode, bucket bits,
                bisection steps), wall_s, reads/s and phase seconds, the
                process's peak device bytes under the -f 0.75 budget and
                its peak RSS, launches of gather_word_windows and
                verify_windows > 0; the truth from gendata.read_truth:
                reads with <= 2 seed and <= 5 mismatches reported unique
                at their fragment, position and strand, >= 0.999 overall,
                in sub-text #0 past base 2^30 and in sub-text #1; (m-b)
                load_texts, run_match_unique and write_unique in this
                process at the fewest -shards whose every unit skips
                bisection with room in its deep-probe slots
                (probe_route_shards): records byte-identical to (m-a)'s,
                launches of probe_candidates and verify_windows > 0; then
                on sub-text #0's last shard (past 2^30) of (m-a)'s plan
                gather_word_windows (the bucket bounds) and
                verify_windows, and of (m-b)'s probe_candidates, each
                bit-exact against its plain version on a batch of the
                reads of that shard, and one step's overflow share on
                each shard and at the fewest bisection-free count
 13. gatherbench  the tool's JSON line at both table sizes; the kernel's
                launches counted over each run
 14. times      each kernel at each main-path shape: kernel, plain version
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

import contextlib
import dataclasses
import gc
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
RANK_TIMEOUT_S = 300          # each subprocess of phase (i)
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
    fastq: bool = False
    seedl: int = 32


UNIQUE = PathCfg("unique", 4_600_000, 12345, 100_000, 100, 12346, 5, 8192,
                 True, 5)
YEAST = PathCfg("matchall", 12_000_000, 1202, 1_000_000, 50, 1203, 3, 32768,
                False, 3)
CHR21 = PathCfg("chr21", 46_700_000, 2103, 1_000_000, 75, 2104, 4, 32768,
                True, 4, fastq=True)
WIDE_SEEDLS = (48, 64)
WIDE_READS = 262_144
CHR21_BUDGET_BYTES = 4e9     # run (c): fracmem x the card's memory
CHR21_RESUME_BUDGET_BYTES = 8e9    # run (d2)'s resume: another plan
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
    from real_tpu_torch import native
    from real_tpu_torch.ops import cuda_build
    names = ("gather_windows", "gather_rowsum")

    def build_native():
        t = time.perf_counter()
        path = native.library_path()
        native.get_lib()
        return path, time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as ex:
        host = ex.submit(build_native)
        paths = list(ex.map(cuda_build.library_path, names))
        host_path, host_s = host.result()
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t:.2f}s (one nvcc per source, in parallel)")
    log(f"[native] {host_path.name} built from native/readpack.cpp and "
        f"loaded in {host_s:.2f}s")
    # ptxas -v, one line per kernel: registers and spill bytes
    for n in names:
        kernel = None
        for line in cuda_build.build_logs.get(n, "").splitlines():
            m = re.search(r"Compiling entry function '\w*?(\d+)([a-z_]+_kernel)"
                          r"(?:I(?:N\w+?(Sig\d+)E)?Li(\d+)E)?", line)
            if m:
                targs = ", ".join(g for g in m.group(3, 4) if g)
                kernel = m.group(2) + (f"<{targs}>" if targs else "")
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


def make_reads(tmp: str, pc: PathCfg, codes, extra=()):
    """(reads path, parity reads path, warmup reads path, one path per
    prefix length in `extra`, truth reads) of one path."""
    from real_tpu_torch.tools import simulate
    t = time.perf_counter()
    truth = simulate.generate_reads(codes, pc.num_reads, pc.patl, ERRPROB,
                                    pc.fastq, seed=pc.reads_seed)
    tr = time.perf_counter() - t
    paths = []
    ext = "fq" if pc.fastq else "fa"
    for tag, rows in (("reads", truth), ("parity", truth[:PARITY_READS]),
                      ("warmup", truth[:pc.batch]),
                      *((f"first{n}", truth[:n]) for n in extra)):
        paths.append(os.path.join(tmp, f"{pc.name}_{tag}.{ext}"))
        simulate.write_reads(rows, paths[-1], pc.fastq)
    log(f"[data] {pc.name}: {pc.num_reads} reads x {pc.patl} bp over "
        f"{pc.genome_n} bp in {time.perf_counter() - t:.1f}s "
        f"(generate_reads {tr:.1f}s)")
    return (*paths, truth)


def path_config(pc: PathCfg, g: str, r: str):
    from real_tpu_torch.config import RealConfig
    return RealConfig(textfilename=g, patternfilename=r, outputfilename="-",
                      batch_size=pc.batch, totalkmax=pc.totalkmax,
                      match_unique=pc.unique, seedl=pc.seedl)


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
        if g.numel() and not torch.equal(g, r):
            # 64-bit lanes can differ by more than an int64 holds
            err = max(err, 1, int((g.to(torch.int64) - r.to(torch.int64))
                                  .abs().clamp(max=2**62).max()))
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
    for seedl in (36, 48, 64):
        for k1 in (1, 2, 3, 4):
            sig, bb, shift = fusedcases.edge_tables_wide(rng, seedl)
            probe, valid = fusedcases.edge_probes_wide(rng, sig, 700, seedl)
            for nb in (700, 0):
                args = (*fusedcases.tensors(
                    (sig.reshape(-1), bb, probe[:nb], valid[:nb]), dev),
                    shift, k1)
                fn, ref = _fused_pair("probe_candidates")
                got = fn(*args)
                torch.cuda.synchronize()
                if got[2].dtype != torch.int64 \
                        or _outputs_err(torch, got, ref(*args)):
                    raise AssertionError("probe_candidates wide edge case "
                                         f"seedl={seedl} k1={k1}")
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
        "batch; the same through the 64-bit entry at seedl 36, 48 and 64, "
        "where half the seedl-64 signatures have the sign bit set); "
        "verify_windows edge cases bit-exact (reads of 16, 36, 50, "
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
    # the vector-load path: tables whose length is not a multiple of 4,
    # windows that end exactly at mw, a base that is not 16 B aligned (the
    # run-time instance), and a width without a template instance (5)
    for mw in (1001, 1002, 1003, 4096, 4097):
        for w in (1, 3, 4, 5, 8, 16):
            for shift in (0, 1):
                words = torch.from_numpy(rng.integers(
                    -2**31, 2**31, mw + shift, dtype=np.int64).astype(
                        np.int32)).to(dev)[shift:]
                idx = np.concatenate([
                    [mw - w - 1, mw - w, mw - w + 1, mw - 4, mw - 1, mw, 0],
                    rng.integers(-10, mw + 10, 633)])
                idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
                got = gather_rowsum(words, idx, w)
                torch.cuda.synchronize()
                if max_abs_err(torch, [got],
                               [gather_rowsum_ref(words, idx, w)]):
                    raise AssertionError(f"gather_rowsum edge case mw={mw} "
                                         f"w={w} base shift {shift}")
    log("[kernel] gather_rowsum edge cases bit-exact (idx < 0, = mw-1, "
        ">= mw, mw < w, top-bit words, int32 wraparound, mw % 4 of 0..3, "
        "windows ending at mw, unaligned table base, w of 1, 3, 4, 5, 8, 16)")
    return errs


def run_once(cfg, reads_path, device, caps=None):
    """One timed pass of a path through its entry points: (read set,
    texts, result, record bytes, record count, phase seconds). The reads
    are parsed anew (no read store), through the native host entries
    unless cfg.native_host is off. `caps` overrides the candidate and
    survivor caps of the first pass."""
    from real_tpu_torch.cli.output import write_all_arrays, write_unique
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import reads as reads_io
    import torch
    ph = {}
    on_card = torch.device(device).type == "cuda"
    cards = range(torch.cuda.device_count()) if on_card else ()
    if on_card:
        gc.collect()
        base = []
        for c in cards:
            torch.cuda.synchronize(c)
            base.append(torch.cuda.memory_allocated(c))
            torch.cuda.reset_peak_memory_stats(c)
    t0 = t = time.perf_counter()
    rs = reads_io.parse_reads(reads_path, use_native=cfg.native_host)
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
    if on_card:
        # device bytes of this run at their peak, over what was live
        # before, on each card (peak_bytes: the first card's)
        peaks = []
        for c in cards:
            torch.cuda.synchronize(c)
            peaks.append(torch.cuda.max_memory_allocated(c) - base[c])
        result.metrics["peak_bytes"] = peaks[0]
        result.metrics["peak_bytes_by_card"] = peaks
    ph["match"] = time.perf_counter() - t
    t = time.perf_counter()
    buf = io.BytesIO()
    if cfg.match_unique:
        records = write_unique(buf, rs, result, texts, cfg.scores,
                               cfg.native_host)
    else:
        records = write_all_arrays(buf, rs, result.cols, texts, cfg.scores,
                                   cfg.native_host)
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


# per path: the one-device timed run's wall seconds (match and output),
# match-phase (dispatch) seconds and batch steps, beside which phase (k)
# prints its runs
ONE_DEVICE = {}
# per phase (j) run: the ranks' metrics (with each rank's seconds from
# start to exit), beside which phases (k) and (l) print
RANK_MESH = {}
# per phase (k) run of one card: its wall seconds, beside which (l) prints
LOCAL_MESH = {}


def _batch_steps(cfg, rs, m, row_align=1) -> int:
    """Batch steps of a run: units dispatched x the batches of a pass."""
    from real_tpu_torch.io import pipeline
    return m["units_dispatched"] * len(pipeline.make_plans(
        rs, cfg.batch_size, cfg.seedl, row_align=row_align))


def _one_device(name, cfg, rs, result, ph) -> None:
    m = result.metrics
    ONE_DEVICE[name] = dict(wall_s=ph["match"] + ph["output"],
                            match_s=m["phase_s"]["match"],
                            steps=_batch_steps(cfg, rs, m))


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
    log(f"{tag} {run_account(torch, m)}")
    _one_device(pc.name, cfg, rs, result, ph)
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
    native_phase(pc, cfg, rs, texts, result, blob)
    store_phase(pc, r, rs)
    return cfg, result, launches, blob


def run_account(torch, m) -> str:
    """The unit loop's account of a run: plan, units, source, memory."""
    plans = ", ".join(
        f"{p['shards']} shard(s)" + (" serial" if p["serial_build"] else "")
        + f" cap {p['bucket_bits_cap']} bits" for p in m["plans"])
    return (f"plan: {plans}; units {m['units']} (dispatched "
            f"{m['units_dispatched']}, skipped {m['units_skipped']}); reads "
            f"{'resident' if m['source_resident'] else 'streamed'} "
            f"({m['resident_read_bytes']} B resident, "
            f"{m['streamed_batches']} streamed batches); planner reserved "
            f"{m['reserved_bytes']} B; peak device memory of the run "
            f"{m['peak_bytes']} B over the bytes live before it, card total "
            f"{torch.cuda.mem_get_info()[1]} B")


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def _same_reads(a, b) -> bool:
    return (a.fastq == b.fastq and a.quality_offset == b.quality_offset
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("lengths", "codes_flat", "offsets"))
            and np.array_equal(a.ids.blob, b.ids.blob)
            and np.array_equal(a.ids.off, b.ids.off))


def native_phase(pc: PathCfg, cfg, rs, texts, result, blob):
    """Every entry of the native host library against its plain version on
    this path's own data; seconds of both on one line each. `rs`, `result`
    and `blob` are the timed run's read set, result and record bytes."""
    from real_tpu_torch.cli.output import write_all_arrays, write_unique
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import fasta, pipeline, reads as reads_io
    tag = f"[native] {pc.name}:"

    def report(entry, what, nat_s, plain_s):
        log(f"{tag} {entry} ({what}): native {nat_s:.3f}s, plain "
            f"{plain_s:.3f}s, equal")

    r, g = cfg.patternfilename, cfg.textfilename
    nat, nat_s = _timed(lambda: reads_io.parse_reads(r))
    plain, plain_s = _timed(lambda: reads_io.parse_reads(r, use_native=False))
    if not (_same_reads(nat, plain) and _same_reads(nat, rs)):
        raise AssertionError(f"{pc.name}: native and plain read parsers "
                             "differ")
    report(("fastq" if rs.fastq else "fasta") + "_reads_count/fill",
           f"{os.path.getsize(r)} B, {nat.num_reads} reads", nat_s, plain_s)
    del nat, plain

    (codes_n, ranges_n), nat_s = _timed(lambda: fasta.parse_genome(g))
    (codes_p, ranges_p), plain_s = _timed(
        lambda: fasta.parse_genome(g, use_native=False))
    if not (np.array_equal(codes_n, codes_p) and ranges_n == ranges_p):
        raise AssertionError(f"{pc.name}: native and plain genome parsers "
                             "differ")
    report("genome_count/fill", f"{os.path.getsize(g)} B, {len(codes_n)} "
           "bases", nat_s, plain_s)
    del codes_n, codes_p

    plan = pipeline.make_plans(rs, cfg.batch_size, cfg.seedl)[0]
    nat, nat_s = _timed(lambda: pipeline._pack_host(rs, plan))
    plain, plain_s = _timed(
        lambda: pipeline._pack_host(rs, plan, use_native=False))
    if not all(np.array_equal(a, b) for a, b in zip(nat, plain)
               if a is not None):
        raise AssertionError(f"{pc.name}: native and plain row packers "
                             "differ")
    report("pack_rows_2bit", f"one plan, {plan.rows} rows x {plan.patl} bp",
           nat_s, plain_s)

    if not pc.unique:
        # the run's sorted order stands for the order the hits arrive in
        # (batches in read order), the shuffle for the worst case
        ident = np.arange(len(result.pid))
        perm = np.random.default_rng(pc.reads_seed).permutation(len(ident))
        for what, order in (("in sorted order", ident), ("shuffled", perm)):
            keys = driver._composite_keys(
                tuple(c[order] for c in result.cols))
            nat, nat_s = _timed(lambda: driver._radix_argsort3(*keys))
            plain, plain_s = _timed(lambda: driver._stable_argsort3(*keys))
            if not np.array_equal(nat, plain):
                raise AssertionError("radix_argsort3 is not the permutation "
                                     "of three stable argsorts")
            if not np.array_equal(order[nat], ident):
                raise AssertionError("radix_argsort3 does not restore the "
                                     "run's sorted order")
            report("radix_argsort3", f"{len(ident)} hits of the run, {what}",
                   nat_s, plain_s)

    buf = io.BytesIO()
    if pc.unique:
        _, plain_s = _timed(lambda: write_unique(
            buf, rs, result, texts, cfg.scores, use_native=False))
        _, nat_s = _timed(lambda: write_unique(
            io.BytesIO(), rs, result, texts, cfg.scores))
    else:
        _, plain_s = _timed(lambda: write_all_arrays(
            buf, rs, result.cols, texts, cfg.scores, use_native=False))
        _, nat_s = _timed(lambda: write_all_arrays(
            io.BytesIO(), rs, result.cols, texts, cfg.scores))
    if buf.getvalue() != blob:
        raise AssertionError(f"{pc.name}: native and plain formatters print "
                             "other bytes")
    nrec = blob.count(b"\n")
    report("format_records", f"{nrec} records, {len(blob)} B, two formatter "
           "threads", nat_s, plain_s)


def store_phase(pc: PathCfg, r, rs):
    """The read store (-R 1): one run that parses and writes it, one that
    loads it again; the loaded arrays must equal the parsed ones."""
    from real_tpu_torch.io import readstore
    first, write_s = _timed(lambda: readstore.parse_reads_cached(r))
    again, load_s = _timed(lambda: readstore.parse_reads_cached(r))
    if not isinstance(again.codes_flat, np.memmap):
        raise AssertionError(f"{pc.name}: the second run did not load the "
                             "read store")
    if not (_same_reads(first, rs) and _same_reads(again, rs)):
        raise AssertionError(f"{pc.name}: the read store holds other reads")
    log(f"[{pc.name}] read store (-R 1): parse and write {write_s:.3f}s, "
        f"reload {load_s:.3f}s ({pc.num_reads} reads)")


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
    """CPU run with the plain host versions against the card's records
    (written by the native formatter)."""
    t = time.perf_counter()
    rs2, texts_cpu, res_cpu, blob_cpu, unique_cpu, _ = run_once(
        dataclasses.replace(cfg, native_host=False), r_small, "cpu")
    if unique_cpu == 0 or blob_cpu != card_records(cfg, rs2, texts_cpu,
                                                   result, PARITY_READS):
        raise AssertionError("CPU records differ from the card's records")
    log(f"[parity] CPU run (plain host versions) on {PARITY_READS} reads: "
        f"{unique_cpu} records byte-identical to the card's "
        f"({time.perf_counter() - t:.1f}s)")


def all_parity_phase(cfg, r_small, result):
    """As unique_parity_phase, for matchAll; the CPU runs use the plain
    host versions (three stable argsorts, NumPy formatter)."""
    t = time.perf_counter()
    plain_cfg = dataclasses.replace(cfg, native_host=False)
    rs2, texts_cpu, _, blob_cpu, n_cpu, _ = run_once(plain_cfg, r_small,
                                                     "cpu")
    if n_cpu == 0 or blob_cpu != card_records(cfg, rs2, texts_cpu, result,
                                              PARITY_READS):
        raise AssertionError("CPU matchAll records differ from the card's")
    ucfg = dataclasses.replace(plain_cfg, match_unique=True)
    _, _, _, blob_u, n_u, _ = run_once(ucfg, r_small, "cpu")
    all_set = set(blob_cpu.splitlines())
    if n_u == 0 or not set(blob_u.splitlines()) <= all_set:
        raise AssertionError("a matchUnique record is missing from matchAll")
    log(f"[allparity] CPU run (plain host versions) on {PARITY_READS} "
        f"reads: {n_cpu} matchAll "
        f"records byte-identical to the card's; all {n_u} matchUnique "
        f"records among them ({time.perf_counter() - t:.1f}s)")


class _StopAfterUnit(Exception):
    """Raised by the hook that stops run (d) after its first unit."""


def _require_same_records(tag, blob, blob_a):
    if blob != blob_a:
        raise AssertionError(f"chr21 ({tag}): records differ from the "
                             "default run's")


def chr21_runs_phase(torch, pc: PathCfg, cfg, r, blob_a, tmp, dev):
    """Runs (b), (c), (d) and (d2) of the chr21 path against run (a)'s
    records."""
    from real_tpu_torch.ops import gather
    steps_per_unit = -(-pc.num_reads // pc.batch)

    # (b) three forced shards, reads streamed
    cfg_b = dataclasses.replace(cfg, index_shards=3, resident_reads_bytes=1)
    gather.reset_launch_counts()
    _, _, res, blob, records, ph = run_once(cfg_b, r, dev)
    m = res.metrics
    log(f"[chr21] (b) -shards 3, reads streamed: {ph['total']:.3f}s = "
        f"{pc.num_reads / ph['total']:.1f} reads/s ({records} records); "
        "phases: " + " ".join(f"{k}={v:.3f}s" for k, v in ph.items())
        + "; match phases: " + " ".join(
            f"{k}={v:.3f}s" for k, v in m["phase_s"].items()))
    log(f"[chr21] (b) {run_account(torch, m)}; launches probe_candidates "
        f"{gather.probe_candidates.launches}, verify_windows "
        f"{gather.verify_windows.launches}")
    if m["units_dispatched"] != 3 or m["source_resident"] \
            or m["streamed_batches"] < 3 * steps_per_unit:
        raise AssertionError("chr21 (b): not 3 units over a streaming source")
    _require_same_records("b", blob, blob_a)

    # (c) the planner under a budget that binds
    total = torch.cuda.mem_get_info()[1]
    fracmem = CHR21_BUDGET_BYTES / total
    _, _, res, blob, records, ph = run_once(
        dataclasses.replace(cfg, fracmem=fracmem), r, dev)
    m = res.metrics
    log(f"[chr21] (c) -f {fracmem:.5f} (budget {CHR21_BUDGET_BYTES:.0f} B of "
        f"{total}): {ph['total']:.3f}s = {pc.num_reads / ph['total']:.1f} "
        f"reads/s ({records} records); match phases: " + " ".join(
            f"{k}={v:.3f}s" for k, v in m["phase_s"].items()))
    log(f"[chr21] (c) {run_account(torch, m)}")
    if m["plans"][0]["shards"] <= 1 or m["units_dispatched"] != m["units"]:
        raise AssertionError("chr21 (c): the planner did not split")
    if m["peak_bytes"] > CHR21_BUDGET_BYTES:
        raise AssertionError(f"chr21 (c): peak {m['peak_bytes']} B over the "
                             f"budget of {CHR21_BUDGET_BYTES:.0f} B")
    _require_same_records("c", blob, blob_a)

    shards_c = m["plans"][0]["shards"]

    # (d) (b) with a checkpoint, stopped after unit 1, then resumed
    ckpt = os.path.join(tmp, "chr21.ckpt")
    cfg_d = dataclasses.replace(cfg_b, checkpoint=ckpt)
    steps = _stopped_after_unit(cfg_d, r, dev, steps_per_unit, "d")
    size = os.path.getsize(ckpt)
    _, _, res, blob, records, ph = run_once(cfg_d, r, dev)
    m = res.metrics
    log(f"[chr21] (d) stopped after unit 1 ({steps} steps, checkpoint "
        f"of {size} B), resumed: {m['units_skipped']} unit skipped, "
        f"{m['units_dispatched']} dispatched, {ph['total']:.3f}s "
        f"({records} records)")
    if m["units_skipped"] != 1 or m["units_dispatched"] != 2 \
            or os.path.exists(ckpt):
        raise AssertionError("chr21 (d): the resumed run did not skip "
                             "exactly unit 1 or left its checkpoint")
    _require_same_records("d", blob, blob_a)

    # (d2) stopped after unit 1 under (c)'s plan, resumed under a -f that
    # plans another shard count: the checkpoint is ignored, with a message
    ckpt = os.path.join(tmp, "chr21_plan.ckpt")
    _stopped_after_unit(dataclasses.replace(cfg, fracmem=fracmem,
                                            checkpoint=ckpt), r, dev,
                        steps_per_unit, "d2")
    fracmem2 = CHR21_RESUME_BUDGET_BYTES / total
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _, _, res, blob, records, ph = run_once(
            dataclasses.replace(cfg, fracmem=fracmem2, checkpoint=ckpt), r,
            dev)
    m = res.metrics
    mismatch = "fingerprint mismatch" in err.getvalue()
    log(f"[chr21] (d2) stopped after unit 1 under -f {fracmem:.5f} "
        f"({shards_c} shards), resumed under -f {fracmem2:.5f} "
        f"({m['plans'][0]['shards']} shards): 'fingerprint mismatch' "
        f"{'printed' if mismatch else 'NOT printed'}, {m['units_skipped']} "
        f"units skipped, {m['units_dispatched']} dispatched, "
        f"{ph['total']:.3f}s ({records} records)")
    if m["plans"][0]["shards"] == shards_c:
        raise AssertionError("chr21 (d2): the resumed run planned the same "
                             "shard count")
    if not mismatch or m["units_skipped"] != 0 or os.path.exists(ckpt):
        raise AssertionError("chr21 (d2): the checkpoint of another plan "
                             "was not ignored")
    _require_same_records("d2", blob, blob_a)


def _stopped_after_unit(cfg, r, dev, steps_per_unit, tag) -> int:
    """A run stopped by an exception from a hook on the match step after
    its first unit, with the checkpoint of that unit on disk; returns the
    steps it ran."""
    from real_tpu_torch.engine import driver
    real_step, calls = driver.match_step, [0]

    def stopping_step(*a, **kw):
        calls[0] += 1
        if calls[0] > steps_per_unit:
            raise _StopAfterUnit()
        return real_step(*a, **kw)
    driver.match_step = stopping_step
    try:
        run_once(cfg, r, dev)
    except _StopAfterUnit:
        pass
    else:
        raise AssertionError(f"chr21 ({tag}): the hook did not stop the run")
    finally:
        driver.match_step = real_step
    if not os.path.exists(cfg.checkpoint):
        raise AssertionError(f"chr21 ({tag}): no checkpoint after unit 1")
    return calls[0] - 1


def chr21_wide_phase(torch, pc: PathCfg, g, r_wide, r_small, truth, dev):
    """Run (e): -l 48 and -l 64 on the first WIDE_READS reads; launches of
    the 64-bit entry, truth share, CPU parity on PARITY_READS reads.
    Returns ({path name: launches}, {seedl: record bytes})."""
    from real_tpu_torch.ops import gather
    launches, blobs = {}, {}
    for seedl in WIDE_SEEDLS:
        wpc = dataclasses.replace(pc, name=f"chr21_l{seedl}", seedl=seedl,
                                  num_reads=WIDE_READS)
        cfg = path_config(wpc, g, r_wide)
        gather.reset_launch_counts()
        rs, texts, res, blobs[seedl], records, ph = run_once(cfg, r_wide, dev)
        launches[wpc.name] = {
            "probe_candidates": gather.probe_candidates.launches_wide,
            "verify_windows": gather.verify_windows.launches}
        share = truth_share(wpc, res, truth[:WIDE_READS])
        _one_device(wpc.name, cfg, rs, res, ph)
        log(f"[chr21] (e) -l {seedl}: {WIDE_READS} reads in "
            f"{ph['total']:.3f}s ({records} records); match phases: "
            + " ".join(f"{k}={v:.3f}s" for k, v in
                       res.metrics["phase_s"].items())
            + f"; launches of the 64-bit probe_candidates entry "
            f"{gather.probe_candidates.launches_wide} of "
            f"{gather.probe_candidates.launches}, verify_windows "
            f"{gather.verify_windows.launches}; truth share {share:.5f}; "
            f"overflow_rerun_reads {res.metrics['overflow_rerun_reads']}")
        if gather.probe_candidates.launches_wide <= 0 \
                or gather.probe_candidates.launches_wide \
                != gather.probe_candidates.launches:
            raise AssertionError(f"chr21 -l {seedl}: the probes did not all "
                                 "go through the 64-bit entry")
        if share < 0.5 or records == 0:
            raise AssertionError(f"chr21 -l {seedl}: truth share {share}")
        t = time.perf_counter()
        rs2, texts_cpu, _, blob_cpu, n_cpu, _ = run_once(
            dataclasses.replace(cfg, native_host=False), r_small, "cpu")
        if n_cpu == 0 or blob_cpu != card_records(cfg, rs2, texts_cpu, res,
                                                  PARITY_READS):
            raise AssertionError(f"chr21 -l {seedl}: CPU records differ from "
                                 "the card's")
        log(f"[chr21] (e) -l {seedl}: CPU run (plain host versions) on "
            f"{PARITY_READS} reads: {n_cpu} records byte-identical to the "
            f"card's ({time.perf_counter() - t:.1f}s)")
    return launches, blobs


def _busy_union(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def trace_report(path: str, top: int = 8):
    """(busy us, window us, the top kernels as [(name, us, calls)], and
    {name: (us, calls)} of every kernel) of a Chrome trace exported by
    torch.profiler: busy is the union of the card's kernel, memcpy and
    memset intervals, the window the span of every timed event."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    window = max(float(e["ts"]) + float(e["dur"]) for e in events) \
        - min(float(e["ts"]) for e in events)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            us, calls = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (us + float(e["dur"]), calls + 1)
    kernels = sorted(((n, us, c) for n, (us, c) in by_name.items()),
                     key=lambda x: -x[1])
    return _busy_union(device), window, kernels[:top], by_name


def traced_phase(pc: PathCfg, g, r, blob_a, tmp):
    """(f) run (a) through the CLI under -trace and -metrics."""
    import glob
    from real_tpu_torch.cli import main as cli
    tdir = os.path.join(tmp, "trace")
    out = os.path.join(tmp, "chr21_traced.txt")
    mpath = os.path.join(tmp, "chr21_traced.json")
    t = time.perf_counter()
    cli.main(["-t", g, "-p", r, "-o", out, "-R", "0", "-B", str(pc.batch),
              "-e", str(pc.totalkmax), "-trace", tdir, "-metrics", mpath])
    wall = time.perf_counter() - t
    with open(out, "rb") as f:
        if f.read() != blob_a:
            raise AssertionError("chr21 (f): traced records differ from "
                                 "(a)'s")
    files = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"chr21 (f): {len(files)} trace files")
    t = time.perf_counter()
    busy, window, kernels, by_name = trace_report(files[0])
    log(f"[trace] chr21 (a): device busy {busy / 1e6:.4f} s of "
        f"{window / 1e6:.4f} s ({busy / window:.4f}); CLI run under the "
        f"profiler {wall:.2f}s, trace {os.path.getsize(files[0])} B read in "
        f"{time.perf_counter() - t:.2f}s")
    for name, us, calls in kernels:
        log(f"[trace]   {us / 1e3:9.3f} ms  {calls:6d} calls  {name[:110]}")
    for want in ("probe_candidates_kernel", "verify_windows_kernel"):
        if not any(want in n for n in by_name):
            raise AssertionError(f"chr21 (f): no {want} in the trace")
    with open(mpath) as f:
        m = json.load(f)
    log(f"[trace] chr21 (a) -metrics: phase_s {m['phase_s']}, wall_s "
        f"{m['wall_s']}, reads_per_sec {m['reads_per_sec']}, mode "
        f"{m['mode']}, native_paths_active {m['native_paths_active']}")


def two_text_phase(torch, pc: PathCfg, codes, r, r_small, tmp, dev):
    """(h) the genome's halves as two .fa files of one directory, both
    modes on the card, against the port on the CPU on PARITY_READS
    reads."""
    from real_tpu_torch.ops import gather
    d = os.path.join(tmp, "two_texts")
    os.makedirs(d)
    seq = np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes().decode()
    half = len(seq) // 2
    for i, part in enumerate((seq[:half], seq[half:])):
        with open(os.path.join(d, f"part{i}.fa"), "w") as f:
            f.write(f">{pc.name}_part{i}\n")
            f.write("\n".join(part[j:j + 60]
                              for j in range(0, len(part), 60)) + "\n")
    for unique in (True, False):
        mode = "matchUnique" if unique else "matchAll"
        cfg = dataclasses.replace(path_config(pc, d, r), match_unique=unique)
        gather.reset_launch_counts()
        _, texts, res, _, records, ph = run_once(cfg, r, dev)
        fid = res.fileid[np.isin(res.st, (1, 2))] if unique else res.fileid
        m = res.metrics
        log(f"[twotexts] {mode}: {len(texts)} texts, units "
            f"{m['units_dispatched']}, {records} records ({int((fid == 1).sum())}"
            f" in file 1) in {ph['total']:.3f}s; launches probe_candidates "
            f"{gather.probe_candidates.launches}, verify_windows "
            f"{gather.verify_windows.launches}")
        if len(texts) != 2 or m["units_dispatched"] != 2 \
                or not (fid == 1).any() or not (fid == 0).any() \
                or gather.probe_candidates.launches <= 0:
            raise AssertionError(f"{mode} (h): the two texts were not both "
                                 "matched on the card")
        t = time.perf_counter()
        rs2, texts_cpu, _, blob_cpu, n_cpu, _ = run_once(
            dataclasses.replace(cfg, native_host=False), r_small, "cpu")
        if n_cpu == 0 or blob_cpu != card_records(cfg, rs2, texts_cpu, res,
                                                  PARITY_READS):
            raise AssertionError(f"{mode} (h): CPU records differ from the "
                                 "card's")
        log(f"[twotexts] {mode}: CPU run (plain host versions) on "
            f"{PARITY_READS} reads: {n_cpu} records byte-identical to the "
            f"card's ({time.perf_counter() - t:.1f}s)")


def _subprocesses(cmds, tag, tmp):
    """Run the commands at once from the repository root, each with a
    timeout and its output in a file; any non-zero exit fails. Returns
    each one's wall seconds."""
    env = dict(os.environ, PYTHONPATH=REPO)
    logs = [os.path.join(tmp, f"{tag.replace(' ', '_')}.{i}.log")
            for i in range(len(cmds))]
    t0 = time.perf_counter()
    procs = []
    secs = []
    try:
        for c, path in zip(cmds, logs):
            with open(path, "wb") as f:
                procs.append(subprocess.Popen(c, cwd=REPO, env=env,
                                              stdout=f,
                                              stderr=subprocess.STDOUT))
        for p, path in zip(procs, logs):
            p.wait(timeout=RANK_TIMEOUT_S)
            secs.append(time.perf_counter() - t0)
            if p.returncode != 0:
                with open(path, "rb") as f:
                    raise AssertionError(f"{tag}: exit {p.returncode}:\n"
                                         + f.read().decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return secs


def ranks_phase(torch, pc: PathCfg, g, r, blob, tmp, world=2):
    """(i) the path with -shards 3 as one CLI process and as `world` ranks,
    without and with -exchange: rank R on card R % device_count, so that
    ranks share the card of a one-card machine and each has its own on a
    machine of `world` cards. `blob`: the records the one process must
    print (None: nothing to hold it to). Returns the one process's
    records."""
    cards = torch.cuda.device_count()
    base = ["-t", g, "-p", r, "-R", "0", "-B", str(pc.batch),
            "-e", str(pc.totalkmax), "-shards", "3"]
    # a rank with several cards of its own would mesh them (phase (l)),
    # and such a mesh refuses -exchange: there each rank pins its card
    pin = cards >= 2 * world
    single = os.path.join(tmp, "one.txt")
    (wall,) = _subprocesses(
        [[sys.executable, "-m", "real_tpu_torch.cli.main", *base,
          "-o", single, "-metrics", single + ".json"]], "one process", tmp)
    with open(single, "rb") as f:
        one = f.read()
    with open(single + ".json") as f:
        m = json.load(f)
    if blob is not None and one != blob:
        raise AssertionError(f"{pc.name} (i): the one-process -shards 3 "
                             "records differ from the timed run's")
    records = one.count(b"\n")
    log(f"[ranks] {pc.name} -shards 3, one process: {wall:.2f}s wall "
        f"(start to exit), wall_s {m['wall_s']} (match + output), phase_s "
        f"{m['phase_s']}; torch.cuda.device_count() {cards}")
    for exchange in (False, True):
        tag = f"{world} ranks{' -exchange' if exchange else ''}"
        out = os.path.join(tmp, f"ranks{int(exchange)}.txt")
        xdir = os.path.join(tmp, "exchange")
        extra = ["-exchange", xdir] if exchange else []
        store = os.path.join(tmp, f"store{int(exchange)}")
        secs = _subprocesses(
            [[sys.executable, "-m", "real_tpu_torch.parallel.multihost",
              "-init_method", f"file://{store}", "-world", str(world),
              "-rank", str(rank), *base,
              # ranks that share a card share its memory
              "-f", str(0.75 / -(-world // cards)), "-o", out,
              "-metrics", out + ".json", *extra]
             + (["-device", f"cuda:{rank % cards}"] if pin else [])
             for rank in range(world)],
            tag, tmp)
        merged = b""
        for rank in range(world):
            with open(f"{out}.{rank}", "rb") as f:
                merged += f.read()
        if merged != one:
            raise AssertionError(f"{pc.name} (i) {tag}: the rank-order "
                                 "concatenation differs from one process's")
        for rank in range(world):
            with open(f"{out}.json.{rank}") as f:
                m = json.load(f)
            if ("index_load" in m["phase_s"]) != exchange:
                raise AssertionError(f"{tag}: rank {rank} did not load "
                                     "its shards from the exchange")
            with open(os.path.join(tmp, f"{tag.replace(' ', '_')}.{rank}"
                                   ".log")) as f:
                card = re.search(r"^rank \d+ of \d+: device (\S+)$",
                                 f.read(), re.M).group(1)
            if card != f"cuda:{rank % cards}":
                raise AssertionError(f"{tag}: rank {rank} ran on {card}")
            log(f"[ranks] {pc.name} {tag}, rank {rank} on {card}: "
                f"{m['num_reads']} reads, {secs[rank]:.2f}s wall (start to "
                f"exit), wall_s {m['wall_s']}, phase_s {m['phase_s']}")
        if exchange:
            nbytes = sum(os.path.getsize(os.path.join(xdir, f))
                         for f in os.listdir(xdir))
            log(f"[ranks] exchange directory: {len(os.listdir(xdir))} "
                f"files, {nbytes} B")
        log(f"[ranks] {pc.name} {tag}: concatenation byte-identical to "
            f"the one process's {records} records")
    return one


def gloo_cuda_probe(torch, tmp):
    """Started at once, read by gloo_cuda_report: whether gloo's
    all_gather takes CUDA tensors in this torch, asked of a one-rank group
    in a process of its own. Nothing switches on the answer: the mesh
    stages its gather through pinned host memory either way."""
    code = (
        "import os, sys, torch, torch.distributed as dist\n"
        "dist.init_process_group('gloo', init_method='file://' + "
        "sys.argv[1], world_size=1, rank=0)\n"
        "x = torch.arange(4, dtype=torch.int32, device='cuda')\n"
        "out = [torch.empty_like(x)]\n"
        "dist.all_gather(out, x)\n"
        "torch.cuda.synchronize()\n"
        "print('gathered', out[0].device, out[0].tolist())\n"
        "dist.destroy_process_group()\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, os.path.join(tmp, "gloo_probe.store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def gloo_cuda_report(torch, proc):
    try:
        text, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        proc.kill()
        proc.wait()
    last = (text.strip().splitlines() or [""])[-1][:300]
    log(f"[mesh] gloo all_gather on CUDA tensors, torch {torch.__version__}: "
        + (f"takes them ({last})" if proc.returncode == 0
           else f"refuses them (exit {proc.returncode}: {last})"))


def mesh_run(torch, tag, pc: PathCfg, g, r, shards, world, want, tmp):
    """(j) one mesh run: `world` ranks of `python -m
    real_tpu_torch.parallel.multihost -mesh` on the card(s), -shards
    `shards`; the rank-order concatenation must be `want`, every rank must
    report its card, its grid coordinates and launches of both fused
    entries (the 64-bit one for wide seeds). Returns the ranks' metrics."""
    from real_tpu_torch.parallel import plan
    cards = torch.cuda.device_count()
    n_dp, n_shard = plan.choose_mesh_shape(world, shards)
    slug = tag.replace(" ", "_")
    out = os.path.join(tmp, f"mesh_{slug}.txt")
    secs = _subprocesses(
        [[sys.executable, "-m", "real_tpu_torch.parallel.multihost",
          "-init_method", f"file://{os.path.join(tmp, slug + '.store')}",
          "-world", str(world), "-rank", str(rank), "-mesh",
          "-t", g, "-p", r, "-R", "0", "-B", str(pc.batch),
          "-e", str(pc.totalkmax), "-u", str(int(pc.unique)),
          "-l", str(pc.seedl), "-shards", str(shards),
          # ranks that share a card share its memory
          "-f", str(0.75 / -(-world // cards)), "-o", out,
          "-metrics", out + ".json"] for rank in range(world)],
        f"mesh {slug}", tmp)
    merged = b""
    for rank in range(world):
        with open(f"{out}.{rank}", "rb") as f:
            merged += f.read()
    if merged != want:
        raise AssertionError(f"(j) {tag}: the rank-order concatenation "
                             "differs from the one process's records")
    metrics = []
    for rank in range(world):
        with open(f"{out}.json.{rank}") as f:
            m = json.load(f)
        with open(os.path.join(tmp, f"mesh_{slug}.{rank}.log")) as f:
            card = re.search(r"^rank \d+ of \d+: device (\S+)$", f.read(),
                             re.M).group(1)
        k = m["kernel_launches"]
        gather_ms = m["phase_s"]["mesh_gather"] / max(m["mesh_gathers"], 1) \
            * 1e3
        log(f"[mesh] {tag}, rank {rank} (dp {m['mesh']['dp']}, shard "
            f"{m['mesh']['shard']}) on {card}: {m['num_reads']} reads, "
            f"units {m['units_dispatched']}, launches probe_candidates "
            f"{k['probe_candidates']} (64-bit {k['probe_candidates_wide']}),"
            f" verify_windows {k['verify_windows']}, gather_word_windows "
            f"{k['gather_word_windows']}; {m['mesh_gathers']} gathers, "
            f"{gather_ms:.3f} ms each; {secs[rank]:.2f}s start to exit, "
            f"wall_s {m['wall_s']}, phase_s {m['phase_s']}")
        if card != f"cuda:{rank % cards}":
            raise AssertionError(f"(j) {tag}: rank {rank} ran on {card}")
        if m["mesh"] != {"n_dp": n_dp, "n_shard": n_shard,
                         "dp": rank // n_shard, "shard": rank % n_shard}:
            raise AssertionError(f"(j) {tag}: rank {rank} at {m['mesh']}")
        if k["probe_candidates"] <= 0 or k["verify_windows"] <= 0 \
                or (pc.seedl > 32) != (k["probe_candidates_wide"] > 0):
            raise AssertionError(f"(j) {tag}: rank {rank} did not launch "
                                 "the fused kernels")
        m["start_to_exit_s"] = secs[rank]
        metrics.append(m)
    records = merged.count(b"\n")
    log(f"[mesh] {tag}: {n_dp} x {n_shard} grid, {world} ranks on {cards} "
        f"card(s), concatenation byte-identical to the one process's "
        f"{records} records")
    RANK_MESH[(pc.name, n_dp, n_shard)] = metrics
    return metrics


def mesh_phase(torch, runs, tmp):
    """(j) the mesh path: each of `runs` = (tag, path, genome, reads,
    -shards, ranks, the one process's records) through mesh_run, with the
    gloo probe alongside the first."""
    probe = gloo_cuda_probe(torch, tmp)
    for i, (tag, pc, g, r, shards, world, want) in enumerate(runs):
        mesh_run(torch, tag, pc, g, r, shards, world, want, tmp)
        if i == 0:
            gloo_cuda_report(torch, probe)


def local_mesh_run(torch, tag, pc: PathCfg, g, r, shards, cells, want):
    """(k) one in-process mesh run through the driver's entry points, the
    cells cfg.mesh_devices = `cells`, -shards `shards`: its records must be
    `want` (the path's one-device bytes), every cell must launch both
    fused entries (the 64-bit one for wide seeds) and every card's peak
    must stay under -f of it. Prints wall_s, host ms per batch step,
    mesh_gather and the gathers beside the path's one-device run and
    phase (j)'s rank mesh of the same grid."""
    from real_tpu_torch.parallel import plan
    cfg = dataclasses.replace(path_config(pc, g, r), index_shards=shards,
                              mesh_devices=list(cells))
    n_dp, n_shard = plan.choose_mesh_shape(len(cells), shards)
    rs, _, res, blob, records, ph = run_once(cfg, r, "cuda")
    if blob != want:
        raise AssertionError(f"(k) {tag}: records differ from the path's "
                             "one-device records")
    m = res.metrics
    mesh = m["mesh"]
    if mesh["grids"] != [[0, n_dp, n_shard]] \
            or mesh["devices"] != [str(c) for c in cells]:
        raise AssertionError(f"(k) {tag}: ran on {mesh}")
    for c, k in enumerate(mesh["cell_launches"]):
        if k["probe_candidates"] <= 0 or k["verify_windows"] <= 0 \
                or (pc.seedl > 32) != (k["probe_candidates_wide"] > 0):
            raise AssertionError(f"(k) {tag}: cell {c} did not launch the "
                                 f"fused kernels ({k})")
    for card, peak in enumerate(m["peak_bytes_by_card"]):
        budget = cfg.fracmem * torch.cuda.mem_get_info(card)[1]
        if peak > budget:
            raise AssertionError(f"(k) {tag}: cuda:{card} peak {peak} B over "
                                 f"-f {cfg.fracmem} = {budget:.0f} B")
    steps = _batch_steps(cfg, rs, m, len(cells))
    gathers = m["mesh_gathers"]
    gather_s = m["phase_s"]["mesh_gather"]
    wall = ph["match"] + ph["output"]
    log(f"[localmesh] {tag}: {n_dp} x {n_shard} grid on "
        f"{', '.join(mesh['devices'])}; {records} records byte-identical to "
        f"the one-device run's; wall_s {wall:.3f} (match + output), units "
        f"{m['units_dispatched']}, {steps} batch steps, host "
        f"{m['phase_s']['match'] / max(steps, 1) * 1e3:.3f} ms per batch "
        f"step, mesh_gather {gather_s:.4f}s over {gathers} gathers "
        f"({gather_s / max(gathers, 1) * 1e3:.4f} ms each); peak by card "
        f"{m['peak_bytes_by_card']} B; phase_s "
        + " ".join(f"{k}={v:.3f}s" for k, v in m["phase_s"].items()))
    log(f"[localmesh] {tag}: cell launches " + "; ".join(
        f"{c}: probe_candidates {k['probe_candidates']} (64-bit "
        f"{k['probe_candidates_wide']}), verify_windows "
        f"{k['verify_windows']}, gather_word_windows "
        f"{k['gather_word_windows']}" for c, k in
        enumerate(mesh["cell_launches"])))
    if len(set(mesh["devices"])) == 1:
        LOCAL_MESH[(pc.name, n_dp, n_shard)] = wall
    one = ONE_DEVICE.get(pc.name)
    if one is not None:
        log(f"[localmesh] {tag}: one-device run of the path: wall_s "
            f"{one['wall_s']:.3f}, {one['steps']} batch steps, host "
            f"{one['match_s'] / max(one['steps'], 1) * 1e3:.3f} ms per "
            "batch step")
    ranks = RANK_MESH.get((pc.name, n_dp, n_shard))
    if ranks is not None:
        log(f"[localmesh] {tag}: phase (j) rank mesh of the grid: wall_s "
            f"{[x['wall_s'] for x in ranks]}, mesh_gather "
            f"{[x['phase_s']['mesh_gather'] for x in ranks]} s over "
            f"{[x['mesh_gathers'] for x in ranks]} gathers, match "
            f"{[x['phase_s']['match'] for x in ranks]} s")
    return m


def cli_default_mesh(torch, pc: PathCfg, g, r, want, tmp):
    """(k) on a machine of several cards: the CLI with no device flag
    meshes every card, and prints the one-device bytes."""
    cards = torch.cuda.device_count()
    out = os.path.join(tmp, "cli_default.txt")
    (wall,) = _subprocesses(
        [[sys.executable, "-m", "real_tpu_torch.cli.main", "-t", g, "-p", r,
          "-o", out, "-R", "0", "-B", str(pc.batch), "-e",
          str(pc.totalkmax), "-metrics", out + ".json"]], "cli default", tmp)
    with open(out, "rb") as f:
        if f.read() != want:
            raise AssertionError("(k) the CLI's default mesh printed other "
                                 "records than one device")
    with open(out + ".json") as f:
        m = json.load(f)
    mesh = m["mesh"]
    if mesh["devices"] != [f"cuda:{i}" for i in range(cards)]:
        raise AssertionError(f"(k) the CLI's default ran on {mesh}")
    for c, k in enumerate(mesh["cell_launches"]):
        if k["probe_candidates"] <= 0 or k["verify_windows"] <= 0:
            raise AssertionError(f"(k) CLI default: cell {c} did not launch "
                                 f"the fused kernels ({k})")
    log(f"[localmesh] CLI with no device flag on {cards} cards: grids "
        f"{mesh['grids']}, records byte-identical to one device's; "
        f"{wall:.2f}s start to exit, wall_s {m['wall_s']}, mesh_gathers "
        f"{m['mesh_gathers']}, phase_s {m['phase_s']}")


def step_sync_check(torch, pc: PathCfg, g, r):
    """(k) a match step never waits for the card: one matchUnique step, one
    matchAll step and one row of a 1 x 2 in-process mesh on the path's
    first batch, each run once and then again under
    torch.cuda.set_sync_debug_mode("error"), which raises at any call that
    synchronizes with the host. Cells on separate cards overlap only if
    their steps do not wait."""
    import traceback
    from real_tpu_torch.engine import driver, matchstep
    from real_tpu_torch.index.build import shard_windows
    from real_tpu_torch.io import pipeline, reads as reads_io
    from real_tpu_torch.parallel import mesh
    cfg = path_config(pc, g, r)
    rs = reads_io.parse_reads(r)
    text = driver.load_texts(cfg, "cuda")[0].packed
    index = path_index(cfg, [driver.TextFile("t", text)], rs.num_reads)
    b = next(iter(pipeline.make_source(rs, cfg.batch_size, cfg.seedl,
                                       "cuda")))
    kw = dict(driver._step_kwargs(cfg, cfg.cand_cap, cfg.survivor_cap),
              text_has_n=text.has_n)
    eps = cfg.filter_value(b.patl)
    args = (index.sig, index.pos, index.bb, text.words, text.nbits,
            text.ncum, text.frag_offsets, b.codes, b.quals, b.valid)
    m = mesh.make_local_mesh(1, 2, ["cuda:0"] * 2)
    reps = mesh.replicate_text(text, m.devices)
    shards = mesh.build_local_shards(
        reps, cfg.seedl, 0, shard_windows(text.n - cfg.seedl + 1, 2), m,
        index.bucket_bits)
    rows = b.codes.shape[0]
    steps = {
        "matchUnique step": lambda: matchstep.match_step(
            *args, matchstep.initial_state(rows, "cuda"), 0, eps, **kw),
        "matchAll step": lambda: matchstep.match_step(
            *args, None, 0, eps, matchall=True, **kw),
        "1 x 2 mesh row step": lambda: mesh.local_row_step(
            m, 0, shards, reps, {torch.device("cuda:0"): b},
            matchstep.initial_state(rows, "cuda"), 0, eps, **kw)}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            where = [f"{os.path.basename(f.filename)}:{f.lineno}" for f in
                     traceback.extract_tb(e.__traceback__)
                     if "real_tpu_torch" in f.filename]
            raise AssertionError(f"(k) the {name} waits for the card at "
                                 f"{' <- '.join(reversed(where))}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    log(f"[localmesh] {pc.name}: no call of a {', '.join(steps)} "
        "synchronizes with the host (torch.cuda.set_sync_debug_mode)")


def local_mesh_phase(torch, runs, multi, tmp):
    """(k) the in-process mesh: the step check on the first run's path,
    then each of `runs` = (tag, path, genome, reads, -shards, cells, the
    path's one-device records) through local_mesh_run; with more than one
    card also `multi` (the same, one cell per card, each run twice: a
    warmup of the other cards, then the timed run) and the CLI's default
    mesh of every card (the first of `multi`'s paths)."""
    _, pc, g, r = (runs or multi)[0][:4]
    step_sync_check(torch, pc, g, r)
    for run in runs:
        local_mesh_run(torch, *run)
    if torch.cuda.device_count() > 1:
        for run in multi:
            # the first run on the other cards is their warmup
            for _ in range(2):
                local_mesh_run(torch, *run)
        _, pc, g, r, _, _, want = multi[0]
        cli_default_mesh(torch, pc, g, r, want, tmp)


# a rank of phase (l): multihost.run_rank with the rank's cells as JSON in
# argv[1] (null: rank_cells' own cards), then this process's peak
# allocated bytes on each card into the file argv[2]
RANK_CELLS_CODE = (
    "import json, sys, torch\n"
    "from real_tpu_torch.cli import main as cli\n"
    "from real_tpu_torch.parallel import multihost\n"
    "job, args = multihost.parse_job(sys.argv[3:])\n"
    "cfg = cli.parse_args(args)\n"
    "cfg.mesh_devices = json.loads(sys.argv[1])\n"
    "rc = multihost.run_rank(cfg, job)\n"
    "with open(sys.argv[2], 'w') as f:\n"
    "    json.dump([torch.cuda.max_memory_allocated(c)\n"
    "               for c in range(torch.cuda.device_count())], f)\n"
    "sys.exit(rc)\n")


def rank_local_run(torch, tag, pc: PathCfg, g, r, shards, world, cells,
                   want, tmp):
    """(l) one run of `world` ranks, each driving an in-process mesh of
    its own through multihost.run_rank on its read slice: `cells` the
    cells of every rank (RealConfig.mesh_devices; None: each rank's own
    cards from rank_cells), -shards `shards`, -f 0.75 over the ranks that
    share a card. The rank-order concatenation must be `want`, every cell
    of every rank must launch both fused entries (the 64-bit one for wide
    seeds) and each rank's peak on each card must stay under its -f of the
    card. Prints each rank's wall_s and seconds from start to exit beside
    phase (j)'s rank mesh and phase (k)'s in-process mesh of the grid."""
    from real_tpu_torch.parallel import multihost, plan
    cards = torch.cuda.device_count()
    per_rank = [list(cells) if cells else multihost.rank_cells(
        "cuda", multihost.HostTopology(rank, world), cards, dict(os.environ))
        for rank in range(world)]
    sharing = max([sum(f"cuda:{c}" in rc for rc in per_rank)
                   for c in range(cards)] + [1])
    fracmem = 0.75 / sharing
    n_dp, n_shard = plan.choose_mesh_shape(len(per_rank[0]), shards)
    slug = "ranklocal_" + re.sub(r"\W+", "_", tag)
    out = os.path.join(tmp, f"{slug}.txt")
    secs = _subprocesses(
        [[sys.executable, "-c", RANK_CELLS_CODE,
          json.dumps(list(cells) if cells else None),
          f"{out}.peak.{rank}",
          "-init_method", f"file://{os.path.join(tmp, slug + '.store')}",
          "-world", str(world), "-rank", str(rank),
          "-t", g, "-p", r, "-R", "0", "-B", str(pc.batch),
          "-e", str(pc.totalkmax), "-u", str(int(pc.unique)),
          "-l", str(pc.seedl), "-shards", str(shards), "-f", str(fracmem),
          "-o", out, "-metrics", out + ".json"] for rank in range(world)],
        slug, tmp)
    merged = b""
    for rank in range(world):
        with open(f"{out}.{rank}", "rb") as f:
            merged += f.read()
    if merged != want:
        raise AssertionError(f"(l) {tag}: the rank-order concatenation "
                             "differs from the path's one-device records")
    metrics = []
    for rank in range(world):
        with open(f"{out}.json.{rank}") as f:
            m = json.load(f)
        with open(f"{out}.peak.{rank}") as f:
            peaks = json.load(f)
        with open(os.path.join(tmp, f"{slug}.{rank}.log")) as f:
            line = re.search(r"^rank \d+ of \d+: device (\S+), cells (.+)$",
                             f.read(), re.M)
        mesh = m["mesh"]
        if line is None or line.group(2).split() != per_rank[rank] \
                or mesh["devices"] != per_rank[rank] \
                or mesh["grids"] != [[0, n_dp, n_shard]] \
                or (mesh["rank"], mesh["ranks"]) != (rank, world):
            raise AssertionError(f"(l) {tag}: rank {rank} ran on {mesh}")
        for c, k in enumerate(mesh["cell_launches"]):
            if k["probe_candidates"] <= 0 or k["verify_windows"] <= 0 \
                    or (pc.seedl > 32) != (k["probe_candidates_wide"] > 0):
                raise AssertionError(f"(l) {tag}: rank {rank} cell {c} did "
                                     f"not launch the fused kernels ({k})")
        for card, peak in enumerate(peaks):
            budget = fracmem * torch.cuda.mem_get_info(card)[1]
            if peak > budget:
                raise AssertionError(f"(l) {tag}: rank {rank} peak {peak} B "
                                     f"on cuda:{card} over -f {fracmem} = "
                                     f"{budget:.0f} B")
        gathers = m["mesh_gathers"]
        gather_s = m["phase_s"]["mesh_gather"]
        log(f"[ranklocal] {tag}, rank {rank} of {world}: {n_dp} x {n_shard} "
            f"grid on {', '.join(mesh['devices'])}; {m['num_reads']} reads, "
            f"units {m['units_dispatched']}, {secs[rank]:.2f}s start to "
            f"exit, wall_s {m['wall_s']}, mesh_gather {gather_s:.4f}s over "
            f"{gathers} gathers; peak by card {peaks} B (-f {fracmem}); "
            "phase_s " + " ".join(f"{k}={v:.3f}s"
                                  for k, v in m["phase_s"].items()))
        log(f"[ranklocal] {tag}, rank {rank}: cell launches " + "; ".join(
            f"{c}: probe_candidates {k['probe_candidates']} (64-bit "
            f"{k['probe_candidates_wide']}), verify_windows "
            f"{k['verify_windows']}, gather_word_windows "
            f"{k['gather_word_windows']}" for c, k in
            enumerate(mesh["cell_launches"])))
        metrics.append(m)
    records = merged.count(b"\n")
    log(f"[ranklocal] {tag}: {world} ranks x {len(per_rank[0])} cells on "
        f"{cards} card(s), concatenation byte-identical to the path's "
        f"{records} one-device records")
    grid = (pc.name, n_dp, n_shard)
    ranks, local, one = (RANK_MESH.get(grid), LOCAL_MESH.get(grid),
                         ONE_DEVICE.get(pc.name))
    log(f"[ranklocal] {tag}: beside it, the {n_dp} x {n_shard} grid as "
        "phase (j)'s rank mesh: " + (
            f"wall_s {[x['wall_s'] for x in ranks]}, start to exit "
            f"{[round(x['start_to_exit_s'], 2) for x in ranks]} s" if ranks
            else "not run")
        + "; as phase (k)'s in-process mesh: " + (
            f"wall_s {local:.3f} (match + output)" if local is not None
            else "not run")
        + (f"; one device: wall_s {one['wall_s']:.3f}" if one else ""))
    return metrics


def rank_local_phase(torch, runs, world, cells, tmp):
    """(l) ranks that each drive a local mesh: each of `runs` = (tag,
    path, genome, reads, -shards, the path's one-device records) as
    `world` ranks through rank_local_run."""
    for tag, pc, g, r, shards, want in runs:
        rank_local_run(torch, tag, pc, g, r, shards, world, cells, want, tmp)


def graft_phase(torch, cells=1):
    """tools/graft_entry.py on the card: entry()'s match step on cuda:0
    against the same step on the CPU (states equal), and
    dryrun_multichip over `cells` cards."""
    from real_tpu_torch.tools import graft_entry
    t = time.perf_counter()
    fn, args = graft_entry.entry("cuda:0")
    state, _ = fn(*args)
    fn_cpu, args_cpu = graft_entry.entry("cpu")
    want, _ = fn_cpu(*args_cpu)
    for f in state._fields:
        if not torch.equal(getattr(state, f).cpu(), getattr(want, f)):
            raise AssertionError(f"graft_entry.entry: {f} differs from the "
                                 "CPU's step")
    hits = int(((state.st == 1) | (state.st == 2)).sum())
    graft_entry.dryrun_multichip(cells)
    log(f"[graft] entry() on cuda:0: {hits} of {state.st.numel()} reads "
        f"unique, state equal to the CPU's; dryrun_multichip({cells}) "
        f"({time.perf_counter() - t:.1f}s)")


# phase (m): the genome-scale path (tools/gendata.py GRCH)
GRCH_READS = 2_000_000
GRCH_TRUTH_FLOOR = 0.999
GRCH_HIGH_BASE = 2**30      # real_tpu once overflowed past this base
GRCH_DISK_BYTES = 4.5e9     # genome 3.15 GB, reads 0.22 GB, read store,
                            # records
GRCH_HOST_BYTES = 24e9      # (m-a)'s process at its peak, and this one's
                            # reads and truth beside it
GRCH_TIMEOUT_S = 900
# the CLI as a user runs it, then its process's peak device bytes
GRCH_CLI_CODE = (
    "import json, sys, torch\n"
    "from real_tpu_torch.cli import main as cli\n"
    "rc = cli.main(sys.argv[2:])\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    json.dump(torch.cuda.max_memory_allocated(), f)\n"
    "sys.exit(rc)\n")


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable line in /proc/meminfo")


def grch_resources(tmp):
    import shutil
    avail, disk = _mem_available(), shutil.disk_usage(tmp).free
    log(f"[grch] host MemAvailable {avail} B, free disk under {tmp} {disk} "
        f"B; the phase needs {GRCH_HOST_BYTES:.0f} B of host memory and "
        f"{GRCH_DISK_BYTES:.0f} B of disk")
    if avail < GRCH_HOST_BYTES or disk < GRCH_DISK_BYTES:
        raise AssertionError(
            f"grch: not enough resources (MemAvailable {avail} B, free disk "
            f"{disk} B; needs {GRCH_HOST_BYTES:.0f} and "
            f"{GRCH_DISK_BYTES:.0f} B)")


def grch_data(tmp):
    """The genome (3.1 Gbp in 24 fragments) and the reads, timed."""
    from real_tpu_torch.io import fasta
    from real_tpu_torch.tools import gendata
    G = gendata.GRCH
    g, r = os.path.join(tmp, "genome.fa"), os.path.join(tmp, "reads.fa")
    t = time.perf_counter()
    gendata.write_random_genome(g, G.genome_n, seed=G.seed,
                                num_fragments=G.fragments)
    genome_s = time.perf_counter() - t
    t = time.perf_counter()
    codes, _ = fasta.parse_genome(g)
    parse_s = time.perf_counter() - t
    gendata.write_reads_fast(r, codes, GRCH_READS, G.patl, G.errprob,
                             G.fastq, seed=G.seed + 1)
    del codes
    reads_s = time.perf_counter() - t
    log(f"[grch] data: genome {G.genome_n} bp in {G.fragments} fragments "
        f"(seed {G.seed}, {os.path.getsize(g)} B) in {genome_s:.1f}s; "
        f"{GRCH_READS} reads x {G.patl} bp FASTA (errprob {G.errprob}, seed "
        f"{G.seed + 1}, {os.path.getsize(r)} B) in {reads_s:.1f}s, of "
        f"which parsing the genome {parse_s:.1f}s")
    return g, r


def _plan_line(p) -> str:
    """One text's plan from the run's account (driver._plan_account)."""
    w, b, st = p["windows"], p["bucket_bits"], p["bsearch_steps"]
    return (f"{p['shards']} shard(s)"
            + (" serial" if p["serial_build"] else " pipelined")
            + f", windows per shard {min(w)}-{max(w)}, bucket bits "
            f"{sorted(set(b))}, bsearch steps {sorted(set(st))}")


def grch_cli_run(torch, g, r, tmp):
    """(m-a): the CLI in a process of its own, nothing forced. Returns
    (record bytes, metrics)."""
    import threading
    out, mfile = os.path.join(tmp, "out.txt"), os.path.join(tmp, "m.json")
    peakf, logf = os.path.join(tmp, "peak.json"), os.path.join(tmp, "cli.log")
    args = ["-t", g, "-p", r, "-o", out, "-u", "1", "-q", "1", "-k", "5",
            "-metrics", mfile]
    t = time.perf_counter()
    with open(logf, "wb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", GRCH_CLI_CODE, peakf, *args], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), stdout=f,
            stderr=subprocess.STDOUT)
    timer = threading.Timer(GRCH_TIMEOUT_S, proc.kill)
    timer.start()
    try:
        # wait4: this child's own resource use (its peak RSS)
        _, status, usage = os.wait4(proc.pid, 0)
    finally:
        timer.cancel()
    proc.returncode = os.waitstatus_to_exitcode(status)
    secs = time.perf_counter() - t
    if proc.returncode != 0:
        with open(logf, "rb") as f:
            raise AssertionError(f"grch (m-a): exit {proc.returncode}:\n"
                                 + f.read().decode()[-3000:])
    with open(mfile) as f:
        m = json.load(f)
    with open(peakf) as f:
        peak = json.load(f)
    total = torch.cuda.mem_get_info()[1]
    budget = 0.75 * total
    k = m["kernel_launches"]
    log(f"[grch] (m-a) python -m real_tpu_torch.cli.main {' '.join(args)}: "
        f"{secs:.1f}s start to exit; wall_s {m['wall_s']}, reads_per_sec "
        f"{m['reads_per_sec']}; phases: " + " ".join(
            f"{key}={v}s" for key, v in m["phase_s"].items()))
    for fi, p in enumerate(m["plans"]):
        log(f"[grch] (m-a) sub-text #{fi}: {_plan_line(p)}")
    log(f"[grch] (m-a) units {m['units']} (dispatched "
        f"{m['units_dispatched']}), reads "
        f"{'resident' if m['source_resident'] else 'streamed'}, planner "
        f"reserved {m['reserved_bytes']} B; peak device memory {peak} B "
        f"against the -f 0.75 budget of {budget:.0f} B (card {total} B); "
        f"host peak RSS {usage.ru_maxrss * 1024} B; launches "
        f"gather_word_windows {k['gather_word_windows']}, verify_windows "
        f"{k['verify_windows']}, probe_candidates {k['probe_candidates']}; "
        f"overflow_rerun_reads {m['overflow_rerun_reads']}")
    if len(m["plans"]) != 2:
        raise AssertionError(f"grch: {len(m['plans'])} texts, not the two "
                             "sub-texts of the split")
    if k["gather_word_windows"] <= 0 or k["verify_windows"] <= 0:
        raise AssertionError("grch (m-a): a K1 entry of the bisection route "
                             "made no launch")
    if peak > budget:
        raise AssertionError(f"grch (m-a): peak {peak} B over the budget "
                             f"of {budget:.0f} B")
    with open(out, "rb") as f:
        return f.read(), m


def grch_truth(blob):
    """Truth of (m-a)'s records from gendata.read_truth: among reads with
    <= 2 mismatches in the seed and <= 5 in all (and inside one fragment),
    the share reported unique at their true fragment, position and
    strand, overall, in sub-text #0 past base 2^30, and in sub-text #1."""
    from real_tpu_torch.engine import driver
    from real_tpu_torch.tools import gendata
    G = gendata.GRCH
    n = GRCH_READS
    got_frag = np.full(n, -1, np.int64)
    got_pos = np.zeros(n, np.int64)
    got_inv = np.zeros(n, bool)
    for line in blob.splitlines():
        f = line.split(b"\t")        # id seq score 1 a patl +/- frag pos
        i = int(f[0][1:])
        got_frag[i] = int(f[7].split(b"_")[1])
        got_pos[i] = int(f[8])
        got_inv[i] = f[6] == b"-"
    start, inv, seedk, totalk = (np.concatenate(c) for c in zip(
        *gendata.read_truth(G.genome_n, n, G.patl, G.errprob, G.seed + 1)))
    per = G.genome_n // G.fragments
    frag = np.minimum(start // per, G.fragments - 1)
    frag_end = np.where(frag == G.fragments - 1, G.genome_n, (frag + 1) * per)
    sel = (seedk <= 2) & (totalk <= 5) & (start + G.patl <= frag_end)
    ok = (got_frag == frag) & (got_pos == start - frag * per + 1) \
        & (got_inv == inv)
    # sub-text #1 starts at the first fragment past the split limit
    split = driver.TEXT_SPLIT_LIMIT // per * per
    shares = {}
    for name, region in (("all", sel),
                         ("sub-text #0 past the high base",
                          sel & (start >= GRCH_HIGH_BASE) & (start < split)),
                         ("sub-text #1", sel & (start >= split))):
        if not region.any():
            raise AssertionError(f"grch truth {name}: no read")
        shares[name] = float(ok[region].mean())
        log(f"[grch] truth {name}: {int(ok[region].sum())} of "
            f"{int(region.sum())} reads = {shares[name]:.6f}")
    log(f"[grch] truth: {int((got_frag >= 0).sum())} reads reported unique "
        f"of {n}; {int(sel.sum())} within the limits, "
        f"{int((start + G.patl > frag_end).sum())} across a fragment end")
    for name, share in shares.items():
        if share < GRCH_TRUTH_FLOOR:
            raise AssertionError(f"grch truth {name}: {share} below "
                                 f"{GRCH_TRUTH_FLOOR}")
    return start, inv


def probe_route_shards(cfg, texts, reads):
    """(the fewest -shards at which no unit of any text bisects, the fewest
    at or past it at which, besides, a full batch's probes of deep buckets
    are expected to take at most half of find_survivors' D = B / 2 slots).

    A unit without bisection takes K1 = 4 lanes per probe from its bucket;
    a probe whose bucket holds more (Poisson at the shard's occupancy)
    needs one of D slots, and a read whose deep probe finds none
    overflows and is rerun with 16x caps in 512-row batches through every
    unit. At an occupancy near 2, 5% of a batch's 12 B probes are deep,
    more than the B / 2 slots."""
    import math
    from real_tpu_torch.engine import driver
    from real_tpu_torch.index.build import pick_bucket_bits
    k1 = min(cfg.cand_cap, 4)

    def units(k):
        for tf in texts:
            for s, e in driver._shard_bounds(tf.packed.n - cfg.seedl + 1, k):
                b = pick_bucket_bits(cfg.seedl, e - s, reads,
                                     cap=driver.BUCKET_BITS_CAP)
                yield e - s, b

    def deep_share(occ):
        return 1 - math.exp(-occ) * sum(occ ** j / math.factorial(j)
                                        for j in range(k1 + 1))
    nobis = next(k for k in range(1, 4096) if all(
        driver._bsearch_steps_static(w, cfg.cand_cap, b) == 0
        for w, b in units(k)))
    fit = next(k for k in range(nobis, 4096) if all(
        driver._bsearch_steps_static(w, cfg.cand_cap, b) == 0
        and deep_share(w / 2**b) * 12 <= 0.25 for w, b in units(k)))
    return nobis, fit


def grch_overflow_share(torch, cfg, index, text, codes, steps) -> float:
    """Share of a batch of reads that find_survivors flags as overflowing
    on one shard: the reads the driver reruns with 16x caps."""
    from real_tpu_torch.engine.matchstep import find_survivors
    surv, _ = find_survivors(
        index.sig, index.pos, index.bb, text.words, text.nbits, text.ncum,
        text.frag_offsets, codes,
        torch.ones(codes.shape[0], dtype=torch.bool, device=codes.device),
        seedl=cfg.seedl, seedkmax=cfg.seedkmax, totalkmax=cfg.totalkmax,
        cand_cap=cfg.cand_cap, survivor_cap=cfg.survivor_cap,
        bsearch_steps=steps, text_has_n=text.has_n)
    return float(surv.overflow.float().mean())


def _shard_reads(torch, rs, start, inv, lo, hi, dev, n=32768):
    """The first n reads whose true window lies in [lo, hi): (codes [n,
    patl] uint8, true start [n], strand [n]) on `dev`."""
    sel = np.flatnonzero((start >= lo) & (start < hi))[:n]
    codes = rs.codes_flat.reshape(rs.num_reads, -1)[sel]
    return (torch.from_numpy(np.ascontiguousarray(codes)).to(dev),
            start[sel], inv[sel])


def grch_kernel_inputs(torch, text, index, rs, start, inv, lo, hi, dev,
                       tag, rng):
    """(sites, reads, fused) of K1's entries on one shard of grch's own
    tables, for a batch of the reads whose true window lies in it: the
    bucket-bound fetch of its bisection route (gather_word_windows, w =
    2), probe_candidates at its batch shape, and verify_windows with each
    read's true window in lane 0 and 7 windows of the shard beside it."""
    from real_tpu_torch.engine.matchstep import (compute_probes,
                                                 pack_read_words)
    from real_tpu_torch.index.signatures import SigConfig
    codes, tstart, tinv = _shard_reads(torch, rs, start, inv, lo, hi, dev)
    B, patl = codes.shape
    probe = compute_probes(codes, index.seedl)
    sc = SigConfig(index.seedl)
    nbuck = index.bb.shape[0] // 6
    lists = torch.arange(6, dtype=torch.int64, device=dev)
    by_list = probe.T.reshape(2, 6, B).permute(1, 0, 2).reshape(6, 2 * B)
    bidx = (sc.bucket_key_bits(by_list, index.bucket_bits)
            + (lists * nbuck)[:, None]).to(torch.int32)
    pos = rng.integers(lo, hi - patl, (B, 8))
    pos[:, 0] = tstart
    lane_inv = rng.random((B, 8)) < 0.5
    lane_inv[:, 0] = tinv
    words_s, words_r = pack_read_words(codes)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    shift = sc.bucket_shift_bits(index.bucket_bits)
    return ([(f"{tag}/b_bucket_bounds", index.bb, bidx, 2)],
            codes,
            [(f"{tag}/probe_candidates",
              (index.sig, index.bb, probe, valid, shift, 4)),
             (f"{tag}/verify_windows",
              (text.words, torch.from_numpy(pos).to(dev),
               torch.from_numpy(lane_inv).to(dev), words_s, words_r, patl,
               index.seedl))])


def grch_phase(torch, dev):
    """Phase (m): the genome-scale path. Returns the K1 sites and fused
    cases on grch's own tables, their errors and outputs, and the launches
    of each route, for the times phase."""
    from real_tpu_torch.cli.output import write_unique
    from real_tpu_torch.config import RealConfig
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import reads as reads_io
    from real_tpu_torch.ops import gather
    from real_tpu_torch.parallel.plan import StreamShardPlan
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grch_") as tmp:
        grch_resources(tmp)
        g, r = grch_data(tmp)
        log(f"[grch] card free before (m-a): {torch.cuda.mem_get_info()[0]} "
            "B")
        blob_a, m_a = grch_cli_run(torch, g, r, tmp)
        start, inv = grch_truth(blob_a)

        # (m-b) in-process: every unit bisection-free (probe_candidates)
        cfg = RealConfig(textfilename=g, patternfilename=r,
                         outputfilename="-", totalkmax=5)
        t = time.perf_counter()
        texts = driver.load_texts(cfg, dev)
        load_s = time.perf_counter() - t
        nobis, shards = probe_route_shards(cfg, texts, GRCH_READS)
        log(f"[grch] (m-b) -shards {nobis} is the fewest at which no unit "
            f"bisects; -shards {shards} the fewest at which, besides, the "
            "deep probes of a batch are expected to fill at most half of "
            "their slots")
        cfg_b = dataclasses.replace(cfg, index_shards=shards)
        t = time.perf_counter()
        rs = reads_io.parse_reads(r)
        parse_s = time.perf_counter() - t
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gather.reset_launch_counts()
        t = time.perf_counter()
        res = driver.run_match_unique(cfg_b, rs, texts, dev)
        torch.cuda.synchronize()
        match_s = time.perf_counter() - t
        launches_b = gather.launch_counts()
        peak_b = torch.cuda.max_memory_allocated() - base
        t = time.perf_counter()
        buf = io.BytesIO()
        write_unique(buf, rs, res, texts, cfg.scores)
        out_s = time.perf_counter() - t
        m = res.metrics
        log(f"[grch] (m-b) load_texts {load_s:.1f}s, parse_reads "
            f"{parse_s:.1f}s, run_match_unique -shards {shards} "
            f"{match_s:.1f}s ({m['units_dispatched']} units), write_unique "
            f"{out_s:.1f}s; match phases: " + " ".join(
                f"{k}={v:.3f}s" for k, v in m["phase_s"].items()))
        for fi, p in enumerate(m["plans"]):
            log(f"[grch] (m-b) sub-text #{fi}: {_plan_line(p)}")
        log(f"[grch] (m-b) peak device memory {peak_b} B over the texts; "
            f"launches {launches_b}; overflow_rerun_reads "
            f"{m['overflow_rerun_reads']}")
        if buf.getvalue() != blob_a:
            raise AssertionError("grch (m-b): records differ from (m-a)'s")
        if launches_b["probe_candidates"] <= 0 \
                or launches_b["verify_windows"] <= 0:
            raise AssertionError("grch (m-b): a K1 entry of the probe route "
                                 "made no launch")
        if any(s for p in m["plans"] for s in p["bsearch_steps"]):
            raise AssertionError("grch (m-b): a unit bisects")
        records = blob_a.count(b"\n")
        log(f"[grch] (m-a) and (m-b) records byte-identical ({records} "
            "records)")
        del res, buf, blob_a

        # K1 on grch's tables: sub-text #0's last shard, past the high
        # base, of (m-a)'s plan, of (m-b)'s and of -shards nobis
        text = texts[0].packed
        nw = text.n - cfg.seedl + 1
        rng = np.random.default_rng(57)
        sites, fused = [], []
        for tag, shards_k, p in (("grch", m_a["plans"][0]["shards"],
                                  m_a["plans"][0]),
                                 ("grch_m_b", shards, None),
                                 ("grch_nobis", nobis, None)):
            lo, hi = driver._shard_bounds(nw, shards_k)[-1]
            splan = StreamShardPlan(shards_k, False, driver.BUCKET_BITS_CAP)
            if p is not None:
                splan = StreamShardPlan(p["shards"], p["serial_build"],
                                        p["bucket_bits_cap"])
            t = time.perf_counter()
            index = driver._build(cfg, text, lo, hi - lo, GRCH_READS, splan)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            if lo < GRCH_HIGH_BASE:
                raise AssertionError(f"{tag}: the last shard starts below "
                                     f"base {GRCH_HIGH_BASE}")
            s_sites, codes, s_fused = grch_kernel_inputs(
                torch, text, index, rs, start, inv, lo, hi, dev, tag, rng)
            steps = driver._bsearch_steps_static(hi - lo, cfg.cand_cap,
                                                 index.bucket_bits)
            over = grch_overflow_share(torch, cfg, index, text, codes, steps)
            log(f"[grch] {tag}: sub-text #0's last shard of {shards_k}, "
                f"windows [{lo}, {hi}) ({hi - lo} windows, bucket bits "
                f"{index.bucket_bits}, bsearch {steps}) built in "
                f"{build_s:.2f}s; one step on {codes.shape[0]} of its reads: "
                f"overflow share {over:.5f}")
            if tag == "grch":       # the bisection route's entries
                sites += s_sites
                fused.append(s_fused[1])
            elif tag == "grch_m_b":     # the probe route's
                fused.append(s_fused[0])
            del index, s_sites, s_fused, codes
            gc.collect()
        errs = gather_kernel_phase(torch, sites, dev)
        ferrs, fouts = fused_kernel_phase(torch, fused, {"grch": 5,
                                                         "grch_m_b": 5}, dev)
    k_a = m_a["kernel_launches"]
    launches = {"grch": {"gather_windows": k_a["gather_word_windows"],
                         "verify_windows": k_a["verify_windows"],
                         "probe_candidates": k_a["probe_candidates"]},
                "grch_m_b": {"gather_windows":
                             launches_b["gather_word_windows"],
                             "verify_windows": launches_b["verify_windows"],
                             "probe_candidates":
                             launches_b["probe_candidates"]}}
    log(f"[grch] phase (m) {time.perf_counter() - t_phase:.1f}s")
    return sites, errs, fused, ferrs, fouts, launches


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


def _sector_bytes(torch, table_len, start, w, per_sector=8) -> int:
    """32 B for every distinct 32 B sector under the w-entry windows at
    `start` (entries past the table end touch nothing); a sector holds 8
    32-bit words or 4 64-bit signatures."""
    win = start.reshape(-1)[:, None] + torch.arange(w, device=start.device)
    return 32 * int(torch.unique(win[win < table_len] // per_sector).numel())


def _bound_bytes(torch, table, idx, w, out_words) -> int:
    """A window gather's bytes: each index read once, each output word
    written once, and every distinct table sector its windows touch."""
    start = idx.to(torch.int64).clamp(0, table.shape[0] - 1)
    return 4 * idx.numel() + 4 * out_words \
        + _sector_bytes(torch, table.shape[0], start, w)


def _probe_reads(torch, args, begin):
    """(bucket-table word indices [2, B, 12], real-end indices [12],
    signature window starts [B, 12]) that probe_candidates reads."""
    from real_tpu_torch.index.signatures import logical_shift_right
    index_sig, index_bb, probe_sig, _, shift, _ = args
    M, nbuck = index_sig.shape[0] // 6, index_bb.shape[0] // 6
    lists = torch.arange(12, device=probe_sig.device) % 6
    h = logical_shift_right(probe_sig, shift) \
        if index_sig.dtype == torch.int64 else probe_sig >> shift
    bi = (h + lists * nbuck).clamp(0, 6 * nbuck - 1)
    start = begin.to(torch.int64).clamp(0, M - 1) + lists * M
    return torch.stack([bi, bi + 1]), lists * nbuck + nbuck - 1, start


def _probe_bound_bytes(torch, args, out) -> int:
    """probe_candidates' bytes: probes (8 B) and validity (1 B per read)
    in; begin, count, k1 lane signatures (4 B each, 8 B wide) and k1 flags
    out; the distinct sectors of the bucket table and of the signature
    lists."""
    index_sig, index_bb, probe_sig, valid, _, k1 = args
    bounds, real_end, start = _probe_reads(torch, args, out[0])
    words = torch.cat([bounds.reshape(-1), real_end])
    bb_bytes = 32 * int(torch.unique(
        words[words < index_bb.shape[0]] // 8).numel())
    nprobe = probe_sig.numel()
    sig_bytes = index_sig.element_size()
    return 8 * nprobe + valid.numel() \
        + nprobe * (8 + (sig_bytes + 1) * k1) + bb_bytes \
        + _sector_bytes(torch, index_sig.shape[0], start, k1,
                        32 // sig_bytes)


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
                     f"{args[1].shape[0]} words + {args[0].shape[0]} "
                     f"signatures of {args[0].element_size()} B")
        else:
            kw = fouts[name][0].shape[0]
            chain = (_select_chain(torch, args[0],
                                   _verify_starts(torch, args), kw + 1),)
            nbytes = _verify_bound_bytes(torch, args, fouts[name])
            shape = (f"n={args[1].numel()} lanes kw={kw} table="
                     f"{args[0].shape[0]} words")
        wide = entry == "probe_candidates" and args[0].dtype == torch.int64
        row(f"{entry}{'_wide' if wide else ''}/{path}", GATHER_SRC,
            GATHER_REPLACES,
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
    """Phases 3-11 on `dev`; returns the kernels' JSON entries."""
    from real_tpu_torch.engine import driver
    unique, yeast, chr21 = UNIQUE, YEAST, CHR21
    wide = [dataclasses.replace(chr21, name=f"chr21_l{seedl}", seedl=seedl)
            for seedl in WIDE_SEEDLS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        gu, codes_u = make_genome(tmp, unique)
        ga, codes_a = make_genome(tmp, yeast)
        gc21, codes_c = make_genome(tmp, chr21)
        ru, ru_small, ru_warm, truth_u = make_reads(tmp, unique, codes_u)

        sites, fused, big_table = [], [], None
        for pc, g, codes in ((unique, gu, codes_u), (yeast, ga, codes_a),
                             (chr21, gc21, codes_c),
                             *((w, gc21, codes_c) for w in wide)):
            cfg = path_config(pc, g, ru)
            texts = driver.load_texts(cfg, dev)
            index = path_index(cfg, texts, pc.num_reads)
            rng = np.random.default_rng(pc.genome_seed)
            if pc.seedl == 32:
                sites += site_inputs(torch, pc, texts[0].packed, index, rng)
            fused += fused_inputs(torch, pc, codes, texts[0].packed, index,
                                  rng)
            if pc is unique:
                big_table = index.sig        # 27,599,904 words, 110 MB
        del index, texts
        errs = gather_kernel_phase(torch, sites, dev)
        ferrs, fouts = fused_kernel_phase(
            torch, fused, {pc.name: pc.totalkmax
                           for pc in (unique, yeast, chr21, *wide)}, dev)
        rcases = rowsum_cases(torch, big_table, dev)
        rerrs = rowsum_kernel_phase(torch, rcases, dev)

        # the yeast read set (a million Python objects) is made after the
        # matchUnique path, so that path's host phases run as before
        cfg_u, res_u, launches_u, blob_u = path_phase(
            torch, unique, gu, ru, ru_warm, truth_u, dev)
        bisection_phase(torch, unique, cfg_u, ru_warm, res_u, launches_u, dev)
        unique_parity_phase(cfg_u, ru_small, res_u)
        del res_u, truth_u
        ra, ra_small, ra_warm, truth_a = make_reads(tmp, yeast, codes_a)
        cfg_a, res_a, launches_a, blob_a = path_phase(
            torch, yeast, ga, ra, ra_warm, truth_a, dev)
        bisection_phase(torch, yeast, cfg_a, ra_warm, res_a, launches_a, dev)
        all_parity_phase(cfg_a, ra_small, res_a)
        del res_a, truth_a

        rc, rc_small, rc_warm, rc_wide, truth_c = make_reads(
            tmp, chr21, codes_c, extra=(WIDE_READS,))
        cfg_c, res_c, launches_c, blob_c = path_phase(
            torch, chr21, gc21, rc, rc_warm, truth_c, dev)
        bisection_phase(torch, chr21, cfg_c, rc_warm, res_c, launches_c, dev)
        del res_c
        chr21_runs_phase(torch, chr21, cfg_c, rc, blob_c, tmp, dev)
        launches_w, blobs_w = chr21_wide_phase(torch, chr21, gc21, rc_wide,
                                               rc_small, truth_c, dev)
        del truth_c

        traced_phase(chr21, gc21, rc, blob_c, tmp)
        two_text_phase(torch, unique, codes_u, ru, ru_small, tmp, dev)
        ranks_phase(torch, unique, gu, ru, blob_u, tmp)
        mesh_phase(torch, [
            ("matchUnique -shards 1", unique, gu, ru, 1, 2, blob_u),
            ("matchUnique -shards 2", unique, gu, ru, 2, 4, blob_u),
            ("matchUnique -shards 4", unique, gu, ru, 4, 2, blob_u),
            ("yeast matchAll -shards 2", yeast, ga, ra, 2, 2, blob_a),
            ("chr21 -shards 2", chr21, gc21, rc, 2, 2, blob_c),
            ("chr21 -l 48 -shards 2", dataclasses.replace(
                wide[0], num_reads=WIDE_READS), gc21, rc_wide, 2, 2,
             blobs_w[48]),
        ], tmp)
        one = ["cuda:0"]
        local_mesh_phase(torch, [
            ("matchUnique -shards 1, 2 cells", unique, gu, ru, 1, one * 2,
             blob_u),
            ("matchUnique -shards 2, 4 cells", unique, gu, ru, 2, one * 4,
             blob_u),
            ("matchUnique -shards 8, 4 cells", unique, gu, ru, 8, one * 4,
             blob_u),
            ("yeast matchAll -shards 2, 2 cells", yeast, ga, ra, 2, one * 2,
             blob_a),
            ("chr21 -shards 2, 2 cells", chr21, gc21, rc, 2, one * 2, blob_c),
            ("chr21 -l 48 -shards 2, 2 cells", dataclasses.replace(
                wide[0], num_reads=WIDE_READS), gc21, rc_wide, 2, one * 2,
             blobs_w[48]),
        ], _card_cell_runs(torch, unique, gu, ru, blob_u, chr21, gc21, rc,
                           blob_c), tmp)
        rank_local_phase(torch, [
            ("matchUnique -shards 1", unique, gu, ru, 1, blob_u),
            ("matchUnique -shards 2", unique, gu, ru, 2, blob_u),
            ("yeast matchAll -shards 2", yeast, ga, ra, 2, blob_a),
            ("chr21 -shards 2", chr21, gc21, rc, 2, blob_c),
            ("chr21 -l 48 -shards 2", dataclasses.replace(
                wide[0], num_reads=WIDE_READS), gc21, rc_wide, 2,
             blobs_w[48]),
        ], 2, one * 2, tmp)
        del blob_u, blob_a, blob_c, blobs_w
        graft_phase(torch)

    g_sites, g_errs, g_fused, g_ferrs, g_fouts, launches_g = grch_phase(
        torch, dev)
    rlaunches = gatherbench_phase(big_table.numel())
    return times_phase(
        torch, sites + g_sites, {**errs, **g_errs}, fused + g_fused,
        {**ferrs, **g_ferrs}, {**fouts, **g_fouts},
        {unique.name: launches_u, yeast.name: launches_a,
         chr21.name: launches_c, **launches_w, **launches_g},
        rcases, rerrs, rlaunches)


def grch_only(torch, dev) -> list:
    """--grch: phase (m) alone, then its kernels' times."""
    sites, errs, fused, ferrs, fouts, launches = grch_phase(torch, dev)
    return times_phase(torch, sites, errs, fused, ferrs, fouts, launches,
                       [], {}, {})


def _card_cell_runs(torch, unique, gu, ru, blob_u, chr21, gc21, rc, blob_c):
    """(k)'s runs of one cell per card: matchUnique -shards 4 (1 x 4 on
    four cards) and chr21 -shards 2 (2 x 2 on four)."""
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [("matchUnique -shards 4, a cell per card", unique, gu, ru, 4,
             cards, blob_u),
            ("chr21 -shards 2, a cell per card", chr21, gc21, rc, 2, cards,
             blob_c)]


def cells_only(torch) -> None:
    """--cells: (k)'s runs of one cell per card and the CLI's default mesh
    of every card, against one-device runs on cuda:0 of the matchUnique
    and chr21 paths; it needs more than one card."""
    if torch.cuda.device_count() < 2:
        raise SystemExit("--cells needs more than one card, this machine "
                         f"has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        blobs = {}
        data = []
        for pc in (UNIQUE, CHR21):
            g, codes = make_genome(tmp, pc)
            r = make_reads(tmp, pc, codes)[0]
            cfg = path_config(pc, g, r)
            for _ in range(2):            # a warmup, then the timed run
                rs, _, res, blobs[pc.name], records, ph = run_once(
                    cfg, r, "cuda:0")
            _one_device(pc.name, cfg, rs, res, ph)
            log(f"[localmesh] {pc.name} on cuda:0 alone: {records} records "
                f"in {ph['total']:.3f}s")
            data.append((g, r))
        (gu, ru), (gc21, rc) = data
        local_mesh_phase(torch, [], _card_cell_runs(
            torch, UNIQUE, gu, ru, blobs[UNIQUE.name], CHR21, gc21, rc,
            blobs[CHR21.name]), tmp)
    graft_phase(torch, torch.cuda.device_count())


def ranks_only(torch, world: int) -> None:
    """--ranks N: the matchUnique data, phase (i) and the matchUnique
    -shards 2 mesh of (j) (the 2 x 2 grid at N = 4), N ranks on N cards;
    on a machine of at least 2N cards also (l)'s matchUnique -shards 2
    and chr21 -shards 2 as N ranks, each driving its own cards
    (rank_cells), against one-device runs on cuda:0."""
    cards = torch.cuda.device_count()
    if cards < world:
        raise SystemExit(f"--ranks {world} needs {world} cards, this "
                         f"machine has {cards}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        g, codes = make_genome(tmp, UNIQUE)
        r = make_reads(tmp, UNIQUE, codes)[0]
        one = ranks_phase(torch, UNIQUE, g, r, None, tmp, world=world)
        mesh_phase(torch, [("matchUnique -shards 2", UNIQUE, g, r, 2, world,
                            one)], tmp)
        if cards < 2 * world:
            return
        gc21, codes_c = make_genome(tmp, CHR21)
        rc = make_reads(tmp, CHR21, codes_c)[0]
        cfg = path_config(CHR21, gc21, rc)
        for _ in range(2):                # a warmup, then the timed run
            rs, _, res, blob_c, records, ph = run_once(cfg, rc, "cuda:0")
        _one_device(CHR21.name, cfg, rs, res, ph)
        log(f"[ranklocal] {CHR21.name} on cuda:0 alone: {records} records, "
            f"wall_s {ph['match'] + ph['output']:.3f}")
        rank_local_phase(torch, [
            ("matchUnique -shards 2, own cards", UNIQUE, g, r, 2, one),
            ("chr21 -shards 2, own cards", CHR21, gc21, rc, 2, blob_c),
        ], world, None, tmp)


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
    if "--ranks" in sys.argv or "--cells" in sys.argv:
        if "--cells" in sys.argv:
            cells_only(torch)
        else:
            ranks_only(torch, int(sys.argv[sys.argv.index("--ranks") + 1]))
        log(f"[done] {time.perf_counter() - t_all:.1f}s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    # plain cuda meshes every card of a machine of several (phase (k)
    # drives that mesh); the phases before it then pin the first card
    dev = "cuda" if torch.cuda.device_count() == 1 else "cuda:0"
    kernels = grch_only(torch, dev) if "--grch" in sys.argv \
        else drive(torch, dev)
    log("kernels: gather_windows, probe_candidates (32-bit and 64-bit "
        "entries), verify_windows, gather_rowsum")
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
