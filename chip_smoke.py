#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (real_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the matchUnique main path at bench.py's size — a 4.6 Mbp random
genome (E. coli scale), 100,000 reads x 100 bp, errprob 0.02, seed 12345,
k <= 5, scores on, batch 8192 — through the port's entry points on CUDA,
and holds every kernel of that path against its plain PyTorch version.
Phases:

  1. card      device name and `nvidia-smi` name/power limit
  2. build     nvcc builds csrc/gather_windows.cu for sm_90a (timed)
  3. kernel    gather_windows bit-exact against gather_word_windows_ref at
               the three main-path shapes on the main path's real tables,
               then edge cases (idx < 0, = mw-1, >= mw, mw < w, top bit)
  4. main      load -> build -> run_match_unique -> write_unique on CUDA,
               warmup then timed; reads/s, phase seconds, overflow reruns,
               kernel launches (must be > 0 at every call site), and the
               truth recall from the simulated read origins
  5. parity    the port on the CPU over the first 2,048 reads: records
               byte-identical to the card's records for those reads
  6. times     per call site: kernel, plain version and one torch
               index_select gather, device time (CUDA events around 10
               calls queued behind a sleep kernel, median of 25) and
               host-inclusive time (the same without the sleep), and the
               bytes bound at 3.35 TB/s

Any failure raises (non-zero exit). Without CUDA, or without the rest of
the repository beside it, it exits non-zero before printing any result.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME_N = 4_600_000
NUM_READS = 100_000
PATL = 100
ERRPROB = 0.02
SEED = 12345
BATCH = 8192
PARITY_READS = 2048
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
TIMING_REPS = 25
LAUNCHES_PER_REP = 10
SOURCE = "real_tpu_torch/csrc/gather_windows.cu"
REPLACES = "real_tpu/ops/pallas_gather.py:71"


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
    t = time.perf_counter()
    path = cuda_build.library_path("gather_windows")
    dt = time.perf_counter() - t
    log(f"[build] {path.name} in {dt:.2f}s")
    for line in cuda_build.build_logs.get("gather_windows", "").splitlines():
        log(f"[build] {line}")


def make_data(tmp: str):
    from real_tpu_torch.io import fasta
    from real_tpu_torch.tools import simulate
    g = os.path.join(tmp, "genome.fa")
    r = os.path.join(tmp, "reads.fa")
    with open(g, "w") as f:
        f.write(simulate.random_genome(GENOME_N, seed=SEED))
    codes, _ = fasta.parse_genome(g)
    truth = simulate.generate_reads(codes, NUM_READS, PATL, ERRPROB, False,
                                    seed=SEED + 1)
    simulate.write_reads(truth, r, False)
    r_small = os.path.join(tmp, "reads_parity.fa")
    simulate.write_reads(truth[:PARITY_READS], r_small, False)
    return g, r, r_small, truth


def site_inputs(torch, texts, index, dev, rng):
    """(name, table, idx, w) at the three main-path call shapes of the
    window gather (engine/matchstep.py), on the main path's tables."""
    text = texts[0].packed
    nwords = text.words.shape[0]
    S = 8
    a = rng.integers(0, (text.n - PATL) // 16, (BATCH, S))
    nbuck = index.bb.shape[0] // 6
    b = rng.integers(0, nbuck - 1, (6, 2 * BATCH)) \
        + (np.arange(6) * nbuck)[:, None]
    M = index.sig.shape[0] // 6
    c = rng.integers(0, M, (BATCH, 12)) + (np.arange(12) % 6) * M
    kw = (PATL + 15) // 16
    assert a.max() < nwords
    return [
        ("a_text_windows", text.words,
         torch.from_numpy(a.astype(np.int32)).to(dev), kw + 1),
        ("b_bucket_bounds", index.bb,
         torch.from_numpy(b.astype(np.int32)).to(dev), 2),
        ("c_tier1_lanes", index.sig,
         torch.from_numpy(c.astype(np.int32)).to(dev), 4),
    ]


def max_abs_err(torch, got, want) -> int:
    g = torch.stack([x.to(torch.int64) for x in got])
    r = torch.stack([x.to(torch.int64) for x in want])
    if g.shape != r.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(r.shape)}")
    return int((g - r).abs().max()) if g.numel() else 0


def kernel_phase(torch, sites, dev):
    from real_tpu_torch.ops.gather import (gather_word_windows,
                                           gather_word_windows_ref)
    errs = {}
    for name, table, idx, w in sites:
        got = gather_word_windows(table, idx, w)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, gather_word_windows_ref(table, idx, w))
        log(f"[kernel] {name}: table {table.shape[0]} words, idx "
            f"{tuple(idx.shape)}, w={w}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"gather_windows disagrees at {name}")
        errs[name] = err
    rng = np.random.default_rng(7)
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
        got = gather_word_windows(words, idx, w)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, gather_word_windows_ref(words, idx, w))
        if err != 0:
            raise AssertionError(f"gather_windows edge case mw={mw} w={w}")
    empty = gather_word_windows(words, torch.zeros((0, 3), dtype=torch.int32,
                                                   device=dev), 2)
    if len(empty) != 2 or empty[0].shape != (0, 3):
        raise AssertionError("gather_windows on empty idx")
    log("[kernel] edge cases bit-exact (idx < 0, = mw-1, >= mw, mw < w, "
        "top-bit words, empty idx)")
    return errs


def run_once(cfg, reads_path, device):
    from real_tpu_torch.cli.output import write_unique
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
    result = driver.run_match_unique(cfg, rs, texts, device)
    if device == "cuda":
        torch.cuda.synchronize()
    ph["match"] = time.perf_counter() - t
    t = time.perf_counter()
    buf = io.BytesIO()
    unique = write_unique(buf, rs, result, texts, cfg.scores)
    ph["output"] = time.perf_counter() - t
    ph["total"] = time.perf_counter() - t0
    return rs, texts, result, buf.getvalue(), unique, ph


def truth_recall(result, truth) -> float:
    ok = sel = 0
    for i, tr in enumerate(truth):
        if tr.nmut > 5:
            continue
        sel += 1
        ok += int(result.st[i] in (1, 2) and result.pos[i] == tr.pos)
    return ok / max(sel, 1)


def main_phase(torch, g, r, truth):
    from real_tpu_torch.config import RealConfig
    from real_tpu_torch.ops.gather import gather_word_windows, \
        reset_launch_counts
    cfg = RealConfig(textfilename=g, patternfilename=r, outputfilename="-",
                     batch_size=BATCH)
    t = time.perf_counter()
    run_once(cfg, r, "cuda")
    log(f"[main] warmup run {time.perf_counter() - t:.2f}s")
    reset_launch_counts()
    rs, texts, result, blob, unique, ph = run_once(cfg, r, "cuda")
    torch.cuda.synchronize()
    launches = dict(gather_word_windows.launches_by_w)
    total = gather_word_windows.launches
    log(f"[main] {NUM_READS} reads in {ph['total']:.3f}s = "
        f"{NUM_READS / ph['total']:.1f} reads/s end to end "
        f"({unique} unique)")
    log("[main] phases: " + " ".join(f"{k}={v:.3f}s" for k, v in ph.items()))
    log("[main] match phases: " + " ".join(
        f"{k}={v:.3f}s" for k, v in result.metrics["phase_s"].items()))
    log(f"[main] overflow-rerun reads: "
        f"{result.metrics['overflow_rerun_reads']}")
    log(f"[main] gather_windows launches: {total} (by w: {launches})")
    kw = (PATL + 15) // 16
    for w in (kw + 1, 2, 4):
        if launches.get(w, 0) <= 0:
            raise AssertionError(f"main path made no w={w} gather launch")
    if sum(launches.values()) != total:
        raise AssertionError("launch counts disagree")
    recall = truth_recall(result, truth)
    log(f"[main] truth recall (reads with <= 5 mutations at their true "
        f"position): {recall:.5f}")
    if recall < 0.95:
        raise AssertionError(f"truth recall {recall} below 0.95")
    if not np.isfinite(result.score[(result.st == 1) | (result.st == 2)]) \
            .all():
        raise AssertionError("non-finite score on a matched read")
    return cfg, rs, texts, result, launches


def parity_phase(cfg, r_small, result):
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


def _events(torch, fn, sleep_cycles: int):
    """(device ms between two events around LAUNCHES_PER_REP calls, host
    seconds spent enqueuing them). With sleep_cycles > 0 a sleep kernel
    holds the stream first, so the calls queue up behind it and the
    events time device work alone, not the host's enqueue rate."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    t = time.perf_counter()
    e0.record()
    for _ in range(LAUNCHES_PER_REP):
        fn()
    e1.record()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / LAUNCHES_PER_REP, host_s


def time_ms(torch, fn):
    """(device ms per call, host-inclusive ms per call): medians over
    TIMING_REPS repetitions of LAUNCHES_PER_REP back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    dev, wall = [], []
    for _ in range(TIMING_REPS):
        while True:
            s0.record()
            torch.cuda._sleep(cycles)
            s1.record()
            torch.cuda.synchronize()
            d, host_s = _events(torch, fn, cycles)
            # the sleep must outlast the enqueue, or the host shows through
            if host_s * 1e3 < 0.5 * s0.elapsed_time(s1):
                break
            cycles *= 2
        dev.append(d)
        wall.append(_events(torch, fn, 0)[0])
    return float(np.median(dev)), float(np.median(wall))


def times_phase(torch, sites, errs, launches):
    from real_tpu_torch.ops.gather import (gather_word_windows,
                                           gather_word_windows_ref)
    out = []
    for name, table, idx, w in sites:
        mw = table.shape[0]
        start = idx.to(torch.int64).clamp(0, mw - 1).reshape(-1)
        win = (start[:, None] + torch.arange(w, device=idx.device)).reshape(-1)
        padded = torch.cat([table, table.new_zeros(w)])
        n = idx.numel()
        touched = int(torch.unique(win[win < mw]).numel())
        bytes_moved = 4 * n + 4 * n * w + 4 * touched
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ms, ms_wall = time_ms(
            torch, lambda: gather_word_windows(table, idx, w))
        plain_ms, plain_wall = time_ms(
            torch, lambda: gather_word_windows_ref(table, idx, w))
        library_ms, library_wall = time_ms(
            torch, lambda: torch.index_select(padded, 0, win))
        log(f"[times] {name}: n={n} w={w} table={mw} words, device us "
            f"(host-inclusive us): kernel {ms * 1e3:.2f} "
            f"({ms_wall * 1e3:.2f}), plain {plain_ms * 1e3:.2f} "
            f"({plain_wall * 1e3:.2f}), index_select "
            f"{library_ms * 1e3:.2f} ({library_wall * 1e3:.2f}), bound "
            f"{bound_ms * 1e3:.3f} ({bytes_moved} B)")
        out.append({"name": f"gather_windows/{name}_w{w}", "route": "cuda",
                    "source": SOURCE, "replaces": REPLACES,
                    "launches": int(launches.get(w, 0)),
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes", "library_ms": library_ms})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import real_tpu_torch  # noqa: F401  (fails outside the repository)
    from real_tpu_torch.engine import driver
    from real_tpu_torch.index.build import build_index, pick_bucket_bits

    t_all = time.perf_counter()
    name, _ = card_phase(torch)
    build_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t = time.perf_counter()
        g, r, r_small, truth = make_data(tmp)
        log(f"[data] {GENOME_N} bp genome, {NUM_READS} reads x {PATL} bp "
            f"in {time.perf_counter() - t:.1f}s")

        from real_tpu_torch.config import RealConfig
        cfg0 = RealConfig(textfilename=g, patternfilename=r,
                          outputfilename="-", batch_size=BATCH)
        texts = driver.load_texts(cfg0, "cuda")
        nwin = texts[0].packed.n - cfg0.seedl + 1
        index = build_index(texts[0].packed, cfg0.seedl, 0, nwin,
                            pick_bucket_bits(cfg0.seedl, nwin, NUM_READS,
                                             cap=driver.BUCKET_BITS_CAP))
        sites = site_inputs(torch, texts, index, "cuda",
                            np.random.default_rng(SEED))
        errs = kernel_phase(torch, sites, "cuda")

        cfg, rs, texts_run, result, launches = main_phase(torch, g, r, truth)
        parity_phase(cfg, r_small, result)
        kernels = times_phase(torch, sites, errs, launches)
    log("kernels: gather_windows")
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
