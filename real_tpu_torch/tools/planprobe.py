"""Measure on the card what the shard planner plans with.

    python3 -m real_tpu_torch.tools.planprobe [--windows 11700000,46700000]
                                              [--seedls 32,48,64] [--out f]

parallel/plan.py budgets device memory with a MemoryModel of the port's
own index build and engine/driver.py reserves a match step's workspace;
both are constants in the source. This tool is where they come from. It prints one
JSON object:

  wide_kernel  the 64-bit probe_candidates entry against its plain version
               on hand-made edge tables (a short first check of a new
               build)
  build        per (seedl, windows): seconds of build_index (synchronized)
               and torch.cuda.max_memory_allocated over the bytes live
               before the call, split into the finished lists, the bucket
               table and the rest, per window — the MemoryModel's inputs —
               and seconds per window (plan.BUILD_S_PER_WINDOW)
  table        seconds per list entry of the histogram bucket table and
               seconds per probe and step of the bisection path
               (index/build.py TABLE_ENTRY_S, TABLE_GATHER_S)
  step         per batch shape: peak bytes of one match step over the bytes
               live before it, per survivor lane and read base
               (driver.STEP_BYTES_PER_LANE_BASE), and host-inclusive
               seconds per read of a step (plan.MATCH_S_PER_READ_PASS)

The text is a random genome made on the host from --seed; nothing is read
from disk. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from real_tpu_torch.engine import matchstep
from real_tpu_torch.engine.driver import (BUCKET_BITS_CAP, resolve_device,
                                          _bsearch_steps_static)
from real_tpu_torch.index.build import build_index, pick_bucket_bits
from real_tpu_torch.index.signatures import SigConfig
from real_tpu_torch.ops import gather
from real_tpu_torch.scoring.scoring import Scoring, score_tables
from real_tpu_torch.text.packed import build_packed_text
from real_tpu_torch.tools import fusedcases


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def check_wide_kernel(dev) -> dict:
    """probe_candidates' 64-bit entry on edge tables, every k1."""
    cases = 0
    for seedl in (36, 48, 64):
        for k1 in (1, 2, 3, 4):
            rng = np.random.default_rng(100 * seedl + k1)
            sig, bb, shift = fusedcases.edge_tables_wide(rng, seedl)
            probe, valid = fusedcases.edge_probes_wide(rng, sig, 700, seedl)
            args = fusedcases.tensors((sig.reshape(-1), bb, probe, valid),
                                      dev)
            got = gather.probe_candidates(*args, shift, k1)
            torch.cuda.synchronize()
            want = gather.probe_candidates_ref(*args, shift, k1)
            for g, r in zip(got, want):
                if g.dtype != r.dtype or not torch.equal(g, r):
                    raise AssertionError(
                        f"wide probe_candidates disagrees with its plain "
                        f"version at seedl={seedl} k1={k1}")
            cases += 1
    return {"cases": cases, "bit_exact": True,
            "launches_wide": gather.probe_candidates.launches_wide}


def _event_ms(fn, reps: int = 7) -> float:
    """Median device ms between two events around one call of fn, for
    functions that synchronize inside (torch.bincount reads its maximum
    back), which tools/cudatime.time_ms cannot queue behind its sleep."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return float(np.median(out))


def probe_build(text, seedl: int, windows: int, reads: int) -> dict:
    """One build_index at `windows` windows: seconds and peak bytes."""
    bbits = pick_bucket_bits(seedl, windows, reads, cap=BUCKET_BITS_CAP)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    index = build_index(text, seedl, 0, windows, bbits)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    lists = _nbytes(index.sig) + _nbytes(index.pos)
    table = _nbytes(index.bb)
    out = {"seedl": seedl, "windows": windows, "bucket_bits": bbits,
           "seconds": seconds, "seconds_per_window": seconds / windows,
           "peak_bytes": peak, "list_bytes": lists, "table_bytes": table,
           "list_bytes_per_window": lists / windows,
           "build_bytes_per_window": (peak - table) / windows}
    del index
    return out


def probe_table(text, windows: int, reads: int, batch: int, patl: int,
                seed: int) -> dict:
    """The bucket table's cost per list entry (histogram route) and the
    bisection path's per probe and step, on a narrow index."""
    from real_tpu_torch.index import build as b
    seedl = 32
    bbits = pick_bucket_bits(seedl, windows, reads, cap=BUCKET_BITS_CAP)
    index = build_index(text, seedl, 0, windows, bbits)
    sc = SigConfig(seedl)
    m = index.sig.shape[0] // 6
    skey = (index.sig[:m].to(torch.int64) & 0xFFFFFFFF)
    real = index.pos[:m] != b.POS_SENTINEL
    nsent = m - real.sum()

    def histogram():
        bucket = torch.where(real, sc.bucket_key_bits(skey, bbits),
                             (1 << bbits) - 1)
        return b._rank_table_histogram(bucket, nsent, bbits)
    hist_ms = _event_ms(histogram)
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(
        0, 4, (batch, patl)).astype(np.uint8)).to(text.words.device)
    probe = matchstep.compute_probes(codes, seedl)
    ms = {}
    for steps in (4, 12):
        ms[steps] = _event_ms(lambda: matchstep._bisected_ranges(
            index.sig, index.bb, probe, sc, bbits, steps))
    per_gather = (ms[12] - ms[4]) * 1e-3 / (batch * 12 * 2 * 8)
    del index
    return {"windows": windows, "bucket_bits": bbits,
            "histogram_ms_per_list": hist_ms,
            "table_entry_s": hist_ms * 1e-3 / m,
            "bisect_ms_steps4": ms[4], "bisect_ms_steps12": ms[12],
            "table_gather_s": per_gather}


def probe_step(text, windows: int, reads: int, batch: int, patl: int,
               quals: bool, matchall: bool, seedl: int, seed: int) -> dict:
    """One match step at a batch shape: peak bytes over what is live
    before it, and host-inclusive seconds per step."""
    dev = text.words.device
    bbits = pick_bucket_bits(seedl, windows, reads, cap=BUCKET_BITS_CAP)
    index = build_index(text, seedl, 0, windows, bbits)
    steps = _bsearch_steps_static(windows, 8, bbits)
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, text.n - patl, batch)
    words = text.words.cpu().numpy().view(np.uint32)
    idx = pos[:, None] + np.arange(patl)
    codes = ((words[idx >> 4] >> (2 * (15 - (idx & 15)).astype(np.uint32)))
             & 3).astype(np.uint8)
    flip = rng.random(codes.shape) < 0.02
    codes[flip] = (codes[flip] + 1) & 3
    codes = torch.from_numpy(codes).to(dev)
    q = torch.from_numpy(rng.integers(0, 40, (batch, patl)).astype(np.int8)
                         ).to(dev) if quals else None
    valid = torch.ones(batch, dtype=torch.bool, device=dev)
    kw = dict(tables=score_tables(Scoring(0.995, 0.41, 0.71, 0.0, 2.0)),
              seedl=seedl, seedkmax=2, totalkmax=4, cand_cap=8,
              survivor_cap=8, scores=True, matchall=matchall,
              bsearch_steps=steps, text_has_n=text.has_n)

    def step():
        state = None if matchall else matchstep.initial_state(batch, dev)
        return matchstep.match_step(
            index.sig, index.pos, index.bb, text.words, text.nbits,
            text.ncum, text.frag_offsets, codes, q, valid, state, 0,
            np.float32(5.0), **kw)
    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    # a step queues more kernels than the stream takes behind a sleep
    # kernel, so its time is host-inclusive: what a pass costs per step
    step_ms = _event_ms(step)
    lanes = batch * 8 * patl
    del index
    return {"seedl": seedl, "batch": batch, "patl": patl, "quals": quals,
            "matchall": matchall, "bsearch_steps": steps,
            "peak_bytes": peak, "bytes_per_lane_base": peak / lanes,
            "step_ms": step_ms, "s_per_read": step_ms * 1e-3 / batch}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", default="11700000,46700000")
    ap.add_argument("--seedls", default="32,48,64")
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=2103)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    sizes = [int(w) for w in args.windows.split(",")]
    seedls = [int(x) for x in args.seedls.split(",")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "torch": torch.__version__,
           "total_memory": torch.cuda.mem_get_info(dev)[1]}
    out["wide_kernel"] = check_wide_kernel(dev)
    print(json.dumps({"wide_kernel": out["wide_kernel"]}), flush=True)

    n = max(sizes) + 64
    rng = np.random.default_rng(args.seed)
    text = build_packed_text(rng.integers(0, 4, n).astype(np.uint8),
                             [("random", 0), ("terminal", n)], dev)
    out["build"] = []
    for seedl in seedls:
        for windows in sizes:
            probe_build(text, seedl, min(windows, 1 << 20), args.reads)
            row = probe_build(text, seedl, windows, args.reads)
            out["build"].append(row)
            print(json.dumps(row), flush=True)
    out["table"] = probe_table(text, max(sizes), args.reads, args.batch, 75,
                               args.seed)
    print(json.dumps(out["table"]), flush=True)
    out["step"] = []
    for patl, quals, matchall, seedl in ((75, True, False, 32),
                                         (50, False, True, 32),
                                         (100, False, False, 32),
                                         (75, True, False, 64)):
        row = probe_step(text, max(sizes), args.reads, args.batch, patl,
                         quals, matchall, seedl, args.seed)
        out["step"].append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
