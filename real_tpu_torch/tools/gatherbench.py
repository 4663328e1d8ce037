"""Gather micro-benchmark: W consecutive 32-bit words summed at N random
offsets of a large table, timed per useful gathered element.

Counterpart of benchmarks/pallasbench.py. Two variants over the same
table and indices:

  take_sum  torch advanced indexing over a [N, W] window index and a sum
            (pallasbench's xla_take8): the yardstick
  rowsum    the hand-written row-gather-sum kernel (ops/rowsum.py,
            csrc/gather_rowsum.cu), pallasbench's pal_rowdma

    python -m real_tpu_torch.tools.gatherbench [--m 2920000] [--n 262144]
        [--w 8] [--reps 10] [--device cuda|cpu]

The table and the indices come from numpy.random.default_rng(0) as in
pallasbench (non-negative int32 words, 0 <= idx < M - 256). On the card
each variant is timed with CUDA events around `--reps` queued calls
(tools/cudatime.py); `--device cpu` runs the plain versions under the host
clock. Prints one JSON line: ns per useful gathered element of each
variant (`<name>_ns`; on the card also the host-inclusive
`<name>_host_ns`), `<name>_ok` (the variant's uint32 total equals
take_sum's) and the device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from real_tpu_torch.engine.driver import resolve_device
from real_tpu_torch.ops.rowsum import gather_rowsum
from real_tpu_torch.text.packed import MASK32, u32

LANE = 128


def make_inputs(m: int, n: int, device):
    """(table int32 [m // 128 * 128], idx int32 [n]) — pallasbench's
    rows x 128 table and its index range."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 31, (m // LANE, LANE), dtype=np.int32)
    idx = rng.integers(0, m - 2 * LANE, n, dtype=np.int32)
    return (torch.from_numpy(table.reshape(-1)).to(device),
            torch.from_numpy(idx).to(device))


def window_index(idx: torch.Tensor, w: int) -> torch.Tensor:
    """[N, w] int64 word index of every lane's window (idx < M - 256, so
    no lane reaches the table end)."""
    return idx.to(torch.int64)[:, None] + torch.arange(w, device=idx.device)


def take_sum(table: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The yardstick: per-lane int64 sum of table[win] (advanced indexing
    and torch.sum). Its low 32 bits are gather_rowsum's lane sum."""
    return table[win].sum(dim=1)


def _uint32_total(lanes: torch.Tensor) -> int:
    return int(u32(lanes).sum()) & MASK32


def _time(fn, reps: int, device: torch.device):
    """(ms per call, host-inclusive ms per call or None)."""
    if device.type == "cuda":
        from real_tpu_torch.tools.cudatime import time_ms
        return time_ms(fn, launches=reps)
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e3, None


def run(m: int = 2_920_000, n: int = 262_144, w: int = 8, reps: int = 10,
        device="cuda") -> dict:
    dev = resolve_device(device)
    if not 1 <= w <= LANE or m <= 2 * LANE:
        raise ValueError(f"need 1 <= w <= {LANE} and m > {2 * LANE}")
    table, idx = make_inputs(m, n, dev)
    win = window_index(idx, w)
    variants = [("take_sum", lambda: take_sum(table, win)),
                ("rowsum", lambda: gather_rowsum(table, idx, w))]
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "M": table.numel(), "N": n, "W": w}
    ref_total = None
    for name, fn in variants:
        total = _uint32_total(fn())
        if ref_total is None:
            ref_total = total
        ms, host_ms = _time(fn, reps, dev)
        out[f"{name}_ns"] = ms * 1e6 / (n * w)
        if host_ms is not None:
            out[f"{name}_host_ns"] = host_ms * 1e6 / (n * w)
        out[f"{name}_ok"] = total == ref_total
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=2_920_000)
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    out = run(a.m, a.n, a.w, a.reps, a.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
