"""Memory-bounded execution planning (after real_tpu/parallel/plan.py).

The card's equivalent of the reference's RAM-budget block sizing
(matchUniqueImplementation.cpp:1208-1244, getPhysicalMemory.cpp): the `-f`
fracmem fraction of the device's memory bounds how many index windows may
be resident, which determines the number of index shards; engine/driver.py
runs the shards as sequential passes over all reads (the reference's "build
block, re-stream all reads" outer loop, :1253-1297).

The planning functions are real_tpu's host math. What they plan WITH is
the port's own: a MemoryModel of this package's index build on this
package's tensors, and time constants of the card, both measured by
tools/planprobe.py on an NVIDIA H100 (PERF.md has the runs). real_tpu's
values describe lax.sort on uint32 planes on its device; the tests pass
them explicitly to hold the functions against real_tpu's.

Index cost model per window (index/build.py):
  resident lists: (sig + pos) x 6 lists = 48 B narrow (int32 + int32),
  72 B wide (int64 + int32);
  build peak: the finished lists plus one list's sort key, permutation
  and sort buffers, the four segment tensors and the window flags
  (`build_bytes_per_window`, measured);
  bucket tables scale with the per-shard width (pick_bucket_bits,
  occupancy ~1) and are budgeted at the 2^25 cap: 6 x (2^25+1) x 4 B ~
  805 MB each, two resident while the loop pipelines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Device bytes of an index shard, per window."""
    bytes_per_window: float      # the finished lists (sig + pos, 6 lists)
    # peak over bytes_per_window while the loop pipelines: the CURRENT
    # unit's lists stay alive while the NEXT unit is built
    build_factor: float
    # the same when the previous unit is freed before the next build
    serial_build_factor: float


def memory_model(bytes_per_window: float,
                 build_bytes_per_window: float,
                 margin: float = 1.1) -> MemoryModel:
    """A MemoryModel from a measured build peak (bytes per window of
    torch.cuda.max_memory_allocated around build_index, the text's and the
    bucket table's bytes taken off), with a margin for the allocator's
    rounding and the sizes between the measured ones."""
    return MemoryModel(
        bytes_per_window=bytes_per_window,
        build_factor=margin * (bytes_per_window + build_bytes_per_window)
        / bytes_per_window,
        serial_build_factor=margin * build_bytes_per_window
        / bytes_per_window)


# tools/planprobe.py, NVIDIA H100 80GB HBM3: build peak per window
# 133.2-133.9 B narrow and 165.2-166.0 B wide at 11.7M and 46.7M windows
# (PERF.md)
NARROW = memory_model(48, 134.0)
WIDE = memory_model(72, 166.0)

BUCKET_TABLE_BYTES = 2 * 6 * ((1 << 25) + 1) * 4   # two tables resident


def model_for(seedl: int) -> MemoryModel:
    return WIDE if seedl > 32 else NARROW


def hbm_bytes_per_device(device="cuda") -> int:
    """The memory budget's base: the card's total memory
    (torch.cuda.mem_get_info), or for a CPU run the host's RAM
    (/proc/meminfo MemTotal) — the moral equivalent of
    getPhysicalMemory.cpp:34-87. An unreadable probe raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemTotal line in /proc/meminfo")


def plan_index_shards(num_windows: int, fracmem: float,
                      reserved_bytes: int = 0,
                      hbm_bytes: Optional[int] = None,
                      model: MemoryModel = NARROW, device="cuda") -> int:
    """Number of index shards so one shard's lists (plus build
    temporaries) fit the fracmem budget of the device.

    Beyond the memory bound, one extra shard can pay for itself by keeping
    per-shard bucket occupancy <= 2 (bucket bits cap at 2^25,
    index.build.pick_bucket_bits): below that the matcher skips in-bucket
    bisection. The two candidates are compared by estimated gathers per
    read = shards * gathers per probe and the cheaper one wins (real_tpu's
    rule)."""
    hbm = hbm_bytes if hbm_bytes is not None else hbm_bytes_per_device(device)
    budget = fracmem * hbm - BUCKET_TABLE_BYTES - reserved_bytes
    if budget <= 0:
        budget = 0.25 * hbm
    per_shard_cost = model.bytes_per_window * model.build_factor
    base = max(1, math.ceil(num_windows * per_shard_cost / budget))
    nobis = max(base, math.ceil(num_windows / (2 << 25)))

    def gathers(shards: int) -> float:
        occ = num_windows / shards / float(1 << 25)
        return shards * (2 + (16 if occ > 2.0 else 8))

    return nobis if gathers(nobis) < gathers(base) else base


# one bucket table resident at a time in serial mode; cap at 2^27 entries
# (6 * 2^27 * 4 B = 3.2 GB) so the table never eats the budget
XXL_BITS_FLOOR, XXL_BITS_CAP = 25, 27


@dataclasses.dataclass
class StreamShardPlan:
    shards: int
    serial_build: bool       # driver must NOT pipeline units
    bucket_bits_cap: int     # pick_bucket_bits cap for these shards


# per-pass cost constants for the serial-vs-pipelined decision of the
# driver (_plan_shards): tools/planprobe.py on an NVIDIA H100 80GB HBM3 at
# the chr21 shapes — a 32,768 x 75 bp scored step takes 8.6 ms of host
# and device together, a 46.7M-window build 0.104-0.108 s (PERF.md)
MATCH_S_PER_READ_PASS = 0.26e-6
BUILD_S_PER_WINDOW = 2.3e-9


def plan_index_shards_streaming(num_windows: int, fracmem: float,
                                reserved_bytes: int = 0,
                                hbm_bytes: Optional[int] = None,
                                model: MemoryModel = NARROW,
                                device="cuda") -> StreamShardPlan:
    """Shard plan when every pass RE-STREAMS the reads (they exceed the
    resident budget): a pass costs a full re-upload of all reads, so the
    planner minimizes PASSES (real_tpu's plan_index_shards_streaming):

    * the build is serialized (match unit u fully, free its lists, then
      build u+1), so the peak is serial_build_factor x lists instead of
      the pipelined build_factor — each shard holds more windows and the
      pass count drops accordingly;
    * the bucket-table width cap rises from 25 to up to 27 bits so the
      bigger shards keep occupancy <= 2 and stay on the bisection-free
      lane path (only ONE table is resident in serial mode); the cap stops
      where the table would exceed a third of the budget.

    The resident-reads case keeps plan_index_shards."""
    hbm = hbm_bytes if hbm_bytes is not None else hbm_bytes_per_device(device)
    budget = fracmem * hbm - reserved_bytes
    if budget <= 0:
        budget = 0.25 * hbm
    pipe_plan = StreamShardPlan(
        shards=plan_index_shards(num_windows, fracmem,
                                 reserved_bytes=reserved_bytes,
                                 hbm_bytes=hbm, model=model),
        serial_build=False, bucket_bits_cap=25)
    # effective table width never exceeds what the window count can use
    # (pick_bucket_bits clamps to the window bit-length)
    wbits = max(num_windows - 1, 1).bit_length()

    def table_bytes(cap: int) -> int:
        return 6 * ((1 << min(cap, max(wbits, 12))) + 1) * 4

    bits_cap = XXL_BITS_FLOOR
    while bits_cap < XXL_BITS_CAP \
            and table_bytes(bits_cap + 1) < budget / 3:
        bits_cap += 1
    if budget <= 2 * table_bytes(bits_cap):
        # device too small for even one table + lists
        return pipe_plan
    per_shard = model.bytes_per_window * model.serial_build_factor
    serial = max(1, math.ceil(num_windows * per_shard
                              / (budget - table_bytes(bits_cap))))
    # shrink the cap to the narrowest width that still keeps the planned
    # shards' occupancy <= 2, then replan — the smaller table can only
    # allow fewer or as many shards
    need = max(-(-num_windows // serial) // 2, 1)
    bits_cap = min(bits_cap, max(XXL_BITS_FLOOR, (need - 1).bit_length()))
    serial = max(1, math.ceil(num_windows * per_shard
                              / (budget - table_bytes(bits_cap))))
    if serial >= pipe_plan.shards:
        # memory never binds (small genome): keep the pipelined plan
        return pipe_plan
    return StreamShardPlan(shards=serial, serial_build=True,
                           bucket_bits_cap=bits_cap)


def device_cells(devices) -> Dict[torch.device, int]:
    """The cells of an in-process mesh (parallel/mesh.py LocalMesh) on each
    distinct device, in first-seen order. Cells that share a device share
    its memory: the driver plans each cell's shard against 1/k of the
    device's memory and of the bytes reserved there (texts, reads, the
    step's workspace), so that the k shards planned for one device fit
    -f of it together, and plans over distinct devices each against that
    device's own memory (hbm_bytes_per_device)."""
    out: Dict[torch.device, int] = {}
    for d in devices:
        d = torch.device(d)
        out[d] = out.get(d, 0) + 1
    return out


def choose_mesh_shape(n_devices: int, total_shards: int):
    """(n_dp, n_shard): the shard axis is the largest divisor of
    n_devices that is <= total_shards (so no shard device idles); the
    rest is read data-parallelism. Host math for the multi-device slice."""
    n_shard = 1
    for d in range(1, n_devices + 1):
        if n_devices % d == 0 and d <= total_shards:
            n_shard = d
    return n_devices // n_shard, n_shard
