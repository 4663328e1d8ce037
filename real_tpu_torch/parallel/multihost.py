"""Several processes over one read file (counterpart of
real_tpu/parallel/multihost.py).

The reference is strictly single-node. The port runs several processes
("ranks") joined through torch.distributed. real_tpu's design is that
every process of a job drives a mesh of its own local devices over its
read slice; here a rank drives the cards `rank_cells` gives it: a card of
its own, several, or a card shared with other ranks past the card count:

* `initialize` joins the job: an explicit init method (a `file://` store
  or `tcp://host:port`), world size and rank, or torchrun's RANK /
  WORLD_SIZE / MASTER_ADDR / MASTER_PORT. The backend is gloo: the ranks
  only meet, matching exchanges nothing between them, and NCCL refuses two
  ranks on one card. A plain single process stays a no-op.
* Cards: `rank_cells` gives a rank asking for plain "cuda" its share of
  its node's cards, interleaved by local rank (LOCAL_RANK and
  LOCAL_WORLD_SIZE under torchrun). A share of one card is `rank_device`'s
  card (modulo the card count, so ranks share cards once there are more
  ranks than cards); a share of several is the rank's in-process dp x
  shard mesh (engine/driver.py local_mesh_cells, real_tpu's
  `jax.local_devices()` mesh per process), as is RealConfig.mesh_devices,
  which names a rank's cells. A rank's local mesh with -exchange raises.
* Input: each rank parses only its contiguous slice of the read file
  (`parse_host_slice` -> io/reads.parse_reads_sliced); the genome is
  parsed and packed by every rank.
* Output: each rank writes its slice's records; concatenating the ranks'
  outputs in rank order reproduces the single-process file byte for byte
  (slices are contiguous in read order and the output pass is read-ordered).
* `BuildExchange` (-exchange <dir>): index shards are owned round-robin by
  rank; every rank takes rank 0's shard plan, builds only its own shards
  and loads the others' from a shared directory, so the build is 1/P per
  process.
* -mesh: the ranks form a dp x shard grid instead (parallel/mesh.py,
  engine/driver.py plan_mesh): every rank parses the whole read file, the
  grid's shape comes from rank 0's shard plan (`dp_shard_axes` over the
  node's ranks, so that a shard row stays on one node), each dp row
  matches its slice (`host_read_slice`), and each rank of a row holds one
  index shard of each pass. The row's shard-0 rank writes the row's
  records and the others an empty file, so the rank-order concatenation
  is again the one-process file. -mesh with -exchange raises.

`python -m real_tpu_torch.parallel.multihost` runs one rank of such a job
through the CLI (`main`, which parses the job's flags and calls
`run_rank`). tests/test_torch_multihost.py, tests/test_torch_mesh_ranks.py
and tests/test_torch_rank_local_mesh.py spawn real processes and hold the
concatenation equal to the one-process file.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from real_tpu_torch.convert import index_from_numpy, index_to_numpy


@dataclasses.dataclass
class HostTopology:
    process_index: int
    process_count: int


def current_topology() -> HostTopology:
    """This process's rank and the job's size (0 of 1 outside a job)."""
    if dist.is_available() and dist.is_initialized():
        return HostTopology(dist.get_rank(), dist.get_world_size())
    return HostTopology(0, 1)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               timeout_s: float = 600.0) -> HostTopology:
    """Join the multi-process job over gloo.

    With an init method or a world size above 1 they are passed through
    (with the rank); with neither, torchrun's environment (WORLD_SIZE > 1
    with RANK, MASTER_ADDR, MASTER_PORT) is read through `env://`. A plain
    single process stays a no-op. A rank that does not arrive within
    timeout_s makes the rendezvous raise."""
    if not dist.is_initialized():
        timeout = datetime.timedelta(seconds=timeout_s)
        if init_method is not None or (world_size or 1) > 1:
            dist.init_process_group("gloo", init_method=init_method,
                                    world_size=world_size, rank=rank,
                                    timeout=timeout)
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=timeout)
    return current_topology()


def rank_device(device: str, topo: HostTopology, device_count: int,
                env=None) -> str:
    """The device this rank runs on. Plain "cuda" in a job of several ranks
    names the rank's own card: LOCAL_RANK under torchrun (the rank among
    its node's processes), else the rank; modulo the card count, so that
    ranks share cards once there are more ranks than cards. An explicit
    card ("cuda:1"), the CPU and a single process stay as asked."""
    if device != "cuda" or topo.process_count <= 1:
        return device
    env = os.environ if env is None else env
    local = int(env.get("LOCAL_RANK", topo.process_index))
    return f"cuda:{local % max(device_count, 1)}"


def local_rank_count(topo: HostTopology, env=None) -> int:
    """Ranks on this rank's node, the port's "local devices" of a node:
    LOCAL_WORLD_SIZE under torchrun (which numbers a node's ranks
    contiguously), else the whole job (one node)."""
    env = os.environ if env is None else env
    return int(env.get("LOCAL_WORLD_SIZE", topo.process_count))


def rank_cells(device: str, topo: HostTopology, device_count: int,
               env=None) -> List[str]:
    """The cards this rank drives. Plain "cuda" in a job of several ranks
    gives each of a node's L ranks (local_rank_count) b = cards // L of
    them, interleaved: cuda:l, cuda:l + L, ... for local rank l, the first
    being rank_device's card. With b <= 1 a rank keeps rank_device's one
    card (shared modulo the count once ranks outnumber cards); cards past
    b * L stay idle, which local rank 0 says on stderr. An explicit card,
    the CPU and a single process keep what was asked for."""
    if device != "cuda" or topo.process_count <= 1:
        return [device]
    env = os.environ if env is None else env
    n_local = local_rank_count(topo, env)
    share = device_count // max(n_local, 1)
    if share <= 1:
        return [rank_device(device, topo, device_count, env)]
    local = int(env.get("LOCAL_RANK", topo.process_index))
    if not 0 <= local < n_local:
        raise ValueError(f"local rank {local} outside the node's {n_local} "
                         "ranks (LOCAL_RANK, LOCAL_WORLD_SIZE)")
    idle = device_count - share * n_local
    if idle and local == 0:
        print(f"{idle} of {device_count} cards stay idle: {n_local} ranks "
              f"take {share} each", file=sys.stderr)
    return [f"cuda:{local + i * n_local}" for i in range(share)]


def host_read_slice(num_reads: int, topo: HostTopology) -> Tuple[int, int]:
    """[lo, hi) patid range that process (or dp row) `topo` matches:
    contiguous slices keep the output a simple concatenation, and every
    slice but the last holds a multiple of 16 reads."""
    from real_tpu_torch.io.reads import split_records
    return split_records(num_reads, topo.process_index, topo.process_count)


def dp_shard_axes(n_local_devices: int, n_processes: int,
                  total_index_shards: int) -> Tuple[int, int]:
    """(n_dp, n_shard) of a job of n_processes nodes of n_local_devices
    each: the shard axis never crosses a node (its all-gathers stay
    inside one), and dp takes the rest (local dp x nodes)."""
    from real_tpu_torch.parallel.plan import choose_mesh_shape
    local_dp, n_shard = choose_mesh_shape(n_local_devices,
                                          total_index_shards)
    return local_dp * n_processes, n_shard


def parse_host_slice(path: str, topo: HostTopology,
                     quality_offset: int = 0, use_native: bool = True):
    """Parse only THIS rank's record slice of the read file. Returns a
    rank-local ReadSet (patids 0..n_local): matching and output run on it
    directly, and the rank-order concat of outputs equals the
    single-process file."""
    from real_tpu_torch.io import reads as reads_io
    rs, _lo, _total = reads_io.parse_reads_sliced(
        path, topo.process_index, topo.process_count, quality_offset,
        use_native=use_native)
    return rs


class BuildExchange:
    """De-replicated index build: index units are owned round-robin by
    rank (unit % P); each rank builds and publishes its own, and every rank
    loads every unit in ascending order (the order scores mode needs: its
    merge is not associative, tests/test_torch_monoid.py).

    Every rank must see the same units: `agree` hands rank 0's plan to all
    (a rank's read slice, and with it the planner's budget, may differ from
    the others'), after rank 0 has cleared the shards an earlier run left
    in the directory, whose markers would otherwise pass for this run's.

    Transport is a shared directory, in real_tpu's layout so that either
    package reads the other's shards: `shard_{unit:05d}.npz` holding sig
    (uint32; the low plane of wide signatures), pos, bb, seedl,
    bucket_bits and, for wide seeds, sig_hi, published through os.replace
    and followed by a `shard_{unit:05d}.done` marker that readers poll for.
    A shard that does not appear within timeout_s raises TimeoutError."""

    def __init__(self, root: str, topo: HostTopology, device,
                 timeout_s: float = 600.0):
        self.root = root
        self.topo = topo
        self.device = device
        self.timeout_s = timeout_s
        os.makedirs(root, exist_ok=True)

    def agree(self, plan):
        """Rank 0's `plan` on every rank (a broadcast over the job's
        group); rank 0 first removes every shard file in the directory."""
        if self.topo.process_index == 0:
            for name in os.listdir(self.root):
                if name.startswith("shard_"):
                    os.remove(os.path.join(self.root, name))
        box = [plan]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def owns(self, unit: int) -> bool:
        return unit % self.topo.process_count == self.topo.process_index

    def _base(self, unit: int) -> str:
        return os.path.join(self.root, f"shard_{unit:05d}")

    def save(self, unit: int, index) -> None:
        """Publish an owned unit's built index."""
        a = index_to_numpy(index)
        arrays = dict(sig=a["sig"], pos=a["pos"], bb=a["bb"],
                      seedl=np.asarray([a["seedl"]]),
                      bucket_bits=np.asarray([a["bucket_bits"]]))
        if a["sig_hi"] is not None:
            arrays["sig_hi"] = a["sig_hi"]
        base = self._base(unit)
        np.savez(base + ".tmp.npz", **arrays)
        os.replace(base + ".tmp.npz", base + ".npz")
        with open(base + ".done.tmp", "w") as f:
            f.write("ok")
        os.replace(base + ".done.tmp", base + ".done")

    def load(self, unit: int):
        """Wait until the owning rank has published `unit`, then load it
        onto this rank's device."""
        base = self._base(unit)
        t0 = time.monotonic()
        while not os.path.exists(base + ".done"):
            if time.monotonic() - t0 > self.timeout_s:
                raise TimeoutError(
                    f"rank {self.topo.process_index}: shard {unit} not "
                    f"published by its owner within {self.timeout_s}s")
            time.sleep(0.02)
        with np.load(base + ".npz") as z:
            return index_from_numpy(
                z["sig"], z["pos"], z["bb"], int(z["bucket_bits"][0]),
                int(z["seedl"][0]), self.device,
                sig_hi=z["sig_hi"] if "sig_hi" in z else None)


USAGE = ("usage: python -m real_tpu_torch.parallel.multihost "
         "[-init_method URL -world N -rank R] [-mesh] "
         "<real_tpu_torch CLI flags>")


def _rank_path(path: str, topo: HostTopology) -> str:
    """A per-rank file name: `path` with `.<rank>` appended ('-' and ''
    stay as they are)."""
    return path if path in ("", "-") else f"{path}.{topo.process_index}"


@dataclasses.dataclass
class Job:
    """How a rank joins its job: an init method, the world size and this
    rank; None where torchrun's environment says it (initialize)."""
    init_method: Optional[str] = None
    world: Optional[int] = None
    rank: Optional[int] = None


def parse_job(argv: List[str]) -> Tuple[Job, List[str]]:
    """The job's flags (-init_method URL -world N -rank R) out of a rank's
    command line, and the CLI flags left."""
    args = list(argv)
    job = Job()
    for flag, attr, typ in (("-init_method", "init_method", str),
                            ("-world", "world", int),
                            ("-rank", "rank", int)):
        if flag in args:
            i = args.index(flag)
            setattr(job, attr, typ(args[i + 1]))
            del args[i:i + 2]
    return job, args


def run_rank(cfg, job: Job) -> int:
    """One rank of a job: join it, take this rank's cards, parse this
    rank's slice of -p (the whole file under -mesh, whose grid comes from
    a plan over every read), match it and write the records to
    `<-o>.<rank>` (and -metrics / -ckpt likewise per rank).
    `cat out.0 out.1 ...` is the one-process output. With use_mesh None a
    rank of several cells (cfg.mesh_devices, else rank_cells) drives them
    as its in-process mesh (engine/driver.py local_mesh_cells); that
    mesh with -exchange raises."""
    from real_tpu_torch.cli import main as cli
    from real_tpu_torch.engine import driver
    cfg.validate()                        # -mesh with -exchange raises
    driver.resolve_device(cfg.device)     # no card: raise before joining
    topo = initialize(job.init_method, job.world, job.rank)
    try:
        cells = driver.local_mesh_cells(cfg, cfg.device)
        if cells:
            cfg.mesh_devices = [str(c) for c in cells]
            device = cells[0]
        else:
            device = driver.resolve_device(rank_device(
                cfg.device, topo, torch.cuda.device_count()))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        print(f"rank {topo.process_index} of {topo.process_count}: device "
              f"{device}" + (f", cells {' '.join(cfg.mesh_devices)}"
                             if cells else ""), file=sys.stderr)
        cfg.outputfilename = _rank_path(cfg.outputfilename, topo)
        cfg.metrics_json = _rank_path(cfg.metrics_json, topo)
        cfg.checkpoint = _rank_path(cfg.checkpoint, topo)
        if cfg.use_mesh:
            from real_tpu_torch.io import reads as reads_io
            rs = reads_io.parse_reads(cfg.patternfilename,
                                      cfg.quality_offset, cfg.native_host)
        else:
            rs = parse_host_slice(cfg.patternfilename, topo,
                                  cfg.quality_offset, cfg.native_host)
        return cli.run(cfg, rs, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> int:
    """One rank of a multi-process run through the CLI: the job's flags
    (-init_method / -world / -rank, or torchrun's environment), -mesh and
    the CLI's flags, then run_rank. -mesh runs the ranks as a mesh (module
    doc); its conflicts raise before the rank joins the job."""
    from real_tpu_torch.cli import main as cli
    job, args = parse_job(sys.argv[1:] if argv is None else argv)
    use_mesh = "-mesh" in args
    if use_mesh:
        args.remove("-mesh")
    if not args:
        print(USAGE, file=sys.stderr)
        return 1
    cfg = cli.parse_args(args)
    if use_mesh:
        cfg.use_mesh = True
    return run_rank(cfg, job)


if __name__ == "__main__":
    sys.exit(main())
