"""Index shards over a dp x shard grid (counterpart of
real_tpu/parallel/mesh.py), in two forms: a grid of the ranks of a job,
and a grid of devices that one process drives.

Both split the work as real_tpu's shard_map does:

* A cell at dp = d, shard = s of an n_dp x n_shard grid matches dp row
  d's slice of every batch against shard s of the pass: windows
  [start + s * per_shard, + per_shard) (build_sharded_index); windows
  past the text's end are sentinels.
* After each step a row gathers its cells' survivors and folds them in
  shard-major order (merge_shard_major), the reference's block-major
  order. Scores mode depends on that order: its fold is not associative
  (engine/monoid.py), so the gather-fold is never replaced by a reduce.

The rank mesh (Mesh, make_mesh): a job of n_dp x n_shard ranks joined
through torch.distributed (parallel/multihost.py), rank r at
dp = r // n_shard, shard = r % n_shard (real_tpu's make_mesh reshape
order). Each dp row matches one contiguous read slice
(multihost.host_read_slice); rows never meet, so every collective runs
inside one row, over the row's own process group. The gather is the
transport: a step's survivors are packed into one int32 buffer, copied
into pinned host memory and all-gathered over gloo (ranks that share a
card cannot use NCCL), then the row's buffers go back to the device in
one copy. The copy to the host waits for the step's device work, so a
rank mesh step with n_shard > 1 ends in a synchronization; a one-shard
row gathers nothing and keeps the one-device loop's dispatch ahead.

The local mesh (LocalMesh, make_local_mesh): one process drives every
cell, cell (d, s) on devices[d * n_shard + s] (by default every card the
process sees, real_tpu's make_mesh over jax.local_devices()); cells may
share a device. The packed text is replicated to each device
(replicate_text), every cell builds its shard on its device
(build_local_shards), and each batch's dp rows go to their cells' devices
(io/pipeline.py BatchSource.rows). A row's gather (gather_to_home) copies
each cell's survivors to the row's home device, cell (d, 0), with
Tensor.to: a peer copy between cards, nothing at all on one card. The
copy is ordered on the two devices' streams and never waits on the host,
so the loop keeps its dispatch ahead.

`gather_s` counts the host seconds spent in the gathers (the driver's
`mesh_gather` phase), for the rank mesh the wait for the device included.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from real_tpu_torch.engine.matchstep import (MatchState, Survivors,
                                             compact_hits, fold_unique,
                                             scored_survivors)
from real_tpu_torch.index.build import SignatureIndex, build_index
from real_tpu_torch.ops import gather as gather_ops
from real_tpu_torch.text.packed import PackedText


@dataclasses.dataclass
class Mesh:
    """This rank's place in an n_dp x n_shard grid and its shard row's
    process group (group rank == shard)."""
    n_dp: int
    n_shard: int
    dp: int
    shard: int
    group: object = None
    gather_s: float = 0.0      # host seconds inside gather_survivors
    gathers: int = 0           # collectives run by gather_survivors


def make_mesh(n_dp: int, n_shard: int) -> Mesh:
    """This rank's Mesh in a job of exactly n_dp * n_shard ranks. Every
    rank creates every row's group, in the same order (a group only some
    ranks create hangs the rest); a row's ranks are given ascending, so
    that the group rank is the shard."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialized process group "
                           "(parallel/multihost.initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_dp * n_shard:
        raise ValueError(f"a {n_dp} x {n_shard} mesh needs "
                         f"{n_dp * n_shard} ranks, the job has {world}")
    group = None
    for d in range(n_dp):
        g = dist.new_group(list(range(d * n_shard, (d + 1) * n_shard)))
        if d == rank // n_shard:
            group = g
    return Mesh(n_dp, n_shard, rank // n_shard, rank % n_shard, group)


def build_sharded_index(text, seedl: int, start: int, per_shard: int,
                        mesh: Mesh, bucket_bits: int) -> SignatureIndex:
    """This rank's shard of a pass: the index over windows
    [start + shard * per_shard, + per_shard). start and per_shard are
    16-aligned; windows at or past the text's last are sentinels, also in
    a shard that lies wholly past it."""
    return build_index(text, seedl, start=start + mesh.shard * per_shard,
                       num_windows=per_shard, bucket_bits=bucket_bits)


_PLANES = 5      # flags (valid | inv << 1), pos, frag, k, score bits


def _pack(surv: Survivors) -> torch.Tensor:
    """One step's survivors as one int32 buffer [5 * B * S + B]."""
    flags = surv.valid.to(torch.int32) | (surv.inv.to(torch.int32) << 1)
    return torch.cat([flags.reshape(-1), surv.pos.reshape(-1),
                      surv.frag.reshape(-1), surv.k.reshape(-1),
                      surv.score.view(torch.int32).reshape(-1),
                      surv.overflow.to(torch.int32)])


def _unpack(buf: torch.Tensor, B: int, S: int) -> Survivors:
    planes = buf[:_PLANES * B * S].view(_PLANES, B, S)
    return Survivors(valid=(planes[0] & 1).bool(),
                     inv=(planes[0] & 2).bool(), pos=planes[1],
                     frag=planes[2], k=planes[3],
                     score=planes[4].view(torch.float32),
                     overflow=buf[_PLANES * B * S:].bool())


def gather_survivors(surv: Survivors, mesh: Mesh) -> List[Survivors]:
    """The survivors of every rank of this rank's shard row, in shard
    order (the collective of a mesh step). A failed collective raises."""
    if mesh.n_shard == 1:
        return [surv]
    t = time.perf_counter()
    B, S = surv.valid.shape
    dev = surv.valid.device
    pin = dev.type == "cuda"
    packed = _pack(surv)
    local = torch.empty(packed.shape, dtype=torch.int32, pin_memory=pin)
    local.copy_(packed)                       # waits for the step
    recv = torch.empty((mesh.n_shard, packed.shape[0]), dtype=torch.int32,
                       pin_memory=pin)
    dist.all_gather(list(recv.unbind(0)), local, group=mesh.group)
    parts = recv.to(dev, non_blocking=True)
    mesh.gather_s += time.perf_counter() - t
    mesh.gathers += 1
    return [_unpack(p, B, S) for p in parts.unbind(0)]


def merge_shard_major(parts: List[Survivors], state: MatchState, fileid: int,
                      epsilon: float, *, scores: bool,
                      matchall: bool = False):
    """Fold a row's survivors in shard-major order (real_tpu/parallel/
    mesh.py sharded_match_step): [n_shard] x [B, S] -> [B, n_shard * S],
    the overflow flags OR'd over the shards, then fold_unique, or for
    matchAll compact_hits with cap = max(2B, B * n_shard * S // 2).
    Returns (new_state, overflow [B]), or (state, CompactHits) for
    matchAll, whose row ids are local to the row's batch."""
    seq = Survivors(*(torch.cat([getattr(p, f) for p in parts], dim=1)
                      for f in Survivors._fields[:-1]),
                    overflow=torch.stack([p.overflow for p in parts])
                    .any(dim=0))
    if matchall:
        B, L = seq.valid.shape
        return state, compact_hits(seq, cap=max(2 * B, B * L // 2))
    return (fold_unique(state, seq, fileid, epsilon, scores=scores),
            seq.overflow)


def sharded_match_step(index_sig, index_pos, index_bb,
                       words, nbits, ncum, frag_offsets,
                       codes, quals, read_valid,
                       state: MatchState, fileid: int, epsilon: float,
                       *, mesh: Mesh, tables=None, seedl: int,
                       seedkmax: int, totalkmax: int, cand_cap: int,
                       survivor_cap: int, scores: bool,
                       matchall: bool = False, bsearch_steps: int = 0,
                       text_has_n: bool = True):
    """One step of this rank: its batch rows (its row's read slice)
    against its index shard, the row's gather, the shard-major fold.
    Returns what real_tpu's sharded_match_step returns: (new_state,
    overflow [B]) for matchUnique, (state, CompactHits) for matchAll."""
    surv = scored_survivors(
        index_sig, index_pos, index_bb, words, nbits, ncum, frag_offsets,
        codes, quals, read_valid, tables=tables, seedl=seedl,
        seedkmax=seedkmax, totalkmax=totalkmax, cand_cap=cand_cap,
        survivor_cap=survivor_cap, scores=scores,
        bsearch_steps=bsearch_steps, text_has_n=text_has_n)
    return merge_shard_major(gather_survivors(surv, mesh), state, fileid,
                             epsilon, scores=scores, matchall=matchall)


def agree_resume(mesh: Mesh, units_done: int) -> int:
    """The unit count a row resumes from: the one its ranks' checkpoints
    all hold, or 0 (with a message) when they differ. A row never resumes
    from the smallest count: folding a unit twice is not safe in scores
    mode."""
    t = torch.tensor([units_done, -units_done], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    lo, hi = int(t[0]), -int(t[1])
    if lo != hi:
        print(f"rank at dp {mesh.dp}, shard {mesh.shard}: the row's "
              f"checkpoints hold {lo} to {hi} units; starting from unit 0",
              file=sys.stderr)
        return 0
    return lo


# ---------------------------------------------------------------------------
# the local mesh: one process, a grid of devices
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocalMesh:
    """An n_dp x n_shard grid of cells that this process drives: cell
    (d, s) is number d * n_shard + s and runs on devices[that number]
    (real_tpu's make_mesh reshape order). Row d's home is cell (d, 0):
    its survivors are folded and its state lives there."""
    n_dp: int
    n_shard: int
    devices: List[torch.device]
    gather_s: float = 0.0      # host seconds inside gather_to_home
    gathers: int = 0           # row gathers run
    # the hand kernels' launches made by each cell's steps, by cell number
    launches: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def cell(self, d: int, s: int) -> torch.device:
        return self.devices[d * self.n_shard + s]

    def home(self, d: int) -> torch.device:
        return self.cell(d, 0)

    def layout(self) -> List[List[torch.device]]:
        """Each row's distinct devices, in shard order (what the row's
        slice of a batch is uploaded to: BatchSource.rows)."""
        return [list(dict.fromkeys(self.cell(d, s)
                                   for s in range(self.n_shard)))
                for d in range(self.n_dp)]


def local_devices() -> List[torch.device]:
    """Every card this process sees: cuda:0 .. cuda:N-1; raises without
    CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a mesh of every card "
                           "needs cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def check_cells(devices) -> List[torch.device]:
    """The cells' devices as torch.devices. A CUDA cell names its card
    (cuda:K) and K must be a card this process sees; anything else raises
    (a cell never moves to another device)."""
    out = []
    for x in devices:
        d = torch.device(x)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh cell on {d}: CUDA is not "
                                   "available")
            if d.index is None:
                raise ValueError("a mesh cell names its card (cuda:K), "
                                 "not cuda")
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"mesh cell on {d} cannot be reached: the process sees "
                    f"{torch.cuda.device_count()} card(s)")
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh cell device {x!r}")
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one cell")
    return out


def make_local_mesh(n_dp: int, n_shard: int,
                    devices: Optional[list] = None) -> LocalMesh:
    """A LocalMesh over the first n_dp * n_shard of `devices` (default:
    every card, local_devices())."""
    devices = check_cells(local_devices() if devices is None else devices)
    if len(devices) < n_dp * n_shard:
        raise ValueError(f"a {n_dp} x {n_shard} mesh needs "
                         f"{n_dp * n_shard} cells, {len(devices)} given")
    return LocalMesh(n_dp, n_shard, devices[:n_dp * n_shard])


_TEXT_TENSORS = ("words", "nbits", "ncum", "frag_offsets", "nb16", "ncum16")


def replicate_text(text: PackedText,
                   devices) -> Dict[torch.device, PackedText]:
    """The packed text on each distinct device of `devices` (real_tpu
    replicates it to the whole mesh, P()); the device that holds it keeps
    the same tensors."""
    out = {}
    for d in dict.fromkeys(torch.device(x) for x in devices):
        out[d] = text if text.words.device == d else dataclasses.replace(
            text, **{f: getattr(text, f).to(d) for f in _TEXT_TENSORS})
    return out


def build_local_shards(texts: Dict[torch.device, PackedText], seedl: int,
                       start: int, per_shard: int, mesh: LocalMesh,
                       bucket_bits: int
                       ) -> Dict[Tuple[torch.device, int], SignatureIndex]:
    """Every cell's shard of a pass, built on the cell's device from its
    replica of the text: shard s covers windows [start + s * per_shard,
    + per_shard), keyed (device, s). Cells of one shard on one device share
    its build (the same lists). start and per_shard are 16-aligned."""
    out = {}
    for i, dev in enumerate(mesh.devices):
        s = i % mesh.n_shard
        if (dev, s) not in out:
            out[(dev, s)] = build_index(
                texts[dev], seedl, start=start + s * per_shard,
                num_windows=per_shard, bucket_bits=bucket_bits)
    return out


def gather_to_home(parts: List[Survivors], mesh: LocalMesh,
                   d: int) -> List[Survivors]:
    """Row d's cells' survivors, in shard order, on the row's home device:
    Tensor.to, a peer copy from another card, nothing on the home card.
    The copies are ordered on both devices' streams without a host wait;
    a failed one raises. A one-shard row gathers nothing."""
    if mesh.n_shard == 1:
        return parts
    t = time.perf_counter()
    home = mesh.home(d)
    out = [Survivors(*(x.to(home, non_blocking=True) for x in p))
           for p in parts]
    mesh.gather_s += time.perf_counter() - t
    mesh.gathers += 1
    return out


def local_row_step(mesh: LocalMesh, d: int,
                   indexes: Dict[Tuple[torch.device, int], SignatureIndex],
                   texts: Dict[torch.device, PackedText], batches: Dict,
                   state: Optional[MatchState], fileid: int,
                   epsilon: float, *, tables=None, seedl: int,
                   seedkmax: int, totalkmax: int, cand_cap: int,
                   survivor_cap: int, scores: bool, matchall: bool = False,
                   bsearch_steps: int = 0, text_has_n: bool = True):
    """Row d of one local mesh step (real_tpu's sharded_match_step on
    the row's cells): each cell (d, s) matches the row's slice of the
    batch on its device (batches[device], io/pipeline.py Batch) against
    its shard (indexes[(device, s)]) and its replica of the text; the row
    gathers the survivors on its home device and folds them shard-major.
    `state` lives on the home device. Returns merge_shard_major's result:
    (new_state, overflow) for matchUnique, (state, CompactHits with row
    ids local to the row) for matchAll. Each cell's kernel launches are
    counted in mesh.launches."""
    parts = []
    for s in range(mesh.n_shard):
        c = d * mesh.n_shard + s
        dev = mesh.devices[c]
        index, text, b = indexes[(dev, s)], texts[dev], batches[dev]
        before = gather_ops.launch_counts()
        parts.append(scored_survivors(
            index.sig, index.pos, index.bb, text.words, text.nbits,
            text.ncum, text.frag_offsets, b.codes, b.quals, b.valid,
            tables=tables, seedl=seedl, seedkmax=seedkmax,
            totalkmax=totalkmax, cand_cap=cand_cap,
            survivor_cap=survivor_cap, scores=scores,
            bsearch_steps=bsearch_steps, text_has_n=text_has_n))
        after = gather_ops.launch_counts()
        counts = mesh.launches.setdefault(c, dict.fromkeys(after, 0))
        for k, v in after.items():
            counts[k] += v - before[k]
    return merge_shard_major(gather_to_home(parts, mesh, d), state, fileid,
                             epsilon, scores=scores, matchall=matchall)
