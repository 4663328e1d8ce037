"""Index shards across ranks: a dp x shard grid (counterpart of
real_tpu/parallel/mesh.py).

real_tpu drives several devices from one process through shard_map. The
port runs one rank per device, joined through torch.distributed
(parallel/multihost.py):

* A mesh is a job of n_dp x n_shard ranks. Rank r sits at
  dp = r // n_shard, shard = r % n_shard (real_tpu's make_mesh reshape
  order).
* Each dp row of n_shard ranks matches one contiguous read slice
  (multihost.host_read_slice). Rows never meet, so every collective of a
  step runs inside one row, over the row's own process group.
* Each rank of a row holds one index shard of a pass: windows
  [start + shard * per_shard, + per_shard) (build_sharded_index); windows
  past the text's end are sentinels.
* After each step the row all-gathers its survivors (gather_survivors)
  and folds them in shard-major order (merge_shard_major), the reference's
  block-major order. Scores mode depends on that order: its fold is not
  associative (engine/monoid.py), so the gather-fold is never replaced by
  a reduce.

The gather is the transport: a step's survivors are packed into one int32
buffer, copied into pinned host memory and all-gathered over gloo (ranks
that share a card cannot use NCCL), then the row's buffers go back to the
device in one copy. The copy to the host waits for the step's device
work, so a mesh step with n_shard > 1 ends in a synchronization; a
one-shard row gathers nothing and keeps the one-device loop's dispatch
ahead. `Mesh.gather_s` counts the seconds spent in the gather (the driver's
`mesh_gather` phase), the wait for the device included.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List

import torch
import torch.distributed as dist

from real_tpu_torch.engine.matchstep import (MatchState, Survivors,
                                             compact_hits, fold_unique,
                                             scored_survivors)
from real_tpu_torch.index.build import SignatureIndex, build_index


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
