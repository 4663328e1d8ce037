"""Driver entry points of the port (the counterpart of the repository's
__graft_entry__.py, which serves the JAX package):

    entry(device)           -> (fn, example_args): one match step (probe,
                               verify and best-hit fold of a read batch
                               against a signature index) on small shapes
    dryrun_multichip(n)     -> both drivers (matchUnique and matchAll)
                               through an in-process dp x shard mesh of n
                               cells, one per card, on tiny shapes

    python -m real_tpu_torch.tools.graft_entry [n]

Both run on the card unless given device="cpu" / a list of CPU cells.
"""

from __future__ import annotations

import functools
import io
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch


def _example(device, batch: int = 256, genome_n: int = 8192,
             patl: int = 80, seed: int = 3):
    """__graft_entry__._example's inputs, on `device`: an 8,192 bp random
    genome in 2 fragments, 256 simulated reads of 80 bases, constant
    quality 30, all valid, and the default score tables."""
    from real_tpu_torch.engine.driver import resolve_device
    from real_tpu_torch.io import fasta
    from real_tpu_torch.io.reads import _MAP_TABLE
    from real_tpu_torch.scoring.scoring import Scoring, score_tables
    from real_tpu_torch.text.packed import build_packed_text
    from real_tpu_torch.tools import simulate
    dev = resolve_device(device)
    gen = simulate.random_genome(genome_n, seed=seed, num_fragments=2)
    codes, ranges = fasta.parse_genome_bytes(
        np.frombuffer(gen.encode(), np.uint8))
    text = build_packed_text(codes, ranges, dev)
    rds = simulate.generate_reads(codes, batch, patl, 0.02, False,
                                  seed=seed + 1)
    mat = np.zeros((batch, patl), np.uint8)
    for i, r in enumerate(rds):
        mat[i] = _MAP_TABLE[np.frombuffer(r.seq.encode(), np.uint8)]
    quals = np.full_like(mat, 30, np.int8)
    valid = np.ones(batch, bool)
    return (text, torch.from_numpy(mat).to(dev),
            torch.from_numpy(quals).to(dev), torch.from_numpy(valid).to(dev),
            score_tables(Scoring()))


def entry(device="cuda"):
    """(fn, args): engine.matchstep.match_step with its static settings
    bound (seedl 32, seedkmax 2, totalkmax 5, caps 32, scores, 4 bisection
    steps), and the example's index, text, batch, fresh state, file id 0
    and epsilon; fn(*args) returns (state, survivors)."""
    from real_tpu_torch.engine.matchstep import initial_state, match_step
    from real_tpu_torch.index.build import build_index
    text, mat, quals, valid, tables = _example(device)
    index = build_index(text, 32)
    state = initial_state(mat.shape[0], mat.device)
    fn = functools.partial(
        match_step, tables=tables, seedl=32, seedkmax=2, totalkmax=5,
        cand_cap=32, survivor_cap=32, scores=True, matchall=False,
        bsearch_steps=4)
    args = (index.sig, index.pos, index.bb,
            text.words, text.nbits, text.ncum, text.frag_offsets,
            mat, quals, valid, state, 0, np.float32(80 * 5 / 70))
    return fn, args


def _dry_records(device, cells: Optional[List[str]], index_shards: int):
    """(matchUnique records, matchAll records, unique hits, matchAll
    hits) of the dry run's inputs (an 8,192 bp genome in 2 fragments, 64
    reads of 80 bases) on `device`, through the in-process mesh of
    `cells` when given."""
    from real_tpu_torch.cli.output import write_all_arrays, write_unique
    from real_tpu_torch.config import RealConfig
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import fasta, reads as reads_io
    from real_tpu_torch.tools import simulate
    with tempfile.TemporaryDirectory(prefix="graft_entry_") as d:
        g, r = os.path.join(d, "g.fa"), os.path.join(d, "r.fa")
        with open(g, "w") as f:
            f.write(simulate.random_genome(8192, seed=3, num_fragments=2))
        codes, _ = fasta.parse_genome(g)
        simulate.write_reads(
            simulate.generate_reads(codes, 64, 80, 0.02, False, seed=4), r,
            False)
        cfg = RealConfig(textfilename=g, patternfilename=r,
                         outputfilename="-", batch_size=64,
                         index_shards=index_shards, scores=True,
                         mesh_devices=list(cells) if cells else None)
        rs = reads_io.parse_reads(r)
        texts = driver.load_texts(cfg, device)
        result = driver.run_match_unique(cfg, rs, texts, device)
        hits = driver.run_match_all(cfg, rs, texts, device, as_arrays=True)
    unique, every = io.StringIO(), io.StringIO()
    write_unique(unique, rs, result, texts, cfg.scores)
    write_all_arrays(every, rs, hits.cols, texts, cfg.scores)
    matched = int(((result.st == 1) | (result.st == 2)).sum())
    return unique.getvalue(), every.getvalue(), matched, len(hits.pid)


def dryrun_multichip(n_devices: int, devices: Optional[List[str]] = None):
    """Run both drivers through the in-process mesh of n_devices cells
    (RealConfig.mesh_devices): index shards over the shard axis, reads
    data-parallel over dp, survivors folded shard-major; 2 index shards
    when n_devices is even. `devices` names the cells, by default the
    first n_devices cards. Raises unless both find hits; returns the
    (matchUnique, matchAll) records."""
    from real_tpu_torch.engine.driver import resolve_device
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} cells named for {n_devices}")
    unique, every, matched, hits = _dry_records(
        resolve_device(devices[0]), devices, 2 if n_devices % 2 == 0 else 1)
    if matched == 0:
        raise AssertionError("no unique hits in the dry run")
    if hits == 0:
        raise AssertionError("no matchAll hits in the dry run")
    print(f"dryrun_multichip({n_devices}): cells {' '.join(devices)}, "
          f"{matched} unique hits, {hits} matchAll hits")
    return unique, every


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else torch.cuda.device_count())
