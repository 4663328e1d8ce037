"""Time the match loop of a source tree of this package on the card.

    python3 -m real_tpu_torch.tools.looptime --tree DIR --label NAME
        --data DIR [--runs 3] [--cells 2,4]

Imports real_tpu_torch from --tree (so that two trees, say a commit and
its parent unpacked with `git archive`, run the same measurement) and
prints one JSON line per timed run of two one-device paths: matchUnique
on a 4.6 Mbp random genome with 100,000 reads x 100 bp (batch 8,192, k <=
5) and matchAll on a 12 Mbp genome with 300,000 reads x 50 bp (batch
32,768, k <= 3), scores on, reads parsed anew, after one warmup run each.
With --cells (and a tree that has RealConfig.mesh_devices) it also times
matchUnique on an in-process mesh of that many cells on cuda:0 (-shards
1 on 2 cells, 2 on 4). Each line holds the driver's seconds (match_s),
the output's, the loop's `match` phase (loop_s, the dispatch), `drain`
and the records' SHA-256 prefix, which must agree between trees. The data
(the port's tools/simulate, fixed seeds) is written into --data once and
reused by later runs. Compare trees only within one call: run them as
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import time

PATHS = {
    # genome bases, genome seed, reads, read length, reads seed, k, batch,
    # matchUnique
    "unique": (4_600_000, 12345, 100_000, 100, 12346, 5, 8192, True),
    "matchall": (12_000_000, 1202, 300_000, 50, 1203, 3, 32768, False),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--cells", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    for name in [m for m in sys.modules if m.startswith("real_tpu_torch")]:
        del sys.modules[name]
    import torch
    from real_tpu_torch.cli.output import write_all_arrays, write_unique
    from real_tpu_torch.config import RealConfig
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import fasta, reads as reads_io
    from real_tpu_torch.tools import simulate
    if not driver.__file__.startswith(os.path.abspath(args.tree)):
        raise SystemExit(f"imported {driver.__file__}, not --tree's")
    os.makedirs(args.data, exist_ok=True)

    def inputs(name):
        n, gseed, num, patl, rseed = PATHS[name][:5]
        g = os.path.join(args.data, f"{name}.fa")
        r = os.path.join(args.data, f"{name}_reads.fa")
        if not os.path.exists(r):
            with open(g, "w") as f:
                f.write(simulate.random_genome(n, seed=gseed))
            codes, _ = fasta.parse_genome(g)
            simulate.write_reads(simulate.generate_reads(
                codes, num, patl, 0.02, False, seed=rseed), r + ".tmp",
                False)
            os.rename(r + ".tmp", r)
        return g, r

    def run(name, cells=None):
        g, r = inputs(name)
        k, batch, unique = PATHS[name][5:]
        cfg = RealConfig(textfilename=g, patternfilename=r,
                         outputfilename="-", totalkmax=k, batch_size=batch,
                         match_unique=unique)
        if cells:
            cfg.mesh_devices = ["cuda:0"] * cells
            cfg.index_shards = cells // 2
        rs = reads_io.parse_reads(r)
        texts = driver.load_texts(cfg, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        if unique:
            res = driver.run_match_unique(cfg, rs, texts, "cuda")
        else:
            res = driver.run_match_all(cfg, rs, texts, "cuda",
                                       as_arrays=True)
        t1 = time.perf_counter()
        buf = io.StringIO()
        if unique:
            write_unique(buf, rs, res, texts, True)
        else:
            write_all_arrays(buf, rs, res.cols, texts, True)
        t2 = time.perf_counter()
        ph = res.metrics["phase_s"]
        return dict(tree=args.label, path=name, cells=cells or 1,
                    match_s=t1 - t, output_s=t2 - t1, loop_s=ph["match"],
                    drain_s=ph.get("drain", 0.0),
                    sha=hashlib.sha256(buf.getvalue().encode())
                    .hexdigest()[:16])

    cells = [int(c) for c in args.cells.split(",") if c]
    if cells and not hasattr(RealConfig(), "mesh_devices"):
        cells = []
    for name, n in [(p, None) for p in PATHS] + [("unique", c)
                                                  for c in cells]:
        run(name, n)
        for _ in range(args.runs):
            print(json.dumps(run(name, n)), flush=True)


if __name__ == "__main__":
    main()
