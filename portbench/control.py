"""The control of the benchmark's comparison: the reference put in the
program's place with its scores summed in float32, one precision below
the float64 that real states. Its records, compared as a run compares the
program's, have to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's data as a run does and prints, for each
read file of the cell's cycle, how many of the sampled reads' records of
the control differ from the reference's, and their sum: the least a run
whose jobs printed the control's records would read. The benchmark's own
runs do not run it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, gen, run  # noqa: E402


def control_readings(cfg: dict, traffic: dict, seed: int,
                     device: str) -> list:
    """Differing records of the float32 control, per read file."""
    import importlib
    ref = importlib.import_module("portbench." + cfg["reference"])
    num = traffic["reads_per_job"]
    g = gen.cell_genome(seed, cfg)
    draws = gen.make_draws(seed, g, cfg, traffic)
    per_draw = {}
    for dnum, dr in draws.items():
        rows = gen.sample(seed, dnum, num, run.SAMPLE_READS)
        quals = None
        if dr.quals is not None:
            quals = dr.quals[rows].astype(np.int64) \
                - ref.quality_offset(dr.quals)
        ids = [bytes(x) for x in gen.read_ids(rows)]
        want, low = (ref.records(g, ids, dr.codes[rows], quals, cfg, device,
                                 dtype) for dtype in (np.float64, np.float32))
        per_draw[dnum] = check.differing(b"".join(r for r in low if r), num,
                                         rows, want)
    return [per_draw[d] for d in gen.file_draws(traffic["files"])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, cfg, traffic = run.cell_files(bench, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        per_file = control_readings(cfg, traffic, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "differing_records": sum(per_file),
                          "per_file": per_file,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
