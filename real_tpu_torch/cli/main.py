"""`real`-compatible command line interface of the PyTorch/CUDA port.

Flags mirror real_tpu's CLI (RealOptions.cpp:142-396), plus -device:

  python -m real_tpu_torch.cli.main -t <text.fa|dir> -p <reads> -o <out|->
           [-s k_seed] [-e k_total] [-l seedl] [-u 0|1] [-q 0|1]
           [-Q offset] [-f fracmem] [-T threads] [-m sortthreads] [-R 0|1]
           [-g 0|1] [-similarity x] [-err x] [-trans x] [-gc x]
           [-gcmut_bias x] [-filter_level 0..4] [-v 0|1]
           [-B batch] [-K cand_cap] [-S survivor_cap] [-device cuda|cpu]
           [-native 0|1] [-shards n] [-ckpt path] [-ckpt_every units]
           [-watchdog seconds] [-debug 0|1] [-metrics path] [-trace dir]
           [-exchange dir]

-R 1 (the default) keeps the parsed reads in a store directory next to the
read file (io/readstore.py) and loads it on later runs. -native 0 runs the
host phases through their plain NumPy versions instead of the C++ library
(native/readpack.cpp), which is built at first use.

Runs matchUnique (-u 1) and matchAll (-u 0) with seeds up to 64 bases on
one device, or, when the process sees more than one card and -device is
the plain `cuda` (the default), on every card at once as a dp x shard
grid of cells (the in-process mesh, parallel/mesh.py LocalMesh);
-device cuda:K pins one card. -f bounds the share of the device's memory the index may
fill: the planner (parallel/plan.py) splits a text's index into as many
shards as that needs, and -shards N forces the count; reads beyond the
resident budget are streamed once per shard. -ckpt saves the state after
every -ckpt_every index units and a later run with the same arguments
resumes there; -watchdog aborts a run whose device fetch hangs; -debug 1
checks every step's scores and the result's invariants.

-metrics writes the run's metrics as JSON after the records: the phase
seconds (`phase_s`), the overflow reruns, the unit loop's account and
wall_s, num_reads, reads_per_sec, mode and native_paths_active. `spans`
lists the job's spans (utils/spans.py), one object each: `id`, `name`,
`parent` (the id of the span it ran in, null for `job`), `thread` (the
native thread id) and `start_ns` / `end_ns` from the job's start. `job`
runs from after the argument parse to before the metrics write; under it
`parse.reads` (the read file's parse or store load), `genome.load` (with
`genome.parse`, `genome.pack` and `genome.upload` for each text), `driver`
(each match call; an overflow rerun's nested in its caller's) with `plan`
(the shard planner and its memory query) and the phases of `phase_s`, and
`output` (the records) with an `output.format` for each chunk formatted
and an `output.write` for each chunk written, on the formatter and writer
threads. A phase_s entry is the sum of its phase's spans (`rerun.` for
those under a nested `driver`); wall_s runs from after `genome.load` to
after `output`. `stream_wait_s` is the seconds the match loop spent
waiting for the streaming reads' producer (io/pipeline.py; 0 when the
reads stay resident; `streamed_batches` counts the batches). `counters`
holds every counter of the job (utils/spans.py `add`) as it was summed:
`stream_wait_s` unrounded, `output.records` (records formatted),
`output.score_slow` (scores the native formatter left to snprintf: those
within 1e-3 of zero, from 1e9 on, inf, NaN), and on the matchAll path
`allhits.decoded` (hit rows decoded from the steps' compacted hits, every
rerun depth) and `allhits.records` (records written). A matchAll job's
`driver` spans hold `allhits.wait` (the host waiting for a step's hit
copy), `allhits.decode` (decoding a step's hits) and `allhits.sort` (each
sort and dedup of the hit columns). -trace records the whole job, from
the read parse to the last record, with torch.profiler (CPU and CUDA
activities on the card, the CPU alone under -device cpu) and writes
one Chrome trace into the directory; each span of
the job's own thread is a `user_annotation` there. -exchange <dir> splits
the index build between the ranks of a multi-process run
(parallel/multihost.py, which also runs one rank of such a run); in a
single process it changes nothing. The runner's -mesh
(cfg.use_mesh) spreads the index shards over the ranks instead
(parallel/mesh.py): its metrics add the rank's `mesh` coordinates and the
`mesh_gather` phase; the in-process mesh's add its `mesh` account (each
text's grid, the cells' devices, each cell's kernel launches) and the same
phase. Every metrics file holds `kernel_launches`, the hand
kernels' launches in the run, the genome pack's (`pack_text`, one a text)
and the score and fold's (`score_fold`, one a step) among them
(ops/gather.py launch_counts), which stay 0 on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import time
from typing import List, Optional

from real_tpu_torch.config import RealConfig
from real_tpu_torch.utils import spans


def parse_args(argv: List[str]) -> RealConfig:
    cfg = RealConfig()
    i = 0
    flags_with_arg = {
        "-t": ("textfilename", str), "-p": ("patternfilename", str),
        "-o": ("outputfilename", str), "-s": ("seedkmax", int),
        "-e": ("totalkmax", int), "-l": ("seedl", int),
        "-f": ("fracmem", float), "-Q": ("quality_offset", int),
        "-m": ("sort_threads", int),
        "-similarity": ("similarity", float), "-err": ("err", float),
        "-trans": ("trans", float), "-gc": ("gc", float),
        "-gcmut_bias": ("gcmut_bias", float),
        "-filter_level": ("filter_level", int),
        # engine knobs
        "-B": ("batch_size", int), "-K": ("cand_cap", int),
        "-S": ("survivor_cap", int), "-shards": ("index_shards", int),
        "-ckpt": ("checkpoint", str), "-ckpt_every": ("checkpoint_every",
                                                      int),
        "-trace": ("trace", str), "-metrics": ("metrics_json", str),
        "-watchdog": ("watchdog_s", int),
        "-exchange": ("build_exchange_dir", str),
        "-device": ("device", str),
    }
    bool_flags = {"-u": "match_unique", "-q": "scores",
                  "-R": "rewritepatterns", "-g": "gaps", "-v": "verbose",
                  "-debug": "debug_checks", "-native": "native_host"}
    while i < len(argv):
        a = argv[i]
        if a in flags_with_arg:
            attr, typ = flags_with_arg[a]
            setattr(cfg, attr, typ(argv[i + 1]))
            i += 2
        elif a in bool_flags:
            setattr(cfg, bool_flags[a], bool(int(argv[i + 1])))
            i += 2
        elif a == "-T":
            i += 2   # thread count: no-op, kept for CLI parity
        elif a in ("-h", "--help"):
            print(__doc__, file=sys.stderr)
            sys.exit(0)
        else:
            print(f"Ignoring argument {a}", file=sys.stderr)
            i += 1
    if not (cfg.textfilename and cfg.patternfilename and cfg.outputfilename):
        print(__doc__, file=sys.stderr)
        raise SystemExit("Mandatory arguments -t/-p/-o missing")
    cfg.validate()
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import readstore

    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    device = driver.resolve_device(cfg.device)
    with _profiled(cfg.trace, device):
        return _job(cfg, device, lambda: readstore.parse_reads_cached(
            cfg.patternfilename, cfg.quality_offset,
            rewrite=cfg.rewritepatterns, use_native=cfg.native_host))


def run(cfg: RealConfig, rs, device) -> int:
    """Match the parsed reads `rs` against cfg's texts on `device` and
    write the records, then the -metrics file, as one job: main() parses
    the whole read file first, one rank of a multi-process run enters here
    with only its slice (parallel/multihost.py), a rank of a mesh run
    (cfg.use_mesh) with the whole file again: run lays the mesh out
    (driver.plan_mesh) and matches the rank's row slice, and only a row's
    shard-0 rank writes records (the others leave their output empty).
    -trace opens the profiler here unless one is already recording."""
    with _profiled("" if spans.profiling() else cfg.trace, device):
        return _job(cfg, device, lambda: rs)


def _job(cfg: RealConfig, device, reads) -> int:
    """One job: the `job` span around the reads (`reads()`), the match and
    the output, then the -metrics file with the job's spans."""
    rec = spans.Recorder()
    with rec.job():
        metrics, num_reads, wall = _match_and_write(cfg, reads(), device)
    if cfg.metrics_json:
        _write_metrics(cfg, dict(
            metrics, spans=rec.export(), counters=dict(rec.counters),
            stream_wait_s=round(rec.counters.get("stream_wait_s", 0.0), 6)),
            num_reads, wall)
    return 0


def _match_and_write(cfg: RealConfig, rs, device):
    """The texts' load, the match and the records; returns the result's
    metrics with the hand kernels' launches, the reads matched, and the
    seconds from before the match (and a mesh run's layout) to after the
    output (wall_s)."""
    from real_tpu_torch.cli.output import write_all_arrays, write_unique
    from real_tpu_torch.engine import driver
    from real_tpu_torch.ops import gather

    cfg.fastq = rs.fastq
    print(f"pattern file is {'FASTQ' if rs.fastq else 'FASTA'}",
          file=sys.stderr)
    launches = gather.launch_counts()
    texts = driver.load_texts(cfg, device)
    if cfg.gaps:
        # the reference ships gapped matching compiled out (real.cpp:23)
        print("Warning: gapped matching (-g) is experimental and disabled "
              "in the reference (real.cpp:23); ignoring it.",
              file=sys.stderr)
    t0 = time.perf_counter()
    mesh_plan = None
    if cfg.use_mesh:
        # rs is the whole read set; this rank matches its row's slice
        mesh_plan = driver.plan_mesh(cfg, rs, texts, device)
        rs = rs.records(mesh_plan.lo, mesh_plan.hi)
    if cfg.match_unique:
        result = driver.run_match_unique(cfg, rs, texts, device,
                                         mesh_plan=mesh_plan)
    else:
        result = driver.run_match_all(cfg, rs, texts, device,
                                      as_arrays=True, mesh_plan=mesh_plan)
    with (contextlib.nullcontext(sys.stdout)
          if cfg.outputfilename == "-"
          else open(cfg.outputfilename, "w")) as out:
        if mesh_plan is not None and mesh_plan.mesh.shard:
            pass    # the row's shard-0 rank writes the row's records
        elif cfg.match_unique:
            unique = write_unique(out, rs, result, texts, cfg.scores,
                                  cfg.native_host)
            print(f"unique: {unique}", file=sys.stderr)
        else:
            write_all_arrays(out, rs, result.cols, texts, cfg.scores,
                             cfg.native_host)
    now = gather.launch_counts()
    return (dict(result.metrics, kernel_launches={
        k: now[k] - launches[k] for k in now}), rs.num_reads,
        time.perf_counter() - t0)


def _write_metrics(cfg: RealConfig, metrics: dict, num_reads: int,
                  wall: float) -> None:
    """The result's metrics plus real_tpu's five run keys (its -metrics
    file, real_tpu/cli/main.py), phase seconds to 3 decimals as there.
    `wall` runs from before the match (and a mesh run's layout) to after
    the output; `metrics` holds the job's spans and counters too."""
    m = dict(metrics, phase_s={k: round(v, 3)
                               for k, v in metrics["phase_s"].items()})
    m.update({"wall_s": round(wall, 3), "num_reads": num_reads,
              "reads_per_sec": round(num_reads / max(wall, 1e-9), 1),
              "mode": "unique" if cfg.match_unique else "all",
              # the native library is never silently absent here
              # (native.get_lib raises), so the flag says which was asked
              "native_paths_active": cfg.native_host})
    with open(cfg.metrics_json, "w") as f:
        json.dump(m, f, indent=1)


@contextlib.contextmanager
def _profiled(trace_dir: str, device):
    """-trace: torch.profiler over the block, one Chrome trace written into
    `trace_dir` (created if missing) afterwards. CPU and CUDA activities on
    the card, the CPU alone on the CPU. A trace of the card that holds no
    device activity (no CUPTI) raises instead of passing for one."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    if on_card and not any(e.device_type() == DeviceType.CUDA
                           for e in prof.profiler.kineto_results.events()):
        raise RuntimeError("-trace: the profiler recorded no activity on "
                           "the card (is CUPTI available?)")
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"))


if __name__ == "__main__":
    sys.exit(main())
