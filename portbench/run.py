"""The benchmark of real_tpu_torch: whole alignment jobs through its CLI.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell of BENCHMARK.json names a configuration (configs/<config>.json: the
genome and the reads, the mode and the mismatch limit) and a traffic mix
(traffic/<traffic>.json: reads per job and the read files the jobs cycle
through). One run is one process:

1. set-up: imports; the genome FASTA and the read files, made from --seed
   under $TMPDIR; one whole job that is not timed (it builds and loads the
   program's kernels and native library in their build directories inside
   the checkout, and warms the card's allocator at the jobs' sizes);
2. the window: jobs one after another, each one call of the program's
   entry real_tpu_torch.cli.main.main as a user runs it
   (-t genome -p reads -u -q -e -R 0 -o -, plus -metrics into $TMPDIR,
   then the configuration's own `flags`, every other option at its
   default), its records written into memory
   in place of the standard output. Once a job has ended, and before the
   next starts, its output is cut down to the lines the check reads and
   the rest freed, as a pipe to the next tool would take it. The window
   is the jobs' time, without those pauses: it ends with the first job
   that brings it to --seconds;
3. with --trace 1, two more jobs under torch.profiler: the first with
   the card's activity alone, which the device's numbers are read from,
   the second with the host's events too, which only label the idle gaps
   (the profiler's cost lengthens both);
4. the check: the records of a sample of reads drawn from the seed,
   in every job's output, against the plain reference (the configuration's
   `reference` module), computed once the program's jobs are done.

The last line of standard output is the result as JSON: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, each read
by metrics/<name>.py from the run's record (see `Run`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
# the JAX package, its libraries and its benchmarks: none may be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "real_tpu", "benchmarks")
# reads of each draw whose records the check compares in every job
SAMPLE_READS = 65536
CACHE = os.path.join(ROOT, ".portbench_cache")
# the program's options that job_argv sets and a configuration may not
HARNESS_FLAGS = ("-t", "-p", "-u", "-q", "-e", "-R", "-o", "-metrics",
                 "-device")

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench import check, gen, trace  # noqa: E402


@dataclasses.dataclass
class Job:
    start: float               # host clock, s
    end: float
    reads: int
    metrics: dict              # the program's -metrics file
    peak_bytes: int            # torch.cuda.max_memory_allocated in the job
    output: List[bytes]        # what it wrote to its standard output;
    draw: int                  # in measure, the sampled reads' lines only
    host: dict = dataclasses.field(default_factory=dict)  # host_delta
    bad_lines: int = 0         # lines no record of a read of the file

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Run:
    """What a metric reader reads: set-up seconds, the window's jobs in
    order, and with --trace 1 the trace of the job traced with the card's
    activity alone, its idle gaps those of the job traced with the host's
    events (else None)."""
    setup_s: float
    jobs: List[Job]
    trace: Optional[trace.Trace]


class Sink:
    """The jobs' standard output: the bytes the program writes, kept in
    memory as it writes them."""

    def __init__(self):
        self.chunks: List[bytes] = []
        self.buffer = self

    def write(self, b):
        self.chunks.append(b if isinstance(b, bytes) else b.encode())
        return len(b)

    def flush(self):
        pass


def host_reading() -> dict:
    """This process's CPU seconds and resident set, in GB."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime}
    try:
        with open("/proc/self/statm") as f:
            out["rss_gb"] = (int(f.read().split()[1])
                             * resource.getpagesize() / 1e9)
    except (OSError, IndexError, ValueError):
        pass
    return out


def host_delta(a: dict, b: dict) -> dict:
    """A job's host readings: the CPU seconds it took, its resident set
    at its end."""
    return {"cpu_s": b["cpu_s"] - a["cpu_s"],
            **({"rss_gb": b["rss_gb"]} if "rss_gb" in b else {})}


def cpu_probe_ms() -> float:
    """Milliseconds of a fixed piece of host work (a Python loop and a
    sum over 8 MB): how fast the host's CPU runs this process now."""
    t = time.perf_counter()
    x = 0
    for i in range(200000):
        x += i * i
    np.ones(1 << 20).sum()
    return 1e3 * (time.perf_counter() - t)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str):
    """(cell, configuration, traffic) of a cell of BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(os.path.join(ROOT, conf["file"])),
            load_json(os.path.join(BENCH, "traffic",
                                   cell["traffic"] + ".json")))


def job_argv(cfg: dict, genome: str, reads: str, metrics: str,
             device: Optional[str]) -> List[str]:
    """A job's command line: the harness's options, then the
    configuration's own `flags` (a list of strings), which may not set
    one of the harness's: the mode, the limit and the output stay its."""
    flags = cfg.get("flags", [])
    if not (isinstance(flags, list)
            and all(isinstance(f, str) for f in flags)):
        raise ValueError(f"flags must be strings: {flags!r}")
    repeated = sorted(set(flags) & set(HARNESS_FLAGS))
    if repeated:
        raise ValueError(f"flags {repeated} are the harness's own")
    argv = ["-t", genome, "-p", reads, "-u", str(int(cfg["mode"] == "unique")),
            "-q", str(int(cfg["scores"])), "-e", str(cfg["max_mismatches"]),
            "-R", "0", "-o", "-", "-metrics", metrics]
    return argv + (["-device", device] if device else []) + flags


def run_job(argv: List[str], reads: int, draw: int, cuda: bool) -> Job:
    import torch
    from real_tpu_torch.cli import main as cli
    sink = Sink()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    h0 = host_reading()
    t0 = time.perf_counter()
    stdout, sys.stdout = sys.stdout, sink
    try:
        rc = cli.main(argv)
    finally:
        sys.stdout = stdout
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    h1 = host_reading()
    if rc != 0:
        raise RuntimeError(f"the job {argv} exited with {rc}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return Job(t0, t1, reads, {}, peak, sink.chunks, draw,
               host_delta(h0, h1))


def traced_job(argv, reads, draw, cuda, path: str,
               host_events: bool) -> Job:
    """A job under torch.profiler, its Chrome trace written to `path`:
    with the card's activity alone, or with the host's events too (on
    the CPU, which has no card's activity, always the host's)."""
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host_events or not cuda else [])
    with profile(activities=acts) as prof:
        job = run_job(argv, reads, draw, cuda)
    prof.export_chrome_trace(path)
    return job


def measure(cfg: dict, traffic: dict, seed: int, seconds: float,
            traced: bool, device: Optional[str] = None,
            tmp: Optional[str] = None):
    """One run: (Run, jobs checked, differing records, memory peak). The
    records of every job are held against the reference. `device` is
    passed to the program as -device (None: its default, the card)."""
    import torch
    cuda = device is None or device.startswith("cuda")
    d = tempfile.mkdtemp(prefix="portbench-", dir=tmp)
    try:
        t = time.perf_counter()
        g, gpath, paths, draws = gen.make_files(seed, d, cfg, traffic)
        log(f"set-up: imports {t - T_START:.3f} s, data "
            f"{time.perf_counter() - t:.3f} s")
        which = gen.file_draws(traffic["files"])
        num = traffic["reads_per_job"]

        keep = {dnum: np.zeros(num, bool) for dnum in draws}
        for dnum, mask in keep.items():
            mask[gen.sample(seed, dnum, num, SAMPLE_READS)] = True

        def job(i, **kw):
            """Job i of the run (0: the untimed one), its output cut down
            to what the check reads once the job has ended."""
            j = (traced_job if kw else run_job)(
                job_argv(cfg, gpath, paths[i % len(paths)],
                         os.path.join(d, f"metrics{i}.json"), device),
                num, which[i % len(paths)], cuda, **kw)
            kept, j.bad_lines = check.sampled_lines(j.output, num,
                                                    keep[j.draw])
            j.output = [kept]
            j.host["probe_ms"] = cpu_probe_ms()
            return j

        warm = job(0)
        peak = warm.peak_bytes
        log(f"set-up: the untimed job {warm.seconds:.3f} s")
        del warm
        setup_s = time.perf_counter() - T_START
        # the window is the jobs' time: it ends with the first job that
        # brings it to `seconds`, and leaves out the cutting down of each
        # job's output between jobs
        jobs: List[Job] = []
        while sum(j.seconds for j in jobs) < seconds or not jobs:
            jobs.append(job(len(jobs) + 1))
        tr, extra = None, []
        if traced:
            for host_events in (False, True):
                path = os.path.join(d, f"trace{int(host_events)}.json")
                extra.append(job(len(jobs) + len(extra) + 1, path=path,
                                 host_events=host_events))
                if not host_events:
                    tr = trace.read(path, extra[0].seconds)
            # the idle gaps as the host's events label them
            tr.idle_gaps = trace.read(path).idle_gaps
            log(f"traced jobs: the card's activity alone "
                f"{extra[0].seconds:.4f} s, with the host's events "
                f"{extra[1].seconds:.4f} s; the window's jobs "
                f"{sum(j.seconds for j in jobs) / len(jobs):.4f} s on "
                f"average")
        for i, j in enumerate(jobs + extra, start=1):
            j.metrics = load_json(os.path.join(d, f"metrics{i}.json"))
        peak = max([peak] + [j.peak_bytes for j in jobs + extra])
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        bad, checked = differing_records(g, draws, jobs + extra, cfg, seed,
                                         num, device or "cuda")
        log(f"check: {time.perf_counter() - t:.3f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return Run(setup_s, jobs, tr), checked, bad, peak


def differing_records(g, draws, jobs, cfg, seed, num, device):
    """[differing records of each job], the jobs checked: each job's
    records of a sample of its draw's reads against the reference's."""
    ref = importlib.import_module("portbench." + cfg["reference"])
    bad = []
    expected = {}
    for dnum, dr in draws.items():
        rows = gen.sample(seed, dnum, num, SAMPLE_READS)
        quals = None
        if dr.quals is not None:
            quals = dr.quals[rows].astype(np.int64) \
                - ref.quality_offset(dr.quals)
        ids = [bytes(x) for x in gen.read_ids(rows)]
        expected[dnum] = rows, ref.records(g, ids, dr.codes[rows], quals,
                                           cfg, device)
    for j in jobs:
        rows, want = expected[j.draw]
        bad.append(check.differing(b"".join(j.output), num, rows, want)
                   + j.bad_lines)
    return bad, len(jobs)


def read_metric(name: str, run: Run):
    """metrics/<name>.py's reading of the run, or None."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", os.path.join(BENCH, "metrics",
                                                 name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def cell_metrics(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of the cell prints: its end-to-end metrics, or
    with --trace 1 its per-layer ones."""
    if not traced:
        return [m for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is forbidden (an entry of
    None blocks an import and loads nothing)."""
    return sorted(m for m, mod in list(sys.modules.items())
                  if m.split(".")[0] in FORBIDDEN and mod is not None)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's and torch's caches at fixed places in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, cfg, traffic = cell_files(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run, checked, bad, peak = measure(cfg, traffic, args.seed, args.seconds,
                                      bool(args.trace))
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": sum(bad) == 0, "attempted": checked,
              "failed": sum(b > 0 for b in bad), "metrics": metrics,
              "device": device}
    if run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps}
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    plan = run.jobs[0].metrics.get("plans")
    for j in run.jobs:
        m = j.metrics
        host = " ".join(f"{k} {v:.4g}" for k, v in j.host.items())
        print(f"job {j.seconds:.4f} s wall_s {m['wall_s']} "
              f"rerun_reads {m['overflow_rerun_reads']} host {host} "
              f"phase_s {m['phase_s']}", file=sys.stderr)
    window = sum(j.seconds for j in run.jobs)
    span = run.jobs[-1].end - run.jobs[0].start
    cpu = sum(j.host.get("cpu_s", 0.0) for j in run.jobs)
    print(f"{len(run.jobs)} jobs in {window:.4f} s ({span:.4f} s with the "
          f"check's cutting down between jobs); CPU {cpu:.4f} s; setup_s {run.setup_s:.4f}; plan {plan}; "
          f"{power_limit()}", file=sys.stderr)
    result["checks"] = {"differing_records": {"value": sum(bad),
                                              "limit": 0}}
    print(f"check differing_records {sum(bad)} limit 0 (sampled reads of "
          f"{checked} jobs, per job {bad})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
