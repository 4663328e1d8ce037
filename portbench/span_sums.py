"""What the per-layer metrics of the program's spans read: the `spans` of
each job's -metrics file (real_tpu_torch/utils/spans.py: id, name, parent,
thread, start_ns, end_ns), summed by name per job, and the mean over the
window's jobs. A span's self time is its length less the part of it that
its children on its own thread cover. A program that writes no spans
gives nothing to read."""

from typing import Optional


def self_ns(span: dict, rows: list) -> int:
    kids = sorted((c["start_ns"], c["end_ns"]) for c in rows
                  if c["parent"] == span["id"]
                  and c["thread"] == span["thread"])
    covered, end = 0, span["start_ns"]
    for a, b in kids:
        if b > end:
            covered += b - max(a, end)
            end = b
    return span["end_ns"] - span["start_ns"] - covered


def job_seconds(rows: list, name: str, own: bool = False) -> float:
    """The seconds of every span `name` of one job, summed: whole, or
    with `own` their self times."""
    return sum(self_ns(s, rows) if own else s["end_ns"] - s["start_ns"]
               for s in rows if s["name"] == name) / 1e9


def mean(run, name: str, own: bool = False) -> Optional[float]:
    """job_seconds of the window's jobs, their mean; None when a job's
    -metrics holds no spans."""
    if not all(j.metrics.get("spans") for j in run.jobs):
        return None
    return sum(job_seconds(j.metrics["spans"], name, own)
               for j in run.jobs) / len(run.jobs)
