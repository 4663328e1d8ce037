"""output.record_ns (layer output): per job, the program's `output.format`
spans summed (nanoseconds on the formatter threads, cli/output.py
_emit_chunks) over its counter `output.records` (the records formatted,
both writers): the formatter's cost of a record; the mean over the
window's jobs. Nothing to read when a job lacks the counter or its spans,
or formatted no record."""

from portbench import span_sums


def read(run):
    per_job = []
    for j in run.jobs:
        records = (j.metrics.get("counters") or {}).get("output.records")
        rows = j.metrics.get("spans")
        if not records or not rows:
            return None
        per_job.append(span_sums.job_seconds(rows, "output.format") * 1e9
                       / records)
    return sum(per_job) / len(per_job) if per_job else None
