"""What the metrics of the layer "matchAll hits" read: the spans and the
counters the program writes on its matchAll path into each job's -metrics
file (real_tpu_torch/engine/driver.py and cli/output.py: spans
`allhits.wait`, `allhits.decode`, `allhits.sort`; counters
`allhits.decoded`, `allhits.records` under `counters`). A program that
writes none of them, or a job that has none, gives nothing to read."""

from typing import Optional

from portbench import span_sums


def span_mean(run, name: str) -> Optional[float]:
    """span_sums.mean of the spans `name`; None unless every job of the
    window has at least one."""
    if not all(any(s["name"] == name for s in j.metrics.get("spans") or ())
               for j in run.jobs):
        return None
    return span_sums.mean(run, name)


def counter_sum(run, name: str) -> Optional[float]:
    """The counter `name` summed over the window's jobs; None unless every
    job has it."""
    values = [(j.metrics.get("counters") or {}).get(name) for j in run.jobs]
    if not values or any(v is None for v in values):
        return None
    return float(sum(values))
