"""allhits.kept_share (layer matchAll hits): the program's counter
`allhits.records` over its counter `allhits.decoded` (hit rows decoded
from the steps' compacted hits, every rerun depth) in the window's jobs,
in %: the share of the decoded rows that became records. The first-pass
hits of the reads that are rerun are the rest. Nothing to read when a job
has no such counter or nothing was decoded."""

from portbench import allhits


def read(run):
    records = allhits.counter_sum(run, "allhits.records")
    decoded = allhits.counter_sum(run, "allhits.decoded")
    if records is None or not decoded:
        return None
    return 100.0 * records / decoded
