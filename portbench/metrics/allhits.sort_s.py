"""allhits.sort_s (layer matchAll hits): per job, the program's
`allhits.sort` spans summed (engine/driver.py _sort_dedup_hits: the hit
columns sorted and deduped, at the finalize of every depth and at the
merge after a rerun); the mean over the window's jobs. Nothing to read
when a job has no such span."""

from portbench import allhits


def read(run):
    return allhits.span_mean(run, "allhits.sort")
