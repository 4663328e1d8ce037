"""allhits.wait_s (layer matchAll hits): per job, the program's
`allhits.wait` spans summed (engine/driver.py _HitFetch.numpy: the host
blocked on a step's hit copy to pinned memory); the mean over the window's
jobs. Nothing to read when a job has no such span."""

from portbench import allhits


def read(run):
    return allhits.span_mean(run, "allhits.wait")
