"""allhits.decode_s (layer matchAll hits): per job, the program's
`allhits.decode` spans summed (engine/driver.py _HitAccumulator.add_compact:
a step's compacted hits decoded into columns on the host); the mean over
the window's jobs. Nothing to read when a job has no such span."""

from portbench import allhits


def read(run):
    return allhits.span_mean(run, "allhits.decode")
