"""output.emit_s (layer output): per job, the program's `output` span
(cli/output.py write_unique / write_all_arrays on the calling thread:
the records formatted and written); the mean over the window's jobs."""

from portbench import span_sums


def read(run):
    return span_sums.mean(run, "output")
