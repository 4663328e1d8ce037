"""output.write_s (layer output): per job, the program's `output.write`
spans summed, one per chunk of records written by the writer thread
(cli/output.py _emit_chunks); the mean over the window's jobs."""

from portbench import span_sums


def read(run):
    return span_sums.mean(run, "output.write")
