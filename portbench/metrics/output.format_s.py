"""output.format_s (layer output): per job, the program's `output.format`
spans summed, one per chunk of records formatted on the formatter threads
(cli/output.py _emit_chunks), in thread-seconds; the mean over the
window's jobs."""

from portbench import span_sums


def read(run):
    return span_sums.mean(run, "output.format")
