"""parse.reads_s (layer host parse): per job, the program's `parse.reads`
span (io/readstore.py parse_reads_cached: the read file's parse, or its
store's load); the mean over the window's jobs."""

from portbench import span_sums


def read(run):
    return span_sums.mean(run, "parse.reads")
