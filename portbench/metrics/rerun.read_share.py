"""rerun.read_share (layer overflow rerun): the program's
overflow_rerun_reads over the reads of the window's jobs, in %. Nothing to
read when no job of the window reran a read."""


def read(run):
    rerun = sum(j.metrics["overflow_rerun_reads"] for j in run.jobs)
    if not rerun:
        return None
    return 100.0 * rerun / sum(j.reads for j in run.jobs)
