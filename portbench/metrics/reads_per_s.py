"""reads_per_s (end to end): all reads of all jobs in the window over the
window's whole length, the jobs' time from the first job's start to the
last job's end, less the pauses between jobs in which the harness cuts
each job's output down to what the check reads."""


def read(run):
    return sum(j.reads for j in run.jobs) / sum(j.seconds for j in run.jobs)
