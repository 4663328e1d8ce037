"""device.idle (layer device): 1 - busy / job, in %: busy is the union of
the card's kernel, memcpy and memset intervals in the profiler's trace of
a job traced with the card's activity alone; job is the mean length of
the window's jobs, which are of the same size and run untraced (tracing
the card lengthens a job)."""


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    job = sum(j.seconds for j in run.jobs) / len(run.jobs)
    return 100.0 * (1.0 - run.trace.busy_s / job)
