"""index_build.s (layer index build): per job, phase_s.index_build of the
program's -metrics; the mean over the window's jobs."""


def read(run):
    return sum(j.metrics["phase_s"]["index_build"]
               for j in run.jobs) / len(run.jobs)
