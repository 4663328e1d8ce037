"""job_s.max (layer job: cli/main.py): the slowest job of the window, by
the harness's clock around each job."""


def read(run):
    return max(j.seconds for j in run.jobs)
