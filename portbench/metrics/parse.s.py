"""parse.s (layer host parse): per job, the job's time less the program's
wall_s, which starts after the read parse and the genome's parse, pack and
upload (cli/main.py); the mean over the window's jobs."""


def read(run):
    return sum(j.seconds - j.metrics["wall_s"]
               for j in run.jobs) / len(run.jobs)
