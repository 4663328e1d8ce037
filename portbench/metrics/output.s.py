"""output.s (layer output: cli/output.py): per job, the program's wall_s
less the sum of all its phase_s, i.e. the records' formatting and writing
plus engine/driver.py's host work outside any phase; the mean over the
window's jobs."""


def read(run):
    return sum(j.metrics["wall_s"] - sum(j.metrics["phase_s"].values())
               for j in run.jobs) / len(run.jobs)
