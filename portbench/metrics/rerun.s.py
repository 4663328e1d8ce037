"""rerun.s (layer overflow rerun): per job, the sum of the program's
rerun.* phases; the mean over the window's jobs. Nothing to read when no
job of the window reran a read."""


def read(run):
    if not sum(j.metrics["overflow_rerun_reads"] for j in run.jobs):
        return None
    return sum(sum(v for k, v in j.metrics["phase_s"].items()
                   if k.startswith("rerun."))
               for j in run.jobs) / len(run.jobs)
