"""driver.loop_s (layer driver): per job, the phases setup, match, drain
and collect of the program's -metrics phase_s (finalize too, in matchAll),
without the overflow rerun's; the mean over the window's jobs."""

PHASES = ("setup", "match", "drain", "collect", "finalize")


def read(run):
    return sum(sum(j.metrics["phase_s"].get(p, 0.0) for p in PHASES)
               for j in run.jobs) / len(run.jobs)
