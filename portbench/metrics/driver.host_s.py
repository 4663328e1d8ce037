"""driver.host_s (layer driver): per job, the self time of every `driver`
span of the program (engine/driver.py run_match_unique / run_match_all,
an overflow rerun's inside its caller's): the driver's host work outside
any phase, `plan` and nested rerun; the mean over the window's jobs."""

from portbench import span_sums


def read(run):
    return span_sums.mean(run, "driver", own=True)
