"""plan.s (layer planner): per job, the program's `plan` spans at every
depth of the driver (engine/driver.py _seq_layout, _local_layout,
plan_mesh: the shard plan and the card's memory query), summed; the mean
over the window's jobs."""

from portbench import span_sums


def read(run):
    return span_sums.mean(run, "plan")
