"""rerun.index_build_device_s (layer overflow rerun): per job, the
program's counter `rerun.index.build_device_s` (engine/driver.py
_BuildClock: the seconds the overflow rerun's index builds occupied the
card, at every depth), 0 for a job whose rerun built nothing (it took the
single unit's cached index, or no read overflowed); the mean over the
window's jobs. Nothing to read when a job lacks the first pass's counter
`index.build_device_s`: a program that times no build."""


def read(run):
    per_job = []
    for j in run.jobs:
        c = j.metrics.get("counters") or {}
        if "index.build_device_s" not in c:
            return None
        per_job.append(c.get("rerun.index.build_device_s", 0.0))
    return sum(per_job) / len(per_job) if per_job else None
