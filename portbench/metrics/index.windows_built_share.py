"""index.windows_built_share (layer index build): per job, the program's
counter `index.windows_built` (the windows of every index unit it built,
at every depth of the overflow rerun: engine/driver.py _foreach_unit)
over the windows of the job's texts (each text's n - seedl + 1, the sum
of its shards' `windows` in -metrics `plans`), in %; the mean over the
window's jobs. 100% when each window is indexed once a job; a rerun that
builds every unit again adds its share. Nothing to read when a job lacks
the counter or its texts' windows."""


def read(run):
    per_job = []
    for j in run.jobs:
        built = (j.metrics.get("counters") or {}).get("index.windows_built")
        windows = sum(sum(p.get("windows", ())) for p in
                      j.metrics.get("plans") or ())
        if built is None or not windows:
            return None
        per_job.append(100.0 * built / windows)
    return sum(per_job) / len(per_job) if per_job else None
