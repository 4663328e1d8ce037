"""index.build_device_s (layer index build): per job, the program's counter
`index.build_device_s` (engine/driver.py _BuildClock: the seconds the
first pass's index builds occupied the card, between timing events
recorded on its stream before and after each build); the mean over the
window's jobs. Nothing to read when a job lacks the counter: a program
without it."""


def read(run):
    per_job = [(j.metrics.get("counters") or {}).get("index.build_device_s")
               for j in run.jobs]
    if not per_job or None in per_job:
        return None
    return sum(per_job) / len(per_job)
