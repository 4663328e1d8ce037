"""device_peak_gb (layer planner): the highest torch.cuda.max_memory_allocated
of the window's jobs, each read after reset_peak_memory_stats at the
job's start, in GB (1e9 bytes)."""


def read(run):
    return max(j.peak_bytes for j in run.jobs) / 1e9 or None
