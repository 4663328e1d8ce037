"""k1.ms (layer kernels: ops/gather.py, csrc/gather_windows.cu): the device
time of K1's kernels in the job traced with the card's activity alone,
by kernel name, in ms."""

K1 = ("probe_candidates_kernel", "verify_windows_kernel",
      "gather_windows_kernel", "gather_windows_any_kernel")


def read(run):
    if run.trace is None:
        return None
    s = sum(t for name, t in run.trace.device_s.items()
            if any(k in name for k in K1))
    return 1e3 * s or None
