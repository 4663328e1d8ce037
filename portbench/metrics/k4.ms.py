"""k4.ms (layer kernels: ops/scorefold.py, csrc/score_fold.cu): the device
time of K4, the score and fold of a step's survivor lanes, in the job
traced with the card's activity alone, by kernel name, in ms. None where
the program has no such kernel."""

K4 = ("score_fold_kernel",)


def read(run):
    if run.trace is None:
        return None
    s = sum(t for name, t in run.trace.device_s.items()
            if any(k in name for k in K4))
    return 1e3 * s or None
