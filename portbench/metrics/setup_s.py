"""setup_s (end to end): process start to the window's opening: imports,
the data made from the seed, and the untimed first job."""


def read(run):
    return run.setup_s
