"""Kernel timing on the card with CUDA events.

time_ms(fn) returns two medians per call of `fn`: the device time, with
the calls queued behind a sleep kernel so that the events time the
device's work and not the host's enqueue rate, and the host-inclusive
time, the same calls without the sleep. chip_smoke.py and
tools/gatherbench.py time with it.
"""

from __future__ import annotations

import time

import numpy as np
import torch


# a sleep of a few seconds: past it, the enqueue is blocking on the stream's
# launch queue (about a thousand pending kernels), not running ahead of it
MAX_SLEEP_CYCLES = 1 << 33


def _events(fn, launches: int, sleep_cycles: int):
    """(device ms between two events around `launches` calls, host
    seconds spent enqueuing them). With sleep_cycles > 0 a sleep kernel
    holds the stream first, so the calls queue up behind it."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    t = time.perf_counter()
    e0.record()
    for _ in range(launches):
        fn()
    e1.record()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / launches, host_s


def time_ms(fn, launches: int = 10, reps: int = 25):
    """(device ms per call, host-inclusive ms per call): medians over
    `reps` repetitions of `launches` back-to-back calls, after a warmup.
    `launches` calls of fn must fit the stream's launch queue: for a
    function of hundreds of small kernels, pass launches=1."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    dev, wall = [], []
    for _ in range(reps):
        while True:
            s0.record()
            torch.cuda._sleep(cycles)
            s1.record()
            torch.cuda.synchronize()
            d, host_s = _events(fn, launches, cycles)
            # the sleep must outlast the enqueue, or the host shows through
            if host_s * 1e3 < 0.5 * s0.elapsed_time(s1):
                break
            cycles *= 2
            if cycles > MAX_SLEEP_CYCLES:
                raise RuntimeError(
                    "time_ms: the host never got ahead of the sleep kernel; "
                    f"{launches} calls of fn queue more kernels than the "
                    "stream takes while it is held (use fewer launches)")
        dev.append(d)
        wall.append(_events(fn, launches, 0)[0])
    return float(np.median(dev)), float(np.median(wall))
