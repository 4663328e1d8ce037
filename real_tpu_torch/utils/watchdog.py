"""Loud-failure watchdog around device synchronization points
(counterpart of real_tpu/utils/watchdog.py).

A wedged device otherwise blocks forever inside a blocking fetch
(`tensor.cpu()`, `event.synchronize()`) with no diagnostics. There is no
portable way to interrupt a blocked runtime call, so on expiry the watchdog
prints a diagnostic (with tracebacks of every thread), flushes, and
hard-exits with status 3. Checkpoints are on disk; a supervisor can resume
with the same command line.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import sys
import threading


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Abort the process if the body takes longer than `seconds`.
    seconds <= 0 disables."""
    if not seconds or seconds <= 0:
        yield
        return

    def expire():
        sys.stderr.write(
            f"\nWATCHDOG: '{what}' exceeded {seconds:.0f}s — the device "
            "appears wedged. Dumping thread stacks and aborting; resume "
            "from the checkpoint (-ckpt) with the same command.\n")
        faulthandler.dump_traceback(file=sys.stderr)
        sys.stderr.flush()
        os._exit(3)

    t = threading.Timer(seconds, expire)
    t.daemon = True
    t.start()
    try:
        yield
    finally:
        t.cancel()
