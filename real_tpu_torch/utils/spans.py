"""The job's spans: named host-clock intervals at each layer boundary, from
the read parse to the last record, and the job's counters.

cli/main.py opens one Recorder per job (`Recorder.job`, the `job` span);
the layers below open their spans with `span` or `traced` and find the
job's recorder in the calling thread's context. A span holds its name, its
start and end (time.perf_counter_ns, relative to the job span's start), the
id of its parent span and its thread (the native thread id, which a
profiler trace names its threads by). A span opened without `at` takes the
innermost span open in its thread's context as its parent; a worker
thread has a context of its own, so its caller hands it `here()` and the
thread opens its spans `at` it. Spans stay in memory until the job ends,
and -metrics writes them as `spans` (Recorder.export).

While a torch profiler is active, a span is also a
torch.profiler.record_function range: a `user_annotation` in the trace, on
the clock of the card's kernels and copies. The profiler records such
ranges on the threads it watches (the thread that opened it), so the
spans of worker threads appear in -metrics alone.

Outside a job (the driver called as a library) a span only times itself:
engine/driver.py's phase seconds are their spans' lengths either way.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

# (the job's recorder, the innermost open span's id) of this context
_HERE: contextvars.ContextVar = contextvars.ContextVar(
    "real_tpu_torch_span", default=(None, None))


def profiling() -> bool:
    """Whether a torch profiler is recording in this process."""
    return torch.autograd._profiler_enabled()


class Recorder:
    """One job's spans, a column per field indexed by span id (columns of
    numbers, not an object per span, which the garbage collector would
    walk), and its counters."""

    def __init__(self) -> None:
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[Optional[int]] = []
        self.parents: List[Optional[int]] = []
        self.threads: List[int] = []
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def open(self, name: str, parent: Optional[int], t: int) -> int:
        with self._lock:
            self.names.append(name)
            self.starts.append(t)
            self.ends.append(None)
            self.parents.append(parent)
            self.threads.append(threading.get_native_id())
            return len(self.names) - 1

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    @contextlib.contextmanager
    def job(self):
        """The `job` span, the root of every span of the job."""
        with span("job", at=(self, None)):
            yield self

    def export(self) -> List[dict]:
        """The spans in the order they opened, times relative to the
        first span's start (an unclosed span's end is None)."""
        t0 = self.starts[0] if self.starts else 0
        return [{"id": i, "name": self.names[i], "parent": self.parents[i],
                 "thread": self.threads[i], "start_ns": self.starts[i] - t0,
                 "end_ns": None if self.ends[i] is None
                 else self.ends[i] - t0}
                for i in range(len(self.names))]


class span:
    """`with span(name):` records the block as a span of the job (if one
    is open in this context, or `at` names one) and, while a profiler
    records, as a record_function range. `ns` is the block's length."""

    __slots__ = ("name", "at", "ns", "_t", "_rec", "_sid", "_token",
                 "_annot")

    def __init__(self, name: str,
                 at: Optional[Tuple[Optional[Recorder],
                                    Optional[int]]] = None) -> None:
        self.name, self.at, self.ns = name, at, 0

    def __enter__(self) -> "span":
        rec, parent = self.at if self.at is not None else _HERE.get()
        self._annot = None
        if profiling():
            self._annot = torch.profiler.record_function(self.name)
            self._annot.__enter__()
        self._rec = rec
        self._t = time.perf_counter_ns()
        if rec is not None:
            self._sid = rec.open(self.name, parent, self._t)
            self._token = _HERE.set((rec, self._sid))
        return self

    def __exit__(self, *exc) -> None:
        t = time.perf_counter_ns()
        self.ns = t - self._t
        if self._rec is not None:
            _HERE.reset(self._token)
            self._rec.ends[self._sid] = t
        if self._annot is not None:
            self._annot.__exit__(*exc)


def traced(name: str):
    """Decorator: every call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def here() -> Tuple[Optional[Recorder], Optional[int]]:
    """This context's (recorder, innermost open span): what a worker
    thread opens its spans `at`."""
    return _HERE.get()


def add(name: str, value: float) -> None:
    """Add `value` to the job's counter `name` (nothing outside a job)."""
    rec = _HERE.get()[0]
    if rec is not None:
        rec.add(name, value)
