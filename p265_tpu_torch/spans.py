"""Host stages timed where they run: wall seconds, the thread's CPU
seconds, and a profiler range while a profiler is on.

`span(stats, name)` adds the block's wall seconds (`time.perf_counter`)
to `stats[name + "_s"]` and the same thread's CPU seconds
(`time.thread_time`) to `stats[name + "_cpu_s"]`.  For Python work the
difference is time off the CPU: waiting for the interpreter lock, plus
the OS's preemption.  While a torch profiler records, the block is also a
`record_function` range named `p265:<name>`, so any trace puts it on its
own thread, nested under its caller's range, beside the device work; with
no profiler on, no range is created.

Each stats key must be written by one thread only: `+=` on one key from
two threads can lose an update.  The decoders' keys and the thread that
writes each are listed in pipeline/decoder.py `TorchDecoder.__init__`.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler

PREFIX = "p265:"


def profiling() -> bool:
    """Whether a torch profiler records on this thread.  A profiler of
    every thread (`profile_all_threads`) sets only the module flag; one of
    the calling thread sets both."""
    return (_profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled())


@contextmanager
def span(stats: dict | None, name: str):
    """Time the block into stats[name + "_s"] and stats[name + "_cpu_s"]
    (stats None: the range alone)."""
    rf = None
    if profiling():
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
    # the CPU clock's interval lies inside the wall clock's
    t0, c0 = time.perf_counter(), time.thread_time()
    try:
        yield
    finally:
        cpu = time.thread_time() - c0
        wall = time.perf_counter() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        if stats is not None:
            stats[name + "_s"] = stats.get(name + "_s", 0.0) + wall
            stats[name + "_cpu_s"] = stats.get(name + "_cpu_s", 0.0) + cpu
