"""The traced run: ranges around the program's functions, the profiler
over the window, and its reduction to per-rank sums.

Ranges are `torch.profiler.record_function` wrappers installed by name
for the window only: the stage ranges that per-layer metrics declare
(RANGES), the host ranges of host_ranges.json (for the breakdown of idle
time), and a wrapper of the entry's decoder that keeps each segment's
`stats`.  A wrapped name that the program no longer has is skipped, and
a metric that reads it then reads nothing.

A stage's device time is the device work inside its range's device-side
span (the first to the last device operation launched inside the range,
on that stream), as p265_tpu_torch/bench.py's stage_profile takes it; the
device's busy time is the union of every device operation's interval,
so work that overlaps on two streams counts once.
"""
from __future__ import annotations

import functools
import importlib
import json
import os

from decode_bench.harness.streams import BENCH_DIR

HOST_RANGES = os.path.join(BENCH_DIR, "harness", "host_ranges.json")
STAGE_PREFIX = "stage:"
HOST_PREFIX = "host:"
WINDOW = "bench:window"


def _resolve(module: str, attr: str):
    """(owner object, attribute name) of module.attr ("Class.method"
    allowed); None where the program has no such name."""
    try:
        owner = importlib.import_module(module)
    except ImportError:
        return None
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    if not callable(getattr(owner, name, None)):
        return None
    return owner, name


def _ranged(label: str, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def f(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    return f


def install(ranges: dict) -> tuple:
    """Wrap every (module, attribute) of {label: [(module, attribute)]} in
    a range named label.  -> (undo(), [labels installed])."""
    saved, found = [], []
    for label, targets in ranges.items():
        for module, attr in targets:
            r = _resolve(module, attr)
            if r is None:
                continue
            owner, name = r
            fn = owner.__dict__[name] if isinstance(owner, type) and \
                name in owner.__dict__ else getattr(owner, name)
            saved.append((owner, name, fn))
            setattr(owner, name, _ranged(label, getattr(owner, name)))
            found.append(label)

    def undo():
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)
    return undo, sorted(set(found))


def keep_stats(cls, into: list):
    """Wrap cls.decode_stream to append each call's numeric stats to
    `into`.  -> undo()."""
    orig = cls.__dict__["decode_stream"] if "decode_stream" in \
        cls.__dict__ else None
    inner = cls.decode_stream

    @functools.wraps(inner)
    def decode_stream(self, data):
        out = inner(self, data)
        into.append({k: v for k, v in self.stats.items()
                     if isinstance(v, (int, float))})
        return out
    cls.decode_stream = decode_stream

    def undo():
        if orig is None:
            del cls.decode_stream
        else:
            cls.decode_stream = orig
    return undo


def host_ranges(path: str = HOST_RANGES) -> dict:
    with open(path) as f:
        return {k: [tuple(t) for t in v] for k, v in json.load(f).items()}


def profiler():
    """A profiler of CPU and CUDA activity on every thread (the
    pipelined decoder's recon and fetch workers launch device work)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted, disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] outside the disjoint sorted `busy`."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def overlap(a: list, b: list) -> float:
    """Total overlap of two disjoint sorted interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def in_spans(spans: list, work: list) -> float:
    """Summed length of the work intervals (start, end, stream) that lie
    inside a span (start, end, stream) on the span's stream (any stream
    where either is unknown)."""
    tot = 0.0
    for s0, s1, ss in spans:
        tot += sum(w1 - w0 for w0, w1, ws in work
                   if s0 <= w0 and w1 <= s1
                   and (ss is None or ws is None or ss == ws))
    return tot


def reduce(prof) -> dict:
    """The per-rank sums of one traced window, in seconds: the window's
    span in the trace, the device's busy union inside it, each stage
    range's device time, device time by operation name, and idle device
    time by the host ranges open during it."""
    from torch.autograd import DeviceType
    spans, work, host, win = {}, [], {}, None
    for e in prof.events():
        t = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            stream = getattr(e, "device_resource_id", None)
            if e.key.startswith(STAGE_PREFIX):
                spans.setdefault(e.key[len(STAGE_PREFIX):], []).append(
                    (*t, stream))
            elif not e.is_user_annotation:
                work.append((*t, stream, e.key))
        elif e.key == WINDOW:
            win = t
        elif e.key.startswith(HOST_PREFIX):
            host.setdefault(e.key[len(HOST_PREFIX):], []).append(t)
    if win is None:
        raise RuntimeError("trace: the window's range is not in the trace")
    lo, hi = win
    busy = clip(union((w[0], w[1]) for w in work), lo, hi)
    by_op = {}
    for w0, w1, _, name in work:
        by_op[name] = by_op.get(name, 0.0) + (w1 - w0)
    idle = gaps(busy, lo, hi)
    idle_by = {name: overlap(idle, union(iv)) for name, iv in host.items()}
    covered = union(x for iv in host.values() for x in iv)
    idle_by["no host range"] = sum(e - s for s, e in idle) - overlap(
        idle, covered)
    return dict(window_s=hi - lo, busy_s=sum(e - s for s, e in busy),
                stage_device_s={st: in_spans(sp, [w[:3] for w in work])
                                for st, sp in spans.items()},
                device_ops=by_op, idle_by_host=idle_by)
