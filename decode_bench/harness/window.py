"""The measured window and the end-to-end metrics taken from it.

A closed loop: one segment at a time, each handed to the entry as soon as
the one before it has returned its pictures.  The window opens after
set-up and closes when the first segment that completes at or after
`seconds` completes, so a segment that straddles `seconds` is neither
cut nor lost.  A rate is all frames completed over the whole window; a
tail is taken over every segment completed in the window.
"""
from __future__ import annotations

import math
import time


def closed_loop(decode, items, seconds: float, clock=time.monotonic,
                keep=None) -> dict:
    """Run decode(item) -> (frames, error) for the items in turn until
    the window closes.  -> {"t_open", "t_close", "segments": [(item, t0,
    t1, frames, error)]}.  keep(frames), where given, replaces a
    segment's frames once its latency is taken, as a consumer of the
    pictures would, so that the window holds no decoded planes."""
    segments = []
    t_open = t1 = clock()
    for item in items:
        t0 = clock()
        frames, error = decode(item)
        t1 = clock()
        if keep is not None and frames is not None:
            frames = keep(frames)
        segments.append((item, t0, t1, frames, error))
        if t1 - t_open >= seconds:
            break
    return dict(t_open=t_open, t_close=t1, segments=segments)


def nearest_rank(values, q: float) -> float | None:
    """The q-quantile (0 < q <= 1) by the nearest-rank rule: the smallest
    value with at least q of the values at or below it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q * len(v)) - 1)]


def fps(frames: int, t_open: float, t_close: float) -> float:
    """Frames completed over the whole window."""
    return frames / (t_close - t_open)


def segment_ms_p95(latencies_s) -> float | None:
    """The 95th percentile of the segments' latencies, ms."""
    p = nearest_rank(latencies_s, 0.95)
    return None if p is None else p * 1e3
