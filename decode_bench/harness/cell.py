"""One process's part of a run: set-up, the window, and what it measured.

`run_rank` builds the entry the configuration names for this rank, decodes
the traffic's warm items (set-up: the kernels build or load, the pinned
staging ring and the allocator fill; the kernels' part is also kept on its
own), waits at the barrier where there is one (a callable that returns
when every rank is set up), and runs the closed loop for the window.  With
`trace`, the window runs under the profiler with the ranges of trace.py.  Once the window has
closed and the device's memory peak is read, every picture of every
segment is compared with the reference's digests; the loop takes each
segment's plane digests as it completes (harness/window.py `keep`), as a
consumer of the pictures would, so no decoded plane is held.  Returns a
summary of plain data (it crosses processes).
"""
from __future__ import annotations

import os
import time

from decode_bench.harness import check, trace as tr, traffic as tf
from decode_bench.harness import spec, work as wk
from decode_bench.harness.entry import ENTRIES
from decode_bench.harness.imports import forbidden_modules
from decode_bench.harness.window import closed_loop


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _bounds(card: str, items: list) -> dict | None:
    """{stage: least seconds the card could take} summed over the decoded
    items (frozen work data); None where the card has no peaks or an item
    no work data."""
    peak = wk.peaks(card)
    if peak is None:
        return None
    out = {}
    for item in items:
        w = wk.load(item)
        if w is None:
            return None
        for st, v in w["stages"].items():
            out[st] = out.get(st, 0.0) + wk.bound_ms(v, peak) / 1e3
    return out


def _native_library() -> str | None:
    """Where the program keeps its native parse library (built with cc on
    a checkout's first run)."""
    try:
        from p265_tpu_torch import native
    except ImportError:
        return None
    return getattr(native, "_SO", None)


def _setup_parts(native_so, native_cached: bool, warm_s: float) -> dict:
    """What set-up built, and what the kernel library's build (on a
    checkout's first run) or load took, from the program's own record;
    {} where the program keeps no such record."""
    try:
        from p265_tpu_torch.kernels._build import build_info
    except ImportError:
        return {}
    if "seconds" not in build_info:
        return {}
    return dict(kernels_s=build_info["seconds"],
                kernels_built=bool(build_info.get("log")),
                parse_built=bool(native_so) and not native_cached
                and os.path.exists(native_so),
                warm_s=warm_s)


def _compare(segments: list) -> dict:
    expected, wrong, missing, failed, bad = {}, 0, 0, 0, 0
    errors = []
    for (_, item), _, _, frames, error in segments:
        if frames is None:
            failed += 1
            errors.append(f"{item}: {error}")
            continue
        if item not in expected:
            expected[item] = check.load_expected(item)["pictures"]
        w, m = check.compare(frames, expected[item])
        wrong, missing = wrong + w, missing + m
        bad += bool(w or m)
    return dict(planes_wrong=wrong, pictures_missing=missing,
                segments_failed=failed, segments_wrong=bad,
                errors=errors[:5])


def run_rank(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, rank: int = 0, nranks: int = 1,
             barrier=None) -> dict:
    import torch
    cfg, traffic = cell["config"], cell["traffic"]
    items = (tf.segment_list(traffic, seed) if "cycles" in traffic
             else tf.sequence(traffic, seed))
    decode, my_items, dec_cls = ENTRIES[cfg["entry"]](
        cfg, device, items, traffic["warm"], rank, nranks)
    native_so = _native_library()
    native_cached = bool(native_so) and os.path.exists(native_so)
    t_warm = time.monotonic()
    for item in traffic["warm"]:
        frames, error = decode((None, item))
        if frames is None:
            raise RuntimeError(f"set-up: warm segment {item}: {error}")
    _sync(device)
    setup_parts = _setup_parts(native_so, native_cached,
                               time.monotonic() - t_warm)
    if barrier is not None:
        barrier()
    undo, stats, prof = [], [], None
    if trace:
        ranges = tr.host_ranges()
        for name in cell["per_layer"]:
            ranges.update(spec.metric(name).RANGES)
        u, _ = tr.install(ranges)
        undo = [u, tr.keep_stats(dec_cls, stats)]
        prof = tr.profiler()
        prof.__enter__()
    try:
        if trace:
            from torch.profiler import record_function
            with record_function(tr.WINDOW):
                win = closed_loop(decode, my_items, seconds,
                                  keep=check.frame_digests)
                _sync(device)
        else:
            win = closed_loop(decode, my_items, seconds,
                              keep=check.frame_digests)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        for u in reversed(undo):
            u()
    cuda = torch.device(device).type == "cuda"
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    segs = win["segments"]
    out = dict(rank=rank, t_open=win["t_open"], t_close=win["t_close"],
               card=card, memory_peak_bytes=peak, setup_parts=setup_parts,
               segments=[(it, t0, t1, None if f is None else len(f))
                         for (_, it), t0, t1, f, _ in segs])
    if trace:
        out["trace"] = tr.reduce(prof) if cuda else None
        out["stats"] = {k: sum(s.get(k, 0) for s in stats)
                        for k in set().union(*stats)} if stats else {}
        out["stage_bound_s"] = _bounds(card, [s[0][1] for s in segs])
    del prof
    out.update(_compare(segs))
    # the harness's own deal: the sequence round robin over the ranks
    out["segments_misdealt"] = sum(
        s[0][0] != rank + k * nranks for k, s in enumerate(segs))
    out["forbidden_modules"] = forbidden_modules()
    return out
