"""The result of a run from its ranks' summaries: the end-to-end metrics
(trace 0) or the per-layer ones (trace 1), the device, the breakdown, and
the numbers compared, each beside its limit."""
from __future__ import annotations

from decode_bench.harness import check, spec, window

TOP = 10


def end_to_end(name: str, ranks: list, t_start: float) -> float | None:
    t_open = min(r["t_open"] for r in ranks)
    t_close = max(r["t_close"] for r in ranks)
    segs = [s for r in ranks for s in r["segments"] if s[3] is not None]
    if name == "fps":
        return window.fps(sum(s[3] for s in segs), t_open, t_close)
    if name == "segment_ms_p95":
        return window.segment_ms_p95([s[2] - s[1] for s in segs])
    if name == "setup_s":
        return t_open - t_start
    raise KeyError(f"no end-to-end metric {name!r}")


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            if v > 0][:TOP]


def _mean_dicts(ds: list) -> dict:
    out = {}
    for d in ds:
        for k, v in d.items():
            out[k] = out.get(k, 0.0) + v / len(ds)
    return out


def setup_parts(ranks: list) -> dict:
    """Parts of set-up, which `setup_s` includes: the slowest rank's
    kernel library build or load and warm segments, in seconds, and
    whether any rank built the kernel or the native parse library."""
    parts = [r.get("setup_parts") or {} for r in ranks]
    if not all(parts):
        return {}
    return {k: (max if k.endswith("_s") else any)(p[k] for p in parts)
            for k in parts[0]}


def checks(ranks: list, nranks: int) -> dict:
    """{name: (value, limit)} of the numbers compared."""
    vals = {k: sum(r[k] for r in ranks) for k in check.LIMITS
            if k != "ranks_missing"}
    vals["ranks_missing"] = nranks - len(ranks)
    return {k: (vals[k], check.LIMITS[k]) for k in check.LIMITS}


def result(cell: dict, ranks: list, nranks: int, t_start: float,
           trace: bool, units: dict) -> dict:
    """The result line's object.  units: {metric: unit}."""
    compared = checks(ranks, nranks)
    correct = all(v <= lim for v, lim in compared.values())
    segs = [s for r in ranks for s in r["segments"]]
    failed = sum(r["segments_failed"] + r["segments_wrong"] for r in ranks)
    out = dict(correct=correct, attempted=len(segs), failed=failed)
    device = dict(platform="gpu" if ranks[0]["card"] != "cpu" else "cpu",
                  kind=ranks[0]["card"], count=nranks,
                  memory_peak_bytes=max(r["memory_peak_bytes"]
                                        for r in ranks))
    metrics = {}
    if not trace:
        for name in cell["end_to_end"]:
            v = end_to_end(name, ranks, t_start)
            if v is not None:
                metrics[name] = dict(value=v, unit=units[name])
    else:
        for name in cell["per_layer"]:
            v = spec.metric(name).read(ranks)
            if v is not None:
                metrics[name] = dict(value=v, unit=units[name])
        traced = [r["trace"] for r in ranks if r.get("trace")]
        if traced:
            device.update(busy_s=sum(t["busy_s"] for t in traced) / len(traced),
                          window_s=sum(t["window_s"] for t in traced)
                          / len(traced))
            out["breakdown"] = dict(
                device_ops=_top(_mean_dicts([t["device_ops"] for t in traced])),
                idle_gaps=_top(_mean_dicts([t["idle_by_host"]
                                            for t in traced])))
    out.update(metrics=metrics, device=device, setup=setup_parts(ranks))
    out["check"] = {k: dict(value=v, limit=lim)
                    for k, (v, lim) in compared.items()}
    return out
