"""The port's end-to-end metric: frames/s of a stream decoded on the card by
PipelinedTorchDecoder, every pass bit-exact against golden.

    python -m p265_tpu_torch.bench [--device cuda] [--stream s1080_ldp4]
        [--warm 3] [--golden DIR]

The counterpart of bench.py, built on run_config.run.  In order: the
kernels and the native parse are built (timed, so that no pass holds
nvcc); the port's GoldenDecoder decodes the stream (timed: the baseline);
one cold pass, then `--warm` passes, each in a fresh decoder after
gc.collect(), each gated against golden on every plane of every frame
before and after the loop filters (run_config.gate, np.array_equal).  On
a card, one more pass under torch.profiler (run_config.profile_pass)
gives each kernel's device ms and the device's idle share, and a serial TorchDecoder pass under torch.profiler gives each stage's
device ms (the kernels launched inside record_function ranges around the
stage functions) and the span of its ranges on the device; each is
held against its bound from p265_tpu_torch.roofline (the census of the
stream, the card's peaks).  Where the stream has a steady-state companion
(STEADY: s1080_ldp4's is s1080_ldp16, the same configuration over 16
frames) one pass of it follows, gated too.  --golden DIR reads each
stream's golden planes and decode seconds from DIR/<stream>.npz
(run_config.save_golden's files, made beforehand) instead of decoding
golden in this process; vs_baseline then divides those seconds, which
are only as good as the host that measured them.

Stdout holds exactly one line, written only after every pass was
bit-exact: JSON with `metric` (naming the platform: gpu or cpu), `value`
(frames/s of the best warm pass), `unit` and `vs_baseline` (golden
seconds over the best warm pass).  Everything else goes to stderr as JSON
lines: the build, golden, every pass (`pass`: "cold" or "warm i"; wall
s, stats, launches of each kernel with the counts set to 0 just before
the pass, peak device memory, each dispatch's pocs and scan steps), the
warm times and their spread, the profile, the steady-state
row.  A failed gate, a missing card or a kernel that does not build
raises: the run exits nonzero and prints no line.  `run()` returns the
same record as a dict.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

STEADY = {"s1080_ldp4": "s1080_ldp16"}
# stage -> the functions whose device work is the stage's, (module, name)
STAGE_FUNCTIONS = {
    "mc": (("p265_tpu_torch.pipeline.batch_decode", "mc_pred_planes"),),
    "residual": (("p265_tpu_torch.kernels.itransform",
                  "batch_residual_grouped"),),
    "scan": (("p265_tpu_torch.pipeline.wavefront", "scan_plane"),),
    "deblock": (("p265_tpu_torch.kernels.loopfilter", "deblock_planes"),),
    "sao": (("p265_tpu_torch.kernels.loopfilter", "sao_apply"),),
    "fetch": (("p265_tpu_torch.pipeline.decoder", "fetch_planes"),),
}


def log(**record) -> None:
    print(json.dumps(record), file=sys.stderr, flush=True)


def _pass(p: dict) -> dict:
    """A run_config pass record as JSON: the stats' numbers only."""
    return dict(seconds=p["seconds"], frames=p["frames"],
                stats={k: v for k, v in p["stats"].items()
                       if isinstance(v, (int, float))},
                launches=p["launches"], peak_bytes=p["peak"],
                dispatches=p["dispatches"])


def saved_golden(stream: str, golden_dir: str) -> tuple:
    """(golden frames, golden decode seconds) of `stream` from
    golden_dir/<stream>.npz (run_config.save_golden)."""
    from p265_tpu_torch.run_config import load_golden
    path = os.path.join(golden_dir, stream + ".npz")
    with np.load(path) as z:
        seconds = float(z["seconds"])
    return load_golden(path), seconds


def busy_in_spans(spans: list, work: list) -> tuple:
    """spans [(stage, start, end)] and work [(start, end)], intervals on
    one device timeline -> ({stage: summed length of the work intervals
    inside its spans}, {stage: summed length of its spans})."""
    busy, total = {}, {}
    for stage, s0, s1 in spans:
        total[stage] = total.get(stage, 0) + s1 - s0
        busy[stage] = busy.get(stage, 0) + sum(
            w1 - w0 for w0, w1 in work if s0 <= w0 and w1 <= s1)
    return busy, total


def stage_profile(data: bytes, device: str) -> tuple:
    """One serial TorchDecoder pass under torch.profiler, each stage's
    functions (STAGE_FUNCTIONS) inside a record_function range named after
    the stage.  -> ({stage: device ms of the kernels and copies inside its
    ranges' spans}, {stage: ms of those spans}).  A range's span is its
    device-side annotation, from the first to the last of the device work
    it launched, gaps included; on the one stream of the serial decoder no
    other stage's work falls inside it.  (The CPU range's own device time
    misses the kernels launched through ctypes.)"""
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from p265_tpu_torch.pipeline.decoder import TorchDecoder

    def ranged(stage, fn):
        def f(*a, **k):
            with record_function(f"stage:{stage}"):
                return fn(*a, **k)
        return f

    saved = []
    for stage, fns in STAGE_FUNCTIONS.items():
        for mod, name in fns:
            m = importlib.import_module(mod)
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, ranged(stage, getattr(m, name)))
    try:
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            TorchDecoder(device).decode_stream(data)
            torch.cuda.synchronize(device)
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    spans, work = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = (e.time_range.start, e.time_range.end)
        if e.key.startswith("stage:"):
            spans.append((e.key[6:], *t))
        elif not e.is_user_annotation:
            work.append(t)
    busy, span = busy_in_spans(spans, work)
    return ({st: busy.get(st, 0) / 1e3 for st in STAGE_FUNCTIONS},
            {st: span.get(st, 0) / 1e3 for st in STAGE_FUNCTIONS})


def shares(w: dict, card: str, kernels_ms: dict, stages_ms: dict) -> dict:
    """Each kernel's and stage's bound (roofline) and its share of the
    measured device ms (None where nothing was measured).  A share above
    roofline.MAX_SHARE, which no card can give, is a fault of the count or
    of the measurement, and raises."""
    from p265_tpu_torch.roofline import MAX_SHARE, bound
    out = {}
    for kind, works, got in (("kernels", w["kernels"], kernels_ms),
                             ("stages", w["stages"], stages_ms)):
        out[kind] = {}
        for name, wk in works.items():
            ms, by = bound(wk, card)
            dev = got.get(name) or None
            out[kind][name] = dict(bytes=wk.bytes, ops=wk.ops, bound_ms=ms,
                                   bound_by=by, device_ms=dev,
                                   bound_share=ms / dev if dev else None)
            if dev and ms / dev > MAX_SHARE:
                raise RuntimeError(f"bench: {name}'s bound {ms} ms is "
                                   f"{ms / dev:.3f} of its measured {dev} "
                                   f"ms, above {MAX_SHARE}")
    return out


def run(stream: str = "s1080_ldp4", n_warm: int = 3, device: str = "cuda",
        golden_dir: str | None = None) -> dict:
    """The bench on `stream` (run_config.run: golden, a cold pass and
    n_warm warm passes, every one gated; a difference raises), with the
    kernels built first, the profile's shares of the roofline bounds on a
    card, and the steady-state row.  Returns the stdout line's keys plus
    the stderr record."""
    import torch
    from p265_tpu_torch import run_config
    from p265_tpu_torch.testgen.streams import get_stream
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA card; pass --device cpu")
    out = dict(stream=stream, device=device)
    t0 = time.perf_counter()
    from p265_tpu_torch.native.parse import native_parse_available
    if not native_parse_available():
        raise RuntimeError("bench: the native C parse did not build")
    if cuda:
        from p265_tpu_torch.kernels import _build
        _build.library()
        out["card"] = torch.cuda.get_device_name(device)
    out["build_s"] = time.perf_counter() - t0
    log(build_s=out["build_s"], device=device, card=out.get("card"))

    def gold(name):
        return None if golden_dir is None else saved_golden(name, golden_dir)

    rec = run_config.run(stream, n_warm, device, profile=cuda,
                         gold=gold(stream))
    info = rec["info"]
    out["golden_s"] = rec["golden_s"]
    log(stream=stream, width=info["width"], height=info["height"],
        frames=rec["frames"], golden_s=out["golden_s"],
        golden_from=golden_dir or "this process")
    passes = [_pass(p) for p in rec["passes"]]
    for i, p in enumerate(passes):
        log(**{"pass": f"warm {i - 1}" if i else "cold"}, **p)
    out["cold"], out["warm"] = passes[0], passes[1:]
    times = rec.get("warm_s", [passes[0]["seconds"]])
    best = min(times)
    out.update(warm_s=times, spread=(max(times) - best) / best,
               fps=rec["frames"] / best)
    log(warm_s=times, spread=out["spread"], fps=out["fps"])
    if cuda:
        from p265_tpu_torch import roofline
        kp = rec["profile"]
        data = get_stream(stream)
        sp, spans = stage_profile(data, device)
        w = roofline.work(roofline.census(data))
        out["profile"] = dict(kp, stages_ms=sp, stage_spans_ms=spans,
                              **shares(w, out["card"], kp["kernels_ms"], sp))
        log(profile=out["profile"])
    steady = STEADY.get(stream)
    if steady:
        r16 = run_config.run(steady, 0, device, gold=gold(steady))
        p16 = _pass(r16["passes"][0])
        out["steady"] = dict(p16, stream=steady, golden_s=r16["golden_s"],
                             fps=p16["frames"] / p16["seconds"])
        log(steady=out["steady"])
    platform = "gpu" if cuda else "cpu"
    out["line"] = {
        "metric": f"{info['height']}p Main-profile frames/s/{platform} "
                  f"(e2e {stream}, bit-exact)",
        "value": round(out["fps"], 4),
        "unit": "fps",
        "vs_baseline": round(out["golden_s"] / best, 3),
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stream", default="s1080_ldp4")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--golden", metavar="DIR", help="read golden planes and "
                    "seconds from DIR/<stream>.npz (run_config.save_golden)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            log(error="no CUDA card; pass --device cpu")
            return 1
        log(nvidia_smi=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    out = run(args.stream, args.warm, args.device, args.golden)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
