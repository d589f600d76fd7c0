"""Decode one named stream on the card: a golden gate, a cold pass and
warm passes, and where the time went.

    python -m p265_tpu_torch.run_config <name> [n_warm] [--device cpu]
        [--profile] [--md5] [--frame-dag-max 1,4]

The counterpart of profiling/run_config.py, for every stream that
`p265_tpu_torch.testgen.streams.get_stream` serves (GENERATORS and CONFIG5,
committed, or encoded once into its cache).  The port's GoldenDecoder
decodes the stream first; then PipelinedTorchDecoder decodes it once cold
and `n_warm` times warm (default 2), each pass in a fresh decoder after
gc.collect(), on `cuda` unless --device says otherwise.  Every pass is
gated against golden on every plane of every frame, before and after the
loop filters (np.array_equal); a difference raises.  --md5 gates against
the committed golden MD5s (data/GOLDEN_MD5) instead of a golden decode
(a 4K GOP takes minutes of pure-Python golden).  --frame-dag-max takes a
list: a cold pass at each value, then the warm passes in turns (1, 4, 4,
1, ...), each summarised apart with the groups (dispatches) it formed.  Everything is printed on stderr: per pass the wall
time and the decoder's stats split, the peak device memory, the launches
of each kernel (counts set to 0 just before the pass) and the scan steps
of each dispatch; then fps (best warm pass) and the warm spread.  On a
stream with tiles or WPP it also times the parse alone (the port's native
CTU parse, no reconstruction) with the host lanes (parse_workers()) and
with one lane, best of 3 each, in turns.  --profile adds one more pass
under torch.profiler: each kernel's device time, in all and launch by
launch, the device's operations and idle share, the host-to-device
copies (device ms of each, beside the pass's staging copies and bytes)
and the calls of the casts and selects (aten::_to_copy, aten::where) on
every thread; then a serial
TorchDecoder pass under torch.profiler gives each stage's device time
(stage_profile).  `run()` returns all of it as one record (report() prints it).
"""
from __future__ import annotations

import argparse
import gc
import os
import statistics
import sys
import time

import numpy as np


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Dispatches:
    """Record (pocs, scan steps) of every batch that build_batch packs
    while the block runs; a batch with no scan TU bucket counts 0 steps
    (scan_plane launches nothing for it)."""

    def __enter__(self):
        from p265_tpu_torch.pipeline import decoder as dm
        self.dm, self.orig, self.seen = dm, dm.build_batch, []

        def spy(tplans, plans, **kw):
            batch = self.orig(tplans, plans, **kw)
            self.seen.append(([p.poc for p in plans],
                              batch["n_steps"] if batch["tu"] else 0))
            return batch
        dm.build_batch = spy
        return self.seen

    def __exit__(self, *exc):
        self.dm.build_batch = self.orig


class GoldFrame:
    """A golden frame reduced to what the gate compares."""

    def __init__(self, poc: int, planes: list, prefilter: list):
        self.poc, self.planes, self.prefilter = poc, planes, prefilter


def golden_frames(data: bytes) -> list:
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    return [GoldFrame(f.poc, f.planes, f.prefilter)
            for f in GoldenDecoder().decode_stream(data)]


def save_golden(name: str, path: str) -> tuple:
    """Decode stream `name` with the port's GoldenDecoder into an .npz at
    `path` (uint8 planes and the decode's seconds); -> (path, golden
    seconds).  A worker process's task: it imports no torch."""
    from p265_tpu_torch.testgen.streams import get_stream
    t0 = time.perf_counter()
    gold = golden_frames(get_stream(name))
    seconds = time.perf_counter() - t0
    arrays = {"poc": np.array([g.poc for g in gold]),
              "seconds": np.array(seconds)}
    for i, g in enumerate(gold):
        for c in range(3):
            for key, p in (("q", g.planes[c]), ("p", g.prefilter[c])):
                if p.min() < 0 or p.max() > 255:
                    raise ValueError(f"{name}: golden sample outside 0..255")
                arrays[f"{key}{i}_{c}"] = p.astype(np.uint8)
    np.savez(path, **arrays)
    return path, seconds


def load_golden(path: str) -> list:
    with np.load(path) as z:
        return [GoldFrame(int(poc), [z[f"q{i}_{c}"] for c in range(3)],
                          [z[f"p{i}_{c}"] for c in range(3)])
                for i, poc in enumerate(z["poc"])]


def gate(frames, gold, what: str) -> None:
    """Every plane of every frame, before and after the filters, equal to
    golden's; raises otherwise."""
    if len(frames) != len(gold):
        raise RuntimeError(f"{what}: {len(frames)} frames, golden has "
                           f"{len(gold)}")
    for f, g in zip(frames, gold):
        if f.poc != g.poc:
            raise RuntimeError(f"{what}: output order differs")
        for c in range(3):
            pre = f.prefilter[c]
            pre = pre.cpu().numpy() if hasattr(pre, "cpu") else pre
            if not np.array_equal(f.planes[c], g.planes[c]):
                raise RuntimeError(f"{what}: poc {f.poc} plane {c} differs "
                                   "from golden")
            if not np.array_equal(pre, g.prefilter[c]):
                raise RuntimeError(f"{what}: poc {f.poc} prefilter {c} "
                                   "differs from golden")


def decode_pass(data: bytes, device: str = "cuda",
                frame_dag_max: int = 1) -> dict:
    """One pass of PipelinedTorchDecoder(device, frame_dag_max=...),
    ending when every output plane is on the host: the frames, wall
    seconds, the decoder's stats, the kernels' launches (counts set to 0
    just before the pass), (pocs, scan steps) of every dispatch and the
    peak device memory in bytes (None off CUDA)."""
    import torch
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with Dispatches() as dispatches:
        dec = PipelinedTorchDecoder(device, frame_dag_max=frame_dag_max)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        frames = dec.decode_stream(data)
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    return dict(frames=frames, seconds=seconds, stats=dict(dec.stats),
                launches=launches, dispatches=list(dispatches),
                frame_dag_max=frame_dag_max,
                peak=torch.cuda.max_memory_allocated(device) if cuda
                else None)


def split(stats: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in stats.items()
                     if isinstance(v, float))


def mib(nbytes) -> str:
    return "n/a" if nbytes is None else f"{nbytes / 2 ** 20:.1f} MiB"


def parse_only(on_plan=None):
    """A GoldenDecoder that runs the native CTU parse and reconstructs
    nothing; on_plan(plan), where given, sees each picture's FramePlan."""
    from p265_tpu_torch.golden.decoder import GoldenDecoder

    class ParseOnly(GoldenDecoder):
        def __init__(self):
            super().__init__(use_native_parse=True)

        def _run_recon(self, task):
            if on_plan is not None:
                on_plan(task["plan"])
            task["frame"].planes = task["frame"].prefilter = [None] * 3
            task["pic"].planes = [np.zeros((2, 2), np.int32)] * 3

    return ParseOnly()


def parse_seconds(data: bytes, lanes: bool, reps: int = 3) -> float:
    """Best of `reps` parses of the whole stream by the port's native CTU
    parse with no reconstruction, with the host lanes (tiles or WPP rows
    on parse_workers() threads, where the stream allows them) or with one
    lane (P265_TPU_PARSE_WORKERS=1)."""
    key = "P265_TPU_PARSE_WORKERS"
    saved = os.environ.get(key)
    if not lanes:
        os.environ[key] = "1"
    try:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            parse_only().decode_stream(data)
            best = min(best, time.perf_counter() - t0)
    finally:
        if saved is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = saved
    return best


def parse_lanes(data: bytes, info: dict) -> dict:
    """The parse alone with and without the host lanes, in turns (one
    lane, lanes, lanes, one lane): the best seconds of each, the lanes and
    the lane path."""
    from p265_tpu_torch.syntax.ctu import parse_workers
    tiles = info["tiles"] != (1, 1)
    path = ("none: tiles and WPP together parse in one lane"
            if tiles and info["wpp"] else
            "tile lanes" if tiles else "WPP row lanes")
    t = {False: [], True: []}
    for lanes in (False, True, True, False):
        t[lanes].append(parse_seconds(data, lanes))
    return dict(one_lane_s=min(t[False]), lanes_s=min(t[True]),
                lanes=parse_workers(), path=path)


# kernel -> its symbol in the device trace
KERNEL_SYMBOLS = {"itransform": "itransform_grouped_kernel",
                  "mc": "mc_grouped_kernel", "scan": "scan_kernel",
                  "deblock": "deblock_tiles", "sao": "sao_tiles"}


# the host-side operators whose calls profile_pass counts in its window:
# casts and selects (the glue the kernels' wire dtypes and SAO's store
# took off the card)
COUNTED_OPS = ("aten::_to_copy", "aten::where")


def profile_pass(data: bytes, device: str) -> dict:
    """One more pass under torch.profiler: device ms of each kernel of
    the port (KERNEL_SYMBOLS), in all and launch by launch (in launch
    order), and of everything, the device operations, wall ms, the
    device's idle share, the host-to-device copies (device ms of each, in
    order) beside the pass's h2d_copies and h2d_bytes, the calls of each
    COUNTED_OPS operator on every thread (op_counts), and the device work
    outside the port's kernels (other_ms, other_ops; other: (name, count,
    ms) of each, largest first)."""
    from p265_tpu_torch.profile_decode import h2d_copies
    import torch
    from torch.autograd import DeviceType
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    # every thread's operators: the pipelined decoder's worker runs them
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        p = decode_pass(data, device)
        torch.cuda.synchronize(device)
    avg = prof.key_averages()
    # the device-side copies of record_function ranges are not work
    ev = [e for e in avg
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in ev) / 1e3
    kernels = {k: sum(e.self_device_time_total for e in ev
                      if sym in e.key) / 1e3
               for k, sym in KERNEL_SYMBOLS.items()}
    each = {k: [e.time_range.elapsed_us() / 1e3 for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and sym in e.name), key=lambda e: e.time_range.start)]
        for k, sym in KERNEL_SYMBOLS.items()}
    wall = p["seconds"] * 1e3
    h2d = h2d_copies(prof)
    counts = {op: sum(e.count for e in avg if e.key == op
                      and e.device_type == DeviceType.CPU)
              for op in COUNTED_OPS}
    # the rest of the device work: every other kernel and copy by name
    glue = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in ev if not any(sym in e.key for sym in
                                          KERNEL_SYMBOLS.values())),
                  key=lambda r: -r[2])
    return dict(wall_ms=wall, device_ms=total, kernels_ms=kernels,
                launches_ms=each, idle=1 - total / wall,
                ops=sum(e.count for e in ev), h2d_ms=h2d,
                h2d_copies=p["stats"].get("h2d_copies"),
                h2d_bytes=p["stats"].get("h2d_bytes"), op_counts=counts,
                other_ms=sum(r[2] for r in glue),
                other_ops=sum(r[1] for r in glue), other=glue)


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


def turns(dags: tuple, n_warm: int) -> list:
    """The passes' frame_dag_max values: a cold pass at each, then
    `n_warm` warm passes at each, in turns (1, 4, 4, 1, ...)."""
    order = list(dags)
    for k in range(n_warm):
        order += list(dags) if k % 2 == 0 else list(reversed(dags))
    return order


def summary(passes: list, frames: int) -> dict:
    """warm_s, fps (best warm pass), spread and median of the warm passes
    of one frame_dag_max (the first pass is the cold one)."""
    warm = [p["seconds"] for p in passes[1:]]
    best = min(warm)
    return dict(warm_s=warm, fps=frames / best,
                spread=(max(warm) - best) / best,
                median=statistics.median(warm))


def run(name: str, n_warm: int = 2, device: str = "cuda",
        profile: bool = False, md5: bool = False,
        dags: tuple = (1,)) -> dict:
    """run_config's work on stream `name`: golden (decoded here; with `md5`
    the committed golden MD5s of data/GOLDEN_MD5 instead), for each
    frame_dag_max of `dags` one cold pass and `n_warm` warm passes, in
    turns (decode_pass after gc.collect(), each gated against golden; a
    difference raises), the parse alone with and without lanes on a
    stream with tiles or WPP, and where `profile` a pass under
    torch.profiler.  -> the record: the
    stream's info, golden_s (None with md5), per pass its decode_pass
    record with the frames counted; with warm passes warm_s, fps (best
    warm pass), spread and median of dags[0], and with several dags each
    one's in by_dag; parse; profile."""
    from p265_tpu_torch.testgen.streams import (check_md5, get_stream,
                                                golden_md5_of, stream_info)
    data = get_stream(name)
    info = stream_info(data)
    if md5:
        expected = golden_md5_of(name)
        n_frames = len({poc for poc, _, _ in expected})
        golden_s = None

        def check(frames, what):
            check_md5(frames, expected, what)
    else:
        t0 = time.perf_counter()
        gold_frames = golden_frames(data)
        golden_s = time.perf_counter() - t0
        n_frames = len(gold_frames)

        def check(frames, what):
            gate(frames, gold_frames, what)
    rec = dict(name=name, bytes=len(data), info=info, device=device,
               frames=n_frames, golden_s=golden_s, md5=md5, passes=[])
    for i, dag in enumerate(turns(dags, n_warm)):
        gc.collect()
        p = decode_pass(data, device, dag)
        check(p["frames"], f"{name} pass {i} frame_dag_max={dag}")
        p["frames"] = len(p["frames"])
        rec["passes"].append(p)
    if n_warm:
        by_dag = {dag: summary([p for p in rec["passes"]
                                if p["frame_dag_max"] == dag], n_frames)
                  for dag in dags}
        rec.update(by_dag[dags[0]])
        if len(dags) > 1:
            rec["by_dag"] = by_dag
    if info["tiles"] != (1, 1) or info["wpp"]:
        rec["parse"] = parse_lanes(data, info)
    if profile:
        rec["profile"] = profile_pass(data, device)
    return rec


def report(rec: dict) -> None:
    """Log a run() record on stderr as text."""
    name, info, passes = rec["name"], rec["info"], rec["passes"]
    log(f"{name}: {rec['bytes']} bytes, {info['width']}x{info['height']}, "
        f"{info['frames']} frames, tiles {info['tiles'][0]}x"
        f"{info['tiles'][1]}, WPP {'on' if info['wpp'] else 'off'}; "
        f"device {rec['device']}")
    if rec["md5"]:
        log(f"golden: the committed MD5s of data/GOLDEN_MD5, "
            f"{rec['frames']} frames")
    else:
        log(f"golden: {rec['golden_s']:.2f} s for {rec['frames']} frames")
    dags = sorted({p["frame_dag_max"] for p in passes})
    seen = set()
    for p in passes:
        dag = p["frame_dag_max"]
        cold = dag not in seen
        seen.add(dag)
        log(f"{'cold' if cold else 'warm'} pass"
            + (f" frame_dag_max={dag}" if len(dags) > 1 else "")
            + f": {p['seconds']:.4f} s, bit-exact vs golden"
            + (" MD5" if rec["md5"] else "")
            + f" (every plane, pre- and post-filter); peak {mib(p['peak'])};"
            f" launches {p['launches']}; stats: {split(p['stats'])}")
        if cold:
            log("  dispatches (pocs: scan steps): " + ", ".join(
                f"{pocs}: {steps}" for pocs, steps in p["dispatches"]))
    for dag in dags if "fps" in rec else ():
        own = [p for p in passes if p["frame_dag_max"] == dag]
        s = rec["by_dag"][dag] if "by_dag" in rec else rec
        peaks = [p["peak"] for p in own]
        log(f"{name}" + (f" frame_dag_max={dag}" if len(dags) > 1 else "")
            + f": warm passes {[round(t, 4) for t in s['warm_s']]} s; "
            f"{s['fps']:.4f} fps (best), spread {s['spread'] * 100:.1f}"
            f"%, median {s['median']:.4f} s; cold "
            f"{own[0]['seconds']:.4f} s; peak "
            f"{mib(max(peaks) if peaks[0] is not None else None)}")
    if "parse" in rec:
        pr = rec["parse"]
        log(f"{name}: parse alone (native CTU parse, best of 3, in turns): "
            f"one lane {pr['one_lane_s']:.4f} s, {pr['lanes']} lanes "
            f"{pr['lanes_s']:.4f} s ({pr['one_lane_s'] / pr['lanes_s']:.2f}"
            f"x); lane path: {pr['path']}")
    if "profile" in rec:
        pr = rec["profile"]
        log(f"{name} under torch.profiler: wall {pr['wall_ms']:.2f} ms, "
            f"device {pr['device_ms']:.4f} ms over {pr['ops']} operations, "
            f"idle share {pr['idle']:.4f}; kernels (device ms) "
            + ", ".join(f"{k} {v:.4f}" for k, v in pr["kernels_ms"].items()))
        log("  device ms of each launch: " + "; ".join(
            f"{k} " + " ".join(f"{v:.4f}" for v in ms)
            for k, ms in pr["launches_ms"].items()))
        log(f"  h2d: {pr['h2d_copies']} staging copies, {pr['h2d_bytes']} "
            f"bytes; {len(pr['h2d_ms'])} host-to-device copies in the "
            f"trace, {sum(pr['h2d_ms']):.4f} device ms (each: "
            + " ".join(f"{v:.4f}" for v in pr["h2d_ms"]) + ")")
        log("  host operators in the window (every thread): " + ", ".join(
            f"{k} {v}" for k, v in pr["op_counts"].items()))
        log(f"  the rest of the device work: {pr['other_ops']} operations, "
            f"{pr['other_ms']:.4f} ms; by name (count, ms): " + "; ".join(
                f"{k[:90]} ({n}, {ms:.4f})" for k, n, ms in pr["other"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name")
    ap.add_argument("n_warm", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="one more pass under torch.profiler (CUDA only)")
    ap.add_argument("--md5", action="store_true", help="gate against "
                    "data/GOLDEN_MD5 instead of a golden decode")
    ap.add_argument("--frame-dag-max", default="1",
                    help="comma list, e.g. 1,4: passes in turns")
    args = ap.parse_args(argv)
    dags = tuple(int(v) for v in args.frame_dag_max.split(","))
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            log("run_config: no CUDA card; pass --device cpu")
            return 1
        import subprocess
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip())
    elif args.profile:
        ap.error("--profile needs a CUDA device")
    rec = run(args.name, args.n_warm, args.device, args.profile,
              md5=args.md5, dags=dags)
    report(rec)
    if args.profile:
        from p265_tpu_torch.testgen.streams import get_stream
        busy, _ = stage_profile(get_stream(args.name), args.device)
        log(f"{args.name}, serial TorchDecoder pass under torch.profiler: "
            "device ms of each stage's functions (STAGE_FUNCTIONS) "
            + ", ".join(f"{k} {v:.4f}" for k, v in busy.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
