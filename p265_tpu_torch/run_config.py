"""Decode one named stream on the card: a golden gate, a cold pass and
warm passes, and where the time went.

    python -m p265_tpu_torch.run_config <name> [n_warm] [--device cpu]
        [--profile]

The counterpart of profiling/run_config.py, for every stream of
`p265_tpu_torch.testgen.streams.GENERATORS` (committed, or encoded once
into its cache).  The port's GoldenDecoder decodes the stream first; then
PipelinedTorchDecoder decodes it once cold and `n_warm` times warm (default
2), each pass in a fresh decoder after gc.collect(), on `cuda` unless
--device says otherwise.  Every pass is gated against golden on every
plane of every frame, before and after the loop filters (np.array_equal);
a difference raises.  Everything is printed on stderr: per pass the wall
time and the decoder's stats split, the peak device memory, the launches
of each kernel (counts set to 0 just before the pass) and the scan steps
of each dispatch; then fps (best warm pass) and the warm spread.  On a
stream with tiles or WPP it also times the parse alone (the port's native
CTU parse, no reconstruction) with the host lanes (parse_workers()) and
with one lane, best of 3 each, in turns.  --profile adds one more pass
under torch.profiler: each kernel's device time and the device's idle
share.
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
    `path` (uint8 planes); -> (path, golden seconds).  A worker process's
    task: it imports no torch."""
    from p265_tpu_torch.testgen.streams import get_stream
    t0 = time.perf_counter()
    gold = golden_frames(get_stream(name))
    seconds = time.perf_counter() - t0
    arrays = {"poc": np.array([g.poc for g in gold])}
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


def decode_pass(data: bytes, device: str = "cuda") -> dict:
    """One pass of PipelinedTorchDecoder(device), ending when every
    output plane is on the host: the frames, wall seconds, the decoder's
    stats, the kernels' launches (counts set to 0 just before the pass),
    (pocs, scan steps) of every dispatch and the peak device memory in
    bytes (None off CUDA)."""
    import torch
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with Dispatches() as dispatches:
        dec = PipelinedTorchDecoder(device)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        frames = dec.decode_stream(data)
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    return dict(frames=frames, seconds=seconds, stats=dict(dec.stats),
                launches=launches, dispatches=list(dispatches),
                peak=torch.cuda.max_memory_allocated(device) if cuda
                else None)


def split(stats: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in stats.items()
                     if isinstance(v, float))


def mib(nbytes) -> str:
    return "n/a" if nbytes is None else f"{nbytes / 2 ** 20:.1f} MiB"


def parse_seconds(data: bytes, lanes: bool, reps: int = 3) -> float:
    """Best of `reps` parses of the whole stream by the port's native CTU
    parse with no reconstruction, with the host lanes (tiles or WPP rows
    on parse_workers() threads, where the stream allows them) or with one
    lane (P265_TPU_PARSE_WORKERS=1)."""
    from p265_tpu_torch.golden.decoder import GoldenDecoder

    class ParseOnly(GoldenDecoder):
        def __init__(self):
            super().__init__(use_native_parse=True)

        def _run_recon(self, task):
            task["frame"].planes = task["frame"].prefilter = [None] * 3
            task["pic"].planes = [np.zeros((2, 2), np.int32)] * 3

    key = "P265_TPU_PARSE_WORKERS"
    saved = os.environ.get(key)
    if not lanes:
        os.environ[key] = "1"
    try:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            ParseOnly().decode_stream(data)
            best = min(best, time.perf_counter() - t0)
    finally:
        if saved is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = saved
    return best


def parse_lanes(name: str, data: bytes, info: dict) -> None:
    """Log the parse alone with and without the host lanes, in turns (one
    lane, lanes, lanes, one lane)."""
    from p265_tpu_torch.syntax.ctu import parse_workers
    tiles = info["tiles"] != (1, 1)
    path = ("none: tiles and WPP together parse in one lane"
            if tiles and info["wpp"] else
            "tile lanes" if tiles else "WPP row lanes")
    t = {False: [], True: []}
    for lanes in (False, True, True, False):
        t[lanes].append(parse_seconds(data, lanes))
    one, lanes = min(t[False]), min(t[True])
    log(f"{name}: parse alone (native CTU parse, best of 3, in turns): one "
        f"lane {one:.4f} s, {parse_workers()} lanes {lanes:.4f} s "
        f"({one / lanes:.2f}x); lane path: {path}")


def profile_pass(data: bytes, device: str) -> dict:
    """One more pass under torch.profiler: device ms of each kernel of
    the port and of everything, wall s and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p = decode_pass(data, device)
        torch.cuda.synchronize(device)
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in ev) / 1e3
    kernels = {sym: sum(e.self_device_time_total for e in ev
                        if sym in e.key) / 1e3
               for sym in ("scan_kernel", "itransform_grouped_kernel",
                           "mc_grouped_kernel")}
    wall = p["seconds"] * 1e3
    return dict(wall_ms=wall, device_ms=total, kernels_ms=kernels,
                idle=1 - total / wall, ops=sum(e.count for e in ev))


def run(name: str, n_warm: int = 2, device: str = "cuda",
        profile: bool = False) -> None:
    """run_config's work on stream `name`, logged on stderr."""
    from p265_tpu_torch.testgen.streams import get_stream, stream_info
    data = get_stream(name)
    info = stream_info(data)
    log(f"{name}: {len(data)} bytes, {info['width']}x{info['height']}, "
        f"{info['frames']} frames, tiles {info['tiles'][0]}x"
        f"{info['tiles'][1]}, WPP {'on' if info['wpp'] else 'off'}; "
        f"device {device}")
    t0 = time.perf_counter()
    gold = golden_frames(data)
    log(f"golden: {time.perf_counter() - t0:.2f} s for {len(gold)} frames")
    times, peaks = [], []
    for i in range(1 + n_warm):
        gc.collect()
        p = decode_pass(data, device)
        gate(p["frames"], gold, f"{name} pass {i}")
        log(f"{'cold' if i == 0 else 'warm'} pass: {p['seconds']:.4f} s, "
            f"bit-exact vs golden (every plane, pre- and post-filter); "
            f"peak {mib(p['peak'])}; launches {p['launches']}; stats: "
            f"{split(p['stats'])}")
        if i == 0:
            log("  dispatches (pocs: scan steps): " + ", ".join(
                f"{pocs}: {steps}" for pocs, steps in p["dispatches"]))
        times.append(p["seconds"])
        peaks.append(p["peak"])
        del p
    if n_warm:
        warm = times[1:]
        best = min(warm)
        log(f"{name}: warm passes {[round(t, 4) for t in warm]} s; "
            f"{len(gold) / best:.4f} fps (best), spread "
            f"{(max(warm) - best) / best * 100:.1f}%, median "
            f"{statistics.median(warm):.4f} s; cold {times[0]:.4f} s; peak "
            f"{mib(max(peaks) if peaks[0] is not None else None)}")
    if info["tiles"] != (1, 1) or info["wpp"]:
        parse_lanes(name, data, info)
    if profile:
        pr = profile_pass(data, device)
        log(f"{name} under torch.profiler: wall {pr['wall_ms']:.2f} ms, "
            f"device {pr['device_ms']:.4f} ms over {pr['ops']} operations, "
            f"idle share {pr['idle']:.4f}; kernels (device ms) "
            + ", ".join(f"{k} {v:.4f}" for k, v in pr["kernels_ms"].items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name")
    ap.add_argument("n_warm", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="one more pass under torch.profiler (CUDA only)")
    args = ap.parse_args(argv)
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
    run(args.name, args.n_warm, args.device, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
