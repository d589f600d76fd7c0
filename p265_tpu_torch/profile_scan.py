"""The scan kernel's launch shapes, timed on a CUDA card.

    python -m p265_tpu_torch.profile_scan [--stream s1080_ldp4.265]
        [--reps 20]

Decodes the stream (a file of p265_tpu_torch/data) once on cuda and keeps
every scan of the pass as it stood before the scan.  Then, for each launch
shape of csrc/scan.cu (the CTAs of its one cluster x the warps of a CTA;
the shipped one, wavefront.SCAN_SHAPE, is the decoder's build, every other
one a build of the kernel library with that shape's compile-time
constants):

- the kernel must be torch.equal to scan_packed_ref on every scan;
- `device_ms`: the summed CUDA-event time of one pass's scan launches, each
  timed alone (median over reps);
- `floor_ms`: the same launches with barrier_only (the steps and barriers
  alone), and per step with TUs the floor and the chain (device - floor);

then one JSON line with every shape's numbers.  The shapes run in turns
(forward, then backward) so a drift of the card's clock shows as a spread.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SHAPES = ((1, 16), (8, 8), (8, 16), (16, 4), (16, 8), (16, 16))


def capture_scans(data: bytes) -> list:
    """[(stacked, starts, n_steps, plane before the scan)] of one pass of
    PipelinedTorchDecoder("cuda") over `data`, scans with steps only."""
    from p265_tpu_torch.pipeline import wavefront as wf
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    scans, orig = [], wf.scan_plane

    def spy(stacked, starts, n_steps, plane, *a, **k):
        if n_steps > 0:
            scans.append((stacked, starts, n_steps, plane.clone()))
        return orig(stacked, starts, n_steps, plane, *a, **k)

    wf.scan_plane = spy
    try:
        PipelinedTorchDecoder("cuda").decode_stream(data)
    finally:
        wf.scan_plane = orig
    return scans


def shape_defines(shape) -> tuple:
    """The compile-time constants of the kernel library whose scan kernel
    launches `shape` (none for the decoder's own)."""
    from p265_tpu_torch.pipeline import wavefront as wf
    if tuple(shape) == wf.SCAN_SHAPE:
        return ()
    return (f"P265_SCAN_CTAS={shape[0]}", f"P265_SCAN_WARPS={shape[1]}")


def time_launches(packs: list, defines: tuple, barrier_only: bool,
                  reps: int) -> float:
    """Median over reps of the summed CUDA-event ms of one launch per
    packed scan, in place on its scratch plane (a scan run again over its
    own output reads the same samples and does the same work)."""
    from p265_tpu_torch.pipeline import wavefront as wf
    runs = []
    for r in range(reps + 2):
        evs = []
        for pk, plane in packs:
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            wf._scan_launch(pk, plane, 0, pk.n_steps, barrier_only, defines)
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        if r >= 2:   # two warm-up runs
            runs.append(sum(s.elapsed_time(e) for s, e in evs))
    return statistics.median(runs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stream", default="s1080_ldp4.265")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scan: needs a CUDA device")
    from p265_tpu_torch.pipeline import wavefront as wf
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(DATA, args.stream), "rb") as f:
        scans = capture_scans(f.read())
    packs = [(wf.pack_scan(st, sd, n, pl.device), pl) for st, sd, n, pl
             in scans]
    want = [wf.scan_packed_ref(pk, pl.clone(), 0, pk.n_steps)
            for pk, pl in packs]
    tus = np.concatenate([pk.step_tus for pk, _ in packs])
    live = int((tus > 0).sum())
    print(f"{args.stream}: {len(scans)} scans, steps "
          f"{[pk.n_steps for pk, _ in packs]}, {live} with TUs; TUs a step "
          f"max {int(tus.max())}, median of the steps with TUs "
          f"{float(np.median(tus[tus > 0]))}", flush=True)
    defs = {shape: shape_defines(shape) for shape in SHAPES}
    for shape in SHAPES:
        for (pk, pl), w in zip(packs, want):
            got = pl.clone()
            wf._scan_launch(pk, got, 0, pk.n_steps, False, defs[shape])
            torch.cuda.synchronize()
            if not torch.equal(got, w):
                raise SystemExit(f"profile_scan: shape {shape} differs from "
                                 "scan_packed_ref")
    work = [(pk, pl.clone()) for pk, pl in packs]
    res = {s: {"device_ms": [], "floor_ms": []} for s in SHAPES}
    for order in (SHAPES, SHAPES[::-1]):
        for shape in order:
            res[shape]["device_ms"].append(
                time_launches(work, defs[shape], False, args.reps))
            res[shape]["floor_ms"].append(
                time_launches(work, defs[shape], True, args.reps))
    out = []
    for (ctas, warps), r in res.items():
        dev = statistics.mean(r["device_ms"])
        floor = statistics.mean(r["floor_ms"])
        row = dict(ctas=ctas, warps=warps, device_ms=r["device_ms"],
                   floor_ms=r["floor_ms"],
                   floor_us_a_step=floor / live * 1e3,
                   chain_us_a_step=(dev - floor) / live * 1e3)
        out.append(row)
        print(f"{ctas} CTA(s) x {warps} warps: device {r['device_ms']} ms, "
              f"floor {r['floor_ms']} ms; a step with TUs: floor "
              f"{row['floor_us_a_step']:.3f} us, chain "
              f"{row['chain_us_a_step']:.3f} us", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "stream": args.stream, "steps_with_tus": live,
                      "shapes": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
