#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (p265_tpu_torch) on one CUDA card.

    python chip_smoke.py

Phases, in order; any failure raises and exits nonzero (nothing falls back):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit, the torch and CUDA versions; the native C parse must be built.
2. build: compiles the CUDA kernels (csrc/*.cu, one nvcc per source, all at
   once) and links them, timed.
3. kernels vs plain: each grouped kernel against its plain torch version on
   the card, torch.equal, over sweeps of sizes, modes and MVs (to 300 px
   outside the picture), each sweep packed as one multi-group launch; the
   scan kernel against scan_packed_ref on random scans (every mode and
   size, every flag, unavailable references outside the plane, empty
   steps, flat and non-flat 32x32 edges; steps wider than the kernel's
   warps; one TU a step), and a split run against one.
4. small streams: the committed 96x64 LDP, RA (bi-pred) and PCM LDP
   streams (PCM CUs in the I picture and in every P picture, whose MC runs
   through K2), PipelinedTorchDecoder on cuda vs the port's GoldenDecoder,
   bit-exact.
5. frame DAG, small: s96x64_ra5 through PipelinedTorchDecoder with
   frame_dag_max 1 and 4, bit-exact, sibling B pictures batched at 4 only.
6. unfused and per-stage paths (96x64 LDP and RA): TorchDecoder on cuda
   with fused=False, filters_on_device=False, apply_filters=False and
   use_native_parse=False against golden; reconstruct_scan_frames +
   loop_filters_frames against the fused decoder's planes.
7. options: a two-GOP stream (s96x64_ldp5 twice) with a truncated slice
   under error_resilient (errors recorded, the second GOP bit-exact);
   save_state on cuda halfway, load_state into a new decoder, the tail
   bit-exact.
8. the CLI as a subprocess: decode --device cuda --pipelined --md5
   --metrics; golden's MD5 and the metrics keys.
9. s1080_ldp4 (1920x1080, IDR + 3 P, QP 32; p265_tpu_torch/data): one
   cold pass bit-exact against GoldenDecoder on every plane, with the
   kernel launch counters reset just before it (3 MC, 7 residual and 4
   scan launches a pass); then 3 warm passes.
10. streams: every stream of p265_tpu_torch/testgen/streams.py that no
   other phase decodes (STREAMS: 416x240 and 832x480 LDP, 1080p intra,
   1080p with 4x2 tiles, with tiles and WPP, 3840x2160 intra, 16 frames of
   1080p LDP), each committed under p265_tpu_torch/data; one cold and one
   warm pass each, bit-exact against golden on every plane before and
   after the filters, the launches of each pass equal to STREAMS'.  The
   golden decodes of these streams run in worker processes (spawn),
   started after phase 1, so that they overlap the card phases.
11. frame DAG at full width: RA_STREAM (1920x1080 random access, QP 32,
   bi-prediction) with frame_dag_max 1 and 4, one cold and three warm
   passes each, in turns; every pass bit-exact against golden on every
   plane before and after the filters; dag_batched, the K1/K2 launches a
   pass, the scan steps of every dispatch (one scan launch each: 8 at 1,
   5 at 4), and fps with spread for both.
12. sharded: one process a rank (NCCL with one rank a card where there are
   two cards or more, else two ranks sharing cuda:0 over gloo).  The space
   axis decodes every picture of s1080_ldp4 row-sharded over the ranks
   (SpatialDecoder), each picture's planes before and after the filters
   equal to phase 9's golden ones on every rank; the stream axis decodes
   the three small streams and s1080_ldp4, split over the ranks, through
   decode_segments_production, bit-exact.  Per rank: the wall time,
   collectives and bytes of each picture, and the kernels' launches
   (counters reset just before each axis), which must all be above 0; the
   space axis launches the scan once a wavefront step, the stream axis
   once a picture.
13. per-kernel time against the plain version and the bound, over every
   call the main path made on one pass of s1080_ldp4: the CUDA-event
   window of the calls (`ms`, host launch gaps included) and the kernel's
   own device time from torch.profiler (`device_ms`).  The scan row: every
   main-path scan equal to its plain version, the window of scan_plane in
   turns with the plain version (one run per turn), the device time, the
   bound by bytes, and the barrier floor (`floor_ms`: the same launches
   computing no TU); the TUs a step (max, median), the launch shape (one
   cluster: CTAs, warps), and per step with TUs the floor and the chain
   (device - floor).

Every path from phase 4 on is driven with the kernels' launch counts set
to 0 just before it and read just after; all must be above 0 (launches
made to compare a kernel with its plain version are outside those windows),
but for the intra streams of phase 10, which have no MC to launch.  The
total wall time is printed before the kernels' record.
Nothing of JAX and nothing of the JAX package p265_tpu may be imported.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "p265_tpu_torch", "data")
STREAM = os.path.join(DATA, "s1080_ldp4.265")
N_FRAMES = 4
RA_STREAM = "s1080_ra8.265"
SMALL = (("LDP", "s96x64_ldp5.265"), ("RA", "s96x64_ra5.265"),
         ("PCM LDP", "s96x64_pcm_ldp5.265"))
# phase 10: stream -> kernel launches a pass (itransform, mc, scan), as
# measured on an H100: K1 and the scan on every stream, K2 on the P
# streams only.  The card takes them in this order, the golden workers in
# the reverse one
STREAMS = {
    "s416_ldp4": (7, 3, 4),
    "s832_ldp4": (7, 3, 4),
    "s1080": (1, 0, 1),
    "s1080_t8": (1, 0, 1),
    "s1080_t8w": (1, 0, 1),
    "s4k": (1, 0, 1),
    "s1080_ldp16": (31, 15, 16),
}
GOLDEN_WORKERS = 3
KERNELS = {  # name -> (source, the TPU kernel it replaces, launches a pass)
    "itransform": ("p265_tpu_torch/csrc/itransform.cu",
                   "p265_tpu/kernels/pallas_itransform.py:39", 7),
    "mc": ("p265_tpu_torch/csrc/mc.cu", "p265_tpu/kernels/pallas_mc.py:44",
           3),
    "scan": ("p265_tpu_torch/csrc/scan.cu",
             "p265_tpu/pipeline/wavefront.py:455 (lax.scan, XLA; not a "
             "Pallas kernel)", 4),
}
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and int32
# multiply-adds/s on the CUDA cores (132 SMs x 64 int32 lanes x 1.98 GHz)
PEAK_BYTES = 3.35e12
PEAK_INT32 = 132 * 64 * 1.98e9


def log(*a) -> None:
    print(*a, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    require(os.path.isdir(os.path.join(ROOT, "p265_tpu_torch")),
            f"p265_tpu_torch is not beside {__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    log(smi.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s)")
    from p265_tpu_torch.native.parse import native_parse_available
    require(native_parse_available(), "native C parse is not available")
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from p265_tpu_torch.kernels import _build
    _build.library()
    info = _build.build_info
    log(f"build: {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.split("ptxas info    :")[-1].strip())


def _k1_inputs(rng, log2: int, n: int = 150, scale: bool = False,
               dtype=np.int32) -> dict:
    s = 1 << log2
    lv = ((rng.random((n, s, s)) < 0.2)
          * rng.integers(-200, 200, (n, s, s))).astype(dtype)
    lv[:5] = rng.integers(-32768, 32768, (5, s, s))
    dst = (rng.random(n) < 0.4) if log2 == 2 else np.zeros(n, bool)
    tsk = ((rng.random(n) < 0.3) & ~dst) if log2 == 2 else np.zeros(n, bool)
    f = dict(coeffs=lv, qp=np.arange(n, dtype=np.int32) % 52, is_dst=dst,
             tskip=tsk, bypass=rng.random(n) < 0.15)
    if scale:
        f["scale_m"] = rng.integers(1, 256, (n, s, s)).astype(np.int32)
        f["scale_m"][:8] = 255
    return f


def _mc_groups(rng, dev, far_px: int, n: int = 4096) -> list:
    """All six geometries, list 0 and a second list, on 1080p luma and
    chroma reference stacks: one launch of twelve groups."""
    import torch
    R = 3
    stacks = {taps: torch.from_numpy(rng.integers(0, 256, (R, H, W)).astype(
        np.uint8)).to(dev) for taps, H, W in ((8, 1080, 1920), (4, 540, 960))}
    groups = []
    for block, taps in ((16, 8), (8, 8), (4, 8), (8, 4), (4, 4), (2, 4)):
        refs = stacks[taps]
        H, W = refs.shape[1:]
        unit = 4 if taps == 8 else 8                     # MV units per pel
        for _ in range(2):
            pos = np.stack([rng.integers(0, (H - block) // block + 1, n),
                            rng.integers(0, (W - block) // block + 1, n)],
                           1) * block
            pos[:64] = [[0, 0], [H - block, W - block]] * 32  # corners
            mv = rng.integers(-far_px * unit, far_px * unit, (n, 2))
            args = [torch.from_numpy(a.astype(np.int32)).to(dev)
                    for a in (pos, rng.integers(0, R, n), mv)]
            groups.append((refs, *args, block, taps))
    return groups


def _max_err(got, want, name: str) -> int:
    """Max abs difference of two kernel results (a list of MC blocks or a
    dict of residuals); raises unless they are torch.equal."""
    if isinstance(got, dict):
        require(list(got) == list(want), f"{name}: sizes differ")
        got, want = list(got.values()), list(want.values())
    require(len(got) == len(want), f"{name}: group counts differ")
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{name}: shape or dtype differs")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    require(err == 0, f"{name} differs from its plain version: max abs "
            f"error {err}")
    return err


def phase_compare(errs: dict) -> None:
    import torch
    from p265_tpu_torch.kernels import itransform, mc
    from p265_tpu_torch.pipeline import wavefront as wf
    from p265_tpu_torch.testgen.scan_cases import (random_scan, wide_scan,
                                                   work_items)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    for scale in (False, True):
        for dtype in (np.int32, np.int16):
            groups = {log2: {k: torch.from_numpy(v).to(dev)
                             for k, v in _k1_inputs(rng, log2, scale=scale,
                                                    dtype=dtype).items()}
                      for log2 in (2, 3, 4, 5)}
            got = itransform.batch_residual_grouped(groups)
            want = itransform.batch_residual_grouped_ref(groups)
            torch.cuda.synchronize()
            errs["itransform"] = max(errs["itransform"], _max_err(
                got, want, f"itransform scale_m={scale} {dtype.__name__}"))
    log("itransform == plain: log2 2..5 in one launch, with/without "
        "scale_m, int32 and int16 levels, DST/tskip/bypass, qp 0..51, "
        "levels to +-2^15, n=150 each")
    for far in (8, 300):
        groups = _mc_groups(rng, dev, far)
        got = mc.mc_blocks_grouped(groups)
        want = mc.mc_blocks_grouped_ref(groups)
        torch.cuda.synchronize()
        errs["mc"] = max(errs["mc"], _max_err(got, want, f"mc far={far}"))
    log("mc == plain: 6 geometries x 2 lists in one launch, n=4096 each, "
        "MVs up to 8 px and up to 300 px beyond the picture")
    ctas, warps = wf.SCAN_SHAPE
    cases = [{}, {}, {}, dict(n_steps=4, per_size=560),
             dict(n_steps=64, one_a_step=True), dict(wide=True)]
    for case, kw in enumerate(cases):
        if kw.get("wide"):
            stacked, starts, n, plane = wide_scan(rng, dev)
            items = work_items(starts, n)
            require(plane.shape[1] == 3840 and int(items.min())
                    > ctas * warps, f"scan sweep {case}: {items} work "
                    f"items a step, not all wider than {ctas * warps} warps")
        else:
            stacked, starts, n, plane = random_scan(rng, dev, **kw)
        packed = wf.pack_scan(stacked, starts, n, dev)
        widths = packed.step_tus[packed.step_tus > 0]
        if kw.get("per_size", 0) > 140:
            require(int(widths.min()) > ctas * warps,
                    f"scan sweep {case}: a step of {int(widths.min())} TUs "
                    f"is not wider than {ctas * warps} warps")
        if kw.get("one_a_step"):
            require(set(widths.tolist()) == {1} and len(widths) == n,
                    f"scan sweep {case}: not one TU a step")
        want = wf.scan_packed_ref(packed, plane.clone(), 0, n)
        got = wf.scan_packed(packed, plane.clone(), 0, n)
        k = int(rng.integers(1, n))
        split = wf.scan_packed(packed, wf.scan_packed(
            packed, plane.clone(), 0, k), k, n)
        torch.cuda.synchronize()
        require(not torch.equal(want, plane), "scan sweep wrote nothing")
        errs["scan"] = max(errs["scan"], _max_err(
            [got], [want], f"scan sweep {case}"))
        require(torch.equal(split, got),
                f"scan sweep {case}: [0, {k}) + [{k}, {n}) differs from "
                f"[0, {n})")
    log("scan == plain: 3 random scans of 48 steps (a fifth empty), 140 "
        "TUs a size 4..32, every mode, random smoothing / strong / edge "
        "flags and ref_ok patterns (unavailable references outside the "
        "plane too), flat and non-flat 32x32 edges; one of 4 steps of ~560 "
        f"TUs (wider than the kernel's {ctas} x {warps} warps); one of 64 "
        "steps of one TU each; one at 4K plane width of 4 steps of 430 work "
        "items (40 32x32 TUs of 8 items each), each step reading what "
        "earlier steps wrote; a split run [0, k) + [k, n) equal to one run "
        "in each")


def _stream_bytes(fn: str) -> bytes:
    """A committed stream, checked against data/SHA256SUMS."""
    from p265_tpu_torch.testgen.streams import committed
    data = committed(fn.removesuffix(".265"))
    require(data is not None, f"{fn} is not committed")
    return data


def _bit_exact(frames, gold, what: str) -> None:
    """Every plane of every frame, pre- and post-filter, equal to golden's
    (np.array_equal); raises otherwise."""
    from p265_tpu_torch.run_config import gate
    gate(frames, gold, what)


def _stats(dec) -> str:
    st = dec.stats
    return (f"parse {st['parse_s']:.3f} s, recon dispatch "
            f"{st['recon_s']:.3f} s, fetch {st['fetch_s']:.3f} s")


def phase_small_streams() -> None:
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    for structure, fn in SMALL:
        data = _stream_bytes(fn)
        gold = GoldenDecoder().decode_stream(data)
        _build.reset_launch_counts()
        frames = PipelinedTorchDecoder("cuda").decode_stream(data)
        launches = dict(_build.LAUNCHES)
        _bit_exact(frames, gold, f"96x64 {structure}")
        require(all(launches[k] > 0 for k in KERNELS),
                f"96x64 {structure}: a kernel never launched: {launches}")
        if structure == "RA":
            require(any(p.motion.uses(0) and p.motion.uses(1)
                        for g in gold for p in g.plan.pus),
                    "RA stream has no bi-predicted PU")
        if structure == "PCM LDP":
            require(all(g.plan.pus and any(t.pcm for t in g.plan.tus)
                        for g in gold if g.poc),
                    "a P picture of the PCM stream lacks PUs or PCM CUs")
            require(launches["mc"] == len(gold) - 1,
                    f"PCM P pictures: {launches['mc']} K2 launches, "
                    f"expected {len(gold) - 1}")
        log(f"96x64 {structure}: {len(frames)} frames bit-exact vs golden, "
            f"launches {launches}")


def _counted(what: str, fn):
    """Run fn() with the kernels' launch counts set to 0 just before and
    read just after; every kernel must have launched.  -> (result,
    launches)."""
    from p265_tpu_torch.kernels import _build
    _build.reset_launch_counts()
    out = fn()
    launches = dict(_build.LAUNCHES)
    require(all(launches[k] > 0 for k in KERNELS),
            f"{what}: a kernel never launched: {launches}")
    return out, launches


def _dag_pass(data: bytes, dag: int) -> dict:
    """One pass of PipelinedTorchDecoder("cuda", frame_dag_max=dag): wall
    seconds to every plane on the host, the frames, dag_batched, the
    kernels' launches, and (pocs, scan steps) of every dispatch."""
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    from p265_tpu_torch.run_config import Dispatches
    with Dispatches() as dispatches:
        dec = PipelinedTorchDecoder("cuda", frame_dag_max=dag)

        def run():
            t0 = time.perf_counter()
            frames = dec.decode_stream(data)
            return frames, time.perf_counter() - t0
        (frames, seconds), launches = _counted(f"frame_dag_max={dag}", run)
    return dict(frames=frames, seconds=seconds, launches=launches,
                batched=dec.stats.get("dag_batched"), dispatches=dispatches,
                stats=_stats(dec))


def _check_dag_pass(p: dict, dag: int, gold, what: str) -> None:
    _bit_exact(p["frames"], gold, f"{what} frame_dag_max={dag}")
    if dag == 1:
        require(p["batched"] is None, f"{what}: dag_batched at 1")
        require(all(len(pocs) == 1 for pocs, _ in p["dispatches"]),
                f"{what}: a group at frame_dag_max=1")
    else:
        require((p["batched"] or 0) >= 2,
                f"{what}: dag_batched {p['batched']} at frame_dag_max={dag}")
        require(p["batched"] == sum(len(pocs) for pocs, _ in p["dispatches"]
                                    if len(pocs) > 1),
                f"{what}: dag_batched does not count the grouped pictures")


def phase_frame_dag(fn: str, warm: int) -> dict:
    """A random-access stream at frame_dag_max 1 and 4, in turns: one cold
    pass each, then `warm` warm passes each; every pass bit-exact."""
    import torch
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    data = _stream_bytes(fn)
    t0 = time.perf_counter()
    gold = GoldenDecoder().decode_stream(data)
    h, w = gold[0].planes[0].shape
    what = f"{fn} ({w}x{h}, {len(gold)} frames)"
    log(f"{what}: golden NumPy decode {time.perf_counter() - t0:.2f} s")
    require(any(p.motion.uses(0) and p.motion.uses(1)
                for g in gold for p in g.plan.pus),
            f"{what}: no bi-predicted PU")
    n_inter = sum(1 for g in gold if g.plan.pus)
    out = {}
    turns = [1, 4] + ([1, 4, 4, 1] * warm)[:2 * warm]
    times = {1: [], 4: []}
    for i, dag in enumerate(turns):
        torch.cuda.synchronize()
        p = _dag_pass(data, dag)
        _check_dag_pass(p, dag, gold, what)
        require(p["launches"]["mc"] == n_inter,
                f"{what}: {p['launches']['mc']} K2 launches for {n_inter} "
                "inter pictures")
        scans = sum(1 for _, steps in p["dispatches"] if steps > 0)
        require(p["launches"]["scan"] == scans,
                f"{what}: {p['launches']['scan']} scan launches for {scans} "
                "dispatches with scan steps")
        cold = i < 2
        log(f"frame_dag_max={dag} {'cold' if cold else 'warm'} pass: "
            f"{p['seconds']:.3f} s ({p['stats']}), launches "
            f"{p['launches']}, dag_batched {p['batched']}")
        if cold:
            log(f"  dispatches (pocs: scan steps): " + ", ".join(
                f"{pocs}: {steps}" for pocs, steps in p["dispatches"]))
            out[dag] = dict(launches=p["launches"], batched=p["batched"],
                            dispatches=p["dispatches"], cold_s=p["seconds"])
        else:
            times[dag].append(p["seconds"])
        del p
    require(out[4]["launches"]["itransform"]
            < out[1]["launches"]["itransform"],
            f"{what}: grouping did not save K1 launches")
    steps = {dag: sum(s for _, s in out[dag]["dispatches"]) for dag in out}
    log(f"{what}: scan steps a pass {steps[1]} ungrouped, {steps[4]} "
        f"grouped; K1 launches {out[1]['launches']['itransform']} / "
        f"{out[4]['launches']['itransform']}, K2 {n_inter} / {n_inter}, "
        f"scan {out[1]['launches']['scan']} / {out[4]['launches']['scan']}")
    for dag, ts in times.items():
        if ts:
            best = min(ts)
            out[dag].update(warm_s=ts, fps=len(gold) / best,
                            spread=(max(ts) - best) / best)
            log(f"frame_dag_max={dag}: warm passes "
                f"{[round(t, 4) for t in ts]} s; {len(gold) / best:.4f} "
                f"fps (best), spread {(max(ts) - best) / best * 100:.1f}%, "
                f"median {statistics.median(ts):.4f} s")
    if warm:
        # the passes are in turns 1, 4, 4, 1, ...: the k-th of each pair up
        wins = sum(b < a for a, b in zip(times[1], times[4]))
        log(f"{what}: frame_dag_max=4 faster than 1 in {wins} of {warm} "
            "pairs of warm passes")
    return out


def phase_unfused() -> None:
    """The unfused decoder and the per-stage entry points on the card."""
    import torch
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.kernels.loopfilter import loop_filters_frames
    from p265_tpu_torch.pipeline.decoder import TorchDecoder
    from p265_tpu_torch.pipeline.wavefront import reconstruct_scan_frames
    from p265_tpu_torch.plan.frame_plan import attach_pred_planes
    options = (dict(fused=False), dict(filters_on_device=False),
               dict(apply_filters=False), dict(use_native_parse=False))
    for structure, fn in SMALL[:2]:
        data = _stream_bytes(fn)
        gold = GoldenDecoder().decode_stream(data)
        unfiltered = GoldenDecoder(apply_filters=False).decode_stream(data)
        for kw in options:
            dec = TorchDecoder("cuda", **kw)
            require(dec.fused == (kw == dict(use_native_parse=False)),
                    f"{kw}: fused is {dec.fused}")
            frames, launches = _counted(
                f"96x64 {structure} {kw}", lambda: dec.decode_stream(data))
            _bit_exact(frames,
                       gold if kw.get("apply_filters", True) else unfiltered,
                       f"96x64 {structure} TorchDecoder {kw}")
            log(f"96x64 {structure} TorchDecoder(cuda, {kw}): bit-exact vs "
                f"golden, launches {launches}")

        # per-stage entry points against the fused decoder's planes
        dec = TorchDecoder("cuda")
        fused = dec.decode_stream(data)
        _bit_exact(fused, gold, f"96x64 {structure} fused")

        def stages():
            tplans = []
            for f in fused:
                tp = dec._build_tplan(f.plan)
                attach_pred_planes(tp, {o.poc: o.planes for o in fused
                                        if o.poc != f.poc}, "cuda")
                tplans.append(tp)
            pre = reconstruct_scan_frames(tplans, "cuda")
            return pre, loop_filters_frames([f.plan for f in fused], pre,
                                            "cuda")
        (pre, filt), launches = _counted(f"96x64 {structure} stages", stages)
        for f, p, q in zip(fused, pre, filt):
            for c in range(3):
                require(p[c].is_cuda and q[c].is_cuda, "a plane left cuda")
                require(torch.equal(p[c], f.prefilter[c].to(torch.int32)),
                        f"reconstruct_scan_frames poc {f.poc} plane {c}")
                require(np.array_equal(q[c].cpu().numpy(), f.planes[c]),
                        f"loop_filters_frames poc {f.poc} plane {c}")
        log(f"96x64 {structure}: reconstruct_scan_frames + "
            f"loop_filters_frames == fused decoder, launches {launches}")


def _two_gops() -> tuple:
    """s96x64_ldp5 followed by its own slices: IDR P P P P | IDR P P P P,
    one set of parameter sets.  -> (stream, units)."""
    from p265_tpu_torch.hls import nal
    data = _stream_bytes(SMALL[0][1])
    units = nal.split_nal_units(data)
    stream = data + b"".join(nal.make_nal(u.nal_type, u.rbsp) for u in units
                             if nal.is_slice_nal(u.nal_type))
    return stream, nal.split_nal_units(stream)


def phase_options() -> None:
    """Error resilience and checkpoint/resume on the card."""
    import torch
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.hls import nal
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    stream, units = _two_gops()
    full = GoldenDecoder().decode_stream(stream)
    require(len(full) == 10, f"two GOPs gave {len(full)} frames")

    # a truncated slice in the first GOP: resync at the second IDR
    slices = [i for i, u in enumerate(units) if nal.is_slice_nal(u.nal_type)]
    bad = b"".join(
        nal.make_nal(u.nal_type, u.rbsp[:max(8, len(u.rbsp) // 3)]
                     if i == slices[1] else u.rbsp)
        for i, u in enumerate(units))
    gdec = GoldenDecoder(error_resilient=True)
    want = gdec.decode_stream(bad)
    dec = PipelinedTorchDecoder("cuda", error_resilient=True)
    frames, launches = _counted("resilient",
                                lambda: dec.decode_stream(bad))
    require(dec.errors and len(dec.errors) == len(gdec.errors),
            f"errors {dec.errors}, golden's {gdec.errors}")
    _bit_exact(frames, want, "resilient decode")
    _bit_exact(frames[-5:], full[-5:], "second GOP after the resync")
    log(f"error_resilient on cuda: {len(dec.errors)} error(s) recorded, "
        f"{len(frames)} frames as golden, the second GOP bit-exact, "
        f"launches {launches}")

    # checkpoint halfway, resume in a new decoder
    half = len(units) // 2
    d1 = PipelinedTorchDecoder("cuda", frame_dag_max=4)
    for u in units[:half]:
        d1.decode_nal(u)
    state = d1.save_state()
    pics = state["dpb"].pics
    require(pics and all(p.planes is not None and p.user.planes is not None
                         and all(t.is_cuda for t in p.planes) for p in pics),
            "save_state: a picture of the DPB is unfinished or off the card")
    d2 = PipelinedTorchDecoder("cuda", frame_dag_max=4)
    d2.load_state(state)

    def resume():
        for u in units[half:]:
            d2.decode_nal(u)
        return d2.flush()
    resumed, launches = _counted("resume", resume)
    require(len(resumed) >= 5, f"resumed {len(resumed)} frames")
    _bit_exact(resumed, full[len(full) - len(resumed):], "resumed tail")
    for u in units[half:]:
        d1.decode_nal(u)
    _bit_exact(d1.flush(), full, "the decoder the state was taken from")
    torch.cuda.synchronize()
    log(f"save_state on cuda after {half} of {len(units)} NAL units, "
        f"load_state: {len(resumed)} resumed frames bit-exact, launches "
        f"{launches}")


def phase_cli() -> None:
    """python -m p265_tpu_torch.cli decode on the card, as a subprocess."""
    from p265_tpu_torch import yuv
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    src = os.path.join(DATA, SMALL[0][1])
    gold = GoldenDecoder().decode_stream(_stream_bytes(SMALL[0][1]))
    want = yuv.sequence_md5([[np.clip(p, 0, 255) for p in g.cropped_planes()]
                             for g in gold])
    with tempfile.TemporaryDirectory() as d:
        met = os.path.join(d, "metrics.jsonl")
        r = subprocess.run(
            [sys.executable, "-m", "p265_tpu_torch.cli", "decode", "-i", src,
             "--device", "cuda", "--pipelined", "--md5", "--metrics", met],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        require(r.returncode == 0, f"cli decode failed:\n{r.stderr}")
        with open(met) as f:
            rec = json.loads(f.read().strip())
    require(f"MD5: {want}" in r.stdout.splitlines(),
            f"cli MD5 differs from golden's {want}:\n{r.stdout}")
    keys = ("frames", "parse_s", "pack_s", "upload_s", "dispatch_s")
    require(all(k in rec for k in keys) and rec["frames"] == len(gold),
            f"cli metrics record {rec}")
    log("cli decode --device cuda --pipelined: MD5 as golden; metrics "
        + json.dumps({k: rec[k] for k in keys}))


def phase_1080() -> tuple:
    import torch
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    from p265_tpu_torch.run_config import Dispatches
    data = _stream_bytes(os.path.basename(STREAM))
    t0 = time.perf_counter()
    gold = GoldenDecoder().decode_stream(data)
    log(f"golden NumPy decode: {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with Dispatches() as dispatches:
        dec = PipelinedTorchDecoder("cuda")
        t0 = time.perf_counter()
        frames = dec.decode_stream(data)
        cold = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"cold pass: {cold:.3f} s ({_stats(dec)})")
    log(f"launches in the cold pass: {launches}; scan steps a picture "
        f"{ {pocs[0]: steps for pocs, steps in dispatches} }")
    require(all(launches[k] > 0 for k in KERNELS),
            f"a kernel of the main path never launched: {launches}")
    require(all(launches[k] == KERNELS[k][2] for k in KERNELS),
            f"launches per pass {launches}, expected "
            f"{ {k: v[2] for k, v in KERNELS.items()} }")
    require(all(f.planes[0].shape == (1080, 1920) for f in frames),
            "s1080_ldp4 frames are not 1920x1080")
    _bit_exact(frames, gold, "s1080_ldp4")
    log(f"s1080_ldp4: {len(frames)} frames 1920x1080 bit-exact vs golden "
        "(every plane, pre- and post-filter)")
    require(len(frames) == N_FRAMES, f"expected {N_FRAMES} frames")
    from p265_tpu_torch.profile_shard import planes_of
    gold_planes = planes_of(gold)
    steps = [st for _, st in dispatches]
    del frames, gold, dec

    times = []
    for _ in range(3):
        dec = PipelinedTorchDecoder("cuda")
        t0 = time.perf_counter()
        out = dec.decode_stream(data)
        times.append(time.perf_counter() - t0)
        require(len(out) == N_FRAMES and all(
            f.planes[c] is not None for f in out for c in range(3)),
            "warm pass lost frames")
        log(f"warm pass: {times[-1]:.3f} s ({_stats(dec)})")
    best = min(times)
    log(f"warm passes {[round(t, 4) for t in times]} s; "
        f"{N_FRAMES / best:.4f} fps (best), spread "
        f"{(max(times) - best) / best * 100:.1f}%; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, gold_planes, steps


def start_goldens(tmp: str) -> tuple:
    """The port's GoldenDecoder on every STREAMS stream, in GOLDEN_WORKERS
    spawned processes, the longest first; -> (pool, {name: AsyncResult of
    run_config.save_golden})."""
    import multiprocessing as mp
    from p265_tpu_torch.run_config import save_golden
    pool = mp.get_context("spawn").Pool(GOLDEN_WORKERS)
    jobs = {name: pool.apply_async(save_golden, (
        name, os.path.join(tmp, name + ".npz"))) for name in reversed(STREAMS)}
    return pool, jobs


def phase_streams(jobs: dict) -> None:
    """Each STREAMS stream on the card: one cold and one warm pass, both
    bit-exact against golden, launches counted in each."""
    from p265_tpu_torch.run_config import decode_pass, load_golden, mib, split
    from p265_tpu_torch.testgen.streams import get_stream, stream_info
    names = ("itransform", "mc", "scan")
    for name, want in STREAMS.items():
        t0 = time.perf_counter()
        path, golden_s = jobs[name].get(timeout=900)
        waited = time.perf_counter() - t0
        gold = load_golden(path)
        data = get_stream(name)
        info = stream_info(data)
        what = f"{name} ({info['width']}x{info['height']}, {len(gold)} frames)"
        passes = []
        for i in range(2):
            p = decode_pass(data, "cuda")
            _bit_exact(p["frames"], gold, f"{what} pass {i}")
            launches = p["launches"]
            require(tuple(launches[k] for k in names) == want,
                    f"{what}: launches {launches}, expected "
                    f"{dict(zip(names, want))}")
            scans = sum(1 for _, st in p["dispatches"] if st > 0)
            require(launches["scan"] == scans, f"{what}: {launches['scan']}"
                    f" scan launches for {scans} dispatches with scan steps")
            passes.append(dict(seconds=p["seconds"], peak=p["peak"],
                               launches=launches, stats=p["stats"],
                               steps=[st for _, st in p["dispatches"]]))
            del p
        cold, warm = passes
        log(f"stream {what}: bit-exact vs golden in both passes (every "
            f"plane, pre- and post-filter); cold {cold['seconds']:.4f} s, "
            f"warm {warm['seconds']:.4f} s = "
            f"{len(gold) / warm['seconds']:.4f} fps; peak "
            f"{mib(max(q['peak'] for q in passes))}; launches "
            f"{cold['launches']}; scan steps of the widest dispatch "
            f"{max(cold['steps'])} (a dispatch: {cold['steps']}); golden "
            f"{golden_s:.2f} s in a worker, waited {waited:.2f} s; warm "
            f"stats {split(warm['stats'])}")


def phase_sharded(gold_planes: dict, steps: list) -> dict:
    """The space and stream axes over the ranks; returns per axis and rank
    the kernel launches.  steps: the scan steps of each s1080_ldp4
    picture, which the space axis runs one scan launch each (the halo
    exchange follows every step)."""
    import torch
    from p265_tpu_torch.profile_shard import (run_ranks, space_axis,
                                              stream_axis, transport)
    ranks = max(2, torch.cuda.device_count())
    backend, cards = transport(ranks)
    log(f"sharded: {ranks} ranks over {backend} on cards {cards}")
    data = _stream_bytes(os.path.basename(STREAM))
    small = [_stream_bytes(fn) for _, fn in SMALL]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ref = os.path.join(d, "s1080_golden.npz")
        np.savez(ref, **gold_planes)
        _, res = run_ranks([(space_axis, (data, ref, 1)),
                            (stream_axis, (small + [data],
                                           [None] * len(small) + [ref]))],
                           ranks)
    out = {"space": [], "stream": []}
    for rank, (space, stream) in enumerate(res):
        sp = space[0]
        log(f"rank {rank} space axis, s1080_ldp4 bit-exact vs golden; "
            "per picture (wall s, collectives, bytes): " + ", ".join(
                f"poc {p['poc']} {p['seconds']:.4f} {p['collectives']} "
                f"{p['bytes']}" for p in sp["pictures"])
            + f"; launches {sp['launches']}")
        log(f"rank {rank} stream axis: segments (stream, segment, frames) "
            f"{stream['segments']} bit-exact in {stream['seconds']:.4f} s; "
            f"launches {stream['launches']}")
        for axis, launches in (("space", sp["launches"]),
                               ("stream", stream["launches"])):
            require(all(launches[k] > 0 for k in KERNELS),
                    f"rank {rank} {axis} axis: a kernel never launched: "
                    f"{launches}")
            out[axis].append(launches)
        require(sp["launches"]["scan"] == sum(steps),
                f"rank {rank} space axis: {sp['launches']['scan']} scan "
                f"launches for {sum(steps)} scan steps")
        pics = sum(f for _, _, f in stream["segments"])
        require(stream["launches"]["scan"] == pics,
                f"rank {rank} stream axis: {stream['launches']['scan']} scan "
                f"launches for {pics} pictures")
    log(f"sharded phase: {time.perf_counter() - t0:.2f} s")
    return out


def _capture_main_path(data: bytes) -> dict:
    """Record the arguments of every grouped kernel call and every scan of
    one pass; a scan's plane is recorded as it stood before the scan."""
    from p265_tpu_torch.kernels import itransform, mc
    from p265_tpu_torch.pipeline import wavefront as wf
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    calls = {"itransform": [], "mc": [], "scan": []}
    orig = {"itransform": itransform.batch_residual_grouped,
            "mc": mc.mc_blocks_grouped, "scan": wf.scan_plane}

    def spy(name):
        def f(*a, **k):
            calls[name].append(
                (a if name != "scan" else (*a[:3], a[3].clone()), k))
            return orig[name](*a, **k)
        return f

    itransform.batch_residual_grouped = spy("itransform")
    mc.mc_blocks_grouped = spy("mc")
    wf.scan_plane = spy("scan")
    try:
        PipelinedTorchDecoder("cuda").decode_stream(data)
    finally:
        itransform.batch_residual_grouped = orig["itransform"]
        mc.mc_blocks_grouped = orig["mc"]
        wf.scan_plane = orig["scan"]
    return calls


def _time_calls(fn, calls, reps: int = 10, warm: int = 2) -> float:
    """Median ms of running every call once, by CUDA events."""
    import torch
    for _ in range(warm):
        for a, k in calls:
            fn(*a, **k)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        for a, k in calls:
            fn(*a, **k)
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def _device_ms(fn, calls, symbol: str, reps: int = 10):
    """Device time (ms) of the kernel `symbol` over one run of every call,
    from torch.profiler, averaged over reps runs; None if the profiler saw
    no device time for it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for a, k in calls:
                fn(*a, **k)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and symbol in e.key)
    return us / 1e3 / reps if us else None


def _work_mc(groups) -> tuple:
    """(bytes, int32 multiply-adds) of one grouped MC call: each reference
    stack read once, the block records read, the output written."""
    stacks = {g[0].data_ptr(): g[0].numel() for g in groups}
    nbytes, ops = sum(stacks.values()), 0
    for refs, pos, ridx, mv, block, taps in groups:
        n = pos.shape[0]
        nbytes += n * (8 + 4 + 8) + 4 * n * block * block
        ops += n * ((block + taps - 1) * block + block * block) * taps
    return nbytes, ops


def _work_itransform(groups) -> tuple:
    """(bytes, int32 multiply-adds) of one grouped residual call: every
    field the kernel reads, read once, and the output written; s^3
    multiply-adds a TU in the even/odd form, 2 s^3 for a 4x4 DST TU."""
    nbytes, ops = 0, 0
    for log2, f in groups.items():
        n, s = f["coeffs"].shape[0], 1 << log2
        for k in ("coeffs", "qp", "tskip", "is_dst", "bypass", "scale_m"):
            if f.get(k) is not None:
                nbytes += f[k].numel() * f[k].element_size()
        nbytes += 4 * n * s * s
        n_dst = int(f["is_dst"].sum()) if (log2 == 2 and f.get("is_dst")
                                           is not None) else 0
        ops += (n + n_dst) * s ** 3
    return nbytes, ops


def _work_scan(stacked: dict, starts: dict, n_steps: int) -> tuple:
    """(bytes, int32 multiply-adds) of one scan: per TU its reference
    indices (int64) and ref_ok read once, the available reference samples
    (int32) gathered once, its mode, flags and position, its residual read
    and its s x s output written, plus the step starts; planar costs 4
    multiply-adds a sample, angular 2, and a smoothed reference 2."""
    nbytes, ops = 4 * len(starts) * (n_steps + 1), 0
    for log2, d in stacked.items():
        s = 1 << log2
        n = int(starts[log2][n_steps])
        if not n:
            continue
        ok = d["ref_ok"][:n]
        mode = d["mode"][:n]
        nbytes += (ok.numel() * 9 + int(ok.sum()) * 4
                   + n * (4 + 3 + 16 + 8 * s * s))
        ops += (s * s * (4 * int((mode == 0).sum())
                         + 2 * int((mode >= 2).sum()))
                + 2 * (4 * s + 2) * int(d["filter_flag"][:n].sum()))
    return nbytes, ops


def _scan_row(calls: list, launches: dict, sharded: dict, dag: dict,
              errs: dict) -> dict:
    """The scan kernel over every scan of one s1080_ldp4 pass: each equal
    to its plain version; the window of scan_plane (packing included) in
    turns with the plain version (one run per turn: the plain I picture
    takes seconds); the kernel's device time; its bound; and the barrier
    floor, the device time of the same launches computing no TU."""
    import torch
    from p265_tpu_torch.pipeline import wavefront as wf
    cl = [(a, k) for a, k in calls if a[2] > 0]
    require(len(cl) == KERNELS["scan"][2], f"{len(cl)} scans in one pass, "
            f"expected {KERNELS['scan'][2]}")
    for (stacked, starts, n, plane0), _ in cl:
        packed = wf.pack_scan(stacked, starts, n, plane0.device)
        got = wf.scan_packed(packed, plane0.clone(), 0, n)
        want = wf.scan_packed_ref(packed, plane0.clone(), 0, n)
        torch.cuda.synchronize()
        errs["scan"] = max(errs["scan"], _max_err(
            [got], [want], "scan main-path call"))
    # in place on scratch planes: a scan run again over its own output
    # reads the same samples (every reference it reads was written by an
    # earlier step, or by no TU) and does the same work
    work = [((st, sd, n, p0.clone()), {}) for (st, sd, n, p0), _ in cl]
    packs = [((wf.pack_scan(st, sd, n, pl.device), pl, 0, n), {})
             for (st, sd, n, pl), _ in work]

    def plain(st, sd, n, pl):
        wf.scan_packed_ref(wf.pack_scan(st, sd, n, pl.device), pl, 0, n)

    p1 = _time_calls(plain, work, reps=1, warm=0)
    k1 = _time_calls(wf.scan_plane, work)
    k2 = _time_calls(wf.scan_plane, work)
    p2 = _time_calls(plain, work, reps=1, warm=0)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    dev_ms = _device_ms(wf.scan_packed, packs, "scan_kernel")
    floor_ms = _device_ms(lambda *a: wf.scan_packed(*a, barrier_only=True),
                          packs, "scan_kernel")
    nbytes = ops = 0
    for (st, sd, n, _), _ in cl:
        b, o = _work_scan(st, sd, n)
        nbytes, ops = nbytes + b, ops + o
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    steps = [n for (_, _, n, _), _ in cl]
    live = [int(pk.step_tus.astype(bool).sum()) for (pk, *_), _ in packs]
    tus = np.concatenate([pk.step_tus for (pk, *_), _ in packs])
    tus_max, tus_med = int(tus.max()), float(np.median(tus[tus > 0]))
    ctas, warps = wf.SCAN_SHAPE
    floor_us = (floor_ms or 0) / sum(live) * 1e3
    chain_us = ((dev_ms or 0) - (floor_ms or 0)) / sum(live) * 1e3
    log(f"scan: {len(cl)} scans per s1080_ldp4 pass, steps {steps} (with "
        f"TUs {live}), TUs a step max {tus_max}, median {tus_med}; launch "
        f"one cluster of {ctas} CTAs x {warps} warps; kernel "
        f"{k1:.4f}/{k2:.4f} ms (device time {dev_ms} ms, barrier floor "
        f"{floor_ms} ms), plain {p1:.4f}/{p2:.4f} ms; "
        f"{nbytes} bytes ({t_bytes:.4f} ms), {ops} int32 multiply-adds "
        f"({t_ops:.4f} ms); bound {bound_ms:.4f} ms by {bound_by}, kernel "
        f"at {ms / bound_ms:.1f}x its bound; a step with TUs: device "
        f"{(dev_ms or 0) / sum(live) * 1e3:.3f} us, floor {floor_us:.3f} "
        f"us, chain (device - floor) {chain_us:.3f} us")
    src, rep, _ = KERNELS["scan"]
    return dict(name="scan", route="cuda", source=src, replaces=rep,
                launches=launches["scan"], launches_per_pass=len(cl),
                sharded_launches={ax: [r["scan"] for r in rs]
                                  for ax, rs in sharded.items()},
                frame_dag_launches={str(k): v["launches"]["scan"]
                                    for k, v in dag.items()},
                max_abs_err=errs["scan"], ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_us=bound_ms * 1e3,
                bound_by=bound_by, floor_ms=floor_ms, steps=steps,
                floor_us_a_step=floor_us, chain_us_a_step=chain_us,
                library_ms=None)


def phase_timing(launches: dict, sharded: dict, dag: dict,
                 errs: dict) -> list:
    import torch
    from p265_tpu_torch.kernels import itransform, mc
    with open(STREAM, "rb") as f:
        calls = _capture_main_path(f.read())
    pairs = {"itransform": (itransform.batch_residual_grouped,
                            itransform.batch_residual_grouped_ref,
                            _work_itransform, "itransform_grouped_kernel"),
             "mc": (mc.mc_blocks_grouped, mc.mc_blocks_grouped_ref,
                    _work_mc, "mc_grouped_kernel")}
    rows = []
    for name, (kern, plain, work, symbol) in pairs.items():
        # a call whose groups are all empty launches nothing
        cl = [(a, k) for a, k in calls[name] if work(a[0])[0]]
        require(len(cl) == KERNELS[name][2], f"{len(cl)} {name} launches "
                f"in one pass, expected {KERNELS[name][2]}")
        for a, k in cl:
            errs[name] = max(errs[name], _max_err(
                kern(*a, **k), plain(*a, **k), f"{name} main-path call"))
        # turns: plain, kernel, kernel, plain
        p1 = _time_calls(plain, cl)
        k1 = _time_calls(kern, cl)
        k2 = _time_calls(kern, cl)
        p2 = _time_calls(plain, cl)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        dev_ms = _device_ms(kern, cl, symbol)
        t_bytes = t_ops = bound_ms = 0.0
        nbytes = ops = 0
        for a, _ in cl:
            b, o = work(a[0])
            nbytes, ops = nbytes + b, ops + o
            t_bytes += b / PEAK_BYTES * 1e3
            t_ops += o / PEAK_INT32 * 1e3
            bound_ms += max(b / PEAK_BYTES, o / PEAK_INT32) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"{name}: {len(cl)} grouped calls per s1080_ldp4 pass; kernel "
            f"{k1:.4f}/{k2:.4f} ms (device time {dev_ms} ms), plain "
            f"{p1:.4f}/{p2:.4f} ms; {nbytes} "
            f"bytes ({t_bytes:.4f} ms), {ops} int32 multiply-adds "
            f"({t_ops:.4f} ms); bound {bound_ms:.4f} ms by {bound_by}, "
            f"kernel at {ms / bound_ms:.1f}x its bound")
        src, rep, _ = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name],
                         launches_per_pass=len(cl),
                         sharded_launches={ax: [r[name] for r in rs]
                                           for ax, rs in sharded.items()},
                         frame_dag_launches={
                             str(k): v["launches"][name]
                             for k, v in dag.items()},
                         max_abs_err=errs[name], ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_us=bound_ms * 1e3,
                         bound_by=bound_by, library_ms=None))
    rows.append(_scan_row(calls["scan"], launches, sharded, dag, errs))
    torch.cuda.synchronize()
    return rows


def main() -> int:
    t_start = time.perf_counter()
    import torch
    kind = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        pool, jobs = start_goldens(tmp)
        try:
            phase_build()
            errs = {k: 0 for k in KERNELS}
            phase_compare(errs)
            phase_small_streams()
            phase_frame_dag(SMALL[1][1], warm=0)
            phase_unfused()
            phase_options()
            phase_cli()
            launches, gold_planes, steps = phase_1080()
            phase_streams(jobs)
        finally:
            pool.terminate()
            pool.join()
    dag = phase_frame_dag(RA_STREAM, warm=3)
    sharded = phase_sharded(gold_planes, steps)
    rows = phase_timing(launches, sharded, dag, errs)
    log(f"chip_smoke: total wall time {time.perf_counter() - t_start:.1f} s")
    require("jax" not in sys.modules, "jax was imported")
    ref = sorted(m for m in sys.modules
                 if m == "p265_tpu" or m.startswith("p265_tpu."))
    require(not ref, f"modules of the JAX package were imported: {ref}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
