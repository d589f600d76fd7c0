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
   outside the picture), each sweep packed as one multi-group launch, at
   the wire dtypes the kernels read (K1:
   every size, DST, transform skip, bypass, uint8 scale_m and qp, int16
   and int32 levels, qp 0..51, saturating levels, TU counts that leave
   partial tiles; K1's plane epilogue, the hoisted inter TUs' add and clip
   into a prediction plane or zeros, positions uint16 past 32767 and
   int32, planes to 70000 columns; the MC kernel with both epilogues: the
   14-bit intermediates of
   mc_blocks_grouped, and the finished samples of mc_pred_planes on 1080p
   pictures, uni, bi and weighted, with pad rows, into fresh planes and
   into two frames' segments of one tall plane that holds an earlier
   prediction (testgen/kernel_cases.py)); the
   scan kernel against scan_packed_ref on random scans (every mode and
   size, every flag, unavailable references outside the plane, empty
   steps, flat and non-flat 32x32 edges; steps wider than the kernel's
   warps; one TU a step; uint16 and int32 coordinates), and a split run
   against one; the whole scan path (K1's epilogue, K1, the scan) of
   planes 40000 and 70000 columns wide (testgen/scan_cases.py
   coord_plane) against its CPU run; the deblocking
   kernel (both directions of a batch's luma and chroma in one launch,
   deblock_planes, at 1080p and 4K; and one direction, luma and chroma,
   as the row-sharded deblocking calls it) and the SAO kernel against
   their plain versions on random filter cases (testgen/filter_cases.py)
   at 1080p widths, on contiguous planes, transposed views and row views
   of a taller plane (the parameters int16 and int8), SAO's uint8 store
   with and without bypass masks, and the row-sharded SAO's halo blocks.
4. small streams: the committed 96x64 LDP, RA (bi-pred) and PCM LDP
   streams (PCM CUs in the I picture and in every P picture, whose MC runs
   through K2), PipelinedTorchDecoder on cuda vs the port's GoldenDecoder,
   bit-exact.
5. frame DAG, small: s96x64_ra5 through PipelinedTorchDecoder with
   frame_dag_max 1 and 4, bit-exact, sibling B pictures batched at 4 only.
6. options and per-stage paths (96x64 LDP and RA): TorchDecoder on cuda
   with apply_filters=False (against the unfiltered golden, no deblocking
   or SAO launch) and with use_native_parse=False, bit-exact;
   reconstruct_scan_frames + loop_filters_frames against the decoder's
   planes.
7. options: a two-GOP stream (s96x64_ldp5 twice) with a truncated slice
   under error_resilient (errors recorded, the second GOP bit-exact);
   save_state on cuda halfway, load_state into a new decoder, the tail
   bit-exact.
8. the CLI as a subprocess: decode --device cuda --pipelined --md5
   --metrics; golden's MD5 and the metrics keys.
9. s1080_ldp4 (1920x1080, IDR + 3 P, QP 32; p265_tpu_torch/data; golden
   decoded by one of the golden workers of phase 10): one
   cold pass bit-exact against GoldenDecoder on every plane, with the
   kernel launch counters reset just before it (3 MC, 7 residual, 4
   scan, 4 deblocking and 8 SAO launches a pass); then 3 warm passes.
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
   5 at 4), one deblocking and two SAO launches a dispatch, and fps with
   spread for both.
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
13. config 5: BASELINE configuration 5, four 4K random-access streams
   (testgen/streams.py CONFIG5: IDR, P at POC 4, B at 2, 1, 3), on the
   ranks of phase 12.  data/GOLDEN_MD5 is held against a live golden
   decode of s4k_ra5_s5 (the first job of the golden workers); that
   stream on one card, a cold and a warm pass, bit-exact against the
   live golden and the MD5s; then profile_shard.run_config5: the stream
   axis (the four streams round robin over the ranks), the global batch
   of their four IRAP pictures (decode_streams_distributed) and the space
   axis on s4k_ra5_s5 (the P and B pictures all-gather the 4K reference
   slabs), every plane of every picture against the MD5s inside the
   ranks; per rank its wall, launches and peak memory, per picture of the
   space axis its wall, collectives and bytes.  Every kernel launches on
   every rank of both axes; the space axis once a scan step.
14. per-kernel time against the plain version and the bound, over every
   call the main path made on one pass of s1080_ldp4 (that pass's staged
   trees, one a dispatch, read after the pass: every leaf on 16 bytes, a
   view of its dispatch's one device buffer, and equal in dtype, shape and
   values to the same leaf uploaded alone, kernels/staging.py per_leaf;
   each call of the
   five kernels torch.equal to its plain version, the K1 calls with the
   plane epilogue (init_plane's) each replayed into a copy of the plane as
   it stood before the call; the MC row is the main
   path's mc_pred_planes, the interpolation, combine and placement of a
   picture in one launch, each call replayed into a zeroed copy of its
   tall plane against mc_pred_planes_ref): the CUDA-event
   window of the calls (`ms`, host launch gaps included) and the kernel's
   own device time from torch.profiler (`device_ms`); beside them the plain
   version's window (`plain_ms`) and, but for the scan, its device time
   (`plain_device_ms`: every device operation it runs).  Each kernel's bound
   is the function's, from p265_tpu_torch.roofline over the census of
   s1080_ldp4 (not from the tensors the calls carry; the census's TUs of
   each size and MC blocks of each geometry must equal the calls'; the MC
   kernel's bound is the MC stage's, since it computes the whole stage), and
   `bound_share` is the bound over the device time: above 1.05, which no
   card can give, fails.  The scan row: every main-path scan equal to its
   plain version, the window of scan_plane in turns with the plain version
   (one run per turn), the device time, and the barrier floor
   (`floor_ms`: the same launches computing no TU); the TUs a step (max,
   median), the launch shape (one cluster: CTAs, warps), and per step with
   TUs the floor and the chain (device - floor).  The deblocking row
   counts its one launch a dispatch (both directions, luma and chroma),
   the SAO row luma and chroma.
15. upload: one s1080_ldp4 pass under torch.profiler
   (run_config.profile_pass): its staging copies (one a dispatch) and
   bytes, and the device ms of every host-to-device copy in the trace (at
   most the reference's per-dtype buffers, REF_BUFFERS a dispatch), the
   pass's device operations, and the calls of aten::_to_copy and
   aten::where in the window (every thread); then
   `python -m p265_tpu_torch.profile_pack s1080_ldp4` as a subprocess,
   its one JSON line printed.
16. measuring modules: bench_kernels in-process (every rate above 0,
   every share at most 1.05), graft_entry.entry() on the card
   torch.equal to its forward on CPU tensors (one K1 launch), and
   graft_entry.dryrun_multichip(2) on the card (NCCL with two cards,
   else two gloo ranks sharing cuda:0), every rank's launches of all five
   kernels above 0; its wall time.

Every path from phase 4 on is driven with the kernels' launch counts set
to 0 just before it and read just after; all must be above 0 (launches
made to compare a kernel with its plain version are outside those windows),
but for the intra streams of phase 10, which have no MC to launch, and
the filter kernels, which launch exactly where the path filters on the
card (every stream here turns both filters on; apply_filters=False
launches neither).  The
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
# phase 10: stream -> kernel launches a pass (itransform, mc, scan,
# deblock, sao), as measured on an H100: K1, the scan and the filters
# (one deblocking and two SAO launches a dispatch) on every stream, K2 on
# the P streams only.  The card takes them in this order, the golden
# workers in the reverse one
STREAMS = {
    "s416_ldp4": (7, 3, 4, 4, 8),
    "s832_ldp4": (7, 3, 4, 4, 8),
    "s1080": (1, 0, 1, 1, 2),
    "s1080_t8": (1, 0, 1, 1, 2),
    "s1080_t8w": (1, 0, 1, 1, 2),
    "s4k": (1, 0, 1, 1, 2),
    "s1080_ldp16": (31, 15, 16, 16, 32),
}
GOLDEN_WORKERS = 4
# BASELINE configuration 5 (phase 13): the stream decoded on one card, on
# the space axis and by a live golden decode (the other three CONFIG5
# streams are held against data/GOLDEN_MD5 only)
CONFIG5_STREAM = "s4k_ra5_s5"
SMI = ""   # nvidia-smi's name and power limit, set by phase_device
KERNELS = {  # name -> (source, the TPU kernel it replaces, launches a pass)
    "itransform": ("p265_tpu_torch/csrc/itransform.cu",
                   "p265_tpu/kernels/pallas_itransform.py:39", 7),
    "mc": ("p265_tpu_torch/csrc/mc.cu", "p265_tpu/kernels/pallas_mc.py:44",
           3),
    "scan": ("p265_tpu_torch/csrc/scan.cu",
             "p265_tpu/pipeline/wavefront.py:455 (lax.scan, XLA; not a "
             "Pallas kernel)", 4),
    "deblock": ("p265_tpu_torch/csrc/loopfilter.cu",
                "p265_tpu/kernels/loopfilter.py:146 and :231 (jax.jit, "
                "XLA; not Pallas kernels)", 4),
    "sao": ("p265_tpu_torch/csrc/loopfilter.cu",
            "p265_tpu/kernels/loopfilter.py:296 (jax.jit, XLA; not a "
            "Pallas kernel)", 8),
}
FILTERS = ("deblock", "sao")


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
    global SMI
    SMI = smi.strip()
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
    from p265_tpu_torch.testgen.scan_cases import (coord_plane, random_scan,
                                                   wide_scan, work_items)
    from p265_tpu_torch.kernels.staging import stage
    from p265_tpu_torch.testgen import kernel_cases as kc
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    for scale in (False, True):
        for dtype in (np.int32, np.int16):
            for n in (150, 2000, 9):
                groups = stage(kc.residual_groups(rng, n, scale, dtype), dev)
                got = itransform.batch_residual_grouped(groups)
                want = itransform.batch_residual_grouped_ref(groups)
                torch.cuda.synchronize()
                errs["itransform"] = max(errs["itransform"], _max_err(
                    got, want, f"itransform scale_m={scale} "
                    f"{dtype.__name__} n={n}"))
    log("itransform == plain: log2 2..5 in one launch, with/without "
        "scale_m, int32 and int16 levels, DST/tskip/bypass, qp 0..51 (the "
        "dequant's left shift included), levels to +-2^15, about 9, 150 "
        "and 2000 TUs a size, each a partial last tile; qp and scale_m "
        "uint8")
    for shape, n in (((1088, 1920), 400), ((128, 40000), 100),
                     ((128, 70000), 100)):
        for scale in (False, True):
            groups = stage(kc.residual_groups(rng, n, scale, plane=shape),
                           dev)
            for base in (rng.integers(0, 256, shape), np.zeros(shape)):
                plane = torch.from_numpy(base.astype(np.int32)).to(dev)
                got = itransform.batch_residual_grouped(groups,
                                                        plane=plane.clone())
                want = itransform.batch_residual_grouped_ref(
                    groups, plane=plane.clone())
                torch.cuda.synchronize()
                require(not torch.equal(want, plane), "itransform plane "
                        "epilogue sweep added nothing")
                errs["itransform"] = max(errs["itransform"], _max_err(
                    [got], [want], f"itransform plane epilogue {shape} "
                    f"scale_m={scale}"))
    log("itransform plane epilogue == plain: every size in one launch, "
        "each TU alone in a 32x32 tile, its residual added in place to a "
        "random prediction plane and to zeros and clipped: 1088x1920 "
        "(about 400 TUs a size), 128x40000 (uint16 positions past 32767) "
        "and 128x70000 (int32), with/without scale_m")
    for far in (8, 300):
        groups = _mc_groups(rng, dev, far)
        got = mc.mc_blocks_grouped(groups)
        want = mc.mc_blocks_grouped_ref(groups)
        torch.cuda.synchronize()
        errs["mc"] = max(errs["mc"], _max_err(got, want, f"mc far={far}"))
    log("mc (intermediates epilogue) == plain: 6 geometries x 2 lists in "
        "one launch, n=4096 each, MVs up to 8 px and up to 300 px beyond "
        "the picture")
    _mc_pred_sweeps(rng, dev, errs)
    ctas, warps = wf.SCAN_SHAPE
    cases = [{}, {}, {}, dict(n_steps=4, per_size=560),
             dict(n_steps=64, one_a_step=True), dict(wide=True)]
    for case, kw in enumerate(cases):
        coord = np.int32 if case % 2 else np.uint16
        if kw.get("wide"):
            stacked, starts, n, plane = wide_scan(rng, dev, coord=coord)
            items = work_items(starts, n)
            require(plane.shape[1] == 3840 and int(items.min())
                    > ctas * warps, f"scan sweep {case}: {items} work "
                    f"items a step, not all wider than {ctas * warps} warps")
        else:
            stacked, starts, n, plane = random_scan(rng, dev, coord=coord,
                                                    **kw)
        packed = wf.pack_scan(stacked, starts, n, dev)
        require(packed.coord_wide == (coord == np.int32),
                f"scan sweep {case}: coordinates not read as {coord}")
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
        "in each; coordinates uint16 in three, int32 in three")
    for cols in (40000, 70000):
        pp = coord_plane(rng, (64, cols), exclusive=True, inter_pred=True)
        got = wf.reconstruct_scan_plane(pp, dev)
        want = wf.reconstruct_scan_plane(pp, "cpu")
        torch.cuda.synchronize()
        errs["scan"] = max(errs["scan"], _max_err(
            [got.cpu()], [want], f"scan path of a {cols}-wide plane"))
    log("scan path (K1's plane epilogue, K1, the scan) of 64-row planes "
        "40000 (uint16 coordinates past 32767) and 70000 (int32) columns "
        "wide == its CPU run")
    _filter_sweeps(rng, dev, errs)


def _mc_pred_sweeps(rng, dev, errs: dict) -> None:
    """The MC kernel with its samples epilogue (mc_pred_planes) against
    mc_pred_planes_ref on 1080p pictures of every bucket with pad rows and
    MVs to 300 px past the picture (testgen/kernel_cases.py pred_case):
    uni, bi, and both with explicit weights (log2_wd 0..7, negative
    weights and offsets); into fresh planes, and two frames into their
    segments of one tall plane (batch_decode's layout) whose other samples
    hold an earlier prediction that must stay as it was."""
    import torch
    from p265_tpu_torch.kernels import mc
    from p265_tpu_torch.kernels.staging import stage
    from p265_tpu_torch.pipeline.batch_decode import segment_rows
    from p265_tpu_torch.pipeline.wavefront import GUARD
    from p265_tpu_torch.testgen.kernel_cases import pred_case
    seg_h, seg_hc = 1080 + GUARD, 540 + GUARD
    for has_bi in (False, True):
        for weighted in (False, True):
            frames = [(stage(st, dev), stage(ar, dev), sh) for st, ar, sh
                      in (pred_case(rng, 1080, 1920, has_bi, weighted)
                          for _ in range(2))]
            stacks, arrays, shapes = frames[0]
            got = mc.mc_pred_planes(stacks, arrays, shapes, has_bi)
            want = mc.mc_pred_planes_ref(stacks, arrays, shapes, has_bi)
            torch.cuda.synchronize()
            what = f"mc_pred_planes bi={has_bi} weighted={weighted}"
            errs["mc"] = max(errs["mc"], _max_err(got, want, what))
            tall = torch.from_numpy(rng.integers(-5, 300, (
                2 * seg_h + 4 * seg_hc, 1920)).astype(np.int32)).to(dev)
            a, b = tall.clone(), tall.clone()
            for f, (stacks, arrays, shapes) in enumerate(frames):
                rows = segment_rows(2, f, seg_h, seg_hc)
                mc.mc_pred_planes(stacks, arrays, shapes, has_bi,
                                  out=(a, rows))
                mc.mc_pred_planes_ref(stacks, arrays, shapes, has_bi,
                                      out=(b, rows))
            torch.cuda.synchronize()
            require(not torch.equal(a, tall), f"{what}: wrote nothing")
            errs["mc"] = max(errs["mc"], _max_err(
                [a], [b], f"{what}, two frames in a tall plane"))
    log("mc (samples epilogue) == plain: mc_pred_planes at 1920x1080, "
        "every bucket with 5 pad rows each, MVs to 300 px past the picture, "
        "uni and bi (60% of the blocks), unweighted and explicitly weighted "
        "(weights and offsets -128..127, log2_wd 0..7); fresh planes, and "
        "two frames into the segments of one tall plane whose other "
        "samples hold an earlier prediction")


def _filter_sweeps(rng, dev, errs: dict) -> None:
    """The deblocking and SAO kernels against their plain versions on
    random cases at 1080p widths, in three layouts, and the row-sharded
    SAO's blocks with their halo rows."""
    import torch
    from p265_tpu_torch.kernels import loopfilter as lf
    from p265_tpu_torch.shard.filters import sao_rows
    from p265_tpu_torch.testgen import filter_cases as fc
    for shape in ((2, 1080, 1920), (1, 2160, 3840)):
        c = fc.deblock_planes_case(rng, *shape)
        fp = {k: torch.from_numpy(v).to(dev) for k, v in c.items()
              if k not in ("luma", "chroma")}
        for name in ("contiguous", "transposed", "rows of a taller plane"):
            luma, chroma = (fc.layouts(c[k], dev)[name]
                            for k in ("luma", "chroma"))
            got = lf.deblock_planes(luma, chroma, fp)
            want = lf.deblock_planes_ref(luma, chroma, fp)
            torch.cuda.synchronize()
            require(not torch.equal(want[0], luma), "deblock_planes sweep: "
                    "the plain version filtered nothing")
            errs["deblock"] = max(errs["deblock"], _max_err(
                got, want, f"deblock_planes {shape} {name}"))
    for chroma, shape in ((False, (2, 1080, 1920)), (False, (2, 1920, 1080)),
                          (True, (4, 540, 960)), (True, (4, 960, 540))):
        c = fc.deblock_case(rng, *shape, chroma=chroma)
        if chroma:
            fn, ref, keys = (lf.deblock_chroma_vertical,
                             lf.deblock_chroma_vertical_ref, ("tc",))
        else:
            fn, ref, keys = (lf.deblock_luma_vertical,
                             lf.deblock_luma_vertical_ref,
                             ("bs", "beta", "tc"))
        args = [torch.from_numpy(c[k]).to(dev) for k in keys]
        for name, planes in fc.layouts(c["planes"], dev).items():
            got, want = fn(planes, *args), ref(planes, *args)
            torch.cuda.synchronize()
            require(not torch.equal(want, planes), "deblock sweep: the "
                    "plain version filtered nothing")
            errs["deblock"] = max(errs["deblock"], _max_err(
                [got], [want], f"deblock chroma={chroma} {shape} {name}"))
    for ctb in (64, 32, 16):
        for shape, size in (((2, 1080, 1920), ctb), ((4, 540, 960),
                                                     ctb >> 1)):
            c = fc.sao_case(rng, *shape, size)
            maps = [torch.from_numpy(c[k]).to(dev)
                    for k in ("ty", "cls", "offs")]
            mask = torch.from_numpy(fc.bypass_masks(rng, *shape)).to(dev)
            pres = fc.layouts(fc.planes(rng, *shape), dev)
            for name, src in fc.layouts(c["src"], dev).items():
                for keep, dt in ((None, torch.int32),
                                 (None, torch.uint8),
                                 ((pres[name], mask), torch.uint8)):
                    got = lf.sao_apply(src, *maps, size, keep, dt)
                    want = lf.sao_apply_ref(src, *maps, size, keep, dt)
                    torch.cuda.synchronize()
                    errs["sao"] = max(errs["sao"], _max_err(
                        [got], [want], f"sao ctb {size} {shape} {name} "
                        f"{dt} masks={keep is not None}"))
    c = fc.sao_case(rng, 1, 1080, 1920, 64)
    maps = [torch.from_numpy(c[k][0]).to(dev) for k in ("ty", "cls", "offs")]
    # 4 blocks of 272 rows, the last 8 past the picture
    for r0, *blk in fc.row_blocks(torch.from_numpy(c["src"][0]).to(dev), 4,
                                  272):
        got = sao_rows(*blk, *maps, 64, r0, 1080)
        want = sao_rows(*(t.cpu() for t in blk), *(m.cpu() for m in maps),
                        64, r0, 1080)
        errs["sao"] = max(errs["sao"], _max_err(
            [got.cpu()], [want], f"sao rows from {r0}"))
    log("deblock == plain: deblock_planes (both directions, one launch) "
        "on luma [2,1080,1920] with chroma [4,540,960] and luma "
        "[1,2160,3840] with chroma [2,1080,1920]; one direction on luma "
        "[2,1080,1920] and [2,1920,1080], chroma [4,540,960] and "
        "[4,960,540]; each contiguous, as a transposed "
        "view and as rows of a taller plane; bS 0..2, beta 0..64, tc "
        "0..24, strong, normal and no filter.  sao == plain: CTB 64/32/16 "
        "(chroma 32/16/8) at 1080p in the same three layouts, every type "
        "and edge class, band positions 0..31, int32 and uint8 out, and "
        "uint8 with bypass masks (the prefilter samples restored); the "
        "row-sharded SAO's 4 blocks of 272 rows with halo rows (the last "
        "past the picture); deblocking grids int16, SAO maps int8")


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
        _filter_launches(launches, len(gold), f"96x64 {structure}")
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


def _filter_launches(launches: dict, dispatches: int, what: str) -> None:
    """One deblocking launch (luma and chroma, both directions) and two
    SAO launches (luma, chroma) a dispatch: every stream here turns both
    filters on in every slice."""
    require(launches["deblock"] == dispatches
            and launches["sao"] == 2 * dispatches,
            f"{what}: launches {launches}, expected 1 deblocking and 2 SAO "
            f"launches for each of {dispatches} dispatches")


def _counted(what: str, fn, filters: bool = True):
    """Run fn() with the kernels' launch counts set to 0 just before and
    read just after; every kernel must have launched, but the filter
    kernels where the path does not filter on the card (filters False),
    which must not have.  -> (result, launches)."""
    from p265_tpu_torch.kernels import _build
    _build.reset_launch_counts()
    out = fn()
    launches = dict(_build.LAUNCHES)
    require(all(launches[k] > 0 for k in KERNELS
                if filters or k not in FILTERS),
            f"{what}: a kernel never launched: {launches}")
    require(filters or not any(launches[k] for k in FILTERS),
            f"{what}: a filter kernel launched on a path that does not "
            f"filter on the card: {launches}")
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
        _filter_launches(p["launches"], len(p["dispatches"]),
                         f"{what} frame_dag_max={dag}")
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


def phase_stages() -> None:
    """The decoder's options and the per-stage entry points on the card."""
    import torch
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.kernels.loopfilter import loop_filters_frames
    from p265_tpu_torch.pipeline.decoder import TorchDecoder
    from p265_tpu_torch.pipeline.wavefront import reconstruct_scan_frames
    from p265_tpu_torch.plan.frame_plan import attach_pred_planes
    options = (dict(apply_filters=False), dict(use_native_parse=False))
    for structure, fn in SMALL[:2]:
        data = _stream_bytes(fn)
        gold = GoldenDecoder().decode_stream(data)
        unfiltered = GoldenDecoder(apply_filters=False).decode_stream(data)
        for kw in options:
            dec = TorchDecoder("cuda", **kw)
            frames, launches = _counted(
                f"96x64 {structure} {kw}", lambda: dec.decode_stream(data),
                filters=dec.apply_filters)
            _bit_exact(frames, gold if dec.apply_filters else unfiltered,
                       f"96x64 {structure} TorchDecoder {kw}")
            log(f"96x64 {structure} TorchDecoder(cuda, {kw}): bit-exact vs "
                f"golden, launches {launches}")

        # per-stage entry points against the decoder's planes
        dec = TorchDecoder("cuda")
        decoded = dec.decode_stream(data)
        _bit_exact(decoded, gold, f"96x64 {structure} TorchDecoder")

        def stages():
            tplans = []
            for f in decoded:
                tp = dec._build_tplan(f.plan)
                attach_pred_planes(tp, {o.poc: o.planes for o in decoded
                                        if o.poc != f.poc}, "cuda")
                tplans.append(tp)
            pre = reconstruct_scan_frames(tplans, "cuda")
            return pre, loop_filters_frames([f.plan for f in decoded],
                                            pre, "cuda")
        (pre, filt), launches = _counted(f"96x64 {structure} stages", stages)
        for f, p, q in zip(decoded, pre, filt):
            for c in range(3):
                require(p[c].is_cuda and q[c].is_cuda, "a plane left cuda")
                require(torch.equal(p[c], f.prefilter[c].to(torch.int32)),
                        f"reconstruct_scan_frames poc {f.poc} plane {c}")
                require(np.array_equal(q[c].cpu().numpy(), f.planes[c]),
                        f"loop_filters_frames poc {f.poc} plane {c}")
        log(f"96x64 {structure}: reconstruct_scan_frames + "
            f"loop_filters_frames == TorchDecoder, launches {launches}")


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


def phase_1080(jobs: dict) -> tuple:
    import torch
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    from p265_tpu_torch.run_config import Dispatches, load_golden
    data = _stream_bytes(os.path.basename(STREAM))
    t0 = time.perf_counter()
    path, golden_s = jobs["s1080_ldp4"].get(timeout=900)
    gold = load_golden(path)
    log(f"golden NumPy decode: {golden_s:.2f} s in a worker, waited "
        f"{time.perf_counter() - t0:.2f} s")

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
    """The port's GoldenDecoder on CONFIG5_STREAM (the longest, phase 13),
    s1080_ldp4 (phase 9), then on every STREAMS stream, the
    longest first, in GOLDEN_WORKERS spawned processes; -> (pool, {name:
    AsyncResult of run_config.save_golden, which writes
    tmp/<name>.npz})."""
    import multiprocessing as mp
    from p265_tpu_torch.run_config import save_golden
    pool = mp.get_context("spawn").Pool(GOLDEN_WORKERS)
    names = [CONFIG5_STREAM, "s1080_ldp4", *reversed(STREAMS)]
    jobs = {name: pool.apply_async(save_golden, (
        name, os.path.join(tmp, name + ".npz"))) for name in names}
    return pool, jobs


def phase_streams(jobs: dict) -> None:
    """Each STREAMS stream on the card: one cold and one warm pass, both
    bit-exact against golden, launches counted in each."""
    from p265_tpu_torch.run_config import decode_pass, load_golden, mib, split
    from p265_tpu_torch.testgen.streams import get_stream, stream_info
    names = tuple(KERNELS)
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


def phase_config5(jobs: dict) -> None:
    """BASELINE configuration 5: four 4K random-access streams (CONFIG5 of
    testgen/streams.py).  data/GOLDEN_MD5 against a live golden decode of
    CONFIG5_STREAM; that stream on one card, a cold and a warm pass, each
    bit-exact against the live golden and the MD5s; then over the ranks
    (profile_shard.run_config5: the stream axis on the four streams, the
    global batch of their IRAP pictures, the space axis on CONFIG5_STREAM,
    every plane against the MD5s inside the ranks), every kernel launched
    on every rank of both axes."""
    import torch
    from p265_tpu_torch.profile_shard import (config5_lines, config5_streams,
                                              run_config5, transport)
    from p265_tpu_torch.run_config import decode_pass, load_golden, mib
    from p265_tpu_torch.testgen.streams import check_md5, planes_md5
    t0 = time.perf_counter()
    ranks = max(2, torch.cuda.device_count())
    backend, cards = transport(ranks)
    log(f"config 5 on {SMI}: {ranks} ranks over {backend} on cards {cards}")
    streams = config5_streams()
    require(streams[0][0] == CONFIG5_STREAM, "CONFIG5's first stream is "
            f"{streams[0][0]}, not {CONFIG5_STREAM}")
    _, data, expected = streams[0]
    t1 = time.perf_counter()
    path, golden_s = jobs[CONFIG5_STREAM].get(timeout=900)
    waited = time.perf_counter() - t1
    gold = load_golden(path)
    live = planes_md5(gold)
    require(live == expected, f"data/GOLDEN_MD5 of {CONFIG5_STREAM} "
            "differs from its live golden decode")
    log(f"{CONFIG5_STREAM}: data/GOLDEN_MD5 equals the live golden decode "
        f"({len(live)} planes; golden {golden_s:.2f} s in a worker, waited "
        f"{waited:.2f} s)")
    passes = []
    for i in range(2):
        p = decode_pass(data, "cuda")
        what = f"{CONFIG5_STREAM} pass {i}"
        _bit_exact(p["frames"], gold, what)
        check_md5(p["frames"], expected, what)
        launches = p["launches"]
        require(all(launches[k] > 0 for k in KERNELS),
                f"{what}: a kernel never launched: {launches}")
        require(launches["mc"] == len(gold) - 1, f"{what}: "
                f"{launches['mc']} K2 launches for {len(gold) - 1} inter "
                "pictures")
        _filter_launches(launches, len(p["dispatches"]), what)
        require(all(f.planes[0].shape == gold[0].planes[0].shape
                    for f in p["frames"]), f"{what}: frame size")
        passes.append(dict(seconds=p["seconds"], peak=p["peak"],
                           launches=launches, dispatches=p["dispatches"]))
        del p
    cold, warm = passes
    steps = sum(st for _, st in cold["dispatches"])
    h, w = gold[0].planes[0].shape
    log(f"config 5 one card, {CONFIG5_STREAM} ({w}x{h}, {len(gold)} "
        "frames): bit-exact vs the live golden and its MD5s in both passes; "
        f"cold {cold['seconds']:.4f} s, warm {warm['seconds']:.4f} s = "
        f"{len(gold) / warm['seconds']:.4f} fps; peak "
        f"{mib(max(q['peak'] for q in passes))}; launches "
        f"{cold['launches']}; dispatches (pocs: scan steps) "
        + ", ".join(f"{pocs}: {st}" for pocs, st in cold["dispatches"]))
    rec = run_config5(ranks, timeout=900, streams=streams)
    for line in config5_lines(rec):
        log(line)
    for rank in range(ranks):
        st, bt, sp = (rec[k][rank] for k in ("stream", "batch", "space"))
        for axis, launches in (("stream", st["launches"]),
                               ("space", sp["launches"])):
            require(all(launches[k] > 0 for k in KERNELS),
                    f"config 5 rank {rank} {axis} axis: a kernel never "
                    f"launched: {launches}")
        require(all(bt["launches"][k] > 0 for k in KERNELS if k != "mc")
                and bt["launches"]["mc"] == 0,
                f"config 5 rank {rank} global batch (IRAP pictures): "
                f"launches {bt['launches']}")
        require(sp["launches"]["scan"] == steps,
                f"config 5 rank {rank} space axis: "
                f"{sp['launches']['scan']} scan launches for {steps} scan "
                "steps")
        require([p["poc"] for p in sp["pictures"]]
                == [pocs[0] for pocs, _ in cold["dispatches"]],
                f"config 5 rank {rank} space axis: pictures "
                f"{[p['poc'] for p in sp['pictures']]}")
        pics = sum(f for _, _, f in st["segments"])
        require(0 < st["launches"]["scan"] <= pics,
                f"config 5 rank {rank} stream axis: "
                f"{st['launches']['scan']} scan launches for {pics} pictures")
    require(sorted(si for r in rec["stream"] for si, _, _ in r["segments"])
            == list(range(len(streams))), "config 5 stream axis: the "
            "streams were not each decoded once")
    log(f"config 5 phase: {time.perf_counter() - t0:.2f} s")


def _keep(t):
    """A copy of a tensor argument with its strides (a transposed view
    stays a transposed view, rows of a tall plane stay rows)."""
    import torch
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


# the main path's filter functions (kernels/loopfilter.py): kernel name
# of each, the wrapper's name (its plain version is name + "_ref")
FILTER_FUNCTIONS = {"deblock_planes": "deblock", "sao_apply": "sao"}


def _capture_main_path(data: bytes) -> dict:
    """Record the arguments of every K1 call, every MC call (the main
    path's mc_pred_planes, which writes into the batch's tall plane), every
    scan and every filter call of one pass; a scan's plane is recorded as
    it stood before the scan, a filter's planes with their strides.  A
    filter call is recorded as ((function name, *arguments), keywords).
    calls["staged"]: per dispatch, the tree that stage() returned and the
    same host tree copied leaf by leaf (staging.per_leaf) when it was
    staged."""
    from p265_tpu_torch.kernels import itransform, staging
    from p265_tpu_torch.kernels import loopfilter as lf
    from p265_tpu_torch.pipeline import batch_decode as bd
    from p265_tpu_torch.pipeline import wavefront as wf
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    calls = {k: [] for k in (*KERNELS, "staged")}
    patched = [(itransform, "batch_residual_grouped", "itransform"),
               (bd, "mc_pred_planes", "mc"), (wf, "scan_plane", "scan"),
               (bd, "stage", "staged"),
               *((lf, fn, k) for fn, k in FILTER_FUNCTIONS.items())]
    orig = [(m, fn, getattr(m, fn)) for m, fn, _ in patched]

    def spy(fn, name, f0):
        def f(*a, **k):
            if name == "staged":
                out = f0(*a, **k)
                calls[name].append((out, staging.per_leaf(a[0], a[1])))
                return out
            if name == "scan":
                calls[name].append(((*a[:3], a[3].clone()), k))
            elif name == "itransform" and k.get("plane") is not None:
                # the epilogue writes into the plane: keep it as it was
                calls[name].append((a, dict(k, plane=k["plane"].clone())))
            elif name in FILTERS:
                calls[name].append(((fn, *map(_keep, a)), k))
            else:
                calls[name].append((a, k))
            return f0(*a, **k)
        return f

    for (m, fn, name), (_, _, f0) in zip(patched, orig):
        setattr(m, fn, spy(fn, name, f0))
    try:
        PipelinedTorchDecoder("cuda").decode_stream(data)
    finally:
        for m, fn, f0 in orig:
            setattr(m, fn, f0)
    return calls


def _check_staging(staged: list) -> None:
    """The staged trees of one s1080_ldp4 pass, read after the pass: one
    a dispatch, each leaf on the card, on 16 bytes, a view of its
    dispatch's one buffer, and equal (dtype, shape, values) to the leaf
    copied alone when it was staged, so no consumer wrote into it."""
    import torch
    from p265_tpu_torch.kernels import staging
    require(len(staged) == N_FRAMES, f"{len(staged)} staged trees in one "
            f"pass, expected {N_FRAMES}")
    leaves = nbytes = 0
    for i, (got, want) in enumerate(staged):
        g, w = staging.leaves(got), staging.leaves(want)
        require(len(g) == len(w), f"dispatch {i}: {len(g)} staged leaves "
                f"for {len(w)}")
        bufs = {t.untyped_storage().data_ptr() for t in g if t.numel()}
        require(len(bufs) == 1, f"dispatch {i}: leaves in {len(bufs)} "
                "device buffers")
        for a, b in zip(g, w):
            require(a.device.type == "cuda" and a.data_ptr() % 16 == 0
                    and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b),
                    f"dispatch {i}: a staged leaf {a.dtype} "
                    f"{tuple(a.shape)} at {a.data_ptr() % 16} mod 16 "
                    f"differs from its per-leaf copy {b.dtype} "
                    f"{tuple(b.shape)}")
        leaves += len(g)
        nbytes += sum(t.numel() * t.element_size() for t in g)
    log(f"staging: {len(staged)} dispatches, {leaves} leaves, {nbytes} "
        "bytes of leaves, every leaf on 16 bytes and equal after the pass "
        "to its per-leaf upload at the wire dtypes")


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


def _device_ms(fn, calls, symbol, reps: int = 10):
    """Device time (ms) of the kernel `symbol` (None: of every device
    operation) over one run of every call, from torch.profiler, averaged
    over reps runs; None if the profiler saw no device time for it."""
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
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation
             and (symbol is None or symbol in e.key))
    return us / 1e3 / reps if us else None


def _bound(name: str, w: dict, card: str, measured_ms) -> dict:
    """The roofline bound of kernel `name` over one pass (w: roofline.work
    of the stream's census) and its share of the measured ms; the share
    must not exceed MAX_SHARE."""
    from p265_tpu_torch.roofline import MAX_SHARE, bound
    wk = w["kernels"][name]
    ms, by = bound(wk, card)
    share = ms / measured_ms
    require(share <= MAX_SHARE, f"{name}: bound {ms} ms is {share:.3f} of "
            f"its measured {measured_ms} ms, above {MAX_SHARE}")
    return dict(bytes=wk.bytes, ops=wk.ops,
                ops_type="fp32" if wk.fp32 else "int32", bound_ms=ms,
                bound_us=ms * 1e3, bound_by=by, bound_share=share)


def _census_matches(pics: list, calls: dict) -> None:
    """The census counts the TUs of each size and the MC blocks of each
    geometry that the pass's K1 and K2 calls carry (a stream with no
    bi-prediction, where the two are equal)."""
    want_tu, want_mc = {}, {}
    for p in pics:
        for log2, split in p["tus"].items():
            want_tu[log2] = want_tu.get(log2, 0) + sum(
                sum(c.values()) for c in split.values())
        for (plane, block, _), n in p["mc"].items():
            key = (8 if plane == "y" else 4, block)
            want_mc[key] = want_mc.get(key, 0) + n
    got_tu, got_mc = {}, {}
    for a, _ in calls["itransform"]:
        for log2, f in a[0].items():
            if f["coeffs"].shape[0]:
                got_tu[log2] = got_tu.get(log2, 0) + f["coeffs"].shape[0]
    for a, _ in calls["mc"]:
        for key, n in _mc_call_blocks(*a[:4]).items():
            k = (8 if key[0] == "y" else 4, key[1])
            got_mc[k] = got_mc.get(k, 0) + n
    require(got_tu == want_tu, f"census TUs {want_tu}, K1 calls {got_tu}")
    require(got_mc == {k: n for k, n in want_mc.items() if n},
            f"census MC blocks {want_mc}, K2 calls {got_mc}")


def _mc_call_blocks(stacks, arrays, shapes, has_bi) -> dict:
    """{(plane, block, list): blocks} that an mc_pred_planes call
    interpolates: every block but the pad rows in list 0, the ones that
    read list 1 in list 1."""
    out = {}
    for c, plane in enumerate(("y", "cb", "cr")):
        for block, d in arrays["y" if c == 0 else "c"].items():
            real = d["pos"][:, 0] < shapes[c][0]
            out[plane, block, 0] = int(real.sum())
            if has_bi:
                out[plane, block, 1] = int((real & d["has1"]).sum())
    return out


def _launched(name: str, args) -> bool:
    """Whether a K1 or MC call launches (some group has a row)."""
    if name == "itransform":
        return any(f["coeffs"].shape[0] for f in args[0].values())
    return any(d["pos"].shape[0] for grp in args[1].values()
               for d in grp.values())


def _fresh_out(k: dict) -> dict:
    """An MC call's keywords with a zeroed copy of its destination, so that
    the kernel and its plain version write into planes of their own."""
    import torch
    plane, rows = k["out"]
    return dict(k, out=(torch.zeros_like(plane), rows))


def _scan_row(calls: list, launches: dict, sharded: dict, dag: dict,
              errs: dict, w: dict, card: str) -> dict:
    """The scan kernel over every scan of one s1080_ldp4 pass: each equal
    to its plain version; the window of scan_plane (packing included) in
    turns with the plain version (one run per turn: the plain I picture
    takes seconds); the kernel's device time; its bound (roofline, from the
    census `w`); and the barrier floor, the device time of the same
    launches computing no TU."""
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
    b = _bound("scan", w, card, dev_ms or ms)
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
        f"{floor_ms} ms), plain {p1:.4f}/{p2:.4f} ms; census "
        f"{b['bytes']} bytes, {b['ops']} {b['ops_type']} multiply-adds; "
        f"bound {b['bound_ms']:.6f} ms by {b['bound_by']}, share "
        f"{b['bound_share']:.6f}; a step with TUs: device "
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
                plain_ms=plain_ms, **b, floor_ms=floor_ms, steps=steps,
                floor_us_a_step=floor_us, chain_us_a_step=chain_us,
                library_ms=None)


def phase_timing(launches: dict, sharded: dict, dag: dict, errs: dict,
                 card: str) -> list:
    import torch
    from p265_tpu_torch import roofline
    from p265_tpu_torch.kernels import itransform, mc
    from p265_tpu_torch.kernels import loopfilter as lf
    with open(STREAM, "rb") as f:
        data = f.read()
    calls = _capture_main_path(data)
    _check_staging(calls.pop("staged"))
    t0 = time.perf_counter()
    pics = roofline.census(data)
    w = roofline.work(pics)
    _census_matches(pics, calls)
    log(f"roofline census of s1080_ldp4: {time.perf_counter() - t0:.2f} s, "
        "its TUs and blocks equal to the main path's K1 and K2 calls; "
        "bounds of one pass: " + ", ".join(
            f"{k} {roofline.bound(v, card)[0]:.6f} ms"
            for k, v in w["kernels"].items()))
    def filter_kernel(fn, *a):
        return getattr(lf, fn)(*a)

    def filter_plain(fn, *a):
        return getattr(lf, fn + "_ref")(*a)

    pairs = {"itransform": (itransform.batch_residual_grouped,
                            itransform.batch_residual_grouped_ref,
                            "itransform_grouped_kernel"),
             "mc": (mc.mc_pred_planes, mc.mc_pred_planes_ref,
                    "mc_grouped_kernel"),
             "deblock": (filter_kernel, filter_plain, "deblock_tiles"),
             "sao": (filter_kernel, filter_plain, "sao_tiles")}
    rows = []
    for name, (kern, plain, symbol) in pairs.items():
        cl = [(a, k) for a, k in calls[name]
              if name in FILTERS or _launched(name, a)]
        require(len(cl) == KERNELS[name][2], f"{len(cl)} {name} launches "
                f"in one pass, expected {KERNELS[name][2]}")
        for a, k in cl:
            if name == "mc":   # the whole tall plane each writes into
                kg, kw = _fresh_out(k), _fresh_out(k)
                kern(*a, **kg)
                plain(*a, **kw)
                got, want = [kg["out"][0]], [kw["out"][0]]
            elif k.get("plane") is not None:   # K1's epilogue, in place
                got = [kern(*a, **dict(k, plane=k["plane"].clone()))]
                want = [plain(*a, **dict(k, plane=k["plane"].clone()))]
            else:
                got, want = kern(*a, **k), plain(*a, **k)
            if name == "sao":
                got, want = [got], [want]
            errs[name] = max(errs[name], _max_err(
                got, want, f"{name} main-path call"))
        # turns: plain, kernel, kernel, plain
        p1 = _time_calls(plain, cl)
        k1 = _time_calls(kern, cl)
        k2 = _time_calls(kern, cl)
        p2 = _time_calls(plain, cl)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        dev_ms = _device_ms(kern, cl, symbol)
        plain_dev = _device_ms(plain, cl, None, reps=3)
        b = _bound(name, w, card, dev_ms or ms)
        epi = sum(k.get("plane") is not None for _, k in cl)
        log(f"{name}: {len(cl)} calls per s1080_ldp4 pass "
            f"({epi} with the plane epilogue); kernel "
            f"{k1:.4f}/{k2:.4f} ms (device time {dev_ms} ms), plain "
            f"{p1:.4f}/{p2:.4f} ms (device time {plain_dev} ms); census "
            f"{b['bytes']} bytes, {b['ops']} "
            f"{b['ops_type']} multiply-adds; bound {b['bound_ms']:.6f} ms by "
            f"{b['bound_by']}, share {b['bound_share']:.6f}")
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
                         plain_ms=plain_ms, plain_device_ms=plain_dev, **b,
                         library_ms=None))
    rows.append(_scan_row(calls["scan"], launches, sharded, dag, errs, w,
                          card))
    torch.cuda.synchronize()
    return rows


# the reference's per-dtype upload buffers a s1080_ldp4 dispatch
# (p265_tpu/pipeline/batch_decode.py _pack: one for each dtype of its
# arrays, bool, uint8, uint16, int16, int32 and int8): the most h2d copies
# a dispatch of the port may make
REF_BUFFERS = 6


def phase_upload() -> None:
    """The upload contract on the card: one profiled pass of s1080_ldp4
    (run_config.profile_pass) with its staging copies and bytes and the
    device ms of every host-to-device copy in the trace (one staging copy
    a dispatch, and no more copies than the reference's per-dtype
    buffers); then `python -m p265_tpu_torch.profile_pack s1080_ldp4` as a
    subprocess (exit 0, one JSON stdout line, printed)."""
    from p265_tpu_torch.run_config import profile_pass
    with open(STREAM, "rb") as f:
        data = f.read()
    pr = profile_pass(data, "cuda")
    h2d = pr["h2d_ms"]
    log(f"upload, one profiled s1080_ldp4 pass: {pr['h2d_copies']} staging "
        f"copies, {pr['h2d_bytes']} bytes; {len(h2d)} host-to-device "
        f"copies in the trace, {sum(h2d):.4f} device ms (each: "
        + " ".join(f"{v:.4f}" for v in h2d) + f"); pass device "
        f"{pr['device_ms']:.4f} ms over {pr['ops']} device operations, "
        f"idle share {pr['idle']:.4f}; host operators in the window (every "
        "thread): " + ", ".join(f"{k} {v}" for k, v in
                                pr["op_counts"].items()))
    require(pr["h2d_copies"] == N_FRAMES,
            f"{pr['h2d_copies']} staging copies for {N_FRAMES} dispatches")
    require(0 < len(h2d) <= REF_BUFFERS * N_FRAMES,
            f"{len(h2d)} h2d copies in a pass, more than the reference's "
            f"{REF_BUFFERS} a dispatch")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "p265_tpu_torch.profile_pack",
                        "s1080_ldp4"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    require(r.returncode == 0, f"profile_pack exited {r.returncode}: "
            f"{r.stderr[-2000:]}")
    lines = r.stdout.splitlines()
    require(len(lines) == 1, f"profile_pack printed {len(lines)} lines")
    rec = json.loads(lines[0])
    require(len(rec["pictures"]) == N_FRAMES and rec["card"],
            f"profile_pack record {lines[0][:300]}")
    log(f"profile_pack s1080_ldp4 ({time.perf_counter() - t0:.1f} s): "
        + lines[0])


def phase_measuring() -> None:
    """The port's measuring modules on the card: the kernel rates, the
    graft entry against its CPU forward, and the sharded dry run over two
    ranks."""
    import torch
    from p265_tpu_torch import bench_kernels, graft_entry
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.roofline import MAX_SHARE
    t0 = time.perf_counter()
    rows = bench_kernels.run("cuda")
    for row in rows:
        log("  bench_kernels:", json.dumps(row))
        rate = row.get("tu_per_s", row.get("blocks_per_s"))
        require(row["ctu_per_s"] > 0 and rate > 0, f"bench_kernels {row}")
        require(row["bound_share"] <= MAX_SHARE,
                f"bench_kernels: share above {MAX_SHARE}: {row}")

    fwd, args = graft_entry.entry("cuda")
    _build.reset_launch_counts()
    got = fwd(*args)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    require(launches["itransform"] == 1,
            f"graft entry: launches {launches}, K1 expected once")
    require(torch.equal(got.cpu(), fwd(*(a.cpu() for a in args))),
            "graft entry on the card differs from its forward on CPU "
            "tensors")
    log(f"graft entry on cuda == on CPU tensors ({tuple(got.shape)}), "
        f"launches {launches}")

    t1 = time.perf_counter()
    out = graft_entry.dryrun_multichip(2)
    require(all(n[k] > 0 for n in out["launches"] for k in KERNELS),
            f"dryrun_multichip: launches per rank {out['launches']}, each "
            "kernel expected on every rank")
    log(f"dryrun_multichip(2): bit-exact over {out['backend']}, launches "
        f"per rank {out['launches']} ({time.perf_counter() - t1:.2f} s)")
    log(f"phase 16 (measuring modules): {time.perf_counter() - t0:.1f} s")


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
            phase_stages()
            phase_options()
            phase_cli()
            launches, gold_planes, steps = phase_1080(jobs)
            phase_streams(jobs)
            dag = phase_frame_dag(RA_STREAM, warm=3)
            sharded = phase_sharded(gold_planes, steps)
            phase_config5(jobs)
        finally:
            pool.terminate()
            pool.join()
        rows = phase_timing(launches, sharded, dag, errs, kind)
        phase_upload()
        phase_measuring()
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
