#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (p265_tpu_torch) on one CUDA card.

    python chip_smoke.py

Phases, in order; any failure raises and exits nonzero (nothing falls back):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit, the torch and CUDA versions; the native C parse must be built.
2. build: compiles the CUDA kernels (csrc/*.cu) with nvcc, timed.
3. kernels vs plain: each kernel against its plain torch version on the
   card, torch.equal, over a sweep of sizes, modes and out-of-picture MVs.
4. small streams: an LDP and an RA (bi-pred) stream from the repo's test
   encoder, PipelinedTorchDecoder on cuda vs GoldenDecoder, bit-exact.
5. s1080_ldp4 (1920x1080, IDR + 3 P, QP 32; p265_tpu_torch/data): one
   cold pass bit-exact against GoldenDecoder on every plane, with the
   kernel launch counters reset just before it; then 3 warm passes.
6. per-kernel time against the plain version, over every call the main
   path made on one pass of s1080_ldp4.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM = os.path.join(ROOT, "p265_tpu_torch", "data", "s1080_ldp4.265")
STREAM_SHA256 = ("d1b7ea38c13d3c7e926c9010d8378b37"
                 "e8abec8a7cd4dceb06fce40c5e00c905")
N_FRAMES = 4
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "itransform": ("p265_tpu_torch/csrc/itransform.cu",
                   "p265_tpu/kernels/pallas_itransform.py:39"),
    "mc": ("p265_tpu_torch/csrc/mc.cu", "p265_tpu/kernels/pallas_mc.py:44"),
}


def log(*a) -> None:
    print(*a, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    log(smi.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s)")
    from p265_tpu.native.parse import native_parse_available
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


def _k1_inputs(rng, log2: int, n: int = 150, scale: bool = False):
    s = 1 << log2
    lv = ((rng.random((n, s, s)) < 0.2)
          * rng.integers(-200, 200, (n, s, s))).astype(np.int32)
    lv[:5] = rng.integers(-32768, 32768, (5, s, s))
    qp = np.arange(n, dtype=np.int32) % 52
    dst = (rng.random(n) < 0.4) if log2 == 2 else np.zeros(n, bool)
    tsk = ((rng.random(n) < 0.3) & ~dst) if log2 == 2 else np.zeros(n, bool)
    byp = rng.random(n) < 0.15
    sm = None
    if scale:
        sm = rng.integers(1, 256, (n, s, s)).astype(np.int32)
        sm[:8] = 255
    return lv, qp, dst, tsk, byp, sm


def phase_compare(errs: dict) -> None:
    import torch
    from p265_tpu_torch.kernels import itransform, mc
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa
    for log2 in (2, 3, 4, 5):
        for scale in (False, True):
            lv, qp, dst, tsk, byp, sm = map(t, _k1_inputs(rng, log2,
                                                          scale=scale))
            got = itransform.batch_residual(lv, qp, dst, tsk, log2,
                                            bypass=byp, scale_m=sm)
            want = itransform.batch_residual_ref(lv, qp, dst, tsk, log2,
                                                 bypass=byp, scale_m=sm)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"itransform log2={log2} "
                    f"scale_m={scale} differs from its plain version")
            errs["itransform"] = max(errs["itransform"],
                                     int((got - want).abs().max()))
    log("itransform == plain: log2 2..5, with/without scale_m, "
        "DST/tskip/bypass, qp 0..51, levels to +-2^15, n=150")
    for block, taps in ((16, 8), (8, 8), (4, 8), (8, 4), (4, 4), (2, 4)):
        H, W = (1080, 1920) if taps == 8 else (540, 960)
        n, R = 4096, 3
        refs = torch.from_numpy(rng.integers(0, 256, (R, H, W)).astype(
            np.uint8)).to(dev)
        pos = np.stack([rng.integers(0, (H - block) // block + 1, n) * block,
                        rng.integers(0, (W - block) // block + 1, n) * block],
                       1)
        pos[:64] = [[0, 0], [H - block, W - block]] * 32   # picture corners
        unit = 4 if taps == 8 else 8                     # MV units per pel
        mv = rng.integers(-300 * unit, 300 * unit, (n, 2))  # +-300 px
        ridx = rng.integers(0, R, n)
        args = [torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (pos, ridx, mv)]
        got = mc.mc_blocks(refs, *args, block, taps)
        want = mc.mc_blocks_ref(refs, *args, block, taps)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"mc block={block} taps={taps} differs from its plain version")
        errs["mc"] = max(errs["mc"], int((got - want).abs().max()))
    log("mc == plain: 6 block/taps geometries, n=4096 each, MVs up to "
        "300 px beyond the picture")


def _stream(structure: str, seed: int):
    from p265_tpu.hls.params import PPS, SPS
    from p265_tpu.testgen.encoder import Encoder, make_moving_sequence
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    frames = make_moving_sequence(96, 64, 5, seed=seed)
    return Encoder(sps, pps, qp=32, seed=seed).encode_sequence(
        frames, structure=structure)[0]


def _bit_exact(frames, gold, what: str) -> None:
    require(len(frames) == len(gold), f"{what}: {len(frames)} frames, "
            f"golden has {len(gold)}")
    for f, g in zip(frames, gold):
        require(f.poc == g.poc, f"{what}: output order differs")
        for c in range(3):
            require(np.array_equal(f.planes[c], g.planes[c]),
                    f"{what}: poc {f.poc} plane {c} differs from golden")
            require(np.array_equal(f.prefilter[c].cpu().numpy(),
                                   g.prefilter[c]),
                    f"{what}: poc {f.poc} prefilter {c} differs from golden")


def phase_small_streams() -> None:
    from p265_tpu.golden.decoder import GoldenDecoder
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    for structure, seed in (("LDP", 41), ("RA", 50)):
        data = _stream(structure, seed)
        gold = GoldenDecoder().decode_stream(data)
        frames = PipelinedTorchDecoder("cuda").decode_stream(data)
        _bit_exact(frames, gold, f"96x64 {structure}")
        if structure == "RA":
            require(any(p.motion.uses(0) and p.motion.uses(1)
                        for g in gold for p in g.plan.pus),
                    "RA stream has no bi-predicted PU")
        log(f"96x64 {structure}: {len(frames)} frames bit-exact vs golden")


def _stats(dec) -> str:
    st = dec.stats
    return (f"parse {st['parse_s']:.3f} s, recon dispatch "
            f"{st['recon_s']:.3f} s, fetch {st['fetch_s']:.3f} s")


def phase_1080() -> dict:
    import torch
    from p265_tpu.golden.decoder import GoldenDecoder
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    require(os.path.exists(STREAM), f"{STREAM} is missing")
    with open(STREAM, "rb") as f:
        data = f.read()
    require(hashlib.sha256(data).hexdigest() == STREAM_SHA256,
            "s1080_ldp4.265 does not match its sha256")
    t0 = time.perf_counter()
    gold = GoldenDecoder().decode_stream(data)
    log(f"golden NumPy decode: {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    dec = PipelinedTorchDecoder("cuda")
    t0 = time.perf_counter()
    frames = dec.decode_stream(data)
    cold = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"cold pass: {cold:.3f} s ({_stats(dec)})")
    log(f"launches in the cold pass: {launches}")
    require(all(launches[k] > 0 for k in KERNELS),
            f"a kernel of the main path never launched: {launches}")
    require(all(f.planes[0].shape == (1080, 1920) for f in frames),
            "s1080_ldp4 frames are not 1920x1080")
    _bit_exact(frames, gold, "s1080_ldp4")
    log(f"s1080_ldp4: {len(frames)} frames 1920x1080 bit-exact vs golden "
        "(every plane, pre- and post-filter)")
    require(len(frames) == N_FRAMES, f"expected {N_FRAMES} frames")
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
    return launches


def _capture_main_path(data: bytes) -> dict:
    """Record the arguments of every kernel-wrapper call of one pass."""
    from p265_tpu_torch.kernels import itransform, mc
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    calls = {"itransform": [], "mc": []}
    orig = {"itransform": itransform.batch_residual, "mc": mc.mc_blocks}

    def spy(name):
        def f(*a, **k):
            calls[name].append((a, k))
            return orig[name](*a, **k)
        return f

    itransform.batch_residual, mc.mc_blocks = spy("itransform"), spy("mc")
    try:
        PipelinedTorchDecoder("cuda").decode_stream(data)
    finally:
        itransform.batch_residual, mc.mc_blocks = (orig["itransform"],
                                                   orig["mc"])
    return calls


def _time_calls(fn, calls, reps: int = 10) -> float:
    """Median ms of running every call once, by CUDA events."""
    import torch
    for _ in range(2):
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


def phase_timing(launches: dict, errs: dict) -> list:
    import torch
    from p265_tpu_torch.kernels import itransform, mc
    with open(STREAM, "rb") as f:
        calls = _capture_main_path(f.read())
    pairs = {"itransform": (itransform.batch_residual,
                            itransform.batch_residual_ref),
             "mc": (mc.mc_blocks, mc.mc_blocks_ref)}
    rows = []
    for name, (kern, plain) in pairs.items():
        cl = calls[name]
        require(cl, f"no {name} calls captured")
        for a, k in cl:
            d = (kern(*a, **k) - plain(*a, **k)).abs()
            errs[name] = max(errs[name], int(d.max()) if d.numel() else 0)
        # turns: plain, kernel, kernel, plain
        p1 = _time_calls(plain, cl)
        k1 = _time_calls(kern, cl)
        k2 = _time_calls(kern, cl)
        p2 = _time_calls(plain, cl)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        shapes = sorted({tuple(a[0].shape) if name == "itransform"
                         else (tuple(a[1].shape)[0], a[4], a[5])
                         for a, _ in cl})
        log(f"{name}: {len(cl)} calls per s1080_ldp4 pass; kernel {k1:.4f}/"
            f"{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms; shapes {shapes}")
        require(errs[name] == 0, f"{name} differs from its plain version")
        src, rep = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain_ms))
    torch.cuda.synchronize()
    return rows


def main() -> int:
    import torch
    kind = phase_device()
    phase_build()
    errs = {"itransform": 0, "mc": 0}
    phase_compare(errs)
    phase_small_streams()
    launches = phase_1080()
    rows = phase_timing(launches, errs)
    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
