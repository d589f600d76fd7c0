"""Throughput of the residual (K1) and MC (K2) kernels: CTU/s, on the card.

    python -m p265_tpu_torch.bench_kernels [--device cuda]

The counterpart of profiling/bench_kernels.py, on its inputs (made from
np.random.default_rng(0)): for each TU size, 2,048 TUs of 20%-dense levels
in +-200 with qp 20-44 (no DST, transform skip or bypass), one size a
batch_residual_grouped call; 4,096 4x4 luma MC blocks on two 1088x1920
uint8 references, MVs in +-128 quarter pels, one mc_blocks_grouped call.
A 64x64 CTU is 256 4x4, 64 8x8, 16 16x16 or 4 32x32 TUs, or 256 4x4 MC
blocks.  Each call is timed by CUDA events, the median of 20 after one
warm-up call (the kernel already built), its inputs resident in the L2
cache as in the original.  Each kernel's bound comes from
p265_tpu_torch.roofline's rules for the same work; `bound_share` is the
bound over the measured ms.  The plain torch versions are timed too,
under route "plain" (the original's "xla" rows): a record, not a
yardstick.  One JSON line a row on stdout; the card's name and power
limit on stderr.

On CPU tensors (`--device cpu`, the tests) each wrapper runs its plain
version, so only the "plain" rows are made, timed by the host clock, with
no bound (a CPU has no entry in the roofline's peaks).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

TU_PER_CTU = {2: 256, 3: 64, 4: 16, 5: 4}
MC_PER_CTU = 256
MC_SHAPE = (1088, 1920)


def k1_inputs(rng, log2: int, n: int) -> dict:
    s = 1 << log2
    lv = ((rng.random((n, s, s)) < 0.2)
          * rng.integers(-200, 200, (n, s, s))).astype(np.int16)
    z = np.zeros(n, bool)
    return dict(coeffs=lv, qp=rng.integers(20, 45, n).astype(np.uint8),
                is_dst=z, tskip=z, bypass=z)


def k2_inputs(rng, n: int) -> tuple:
    H, W = MC_SHAPE
    ref = rng.integers(0, 256, (2, H, W)).astype(np.uint8)
    pos = np.stack([rng.integers(0, H - 8, n), rng.integers(0, W - 8, n)],
                   axis=1).astype(np.int32)
    ridx = rng.integers(0, 2, n).astype(np.int32)
    mv = rng.integers(-128, 128, (n, 2)).astype(np.int32)
    return ref, pos, ridx, mv


def k2_work(ref, pos, ridx, mv, block: int = 4, taps: int = 8):
    """roofline's K2 work of one group: the union of the blocks' windows
    over each reference, the records and intermediates, the filter."""
    from p265_tpu_torch import roofline
    lead, span = taps // 2 - 1, block + taps - 1
    y0 = pos[:, 0] + (mv[:, 1] >> 2) - lead
    x0 = pos[:, 1] + (mv[:, 0] >> 2) - lead
    refs = sum(roofline.window_samples(
        zip(y0[ridx == r], x0[ridx == r], y0[ridx == r] + span,
            x0[ridx == r] + span), ref.shape[1:])
        for r in range(ref.shape[0]))
    return roofline.Work(refs, 0) + roofline.mc_block_work(block, taps,
                                                           len(pos))


def _time_ms(fn, reps: int, cuda: bool) -> float:
    """Median ms of `reps` calls of fn, after one warm-up call: CUDA
    events on a card, the host clock on the CPU."""
    import torch
    fn()
    if cuda:
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def run(device: str = "cuda", n_tu: int = 2048, n_blocks: int = 4096,
        reps: int = 20) -> list:
    """The rows: per TU size and for MC, the kernel (on a card) and its
    plain version, each {kernel, route, device, ms, ctu_per_s, tu_per_s or
    blocks_per_s, bound_ms, bound_by, bound_share}."""
    import torch
    from p265_tpu_torch import roofline
    from p265_tpu_torch.kernels import itransform, mc
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_kernels: no CUDA card; pass --device "
                               "cpu")
        from p265_tpu_torch.kernels import _build
        _build.library()
    card = torch.cuda.get_device_name(dev) if cuda else None
    routes = ((("cuda", itransform.batch_residual_grouped,
                mc.mc_blocks_grouped),) if cuda else ()) + (
        ("plain", itransform.batch_residual_grouped_ref,
         mc.mc_blocks_grouped_ref),)
    rng = np.random.default_rng(0)
    rows = []

    def row(kernel, route, ms, work, per_ctu, n, unit):
        b = roofline.bound(work, card) if cuda else (None, None)
        rows.append({"kernel": kernel, "route": route, "device": card or
                     "cpu", "ms": ms, "ctu_per_s": n / per_ctu / ms * 1e3,
                     unit: n / ms * 1e3, "bound_ms": b[0], "bound_by": b[1],
                     "bound_share": b[0] / ms if cuda else None})

    for log2, per_ctu in TU_PER_CTU.items():
        f = k1_inputs(rng, log2, n_tu)
        groups = {log2: {k: torch.from_numpy(v).to(dev)
                         for k, v in f.items()}}
        work = roofline.residual_work(log2, roofline.tu_counts(
            f["is_dst"], f["tskip"], f["bypass"]))
        s = 1 << log2
        for route, k1, _ in routes:
            ms = _time_ms(lambda: k1(groups), reps, cuda)
            row(f"idct{s}x{s}", route, ms, work, per_ctu, n_tu, "tu_per_s")
    ref, pos, ridx, mv = k2_inputs(rng, n_blocks)
    group = [(torch.from_numpy(ref).to(dev),
              *(torch.from_numpy(a).to(dev) for a in (pos, ridx, mv)), 4, 8)]
    work = k2_work(ref, pos, ridx, mv)
    for route, _, k2 in routes:
        ms = _time_ms(lambda: k2(group), reps, cuda)
        row("mc-luma-8tap", route, ms, work, MC_PER_CTU, n_blocks,
            "blocks_per_s")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("bench_kernels: no CUDA card; pass --device cpu",
                  file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              file=sys.stderr, flush=True)
    for rec in run(args.device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
