"""Where the time of one s1080_ldp4 decode goes, on a CUDA card.

    python -m p265_tpu_torch.profile_decode

After one warm-up pass it prints:

1. per picture and per Stage-B stage, the wall time of TorchDecoder with
   the device synchronised after every stage (so each stage's host and
   device time are charged to it; the sum is a serial decode);
2. for PipelinedTorchDecoder, a torch.profiler window over one whole pass:
   wall time, device time (the sum of kernel and copy time), the device's
   idle share, the number of device operations, and the top kernels.
"""
from __future__ import annotations

import collections
import os
import time

import torch

STREAM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "s1080_ldp4.265")


def _stage_table(data: bytes) -> None:
    from p265_tpu_torch.pipeline import batch_decode as bd
    from p265_tpu_torch.pipeline import decoder as dm
    acc = collections.defaultdict(float)
    steps = []

    def timed(name, fn):
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            if name == "scan":
                steps.append(a[2])
            return r
        return f

    stages = [(dm, "build_tensor_plan", "tensor plan"),
              (dm, "mc_arrays_padded", "MC pack"),
              (dm, "build_batch", "batch pack"),
              (bd, "upload", "upload"),
              (bd, "mc_pred_planes", "MC"),
              (bd, "expand", "intra residual"),
              (bd, "scan_plane", "scan"),
              (bd, "deblock_luma_vertical", "deblock"),
              (bd, "deblock_chroma_vertical", "deblock"),
              (bd, "sao_apply", "SAO")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in stages]
    for m, n, label in stages:
        setattr(m, n, timed(label, getattr(m, n)))
    rows = []
    orig_run = dm.TorchDecoder._run_recon

    def run(self, task):
        acc.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_run(self, task)
        rows.append((task["plan"].poc, bool(task["plan"].pus), steps[-1],
                     time.perf_counter() - t0, dict(acc)))

    dm.TorchDecoder._run_recon = run
    try:
        dm.TorchDecoder("cuda").decode_stream(data)
    finally:
        dm.TorchDecoder._run_recon = orig_run
        for m, n, f in saved:
            setattr(m, n, f)
    labels = list(dict.fromkeys(label for _, _, label in stages))
    print("serial TorchDecoder, device synchronised after every stage (s):")
    print("poc kind steps total " + " | ".join(labels) + " | rest")
    for poc, inter, n_steps, total, a in rows:
        parts = [a.get(lb, 0.0) for lb in labels]
        print(f"{poc} {'P' if inter else 'I'} {n_steps} {total:.4f} "
              + " | ".join(f"{p:.4f}" for p in parts)
              + f" | {total - sum(parts):.4f}")


def _profile_window(data: bytes) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    dec = PipelinedTorchDecoder("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode_stream(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    n_ops = sum(e.count for e in dev)
    print(f"pipelined pass under torch.profiler: wall {wall:.4f} s, device "
          f"time {dev_us / 1e6:.4f} s over {n_ops} device operations, "
          f"idle share {1 - dev_us / 1e6 / wall:.4f}")
    print("top device operations (self device ms, count):")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} {e.count:7d}  "
              f"{e.key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    with open(STREAM, "rb") as f:
        data = f.read()
    PipelinedTorchDecoder("cuda").decode_stream(data)   # warm-up
    _stage_table(data)
    _profile_window(data)


if __name__ == "__main__":
    main()
