"""Where the time of one decode goes, on a CUDA card.

    python -m p265_tpu_torch.profile_decode [--stream s1080_ra8.265]
        [--frame-dag-max 4] [--json stages.json]

The stream is a file of p265_tpu_torch/data (default s1080_ldp4.265).
After one warm-up pass it prints:

1. per dispatch (a picture, or a frame-DAG group of pictures) and per
   Stage-B stage, the wall time of TorchDecoder with the device
   synchronised after every stage (so each stage's host and device time
   are charged to it; the sum is a serial decode), and the dispatch's
   h2d copies and bytes (stats["h2d_copies"], stats["h2d_bytes"]);
2. for PipelinedTorchDecoder, a torch.profiler window over one whole pass:
   wall time, device time (the sum of kernel and copy time), the device's
   idle share, the number of device operations, the top kernels, and the
   host-to-device copies with the device ms of each, in order (one a
   dispatch: the h2d device ms of each dispatch), the motion replay: the
   PUs it derived (stats["replay_pus"]), the bi-predicted ones
   (replay_bi_pus) and its `finalize` span, the pictures with TMVP on
   (tmvp_pictures), and the MC pack: its blocks (mc_blocks, mc_bi_blocks),
   the reference pictures it stacked (ref_pictures, ref_stack_bytes), its
   `mc_pack` and `ref_stack` spans and the pictures it packed straight
   from the motion replay's PU table (mc_table_pictures).

--json writes the stage table's sums over the dispatches of the stages
that p265_tpu_torch.roofline counts as a whole, {stage: seconds a pass}
(mc, scan, deblock, sao), for `python -m p265_tpu_torch.roofline <stream>
stages.json`.  The residual stage has no column: "intra residual" times
the scan TUs' K1 call only; the hoisted inter TUs' call is in "rest".
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time

import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# a column of the stage table -> the roofline stage it times as a whole
ROOFLINE_STAGES = {"MC": "mc", "scan": "scan", "deblock": "deblock",
                   "SAO": "sao"}


def _stage_table(data: bytes, dag: int) -> dict:
    from p265_tpu_torch.kernels import loopfilter as lf
    from p265_tpu_torch.pipeline import batch_decode as bd
    from p265_tpu_torch.pipeline import decoder as dm
    from p265_tpu_torch.pipeline import wavefront as wf
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
              (dm, "mc_arrays", "MC pack"),
              (dm, "build_batch", "batch pack"),
              (bd, "stage", "upload"),
              (bd, "mc_pred_planes", "MC"),
              (wf, "expand", "intra residual"),
              (wf, "scan_plane", "scan"),
              (lf, "deblock_planes", "deblock"),
              (lf, "sao_apply", "SAO")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in stages]
    for m, n, label in stages:
        setattr(m, n, timed(label, getattr(m, n)))
    rows = []
    orig_run = dm.TorchDecoder._run_recon_group

    def run(self, tasks):
        # the tensor plans were built while the stream was parsed, before
        # the group was closed: their time is already in acc
        torch.cuda.synchronize()
        h2d = self.stats["h2d_copies"], self.stats["h2d_bytes"]
        t0 = time.perf_counter()
        orig_run(self, tasks)
        rows.append(("+".join(str(t["plan"].poc) for t in tasks),
                     "BPI"[tasks[0]["plan"].sh.slice_type], steps[-1],
                     time.perf_counter() - t0 + acc["tensor plan"],
                     dict(acc), self.stats["h2d_copies"] - h2d[0],
                     self.stats["h2d_bytes"] - h2d[1]))
        acc.clear()

    dm.TorchDecoder._run_recon_group = run
    try:
        dm.TorchDecoder("cuda", frame_dag_max=dag).decode_stream(data)
    finally:
        dm.TorchDecoder._run_recon_group = orig_run
        for m, n, f in saved:
            setattr(m, n, f)
    labels = list(dict.fromkeys(label for _, _, label in stages))
    print(f"serial TorchDecoder(frame_dag_max={dag}), device synchronised "
          "after every stage (s):")
    print("pocs kind steps total " + " | ".join(labels)
          + " | rest | h2d copies | h2d bytes")
    for poc, kind, n_steps, total, a, copies, nbytes in rows:
        parts = [a.get(lb, 0.0) for lb in labels]
        print(f"{poc} {kind} {n_steps} {total:.4f} "
              + " | ".join(f"{p:.4f}" for p in parts)
              + f" | {total - sum(parts):.4f} | {copies} | {nbytes}")
    return {st: sum(r[4].get(label, 0.0) for r in rows)
            for label, st in ROOFLINE_STAGES.items()}


def _profile_window(data: bytes, dag: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    dec = PipelinedTorchDecoder("cuda", frame_dag_max=dag)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode_stream(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device-side copies of record_function ranges are not work
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in dev)
    n_ops = sum(e.count for e in dev)
    print(f"pipelined pass under torch.profiler: wall {wall:.4f} s, device "
          f"time {dev_us / 1e6:.4f} s over {n_ops} device operations, "
          f"idle share {1 - dev_us / 1e6 / wall:.4f}")
    print("top device operations (self device ms, count):")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} {e.count:7d}  "
              f"{e.key[:90]}")
    h2d = h2d_copies(prof)
    print(f"host-to-device copies: {len(h2d)}, {sum(h2d):.4f} device ms; "
          "each, in order: " + " ".join(f"{ms:.4f}" for ms in h2d))
    st = dec.stats
    print(f"motion replay (native, in C): {st['replay_pus']} PUs "
          f"({st['replay_bi_pus']} bi-predicted), finalize "
          f"{st['finalize_s'] * 1e3:.2f} ms wall, "
          f"{st['finalize_cpu_s'] * 1e3:.2f} ms thread CPU; "
          f"{st['tmvp_pictures']} pictures with TMVP")
    print(f"MC pack: {st['mc_blocks']} blocks ({st['mc_bi_blocks']} with a "
          f"second list), {st['ref_pictures']} reference pictures stacked "
          f"({st['ref_stack_bytes']} bytes); mc_pack "
          f"{st['mc_pack_s'] * 1e3:.2f} ms wall, ref_stack "
          f"{st['ref_stack_s'] * 1e3:.2f} ms wall; "
          f"{st['mc_table_pictures']} pictures packed from the replay's "
          "PU table")


def h2d_copies(prof) -> list:
    """Device ms of each host-to-device copy of a torch.profiler window,
    in the order they ran."""
    from torch.autograd import DeviceType
    ev = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "HtoD" in e.name),
                key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in ev]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stream", default="s1080_ldp4.265")
    ap.add_argument("--frame-dag-max", type=int, default=1)
    ap.add_argument("--json", help="write {roofline stage: seconds a "
                    "pass} here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    with open(os.path.join(DATA, args.stream), "rb") as f:
        data = f.read()
    PipelinedTorchDecoder("cuda").decode_stream(data)   # warm-up
    print(f"{args.stream}, frame_dag_max={args.frame_dag_max}")
    sums = _stage_table(data, args.frame_dag_max)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(sums, f)
    _profile_window(data, args.frame_dag_max)


if __name__ == "__main__":
    main()
