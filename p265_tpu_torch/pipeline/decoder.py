"""Torch decoder: Stage A host parse -> Stage B reconstruction on a device.

Counterpart of p265_tpu/pipeline/decoder.py `TpuDecoder` (its fused path).
It subclasses the shared DecoderBase (parsing, DPB, motion context) and
reconstructs each picture with one pipeline/batch_decode pass.  The DPB
slabs (`pic.planes`) are uint8 tensors that stay on the device, so the next
picture's MC reads them with no host round trip; `frame.planes` are host
int32 arrays and `frame.prefilter` stays on the device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from p265_tpu_torch.golden.decoder import DecoderBase
from p265_tpu_torch.plan.frame_plan import build_tensor_plan
from p265_tpu_torch.kernels.mc import (mc_arrays_padded, mc_block_counts,
                                       ref_stacks)
from p265_tpu_torch.pipeline.batch_decode import (build_batch,
                                                  decode_batch_planes)


def slabs_from_numpy(planes, device) -> list:
    """[y, cb, cr] sample planes (numpy, any integer type, values 0..255)
    -> the port's DPB slabs: uint8 tensors on `device`."""
    return [torch.from_numpy(np.ascontiguousarray(p, dtype=np.uint8)).to(
        device) for p in planes]


class TorchDecoder(DecoderBase):
    """Annex-B stream -> YUV frames, reconstructed on `device` ("cuda",
    "cuda:1", "cpu", ...).  Bit-exact vs GoldenDecoder."""

    def __init__(self, device):
        super().__init__(use_native_parse=True)
        self.device = torch.device(device)
        # the intra A-table product (kernels/intra.py) is exact only in
        # full float32: TF32 would round the 8-bit reference samples
        torch.backends.cuda.matmul.allow_tf32 = False
        self.stats["fetch_s"] = 0.0

    def _build_tplan(self, plan):
        ns = getattr(plan, "nstate", None)
        if ns is not None:
            ns.finalize(plan)  # plan.sao must exist before filter packing
        return build_tensor_plan(plan, skip_pred=True)

    def _dispatch(self, task: dict) -> None:
        """Pack + enqueue one picture's device work; fills pic.planes
        (device slabs) and frame.prefilter."""
        plan, frame, pic = task["plan"], task["frame"], task["pic"]
        tplan = task.get("tplan") or self._build_tplan(plan)
        mc = refs = None
        if plan.pus:
            poc_list = sorted(task["refs"])
            mc = [mc_arrays_padded(plan,
                                   {p: i for i, p in enumerate(poc_list)},
                                   mc_block_counts(plan))]
            refs = [ref_stacks({p: r.planes for p, r in task["refs"].items()},
                               poc_list, self.device)]
        batch = build_batch([tplan], [plan], mc=mc)
        pl, pc, fl, fc = decode_batch_planes(batch, refs, self.device)
        pic.planes = [fl[0], fc[0], fc[1]]
        frame.prefilter = [pl[0], pc[0], pc[1]]

    def _run_recon(self, task: dict) -> None:
        t0 = time.perf_counter()
        self._dispatch(task)
        t1 = time.perf_counter()
        task["frame"].planes = fetch_planes(task["pic"].planes)
        self.stats["recon_s"] += t1 - t0
        self.stats["fetch_s"] += time.perf_counter() - t1


def fetch_planes(planes, event=None, stream=None) -> list:
    """Device uint8 planes -> host int32 arrays.

    On CUDA with an event, the copy waits for that event on `stream` (into
    pinned memory), so it overlaps device work enqueued after the event."""
    if event is None:
        return [p.cpu().numpy().astype(np.int32) for p in planes]
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                for p in planes]
        for h, p in zip(host, planes):
            h.copy_(p, non_blocking=True)
    stream.synchronize()
    return [h.numpy().astype(np.int32) for h in host]
