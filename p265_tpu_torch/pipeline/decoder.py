"""Torch decoder: Stage A host parse -> Stage B reconstruction on a device.

Counterpart of p265_tpu/pipeline/decoder.py `TpuDecoder`.  It subclasses
the shared DecoderBase (parsing, DPB, motion context, error resilience,
checkpoint/resume, metrics) and reconstructs each picture, or each group of
mutually independent pictures, with one pipeline/batch_decode pass.  The
DPB slabs (`pic.planes`) are uint8 tensors that stay on the device, so the
next picture's MC reads them with no host round trip; `frame.planes` are
host int32 arrays and `frame.prefilter` stays on the device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from p265_tpu_torch.golden.decoder import DecoderBase, apply_loop_filters
from p265_tpu_torch.kernels.loopfilter import filter_flags, loop_filters
from p265_tpu_torch.kernels.mc import (mc_arrays_padded, mc_block_counts,
                                       ref_stacks)
from p265_tpu_torch.pipeline.batch_decode import (build_batch,
                                                  decode_batch_planes)
from p265_tpu_torch.pipeline.wavefront import reconstruct_scan
from p265_tpu_torch.plan.frame_plan import (attach_pred_planes,
                                            build_tensor_plan)


def slabs_from_numpy(planes, device) -> list:
    """[y, cb, cr] sample planes (numpy, any integer type, values 0..255)
    -> the port's DPB slabs: uint8 tensors on `device`."""
    return [torch.from_numpy(np.ascontiguousarray(p, dtype=np.uint8)).to(
        device) for p in planes]


def _batchable(plan) -> bool:
    """An inter picture without PCM CUs (build_tensor_plan has set
    _has_pcm): intra pictures and pictures with PCM go alone."""
    return bool(plan.pus) and not getattr(plan, "_has_pcm", False)


def _joins(group: list, task: dict, max_f: int) -> bool:
    """Whether `task` may join the open `group` of the frame DAG."""
    plan, first = task["plan"], group[0]["plan"]
    return (len(group) < max_f and _batchable(plan) and _batchable(first)
            and plan.sps == first.sps
            and filter_flags(plan) == filter_flags(first)
            and all(g["frame"].poc not in task["refs"] for g in group))


def plan_frame_groups(tasks, max_f: int = 4) -> list:
    """Frame-DAG scheduler: partition a decode-order task list into groups
    of MUTUALLY INDEPENDENT inter pictures that can share ONE Stage-B pass
    on the batch axis: hierarchical-B siblings whose references all lie
    outside the group (a random-access mini-GOP decodes 0, 4, 2 and then
    batches {1, 3}).  Counterpart of the JAX package's plan_frame_groups,
    with its rule.

    A task joins the open group iff: it is an inter picture without PCM,
    same SPS and filter flags as the group, its DPB reference set contains
    no group member's POC, and the group stays within max_f.  Groups
    preserve decode order, so every reference outside the group is already
    reconstructed when the group runs.  The rule looks only at the open
    group and the next task, so it can run while the stream is parsed
    (TorchDecoder._schedule_recon) and give the same groups."""
    groups: list[list] = []
    for t in tasks:
        if groups and _joins(groups[-1], t, max_f):
            groups[-1].append(t)
        else:
            groups.append([t])
    return groups


class TorchDecoder(DecoderBase):
    """Annex-B stream -> YUV frames, reconstructed on `device` ("cuda" by
    default; "cuda:1", "cpu", ...).  Bit-exact vs GoldenDecoder.  On a
    machine without a CUDA card the default device fails in torch at the
    first decode, with no fallback: ask for "cpu" there.

    The options have TpuDecoder's meaning.  fused (default): one
    batch_decode pass per picture does reconstruction and filters.
    fused=False: `_reconstruct` (pipeline/wavefront reconstruct_scan, MC
    through attach_pred_planes) and then `_filters`: loop_filters on the
    device, or with filters_on_device=False the golden apply_loop_filters
    on the host.  apply_filters=False returns the prefilter planes (and
    implies the unfused path, as does filters_on_device=False).
    use_native_parse=False takes the Python CTU parse instead of the C one.
    frame_dag_max > 1 batches up to that many mutually independent inter
    pictures into one pass (plan_frame_groups; fused path only).  It is 1
    by default.

    TpuDecoder's use_mxu, shape_policy and calibrate_frames have no
    counterpart: the port has one exact intra route and runs exact shapes
    with nothing to compile, so there is no calibration window either.  A
    group is therefore closed by the rule alone: the parse runs ahead of
    the reconstruction by at most the open group (fewer than frame_dag_max
    pictures), and the groups of a stream are the same on every run.

    error_resilient, errors, save_state/load_state and write_metrics are
    DecoderBase's; save_state first finishes every picture in flight.
    """

    def __init__(self, device="cuda", apply_filters: bool = True,
                 filters_on_device: bool = True,
                 use_native_parse: bool = True, fused: bool = True,
                 frame_dag_max: int = 1, error_resilient: bool = False):
        super().__init__(apply_filters=apply_filters,
                         error_resilient=error_resilient,
                         use_native_parse=use_native_parse)
        self.device = torch.device(device)
        # the intra A-table product (kernels/intra.py) is exact only in
        # full float32: TF32 would round the 8-bit reference samples
        torch.backends.cuda.matmul.allow_tf32 = False
        self.filters_on_device = filters_on_device
        self.fused = fused and apply_filters and filters_on_device
        self.frame_dag_max = frame_dag_max if self.fused else 1
        self._open: list = []       # the open frame-DAG group
        self.stats.update(fetch_s=0.0, h2d_bytes=0, h2d_copies=0)

    def _build_tplan(self, plan):
        ns = getattr(plan, "nstate", None)
        if ns is not None:
            ns.finalize(plan)  # plan.sao must exist before filter packing
        return build_tensor_plan(plan, skip_pred=True)

    # -- scheduling: the frame DAG, grouped while the stream is parsed ------
    def _schedule_recon(self, task: dict) -> None:
        task["tplan"] = self._build_tplan(task["plan"])
        if self._open and not _joins(self._open, task, self.frame_dag_max):
            self._close_group()
        self._open.append(task)
        if (len(self._open) >= self.frame_dag_max
                or not _batchable(task["plan"])):
            self._close_group()     # nothing can join it any more

    def _close_group(self) -> None:
        group, self._open = self._open, []
        if group:
            self._emit_group(group)

    def _emit_group(self, group: list) -> None:
        self._run_recon_group(group)

    def _drain_recon(self) -> None:
        self._close_group()

    def save_state(self) -> dict:
        """DecoderBase's state, taken after every scheduled picture has
        been reconstructed and fetched: the DPB then holds finished slabs
        and frames only.  The decoder goes on decoding afterwards.

        The native parse keeps a picture's C-side records in ctypes
        buffers (plan.nstate), which cannot be copied; nothing reads them
        once the picture is reconstructed, so the saved frames go without
        them."""
        self._drain_recon()
        held = []
        if self.dpb is not None:
            for pic in self.dpb.pics + self.dpb.outputs:
                plan = pic.user.plan
                if getattr(plan, "nstate", None) is not None:
                    held.append((plan, plan.nstate))
                    plan.nstate = None
        try:
            return super().save_state()
        finally:
            for plan, ns in held:
                plan.nstate = ns

    # -- reconstruction ------------------------------------------------------
    def _dispatch_group(self, tasks: list) -> None:
        """Fused path: pack + enqueue the device work of F pictures as ONE
        batch; fills each pic.planes (device slabs) and frame.prefilter.
        Every picture keeps its own reference stacks and MC block arrays;
        the merged tall plane carries all 3F segments through one scan and
        one filter pass."""
        F = len(tasks)
        plans = [t["plan"] for t in tasks]
        tplans = [t["tplan"] for t in tasks]
        mc = refs = None
        if any(p.pus for p in plans):
            mc, refs = [], []
            for t, plan in zip(tasks, plans):
                poc_list = sorted(t["refs"])
                mc.append(mc_arrays_padded(
                    plan, {p: i for i, p in enumerate(poc_list)},
                    mc_block_counts(plan)))
                refs.append(ref_stacks(
                    {p: r.planes for p, r in t["refs"].items()}, poc_list,
                    self.device))
        batch = build_batch(tplans, plans, mc=mc, stats=self.stats)
        pl, pc, fl, fc = decode_batch_planes(batch, refs, self.device,
                                             stats=self.stats)
        for f, t in enumerate(tasks):
            t["pic"].planes = [fl[f], fc[f], fc[F + f]]
            t["frame"].prefilter = [pl[f], pc[f], pc[F + f]]

    def _reconstruct(self, plan, refs: dict, tplan=None) -> list:
        """Unfused path: the picture's prefilter planes, int32 tensors on
        the device (MC through K2, residuals through K1, one merged
        scan)."""
        if tplan is None:
            tplan = self._build_tplan(plan)
        attach_pred_planes(tplan, refs, self.device)
        return reconstruct_scan(tplan, self.device)

    def _filters(self, plan, planes: list) -> list:
        """Unfused path: prefilter planes (device tensors) -> filtered
        planes (device tensors, or host arrays from the host filters)."""
        if self.filters_on_device:
            return loop_filters(plan, planes, self.device)
        return apply_loop_filters(plan, [p.cpu().numpy() for p in planes])

    def _dispatch_unfused(self, task: dict) -> float:
        """Per-stage path of one picture; returns the filters' seconds."""
        plan, frame, pic = task["plan"], task["frame"], task["pic"]
        refs = {p: r.planes for p, r in task["refs"].items()}
        planes = prefilter = self._reconstruct(plan, refs,
                                               tplan=task.get("tplan"))
        t0 = time.perf_counter()
        if self.apply_filters:
            planes = self._filters(plan, prefilter)
        frame.prefilter = prefilter
        if isinstance(planes[0], torch.Tensor):
            pic.planes = [p.to(torch.uint8) for p in planes]
        else:
            pic.planes = slabs_from_numpy(planes, self.device)
        return time.perf_counter() - t0

    def _run_recon(self, task: dict) -> None:
        t0 = time.perf_counter()
        filter_s = 0.0
        if self.fused:
            self._dispatch_group([task])
        else:
            filter_s = self._dispatch_unfused(task)
        self.stats["filter_s"] += filter_s
        self.stats["recon_s"] += time.perf_counter() - t0 - filter_s
        self._fetch(task)

    def _run_recon_group(self, tasks: list) -> None:
        """Frame-DAG batch: F mutually independent inter pictures in ONE
        pass (plan_frame_groups); a group of one is a plain _run_recon."""
        if len(tasks) == 1 or not self.fused:
            for t in tasks:
                self._run_recon(t)
            return
        t0 = time.perf_counter()
        self._dispatch_group(tasks)
        self.stats["recon_s"] += time.perf_counter() - t0
        for t in tasks:
            self._fetch(t)
        self.stats["dag_batched"] = (self.stats.get("dag_batched", 0)
                                     + len(tasks))

    def _fetch(self, task: dict) -> None:
        """The picture's output planes to the host (frame.planes)."""
        t0 = time.perf_counter()
        task["frame"].planes = fetch_planes(task["pic"].planes)
        self.stats["fetch_s"] += time.perf_counter() - t0


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
