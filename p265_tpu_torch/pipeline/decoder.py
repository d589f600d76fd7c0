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

from p265_tpu_torch.golden.decoder import DecoderBase
from p265_tpu_torch.kernels.loopfilter import filter_flags
from p265_tpu_torch.kernels.mc import mc_arrays, ref_stacks
from p265_tpu_torch.pipeline.batch_decode import (build_batch,
                                                  decode_batch_planes)
from p265_tpu_torch.plan.frame_plan import build_tensor_plan
from p265_tpu_torch.spans import span

# the spans of TorchDecoder.stats (spans.py), by the one thread that
# writes each: the caller's (the parse thread) finalize and tensor_plan;
# the recon worker mc_pack, ref_stack (inside mc_pack), pack, edge_params
# (inside pack: the deblocking grids), upload and dispatch; the fetch (the
# fetch worker in PipelinedTorchDecoder, the recon worker here) fetch
SPANS = ("finalize", "tensor_plan", "mc_pack", "ref_stack", "pack",
         "edge_params", "upload", "dispatch", "fetch")
# the counters, by the one thread that writes each: the parse thread's
# replay_pus and replay_bi_pus (the PUs the native motion replay derived,
# and those with both ref_idx >= 0) and tmvp_pictures (pictures whose
# slices have TMVP on); the recon worker's mc_blocks and mc_bi_blocks (the
# MC blocks mc_arrays packed, and those with a second list),
# ref_pictures and ref_stack_bytes (the reference pictures stacked for
# K2, and the stacks' bytes) and mc_table_pictures (the pictures packed
# straight from the motion replay's PU table, not from PuRec objects)
COUNTERS = ("replay_pus", "replay_bi_pus", "tmvp_pictures", "mc_blocks",
            "mc_bi_blocks", "ref_pictures", "ref_stack_bytes",
            "mc_table_pictures")


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

    Every picture, and every frame-DAG group, is reconstructed by one
    batch_decode pass (`_dispatch_group`).  The options have TpuDecoder's
    meaning.  apply_filters=False returns the prefilter planes: the batch
    is packed with no filter stage, so no deblocking or SAO kernel runs.
    use_native_parse=False takes the Python CTU parse instead of the C one.
    frame_dag_max > 1 batches up to that many mutually independent inter
    pictures into one pass (plan_frame_groups).  It is 1 by default.
    filters_on_device is accepted as True only, the value that the
    benchmark's configurations (decode_bench/configs) pass: the filters
    run on `device`, and the host filters have no path here.

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
                 use_native_parse: bool = True, frame_dag_max: int = 1,
                 error_resilient: bool = False, *,
                 filters_on_device: bool = True):
        if filters_on_device is not True:
            raise TypeError("TorchDecoder: the loop filters run on the "
                            "decoder's device only (filters_on_device=True)")
        super().__init__(apply_filters=apply_filters,
                         error_resilient=error_resilient,
                         use_native_parse=use_native_parse)
        self.device = torch.device(device)
        # the intra A-table product (kernels/intra.py) is exact only in
        # full float32: TF32 would round the 8-bit reference samples
        torch.backends.cuda.matmul.allow_tf32 = False
        self.frame_dag_max = frame_dag_max
        self._open: list = []       # the open frame-DAG group
        # every key exists before the first picture, and each is written
        # by one thread only; queue_wait_s (the recon worker's) sums each
        # picture's wait for the recon worker, 0 where nothing queues;
        # edge_params_c_pictures (the recon worker's) counts the pictures
        # whose deblocking grids the C call derived (native/deblock.py)
        self.stats.update({k + sfx: 0.0 for k in SPANS
                           for sfx in ("_s", "_cpu_s")})
        self.stats.update(queue_wait_s=0.0, h2d_bytes=0, h2d_copies=0,
                          edge_params_c_pictures=0)
        self.stats.update({k: 0 for k in COUNTERS})

    def _finish_picture(self) -> None:
        """DecoderBase's, with the motion replay and the SAO records
        (`finalize`, idempotent) run first inside the `finalize` span; an
        incomplete picture goes straight to DecoderBase, which raises."""
        pic_st = self._pic
        ns = None if pic_st is None else getattr(pic_st["plan"], "nstate",
                                                  None)
        if ns is not None and pic_st["ctbs"] == pic_st["sps"].num_ctbs:
            try:
                with span(self.stats, "finalize"):
                    ns.finalize(pic_st["plan"], pic_st["mctx"])
                self.stats["replay_pus"] += getattr(ns, "replayed_pus", 0)
                self.stats["replay_bi_pus"] += getattr(ns, "replayed_bi_pus",
                                                       0)
            except BaseException:
                self._pic = None    # as DecoderBase drops it
                raise
        if (pic_st is not None and pic_st["ctbs"] == pic_st["sps"].num_ctbs
                and pic_st["plan"].sh.temporal_mvp_enabled):
            self.stats["tmvp_pictures"] += 1
        super()._finish_picture()

    def _build_tplan(self, plan):
        ns = getattr(plan, "nstate", None)
        if ns is not None:
            ns.finalize(plan)  # plan.sao must exist before filter packing
        with span(self.stats, "tensor_plan"):
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
        """Pack + enqueue the device work of F pictures as ONE batch; fills
        each pic.planes (device slabs) and frame.prefilter.
        Every picture keeps its own reference stacks and MC block arrays;
        the merged tall plane carries all 3F segments through one scan and
        one filter pass."""
        F = len(tasks)
        plans = [t["plan"] for t in tasks]
        tplans = [t["tplan"] for t in tasks]
        mc = refs = None
        st = self.stats
        if any(p.pus for p in plans):
            mc, refs = [], []
            with span(st, "mc_pack"):
                for t, plan in zip(tasks, plans):
                    poc_list = sorted(t["refs"])
                    mc.append(mc_arrays(plan, poc_list))
                    with span(st, "ref_stack"):
                        refs.append(ref_stacks(
                            {p: r.planes for p, r in t["refs"].items()},
                            poc_list, self.device))
            # counted outside the span, so that mc_pack_s times the pack
            blocks = [d["has1"] for arrays in mc for grp in arrays.values()
                      for d in grp.values()]
            st["mc_blocks"] += sum(len(b) for b in blocks)
            st["mc_bi_blocks"] += sum(int(np.count_nonzero(b))
                                      for b in blocks)
            st["ref_pictures"] += sum(len(t["refs"]) for t in tasks)
            st["ref_stack_bytes"] += sum(s.nbytes for r in refs for s in r)
            st["mc_table_pictures"] += sum(
                getattr(p.pus, "table", None) is not None for p in plans)
        batch = build_batch(tplans, plans, mc=mc, stats=self.stats,
                            filters=self.apply_filters)
        pl, pc, fl, fc = decode_batch_planes(batch, refs, self.device,
                                             stats=self.stats)
        for f, t in enumerate(tasks):
            t["pic"].planes = [fl[f], fc[f], fc[F + f]]
            t["frame"].prefilter = [pl[f], pc[f], pc[F + f]]

    def _run_recon(self, task: dict) -> None:
        """DecoderBase's hook: a group of one."""
        self._run_recon_group([task])

    def _run_recon_group(self, tasks: list) -> None:
        """A frame-DAG group (plan_frame_groups; one picture where nothing
        batches) in ONE pass, then each picture's fetch; recon_s times the
        pack and dispatch, and a group of two or more counts its pictures
        in dag_batched."""
        t0 = time.perf_counter()
        self._dispatch_group(tasks)
        self.stats["recon_s"] += time.perf_counter() - t0
        for t in tasks:
            self._fetch(t)
        if len(tasks) > 1:
            self.stats["dag_batched"] = (self.stats.get("dag_batched", 0)
                                         + len(tasks))

    def _fetch(self, task: dict) -> None:
        """The picture's output planes to the host (frame.planes)."""
        with span(self.stats, "fetch"):
            task["frame"].planes = fetch_planes(task["pic"].planes)


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
