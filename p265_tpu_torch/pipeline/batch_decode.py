"""Stage B for a batch of same-resolution frames, end to end on the device.

Counterpart of p265_tpu/pipeline/batch_decode.py.  `build_batch` (host,
NumPy) packs the tensor plans into arrays; `decode_batch_planes` (device)
reproduces `_decode_batch_jit` step for step:

1. MC from device-resident uint8 reference slabs (kernels/mc.py), one
   kernel launch per frame that writes the finished samples into the
   frame's segments of the tall prediction plane, then the PCM samples
   scattered over the prediction (PCM TUs are pred-only inter TUs);
2. the residuals of every inter TU ("hoisted" out of the scan: they have
   no in-picture dependencies), one kernel launch for all TU sizes that
   adds each residual to the prediction at its TU and clips, in place
   (init = clip(pred + residual));
3. the residuals of the intra TUs (one launch), then the intra wavefront
   scan;
4. deblocking, vertical then horizontal (the vertical filter on the
   transposed planes);
5. SAO, whose launch also restores the bypass (lossless) samples and
   writes the uint8 output (steps 4-5 are kernels/loopfilter.py
   `filter_planes`).

Plane layout: the F luma segments first, then F cb and F cr segments, each
h + GUARD rows high inside one tall plane.  The batch's arrays travel at
the reference's narrow wire dtypes and reach the device in ONE copy a
dispatch (kernels/staging.py), the reference's "one dispatch (a few
per-dtype uploads)", and the kernels read them at those dtypes; its
per-dtype buffer layout and power-of-two shape
ladder worked around XLA compile costs and have no counterpart here:
arrays keep their exact shapes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from p265_tpu_torch.kernels.loopfilter import (filter_flags, filter_planes,
                                               pack_filter_params)
from p265_tpu_torch.kernels.mc import mc_pred_planes, pcm_samples, uses_l1
from p265_tpu_torch.kernels.staging import stage
from p265_tpu_torch.pipeline.wavefront import (
    GUARD, attached_pred, hoist_inter, merge_segments, run_scan, scan_fields,
    segment_offsets, stack_plane, step_starts)


def _add(stats, key: str, seconds: float) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + seconds


def build_batch(tplans: list, plans: list, mc: list | None = None,
                stats: dict | None = None) -> dict:
    """Host: F frame plans of one resolution -> the batch's arrays.

    mc: optional per-frame list of kernels.mc.mc_arrays_padded dicts; each
    frame's prediction planes are then computed on the device from its
    reference slabs.  Without mc, a tensor plan's attached prediction
    planes (PlanePlan.inter_pred) are taken.  Returns a dict: "meta" (static shapes and flags), "tu"
    ({log2: scan fields + starts}), "n_steps", "itu"
    (hoisted inter TUs or None), "fp" (filter and mask arrays; the batch is
    filtered with ONE set of flags, so pictures whose flags differ raise),
    "mc", "pcm" (flat indices into the tall plane and samples of every PCM
    TU, or None) and "attached" (the PlanePlans and their segment offsets,
    for their inter_pred).  stats: optional dict accumulating pack_s."""
    t0 = time.perf_counter()
    F = len(tplans)
    sps = plans[0].sps
    H, W = sps.pic_height, sps.pic_width
    Hc, Wc = H >> 1, W >> 1
    pps_ = ([tp.planes[0] for tp in tplans] + [tp.planes[1] for tp in tplans]
            + [tp.planes[2] for tp in tplans])
    merged = merge_segments(pps_)
    itu = hoist_inter(merged)
    fp = pack_filter_params(plans)
    deblock_on, sao_luma, sao_chroma = filter_flags(plans[0])

    seg_h, seg_hc = H + GUARD, Hc + GUARD
    stamps = [st for f, p in enumerate(plans) if (st := pcm_samples(
        p, segment_rows(F, f, seg_h, seg_hc), merged.shape[1])) is not None]
    pcm = (None if not stamps else
           tuple(np.concatenate(a) for a in zip(*stamps)))

    meta = dict(F=F, shape=merged.shape, seg_h=seg_h, seg_hc=seg_hc,
                H=H, W=W, Hc=Hc, Wc=Wc, deblock=deblock_on,
                sao_luma=sao_luma, sao_chroma=sao_chroma,
                ctb=sps.ctb_size, has_masks="mask_y" in fp)
    batch = dict(meta=meta, tu=stack_plane(merged), n_steps=merged.n_steps,
                 itu=itu, fp=fp, mc=mc, pcm=pcm,
                 attached=(pps_, segment_offsets(pps_)))
    _add(stats, "pack_s", time.perf_counter() - t0)
    return batch


def segment_rows(F: int, f: int, seg_h: int, seg_hc: int) -> tuple:
    """First rows of frame f's y, cb and cr segments in the tall plane."""
    return (f * seg_h, F * seg_h + f * seg_hc, F * seg_h + (F + f) * seg_hc)


def decode_batch_planes(batch: dict, refs, device,
                        stats: dict | None = None):
    """Device: one batch -> (pre_luma [F,H,W], pre_chroma [2F,Hc,Wc], luma,
    chroma), uint8 tensors on `device` (chroma: F cb planes, then F cr).

    refs: None, or per frame a 3-tuple of uint8 reference stacks [R,H,W]
    (y, cb, cr) on `device`, for the frames' MC; the stacks of different
    frames may differ in length.  stats: optional dict accumulating
    stage()'s upload_s, h2d_bytes and h2d_copies (every array of the
    batch, the scan's step starts included, in one copy) and dispatch_s
    (the host time of enqueueing the device work)."""
    device = torch.device(device)
    m = batch["meta"]
    F, H, W, Hc, Wc = m["F"], m["H"], m["W"], m["Hc"], m["Wc"]
    seg_h, seg_hc = m["seg_h"], m["seg_hc"]
    total_h, pw = m["shape"]
    shape = (total_h + GUARD, pw)
    tu, starts = scan_fields(batch["tu"])
    dev = stage(dict(fp=batch["fp"], mc=batch["mc"], pcm=batch["pcm"],
                     itu=batch["itu"], tu=tu,
                     starts=step_starts(starts, batch["n_steps"])),
                device, stats)
    t1 = time.perf_counter()

    # 1. MC prediction planes at each frame's segment offsets: one MC
    #    launch per frame writes the frame's samples straight into the tall
    #    plane; has_bi comes from the host arrays, so no sync; then the PCM
    #    samples, one scatter over them.  MC owns its frames' segments:
    #    where an attached prediction lies under them (no decoder path
    #    attaches one to a frame with device MC), they are zeroed first
    pred = attached_pred(*batch["attached"], shape, device)
    attached = pred is not None
    if pred is None and (dev["mc"] is not None or dev["pcm"] is not None):
        pred = torch.zeros(shape, dtype=torch.int32, device=device)
    if dev["mc"] is not None:
        shapes = ((H, W), (Hc, Wc), (Hc, Wc))
        for f, (fmc, rf) in enumerate(zip(dev["mc"], refs)):
            offs = segment_rows(F, f, seg_h, seg_hc)
            if attached:
                for oy, (h, w) in zip(offs, shapes):
                    pred[oy:oy + h, :w] = 0
            mc_pred_planes(rf, fmc, shapes, uses_l1(batch["mc"][f]),
                           out=(pred, offs))
    if dev["pcm"] is not None:
        idx, val = dev["pcm"]
        pred.view(-1)[idx] = val

    # 2.-3. hoisted inter TUs, intra residuals, wavefront scan
    plane = run_scan(dev["itu"], dev["tu"], starts, batch["n_steps"], pred,
                     shape, device, starts_dev=dev["starts"])

    # split the tall plane (F*seg_h + 2F*seg_hc rows, the guard included)
    # into [F] luma and [2F] chroma batches
    pre_luma = plane[:F * seg_h].reshape(F, seg_h, pw)[:, :H, :W]
    pre_chroma = plane[F * seg_h:].reshape(2 * F, seg_hc, pw)[:, :Hc, :Wc]

    # 4.-5. deblocking, SAO with the bypass samples, uint8 out
    luma, chroma = filter_planes(pre_luma, pre_chroma, dev["fp"], m["ctb"])
    out = (pre_luma.to(torch.uint8), pre_chroma.to(torch.uint8), luma,
           chroma)
    _add(stats, "dispatch_s", time.perf_counter() - t1)
    return out


def decode_batch(tplans: list, plans: list, device):
    """Convenience: -> (prefilter, filtered), per frame [y, cb, cr] uint8
    tensors on `device` (chroma order restored); inter pictures carry
    their prediction planes in their tensor plans.  Counterpart of
    p265_tpu.pipeline.batch_decode.decode_batch."""
    F = len(tplans)
    pl, pc, fl, fc = decode_batch_planes(build_batch(tplans, plans), None,
                                         device)
    pre = [[pl[f], pc[f], pc[F + f]] for f in range(F)]
    filt = [[fl[f], fc[f], fc[F + f]] for f in range(F)]
    return pre, filt
