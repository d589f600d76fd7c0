"""Stage B for a batch of same-resolution frames, end to end on the device.

Counterpart of p265_tpu/pipeline/batch_decode.py.  `build_batch` (host,
NumPy) packs the tensor plans into arrays; `decode_batch_planes` (device)
reproduces `_decode_batch_jit` step for step:

1. MC from device-resident uint8 reference slabs (kernels/mc.py), one
   kernel launch per frame, then the PCM samples scattered over the
   prediction (PCM TUs are pred-only inter TUs);
2. the residuals of every inter TU ("hoisted" out of the scan: they have
   no in-picture dependencies), one kernel launch for all TU sizes, with
   one scatter, then init = clip(pred + residual);
3. the residuals of the intra TUs (one launch), then the intra wavefront
   scan;
4. deblocking, vertical then horizontal (the vertical filter on the
   transposed planes);
5. SAO;
6. the restore of bypass (lossless) samples.

Plane layout: the F luma segments first, then F cb and F cr segments, each
h + GUARD rows high inside one tall plane.  The JAX package's per-dtype
pack/unpack buffers and power-of-two shape ladder worked around XLA
compile costs and have no counterpart here: arrays keep their exact shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p265_tpu_torch.golden.decoder import bypass_pixel_masks
from p265_tpu_torch.kernels import itransform
from p265_tpu_torch.kernels.loopfilter import (
    chroma_edge_params, deblock_chroma_vertical, deblock_luma_vertical,
    luma_edge_params, sao_apply, sao_maps)
from p265_tpu_torch.kernels.mc import mc_pred_planes, pcm_samples, uses_l1
from p265_tpu_torch.pipeline.wavefront import (
    GUARD, expand, merge_segments, scan_plane, stack_plane)

_SCAN_KEEP = ("pos", "step", "coeffs", "qp", "mode", "c_idx", "is_dst",
              "tskip", "has_res", "bypass", "scale_m", "inter",
              "filter_flag", "strong_allowed", "dc_edge", "ref_ys", "ref_xs",
              "ref_ok", "ok_scan")


def hoist_inter(merged) -> dict | None:
    """Pull every inter-predicted TU out of the wavefront scan.

    Inter TUs read no in-picture samples (their prediction is the MC
    plane), so they all sit at step 1; applying them in one pass before
    the scan keeps the dependency order (intra readers of inter samples sit
    at step >= 2) and leaves the scan intra-only.  Mutates merged.batches
    in place; returns {log2: dict(pos, coeffs, qp, tskip, bypass
    [, scale_m])} of the inter TUs, or None when there are none."""
    out = {}
    for log2, b in list(merged.batches.items()):
        m = np.asarray(b.inter)
        if not m.any():
            continue
        d = dict(pos=b.pos[m].astype(np.int64),
                 coeffs=b.coeffs[m].astype(np.int16),
                 qp=b.qp[m].astype(np.int32), tskip=b.tskip[m].astype(bool),
                 bypass=b.bypass[m].astype(bool))
        if b.scale_m is not None:
            d["scale_m"] = b.scale_m[m].astype(np.int32)
        out[log2] = d
        keep = ~m
        merged.batches[log2] = dataclasses.replace(
            b, **{f: (None if getattr(b, f) is None else getattr(b, f)[keep])
                  for f in _SCAN_KEEP})
    return out or None


def build_batch(tplans: list, plans: list, mc: list | None = None) -> dict:
    """Host: F frame plans of one resolution -> the batch's arrays.

    mc: optional per-frame list of kernels.mc.mc_arrays_padded dicts; each
    frame's prediction planes are then computed on the device from its
    reference slabs.  Returns a dict: "meta" (static shapes and flags),
    "tu" ({log2: scan fields + starts}), "n_steps", "itu" (hoisted inter
    TUs or None), "fp" (filter and mask arrays), "mc" and "pcm" (flat
    indices into the tall plane and samples of every PCM TU, or None)."""
    F = len(tplans)
    sps = plans[0].sps
    H, W = sps.pic_height, sps.pic_width
    Hc, Wc = H >> 1, W >> 1
    pps_ = ([tp.planes[0] for tp in tplans] + [tp.planes[1] for tp in tplans]
            + [tp.planes[2] for tp in tplans])
    merged = merge_segments(pps_)
    itu = hoist_inter(merged)
    tu = stack_plane(merged)

    # the batch is filtered with ONE set of flags
    sigs = {(p.sh.deblocking_filter_disabled,
             p.sps.sao_enabled and p.sh.sao_luma,
             p.sps.sao_enabled and p.sh.sao_chroma) for p in plans}
    if len(sigs) != 1:
        raise ValueError("build_batch: frames with different loop-filter "
                         f"flags in one batch: {sigs}")
    fp = {}
    deblock_on = not plans[0].sh.deblocking_filter_disabled
    if deblock_on:
        for vertical in (True, False):
            lp = [luma_edge_params(p, vertical) for p in plans]
            cp = [chroma_edge_params(p, vertical) for p in plans]
            key = "v" if vertical else "h"
            fp[f"bs_{key}"] = np.stack([x[0] for x in lp])
            fp[f"beta_{key}"] = np.stack([x[1] for x in lp])
            fp[f"tc_{key}"] = np.stack([x[2] for x in lp])
            fp[f"tcc_{key}"] = np.stack([x[0] for x in cp]
                                        + [x[1] for x in cp])
    sao_luma = bool(plans[0].sps.sao_enabled and plans[0].sh.sao_luma)
    sao_chroma = bool(plans[0].sps.sao_enabled and plans[0].sh.sao_chroma)
    for c, on in ((0, sao_luma), (1, sao_chroma)):
        if not on:
            continue
        # order matches the plane layout: lumas / all cb then all cr
        maps = [sao_maps(p, cc) for cc in ((0,) if c == 0 else (1, 2))
                for p in plans]
        for i, name in enumerate(("ty", "cls", "off")):
            fp[f"sao_{name}_{c}"] = np.stack([m[i] for m in maps])

    masks = [bypass_pixel_masks(p) for p in plans]
    has_masks = any(m is not None for m in masks)
    if has_masks:
        fp["mask_y"] = np.stack([(m[0] if m is not None
                                  else np.zeros((H, W), bool))
                                 for m in masks])
        fp["mask_c"] = np.stack([(m[c] if m is not None
                                  else np.zeros((Hc, Wc), bool))
                                 for c in (1, 2) for m in masks])

    seg_h, seg_hc = H + GUARD, Hc + GUARD
    stamps = [st for f, p in enumerate(plans) if (st := pcm_samples(
        p, segment_rows(F, f, seg_h, seg_hc), merged.shape[1])) is not None]
    pcm = (None if not stamps else
           tuple(np.concatenate(a) for a in zip(*stamps)))

    meta = dict(F=F, shape=merged.shape, seg_h=seg_h, seg_hc=seg_hc,
                H=H, W=W, Hc=Hc, Wc=Wc, deblock=deblock_on,
                sao_luma=sao_luma, sao_chroma=sao_chroma,
                ctb=sps.ctb_size, has_masks=has_masks)
    return dict(meta=meta, tu=tu, n_steps=merged.n_steps, itu=itu, fp=fp,
                mc=mc, pcm=pcm)


def segment_rows(F: int, f: int, seg_h: int, seg_hc: int) -> tuple:
    """First rows of frame f's y, cb and cr segments in the tall plane."""
    return (f * seg_h, F * seg_h + f * seg_hc, F * seg_h + (F + f) * seg_hc)


def upload(tree, device):
    """A dict tree of NumPy arrays -> the same tree of tensors on device."""
    if isinstance(tree, dict):
        return {k: upload(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def init_plane(itu, pred, shape, device):
    """Device: the plane [rows, pw] int32 before the scan.  The residuals
    of the hoisted inter TUs (itu: hoist_inter's dict as device tensors,
    or None) in one K1 launch for all sizes and one scatter, then
    clip(pred + residual) everywhere; intra regions get values that the
    scan overwrites."""
    plane = torch.zeros(shape, dtype=torch.int32, device=device)
    if itu is None:
        return plane
    pw = shape[1]
    res = itransform.batch_residual_grouped(itu)
    idx, val = [], []
    for log2, d in itu.items():
        ar = torch.arange(1 << log2, device=device)
        idx.append(((d["pos"][:, 0, None, None] + ar[None, :, None]) * pw
                    + d["pos"][:, 1, None, None]
                    + ar[None, None, :]).reshape(-1))
        val.append(res[log2].reshape(-1))
    res_plane = torch.zeros_like(plane).view(-1)
    res_plane[torch.cat(idx)] = torch.cat(val)
    base = pred if pred is not None else plane
    return (base + res_plane.view(shape)).clamp(0, 255)


def decode_batch_planes(batch: dict, refs, device):
    """Device: one batch -> (pre_luma [F,H,W], pre_chroma [2F,Hc,Wc], luma,
    chroma), uint8 tensors on `device` (chroma: F cb planes, then F cr).

    refs: None, or per frame a 3-tuple of uint8 reference stacks [R,H,W]
    (y, cb, cr) on `device`, for the frames' MC."""
    device = torch.device(device)
    m = batch["meta"]
    F, H, W, Hc, Wc = m["F"], m["H"], m["W"], m["Hc"], m["Wc"]
    seg_h, seg_hc = m["seg_h"], m["seg_hc"]
    total_h, pw = m["shape"]
    i32 = torch.int32
    fp = upload(batch["fp"], device)

    # 1. MC prediction planes at each frame's segment offsets, one grouped
    #    MC launch per frame; has_bi comes from the host arrays, so no sync;
    #    then the PCM samples, one scatter over them
    pred = None
    if batch["mc"] is not None or batch["pcm"] is not None:
        pred = torch.zeros((total_h + GUARD, pw), dtype=i32, device=device)
    if batch["mc"] is not None:
        shapes = ((H, W), (Hc, Wc), (Hc, Wc))
        for f, (fmc, rf) in enumerate(zip(batch["mc"], refs)):
            planes = mc_pred_planes(rf, upload(fmc, device), shapes,
                                    uses_l1(fmc))
            offs = segment_rows(F, f, seg_h, seg_hc)
            for oy, (h, w), p in zip(offs, shapes, planes):
                pred[oy:oy + h, :w] = p
    if batch["pcm"] is not None:
        idx, val = (upload(a, device) for a in batch["pcm"])
        pred.view(-1)[idx] = val

    # 2. hoisted inter TUs
    itu = None if batch["itu"] is None else upload(batch["itu"], device)
    plane = init_plane(itu, pred, (total_h + GUARD, pw), device)

    # 3. intra residuals + wavefront scan
    tu = batch["tu"]
    starts = {log2: d["starts"] for log2, d in tu.items()}
    stacked = expand({log2: upload({k: v for k, v in d.items()
                                     if k != "starts"}, device)
                      for log2, d in tu.items()}, pw)
    plane = scan_plane(stacked, starts, batch["n_steps"], plane)

    # split the tall plane (F*seg_h + 2F*seg_hc rows, the guard included)
    # into [F] luma and [2F] chroma batches
    luma = plane[:F * seg_h].reshape(F, seg_h, pw)[:, :H, :W]
    chroma = plane[F * seg_h:].reshape(2 * F, seg_hc, pw)[:, :Hc, :Wc]
    pre_luma, pre_chroma = luma, chroma

    # 4. deblocking: vertical edges, then horizontal on the transposes
    if m["deblock"]:
        for key in ("v", "h"):
            if key == "h":
                luma, chroma = luma.transpose(1, 2), chroma.transpose(1, 2)
            bs = fp[f"bs_{key}"]
            if bs.shape[2]:
                luma = deblock_luma_vertical(luma, bs, fp[f"beta_{key}"],
                                             fp[f"tc_{key}"])
            tcc = fp[f"tcc_{key}"]
            if tcc.shape[2]:
                chroma = deblock_chroma_vertical(chroma, tcc)
            if key == "h":
                luma, chroma = luma.transpose(1, 2), chroma.transpose(1, 2)
    # 5. SAO
    if m["sao_luma"]:
        luma = sao_apply(luma, fp["sao_ty_0"], fp["sao_cls_0"],
                         fp["sao_off_0"], m["ctb"])
    if m["sao_chroma"]:
        chroma = sao_apply(chroma, fp["sao_ty_1"], fp["sao_cls_1"],
                           fp["sao_off_1"], m["ctb"] >> 1)
    # 6. bypass samples keep their pre-filter values
    if m["has_masks"]:
        luma = torch.where(fp["mask_y"], pre_luma, luma)
        chroma = torch.where(fp["mask_c"], pre_chroma, chroma)
    u8 = torch.uint8
    return (pre_luma.to(u8), pre_chroma.to(u8), luma.contiguous().to(u8),
            chroma.contiguous().to(u8))
