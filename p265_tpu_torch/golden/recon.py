"""Golden scalar reconstruction: FramePlan -> pre-filter YUV planes.

Inter prediction (MC from DPB reference pictures) is computed into prediction
planes up front -- it has no dependency on the current frame -- then the
sequential z-order TU walk adds residuals, with intra TUs predicting from
previously reconstructed samples as before.
"""
from __future__ import annotations

import numpy as np

from p265_tpu_torch.golden.intra import intra_predict_tu
from p265_tpu_torch.golden.inter import (combine_bi, combine_pu, combine_uni,
                                   mc_chroma, mc_luma)
from p265_tpu_torch.golden.transform import (dequant, inverse_transform,
                                       transform_skip_residual)
from p265_tpu_torch.syntax.ctu import FramePlan
from p265_tpu_torch.tables import chroma_qp_from_luma, clip3


def tu_qp(plan: FramePlan, c_idx: int, luma_qp: int) -> int:
    if c_idx == 0:
        return luma_qp
    off = (plan.pps.cb_qp_offset if c_idx == 1 else plan.pps.cr_qp_offset)
    off += (plan.sh.cb_qp_offset if c_idx == 1 else plan.sh.cr_qp_offset)
    return chroma_qp_from_luma(clip3(0, 57, luma_qp + off))


def build_inter_pred(plan: FramePlan, refs: dict) -> list[np.ndarray] | None:
    """MC prediction planes for every inter PU + raw PCM sample blocks.

    refs: poc -> [y, cb, cr].  PCM blocks execute in the no-dependency class
    (like MC): their samples are placed into the prediction planes and the
    TU records are pred_only."""
    pcm_tus = [t for t in plan.tus if t.pcm]
    if not plan.pus and not pcm_tus:
        return None
    sps = plan.sps
    w, h = sps.pic_width, sps.pic_height
    pred = [np.zeros((h, w), np.int32),
            np.zeros((h >> 1, w >> 1), np.int32),
            np.zeros((h >> 1, w >> 1), np.int32)]
    wt = None
    if ((plan.pps.weighted_pred and plan.sh.slice_type == 1)
            or (plan.pps.weighted_bipred and plan.sh.slice_type == 0)):
        wt = plan.sh.pred_weights
    for pu in plan.pus:
        m = pu.motion
        luma_parts = []
        chroma_parts = [[], []]
        for lx in range(2):
            if not m.uses(lx):
                continue
            ref_planes = refs[m.ref_poc[lx]]
            mvx, mvy = m.mv[lx]
            luma_parts.append(mc_luma(ref_planes[0], pu.x, pu.y, pu.w, pu.h,
                                      mvx, mvy))
            for ci in (1, 2):
                chroma_parts[ci - 1].append(
                    mc_chroma(ref_planes[ci], pu.x >> 1, pu.y >> 1,
                              pu.w >> 1, pu.h >> 1, mvx, mvy))
        py, pcb, pcr = combine_pu(luma_parts, chroma_parts[0],
                                  chroma_parts[1], m, wt)
        pred[0][pu.y:pu.y + pu.h, pu.x:pu.x + pu.w] = py
        cy, cx, cw, ch = pu.y >> 1, pu.x >> 1, pu.w >> 1, pu.h >> 1
        pred[1][cy:cy + ch, cx:cx + cw] = pcb
        pred[2][cy:cy + ch, cx:cx + cw] = pcr
    for t in pcm_tus:
        sz = 1 << t.log2
        pred[t.c_idx][t.y:t.y + sz, t.x:t.x + sz] = t.levels
    return pred


def reconstruct(plan: FramePlan, refs: dict | None = None) -> list[np.ndarray]:
    """Returns [y, cb, cr] int32 planes, pre-loop-filter."""
    sps = plan.sps
    w, h = sps.pic_width, sps.pic_height
    cw, ch = w >> 1, h >> 1
    planes = [np.zeros((h, w), np.int32),
              np.zeros((ch, cw), np.int32),
              np.zeros((ch, cw), np.int32)]
    avails = [np.zeros(((h + 3) >> 2, (w + 3) >> 2), bool),
              np.zeros(((ch + 3) >> 2, (cw + 3) >> 2), bool),
              np.zeros(((ch + 3) >> 2, (cw + 3) >> 2), bool)]
    inter_pred = build_inter_pred(plan, refs or {})
    cur_tile = 0
    cur_slice = 0
    for tu in plan.tus:
        if tu.tile != cur_tile or tu.slice_idx != cur_slice:
            # prediction never crosses tile or slice boundaries
            cur_tile = tu.tile
            cur_slice = tu.slice_idx
            for a in avails:
                a[:] = False
        reconstruct_tu(plan, tu, planes, avails, inter_pred)
    return planes


def reconstruct_tu(plan: FramePlan, tu, planes, avails, inter_pred=None) -> None:
    size = 1 << tu.log2
    plane = planes[tu.c_idx]
    avail = avails[tu.c_idx]
    if tu.is_inter:
        pred = inter_pred[tu.c_idx][tu.y:tu.y + size, tu.x:tu.x + size]
    else:
        pred = intra_predict_tu(plane, avail, tu.x, tu.y, size, tu.mode,
                                tu.c_idx, plan.sps.strong_intra_smoothing)
    if tu.pred_only:
        rec = pred
    elif tu.bypass:
        # transquant bypass: coded levels ARE the spatial residual (lossless)
        rec = np.clip(pred + tu.levels, 0, 255)
    else:
        qp = tu_qp(plan, tu.c_idx, tu.qp)
        sm = None
        if plan.scaling is not None and not tu.tskip:
            sm = plan.scaling[(tu.log2, tu.matrix_id)]
        d = dequant(tu.levels, qp, tu.log2, sm)
        if tu.tskip:
            res = transform_skip_residual(d)
        else:
            is_dst = (not tu.is_inter) and tu.c_idx == 0 and tu.log2 == 2
            res = inverse_transform(d, tu.log2, is_dst)
        rec = np.clip(pred + res, 0, 255)
    plane[tu.y:tu.y + size, tu.x:tu.x + size] = rec
    avail[tu.y >> 2:(tu.y + size) >> 2, tu.x >> 2:(tu.x + size) >> 2] = True
