"""Golden SAO filter (spec 8.7.3): band offset + edge offset per CTU.

Reads deblocked samples (including neighbors across CTU edges) and writes a
separate surface, as the spec requires.
"""
from __future__ import annotations

import numpy as np

from p265_tpu_torch.syntax.ctu import SAO_BAND, SAO_EDGE, FramePlan

# EO class -> (neighbor0 dy,dx ; neighbor1 dy,dx)
_EO_NEIGHBORS = {
    0: ((0, -1), (0, 1)),     # horizontal
    1: ((-1, 0), (1, 0)),     # vertical
    2: ((-1, -1), (1, 1)),    # 135 degrees
    3: ((-1, 1), (1, -1)),    # 45 degrees
}


def _sao_component(src: np.ndarray, out: np.ndarray, x0: int, y0: int,
                   w: int, h: int, ty: int, cls: int, offsets: list[int]) -> None:
    blk = src[y0:y0 + h, x0:x0 + w].astype(np.int32)
    if ty == SAO_BAND:
        band = blk >> 3  # 8-bit: 32 bands
        res = blk.copy()
        for i in range(4):
            b = (cls + i) & 31
            res = np.where(band == b, blk + offsets[i], res)
        out[y0:y0 + h, x0:x0 + w] = np.clip(res, 0, 255)
        return
    # edge offset
    (dy0, dx0), (dy1, dx1) = _EO_NEIGHBORS[cls]
    H, W = src.shape
    yy, xx = np.mgrid[y0:y0 + h, x0:x0 + w]
    n0y, n0x = yy + dy0, xx + dx0
    n1y, n1x = yy + dy1, xx + dx1
    valid = ((n0y >= 0) & (n0y < H) & (n0x >= 0) & (n0x < W)
             & (n1y >= 0) & (n1y < H) & (n1x >= 0) & (n1x < W))
    n0 = src[np.clip(n0y, 0, H - 1), np.clip(n0x, 0, W - 1)].astype(np.int32)
    n1 = src[np.clip(n1y, 0, H - 1), np.clip(n1x, 0, W - 1)].astype(np.int32)
    s0 = np.sign(blk - n0)
    s1 = np.sign(blk - n1)
    edge = s0 + s1
    res = blk.copy()
    # categories: edge==-2 -> cat1; -1 -> cat2; +1 -> cat3; +2 -> cat4
    for cat, cond in ((0, edge == -2), (1, edge == -1), (2, edge == 1),
                      (3, edge == 2)):
        res = np.where(cond & valid, blk + offsets[cat], res)
    out[y0:y0 + h, x0:x0 + w] = np.clip(res, 0, 255)


def sao_picture(plan: FramePlan, planes: list[np.ndarray]) -> list[np.ndarray]:
    sps, sh = plan.sps, plan.sh
    outs = [p.copy() for p in planes]
    ctb = sps.ctb_size
    for ctb_addr, rec in enumerate(plan.sao):
        xc = (ctb_addr % sps.pic_width_ctbs) * ctb
        yc = (ctb_addr // sps.pic_width_ctbs) * ctb
        for c in range(3):
            if c == 0 and not sh.sao_luma:
                continue
            if c > 0 and not sh.sao_chroma:
                continue
            ty = rec.type[c]
            if ty == 0:
                continue
            if c == 0:
                x0, y0 = xc, yc
                w = min(ctb, sps.pic_width - x0)
                h = min(ctb, sps.pic_height - y0)
            else:
                x0, y0 = xc >> 1, yc >> 1
                w = min(ctb >> 1, (sps.pic_width >> 1) - x0)
                h = min(ctb >> 1, (sps.pic_height >> 1) - y0)
            _sao_component(planes[c], outs[c], x0, y0, w, h, ty,
                           rec.cls[c], rec.offsets[c])
    return outs
