"""Golden inter prediction: MC interpolation + uni/bi combination (spec 8.5.4).

8-tap luma quarter-pel, 4-tap chroma eighth-pel, separable H-then-V with
14-bit intermediates; edge-clamped reference fetch.  Oracle for
p265_tpu.kernels.mc.
"""
from __future__ import annotations

import numpy as np

from decode_bench.reference.tables import CHROMA_FILTER, LUMA_FILTER

BIT_DEPTH = 8
SHIFT1 = BIT_DEPTH - 8 + 6            # 6: after H filter
SHIFT2 = 6                            # after V filter (14-bit intermediate)
OFFSET_UNI = 1 << (14 - BIT_DEPTH - 1)
SHIFT_UNI = 14 - BIT_DEPTH
OFFSET_BI = 1 << (15 - BIT_DEPTH - 1)
SHIFT_BI = 15 - BIT_DEPTH


def fetch_ref_window(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
                     pad_l: int, pad_t: int, pad_r: int, pad_b: int
                     ) -> np.ndarray:
    """Edge-clamped window [(h+pad_t+pad_b), (w+pad_l+pad_r)] starting at
    (x0-pad_l, y0-pad_t) in ref."""
    H, W = ref.shape
    ys = np.clip(np.arange(y0 - pad_t, y0 + h + pad_b), 0, H - 1)
    xs = np.clip(np.arange(x0 - pad_l, x0 + w + pad_r), 0, W - 1)
    return ref[np.ix_(ys, xs)]


def mc_luma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
            mv_x: int, mv_y: int) -> np.ndarray:
    """Quarter-pel luma MC -> 14-bit intermediate [h, w] int32 (pre-rounding)."""
    ix, fx = mv_x >> 2, mv_x & 3
    iy, fy = mv_y >> 2, mv_y & 3
    win = fetch_ref_window(ref, x0 + ix, y0 + iy, w, h, 3, 3, 4, 4).astype(np.int64)
    # separable: H filter then V filter (integer positions fall out of the
    # generic path because filter[0] = [0,0,0,64,0,0,0,0])
    fh = LUMA_FILTER[fx].astype(np.int64)
    tmp = sum(fh[k] * win[:, k:k + w] for k in range(8))      # [h+7, w]
    tmp = tmp >> (BIT_DEPTH - 8)                               # shift1 = bd-8
    fv = LUMA_FILTER[fy].astype(np.int64)
    out = sum(fv[k] * tmp[k:k + h, :] for k in range(8)) >> 6
    return out.astype(np.int32)


def mc_chroma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
              mv_x: int, mv_y: int) -> np.ndarray:
    """Eighth-pel chroma MC -> 14-bit intermediate [h, w] int32."""
    ix, fx = mv_x >> 3, mv_x & 7
    iy, fy = mv_y >> 3, mv_y & 7
    win = fetch_ref_window(ref, x0 + ix, y0 + iy, w, h, 1, 1, 2, 2).astype(np.int64)
    fh = CHROMA_FILTER[fx].astype(np.int64)
    tmp = sum(fh[k] * win[:, k:k + w] for k in range(4))
    tmp = tmp >> (BIT_DEPTH - 8)
    fv = CHROMA_FILTER[fy].astype(np.int64)
    out = sum(fv[k] * tmp[k:k + h, :] for k in range(4)) >> 6
    return out.astype(np.int32)


def combine_uni(pred: np.ndarray) -> np.ndarray:
    """14-bit intermediate -> 8-bit samples: (p + 32) >> 6, clipped."""
    return np.clip((pred + OFFSET_UNI) >> SHIFT_UNI, 0, 255).astype(np.int32)


def combine_bi(pred0: np.ndarray, pred1: np.ndarray) -> np.ndarray:
    """Bi-prediction average: (a + b + 64) >> 7, clipped."""
    s = pred0.astype(np.int64) + pred1.astype(np.int64)
    return np.clip((s + OFFSET_BI) >> SHIFT_BI, 0, 255).astype(np.int32)


def combine_uni_weighted(pred: np.ndarray, w: int, o: int, log2_denom: int
                         ) -> np.ndarray:
    """Explicit weighted uni-prediction (spec 8.5.4.2.3)."""
    log2_wd = log2_denom + (14 - BIT_DEPTH)
    p = pred.astype(np.int64) * w
    if log2_wd >= 1:
        p = (p + (1 << (log2_wd - 1))) >> log2_wd
    return np.clip(p + o, 0, 255).astype(np.int32)


def combine_bi_weighted(p0: np.ndarray, p1: np.ndarray, w0: int, o0: int,
                        w1: int, o1: int, log2_denom: int) -> np.ndarray:
    """Explicit weighted bi-prediction (spec 8.5.4.2.3)."""
    log2_wd = log2_denom + (14 - BIT_DEPTH)
    s = (p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
         + ((o0 + o1 + 1) << log2_wd))
    return np.clip(s >> (log2_wd + 1), 0, 255).astype(np.int32)


def combine_pu(luma_parts, cb_parts, cr_parts, motion, wt):
    """Combine per-list 14-bit MC intermediates for one PU.

    wt: WeightTable or None (default prediction).  Returns (y, cb, cr)."""
    used = [lx for lx in range(2) if motion.uses(lx)]
    if wt is None:
        if len(used) == 2:
            return (combine_bi(*luma_parts), combine_bi(*cb_parts),
                    combine_bi(*cr_parts))
        return (combine_uni(luma_parts[0]), combine_uni(cb_parts[0]),
                combine_uni(cr_parts[0]))
    ents = [wt.get(lx, motion.ref_idx[lx]) for lx in used]
    if len(used) == 2:
        e0, e1 = ents
        return (
            combine_bi_weighted(luma_parts[0], luma_parts[1], e0[0], e0[1],
                                e1[0], e1[1], wt.luma_log2_denom),
            combine_bi_weighted(cb_parts[0], cb_parts[1], e0[2], e0[3],
                                e1[2], e1[3], wt.chroma_log2_denom),
            combine_bi_weighted(cr_parts[0], cr_parts[1], e0[4], e0[5],
                                e1[4], e1[5], wt.chroma_log2_denom))
    e = ents[0]
    return (combine_uni_weighted(luma_parts[0], e[0], e[1], wt.luma_log2_denom),
            combine_uni_weighted(cb_parts[0], e[2], e[3], wt.chroma_log2_denom),
            combine_uni_weighted(cr_parts[0], e[4], e[5], wt.chroma_log2_denom))
