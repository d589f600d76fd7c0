"""Batched intra prediction (spec 8.4.4.2) as one matrix product per TU.

Counterpart of p265_tpu/kernels/intra.py (`filter_refs`, `predict_batch`) and
p265_tpu/kernels/intra_mxu.py (`a_table`, `predict_values`).  Every mode is
linear in the (filtered) reference samples, so per (mode, size) an integer
matrix A [s*s, 4s+3] over v = [left(0..2s), top(0..2s), 1] gives
pred = (A @ v) >> shift with all spec rounding folded into the constant
column; the DC/vertical/horizontal edge filters and the reference smoothing
stay vector ops.  The JAX package ran this as XLA, so it is plain torch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from p265_tpu_torch.tables import INTRA_ANGLE, INV_ANGLE

_ANGLE = np.zeros(35, np.int64)
_ANGLE[2:] = INTRA_ANGLE
_INV = np.zeros(35, np.int64)
_INV[11:26] = INV_ANGLE


def _angular_ext_weights(s: int, angle: int, k: int) -> np.ndarray:
    """Weights over the extended reference (positions 0..3s+1, base=s) for
    one angular mode, in main-axis layout [s*s (y-major), 3s+2]."""
    base = s
    W = np.zeros((s * s, 3 * s + 2), np.int64)
    for y in range(1, s + 1):
        idx = (y * angle) >> 5
        fact = (y * angle) & 31
        for x in range(s):
            i1 = min(max(base + x + idx + 1, 0), 3 * s)
            i2 = min(i1 + 1, 3 * s + 1)
            r = (y - 1) * s + x
            W[r, i1] += (32 - fact) * k
            W[r, i2] += fact * k
    return W


def _ext_to_v(s: int, inv: int, main_off: int, side_off: int) -> np.ndarray:
    """Map extended-ref positions to v entries: ext[s+j] = main[j]
    (j = 0..2s); ext[0..s-1] = side[...] by inverse-angle projection."""
    base = s
    E = np.zeros((3 * s + 2, 4 * s + 3), np.int64)
    for j in range(2 * s + 1):
        E[base + j, main_off + j] = 1
    for i in range(s):
        side_idx = min(max(((i - s) * inv + 128) >> 8, 0), 2 * s)
        E[i, side_off + side_idx] = 1
    return E


@functools.lru_cache(maxsize=None)
def a_table(size: int) -> np.ndarray:
    """[35, s*s, 4s+3] int16 prediction matrices; v = [left, top, 1]."""
    s = size
    R = 4 * s + 3
    shift = 6 if s == 32 else 5
    k = 1 << (shift - 5)              # angular scale
    log2s = int(np.log2(s))
    kp = 1 << (shift - log2s - 1)     # planar/DC scale
    L, T, C = 0, 2 * s + 1, 4 * s + 2
    A = np.zeros((35, s * s, R), np.int64)

    # mode 0, planar: ((s-1-x)*left[1+y] + (x+1)*top[s+1]
    #   + (s-1-y)*top[1+x] + (y+1)*left[s+1] + s) >> (log2s+1)
    for y in range(s):
        for x in range(s):
            r = y * s + x
            A[0, r, L + 1 + y] += (s - 1 - x) * kp
            A[0, r, T + s + 1] += (x + 1) * kp
            A[0, r, T + 1 + x] += (s - 1 - y) * kp
            A[0, r, L + s + 1] += (y + 1) * kp
            A[0, r, C] += s * kp

    # mode 1, DC interior: (sum(left[1..s]) + sum(top[1..s]) + s)
    #   >> (log2s+1); the luma edges are patched in predict_from_refs
    for j in range(1, s + 1):
        A[1, :, L + j] = kp
        A[1, :, T + j] = kp
    A[1, :, C] = s * kp

    # modes 2..34, angular: vertical family (>= 18) has main = top, side =
    # left; the horizontal family is computed on main = left and transposed
    for m in range(2, 35):
        angle, inv = int(_ANGLE[m]), int(_INV[m])
        W = _angular_ext_weights(s, angle, k)
        if m >= 18:
            Am = W @ _ext_to_v(s, inv, main_off=T, side_off=L)
        else:
            At = W @ _ext_to_v(s, inv, main_off=L, side_off=T)
            Am = At.reshape(s, s, R).transpose(1, 0, 2).reshape(s * s, R)
        Am[:, C] += 16 * k                   # angular rounding constant
        A[m] = Am

    # |A| <= 128 and row sums <= 96: with refs <= 255 every float32
    # partial sum of A @ v is an integer below 2^24, hence exact
    assert np.abs(A).max() <= 128 and A.min() >= 0
    assert A.sum(axis=2).max() <= 96
    return A.astype(np.int16)


@functools.lru_cache(maxsize=None)
def _a_f32(size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a_table(size).astype(np.float32)).to(device)


def filter_refs(left, top, size: int, filter_flag, strong_allowed):
    """[1 2 1] + strong (32x32) smoothing.  left/top: [n, 2s+1] int32."""
    n2 = 2 * size
    fl, ft = left.clone(), top.clone()
    fl[:, 1:n2] = (left[:, 0:n2 - 1] + 2 * left[:, 1:n2]
                   + left[:, 2:n2 + 1] + 2) >> 2
    ft[:, 1:n2] = (top[:, 0:n2 - 1] + 2 * top[:, 1:n2]
                   + top[:, 2:n2 + 1] + 2) >> 2
    corner = (left[:, 1] + 2 * left[:, 0] + top[:, 1] + 2) >> 2
    fl[:, 0] = corner
    ft[:, 0] = corner
    if size == 32:
        thresh = 1 << 3  # 1 << (bit_depth - 5)
        flat_h = (top[:, 0] + top[:, n2] - 2 * top[:, size]).abs() < thresh
        flat_v = (left[:, 0] + left[:, n2] - 2 * left[:, size]).abs() < thresh
        strong = strong_allowed & flat_h & flat_v
        i = torch.arange(n2 + 1, dtype=torch.int32, device=left.device)[None]
        sl = ((n2 - i) * left[:, 0:1] + i * left[:, n2:n2 + 1] + size) >> 6
        st = ((n2 - i) * top[:, 0:1] + i * top[:, n2:n2 + 1] + size) >> 6
        sl[:, 0], sl[:, n2] = left[:, 0], left[:, n2]
        st[:, 0], st[:, n2] = top[:, 0], top[:, n2]
        fl = torch.where(strong[:, None], sl, fl)
        ft = torch.where(strong[:, None], st, ft)
    use = filter_flag[:, None]
    return torch.where(use, fl, left), torch.where(use, ft, top)


def predict_from_refs(refs, mode, filter_flag, strong_allowed, size: int,
                      c_idx: int, dc_edge=None):
    """Intra prediction [n, s, s] int32 from gathered reference samples.

    refs [n, 2(2s+1)] int32: left(0..2s) then top(0..2s), index 0 the
    corner.  c_idx 0 applies the luma smoothing and edge filters, gated per
    TU by filter_flag and dc_edge (so one call serves luma and chroma)."""
    s = size
    nref = 2 * s + 1
    shift = 6 if s == 32 else 5
    left, top = refs[:, :nref], refs[:, nref:]
    if c_idx == 0:
        left, top = filter_refs(left, top, s, filter_flag, strong_allowed)
    n = mode.shape[0]
    v = torch.cat([left, top, torch.ones_like(left[:, :1])], 1)
    A = _a_f32(s, refs.device)[mode.long()]        # [n, s*s, 4s+3]
    acc = torch.bmm(A, v.to(torch.float32)[:, :, None])[:, :, 0]
    pred = (acc.to(torch.int32) >> shift).reshape(n, s, s)

    if c_idx == 0 and s < 32:
        edge = (torch.ones_like(mode, dtype=torch.bool) if dc_edge is None
                else dc_edge)
        # DC edge filters: dc equals any interior sample of the DC matrix
        dc = pred[:, 1, 1].clone()
        row0 = (top[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        corner = (left[:, 1] + 2 * dc + top[:, 1] + 2) >> 2
        is_dc = ((mode == 1) & edge)[:, None]
        pred[:, 0, 1:] = torch.where(is_dc, row0, pred[:, 0, 1:])
        pred[:, 1:, 0] = torch.where(is_dc, col0, pred[:, 1:, 0])
        pred[:, 0, 0] = torch.where(is_dc[:, 0], corner, pred[:, 0, 0])
        # vertical (26) / horizontal (10) edges on unfiltered refs
        # (filter_flag is False for modes 10/26)
        v_col = (top[:, 1][:, None]
                 + ((left[:, 1:s + 1] - left[:, 0][:, None]) >> 1)
                 ).clamp(0, 255)
        h_row = (left[:, 1][:, None]
                 + ((top[:, 1:s + 1] - top[:, 0][:, None]) >> 1)
                 ).clamp(0, 255)
        pred[:, :, 0] = torch.where(((mode == 26) & edge)[:, None], v_col,
                                    pred[:, :, 0])
        pred[:, 0, :] = torch.where(((mode == 10) & edge)[:, None], h_row,
                                    pred[:, 0, :])
    return pred


def predict_values(plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
                   strong_allowed, residual, size: int, c_idx: int,
                   inter=None, pred_plane=None, dc_edge=None):
    """One wavefront step of one size bucket, without the plane scatter.

    plane [Hp, W] int32; pos [n,2] (y, x); ref_* [n, 2(2s+1)]; mode [n];
    residual [n,s,s]; inter [n] bool takes the prediction from pred_plane.
    Returns (rows, cols, out) for the caller's merged scatter.  Gather
    indices are clamped into the plane, as the reference's gathers are."""
    s = size
    H, W = plane.shape
    ys = ref_ys.long().clamp(0, H - 1)
    xs = ref_xs.long().clamp(0, W - 1)
    refs = torch.where(ref_ok, plane[ys, xs], 128)
    pred = predict_from_refs(refs, mode, filter_flag, strong_allowed, s,
                             c_idx, dc_edge)
    ar = torch.arange(s, device=plane.device)
    rows = pos[:, 0].long()[:, None, None] + ar[None, :, None]
    cols = pos[:, 1].long()[:, None, None] + ar[None, None, :]
    if inter is not None and pred_plane is not None:
        ph, pw = pred_plane.shape
        mc = pred_plane[rows.clamp(0, ph - 1), cols.clamp(0, pw - 1)]
        pred = torch.where(inter[:, None, None], mc, pred)
    out = (pred + residual).clamp(0, 255)
    return rows, cols, out


def predict_batch(plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
                  strong_allowed, residual, size: int, c_idx: int,
                  inter=None, pred_plane=None, dc_edge=None):
    """predict_values + the scatter into the plane, one call: a new plane,
    the input is not modified.  Counterpart of the JAX package's
    kernels/intra.py predict_batch and kernels/intra_mxu.py
    predict_batch_mxu, which give the same integers by two routes; the
    port has the one exact route of predict_from_refs."""
    rows, cols, out = predict_values(
        plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
        strong_allowed, residual, size, c_idx, inter=inter,
        pred_plane=pred_plane, dc_edge=dc_edge)
    plane = plane.clone()
    plane[rows, cols] = out
    return plane
