"""Golden scalar intra prediction: 35 modes + reference handling (spec 8.4.4.2).

Oracle for p265_tpu.kernels.intra.  Operates on one TU at a time with numpy
int32; bit-exact per spec.
"""
from __future__ import annotations

import numpy as np

from decode_bench.reference.tables import INTRA_ANGLE, INTRA_HOR_VER_DIST_THRES, INV_ANGLE

INTRA_PLANAR = 0
INTRA_DC = 1


def gather_references(pic: np.ndarray, avail: np.ndarray, x0: int, y0: int,
                      size: int, bit_depth: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Reference sample gathering + substitution (spec 8.4.4.2.2).

    pic: full-plane reconstructed (pre-filter) samples, int32 [H, W]
    avail: per-sample availability map is expensive; instead callers pass a
           boolean function-of-block grid via `avail[y, x]` at SAMPLE level?
           We take avail as a per-4x4-block boolean grid [H/4, W/4] marking
           "already reconstructed and in same slice/tile".
    Returns (left_col[2*size+1], top_row[2*size+1]) where index 0 of each is
    the corner p[-1][-1]: left[i] = p[-1][i-1] (top->bottom), top[j] = p[j-1][-1].
    Layout used onward: ref[0] = corner; left[1..2N] downward; top[1..2N] rightward.
    """
    n = size
    h, w = pic.shape

    def sample_avail(x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= w or y >= h:
            return False
        return bool(avail[y >> 2, x >> 2])

    # collect in spec search order: p[-1][2N-1] ... p[-1][-1], then p[0..2N-1][-1]
    coords = ([(x0 - 1, y0 + i) for i in range(2 * n - 1, -1, -1)]
              + [(x0 - 1, y0 - 1)]
              + [(x0 + i, y0 - 1) for i in range(2 * n)])
    vals = np.empty(4 * n + 1, dtype=np.int32)
    ok = np.empty(4 * n + 1, dtype=bool)
    for i, (x, y) in enumerate(coords):
        a = sample_avail(x, y)
        ok[i] = a
        vals[i] = pic[min(max(y, 0), h - 1), min(max(x, 0), w - 1)] if a else 0
    if not ok.any():
        vals[:] = 1 << (bit_depth - 1)
    else:
        if not ok[0]:
            first = int(np.argmax(ok))
            vals[0] = vals[first]
            ok[0] = True
        for i in range(1, 4 * n + 1):
            if not ok[i]:
                vals[i] = vals[i - 1]
    # repackage: coords order is bottom-left upward; build left/top arrays
    # left[0]=corner, left[1..2N]=p[-1][0..2N-1]; top[0]=corner, top[1..2N]
    corner = vals[2 * n]
    left = np.empty(2 * n + 1, dtype=np.int32)
    top = np.empty(2 * n + 1, dtype=np.int32)
    left[0] = corner
    left[1:] = vals[2 * n - 1::-1]  # reverse of bottom-up -> top-down
    top[0] = corner
    top[1:] = vals[2 * n + 1:]
    return left, top


def filter_references(left: np.ndarray, top: np.ndarray, size: int, mode: int,
                      strong_smoothing: bool, bit_depth: int = 8
                      ) -> tuple[np.ndarray, np.ndarray]:
    """[1 2 1] smoothing + optional strong (bilinear) smoothing (8.4.4.2.3)."""
    if mode == INTRA_DC or size == 4:
        return left, top
    min_dist = min(abs(mode - 26), abs(mode - 10))
    if min_dist <= INTRA_HOR_VER_DIST_THRES.get(size, 10):
        return left, top
    n = size
    if size == 32 and strong_smoothing:
        thresh = 1 << (bit_depth - 5)
        flat_h = abs(int(top[0]) + int(top[2 * n]) - 2 * int(top[n])) < thresh
        flat_v = abs(int(left[0]) + int(left[2 * n]) - 2 * int(left[n])) < thresh
        if flat_h and flat_v:
            fl = np.empty_like(left)
            ft = np.empty_like(top)
            fl[0] = left[0]
            ft[0] = top[0]
            for i in range(1, 2 * n):
                fl[i] = ((2 * n - i) * int(left[0]) + i * int(left[2 * n]) + n) >> 6
                ft[i] = ((2 * n - i) * int(top[0]) + i * int(top[2 * n]) + n) >> 6
            fl[2 * n] = left[2 * n]
            ft[2 * n] = top[2 * n]
            return fl, ft
    # [1 2 1] filter; corner uses left[1] and top[1]
    fl = left.copy()
    ft = top.copy()
    corner = (int(left[1]) + 2 * int(left[0]) + int(top[1]) + 2) >> 2
    fl[1:2 * n] = (left[0:2 * n - 1].astype(np.int64) + 2 * left[1:2 * n]
                   + left[2:2 * n + 1] + 2) >> 2
    ft[1:2 * n] = (top[0:2 * n - 1].astype(np.int64) + 2 * top[1:2 * n]
                   + top[2:2 * n + 1] + 2) >> 2
    fl[0] = ft[0] = corner
    # last samples unfiltered (no right/bottom neighbor): spec keeps p[-1][63]
    return fl.astype(np.int32), ft.astype(np.int32)


def predict(mode: int, left: np.ndarray, top: np.ndarray, size: int, c_idx: int,
            bit_depth: int = 8) -> np.ndarray:
    """Intra sample prediction (spec 8.4.4.2.5-8.4.4.2.7) -> [size,size] int32."""
    n = size
    pmax = (1 << bit_depth) - 1
    out = np.empty((n, n), dtype=np.int32)
    l_ = left.astype(np.int64)
    t_ = top.astype(np.int64)
    if mode == INTRA_PLANAR:
        x = np.arange(n)
        y = np.arange(n)[:, None]
        out = ((n - 1 - x) * l_[1 + y] + (x + 1) * t_[n + 1]
               + (n - 1 - y) * t_[1 + x] + (y + 1) * l_[n + 1] + n) >> (
                   int(np.log2(n)) + 1)
        return out.astype(np.int32)
    if mode == INTRA_DC:
        dc = (int(l_[1:n + 1].sum() + t_[1:n + 1].sum()) + n) >> (int(np.log2(n)) + 1)
        out[:] = dc
        if c_idx == 0 and n < 32:
            # edge filtering (8.4.4.2.5)
            out[0, 0] = (l_[1] + 2 * dc + t_[1] + 2) >> 2
            out[0, 1:] = (t_[2:n + 1] + 3 * dc + 2) >> 2
            out[1:, 0] = (l_[2:n + 1] + 3 * dc + 2) >> 2
        return out
    # angular (8.4.4.2.6)
    angle = int(INTRA_ANGLE[mode - 2])
    if mode >= 18:
        # main reference = top row
        ref = np.zeros(3 * n + 2, dtype=np.int64)  # index offset n: ref[n+i] = p[i-1][-1]
        base = n
        ref[base:base + 2 * n + 1] = t_[0:2 * n + 1]
        if angle < 0:
            inv = int(INV_ANGLE[mode - 11])
            last = (n * angle) >> 5
            # indices below (last+1) are never read: exclusive bound (HM form)
            for xi in range(-1, last, -1):
                ref[base + xi] = l_[((xi * inv + 128) >> 8)]
        y = np.arange(1, n + 1)[:, None]
        idx = ((y * angle) >> 5)
        fact = (y * angle) & 31
        x = np.arange(n)
        i1 = base + x + idx + 1
        pred = ((32 - fact) * ref[i1] + fact * ref[i1 + 1] + 16) >> 5
        out = pred.astype(np.int32)
        if mode == 26 and c_idx == 0 and n < 32:
            # pred[0][y] = Clip1(p[0][-1] + ((p[-1][y] - p[-1][-1]) >> 1))
            col = t_[1] + ((l_[1:n + 1] - l_[0]) >> 1)
            out[:, 0] = np.clip(col, 0, pmax)
        return out
    else:
        # modes 2..17: mirror with left as main reference
        ref = np.zeros(3 * n + 2, dtype=np.int64)
        base = n
        ref[base:base + 2 * n + 1] = l_[0:2 * n + 1]
        if angle < 0:
            inv = int(INV_ANGLE[mode - 11])
            last = (n * angle) >> 5
            for xi in range(-1, last, -1):
                ref[base + xi] = t_[((xi * inv + 128) >> 8)]
        x = np.arange(1, n + 1)[:, None]
        idx = (x * angle) >> 5
        fact = (x * angle) & 31
        yy = np.arange(n)
        i1 = base + yy + idx + 1
        pred = ((32 - fact) * ref[i1] + fact * ref[i1 + 1] + 16) >> 5
        out = pred.T.astype(np.int32)  # transpose back (x,y swapped)
        if mode == 10 and c_idx == 0 and n < 32:
            # pred[x][0] = Clip1(p[-1][0] + ((p[x][-1] - p[-1][-1]) >> 1))
            row = l_[1] + ((t_[1:n + 1] - t_[0]) >> 1)
            out[0, :] = np.clip(row, 0, pmax)
        return out


def intra_predict_tu(pic: np.ndarray, avail: np.ndarray, x0: int, y0: int,
                     size: int, mode: int, c_idx: int, strong_smoothing: bool,
                     bit_depth: int = 8) -> np.ndarray:
    left, top = gather_references(pic, avail, x0, y0, size, bit_depth)
    if c_idx == 0:
        left, top = filter_references(left, top, size, mode, strong_smoothing,
                                      bit_depth)
    return predict(mode, left, top, size, c_idx, bit_depth)


def derive_mpm(left_mode: int | None, above_mode: int | None) -> list[int]:
    """candModeList derivation (spec 8.4.2).  None -> unavailable -> DC."""
    a = INTRA_DC if left_mode is None else left_mode
    b = INTRA_DC if above_mode is None else above_mode
    if a == b:
        if a < 2:
            return [INTRA_PLANAR, INTRA_DC, 26]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    cands = [a, b]
    for c in (INTRA_PLANAR, INTRA_DC, 26):
        if c not in cands:
            cands.append(c)
            break
    return cands
