# Copy of p265_tpu/tables.py.  Deviation: the provenance paragraph of the
# module docstring is reworded; every value is the same.
"""Every HEVC spec constant used by the framework, in one audited module.

PROVENANCE: the values are those of p265_tpu/tables.py.  Transform
matrices, interpolation filters and level scales were verified numerically
(SURVEY.md Appendix A); entries marked [MEM] below (CABAC init values,
rangeTabLPS, deblocking beta/tc, chroma QP map) were not checked against
the published spec tables, and the encoder/decoder round trip keeps the
system internally bit-exact even if one of them diverges.  Such an audit
starts with exactly this file (SURVEY.md section 7.7).

Spec clause references are given per table (ITU-T H.265 (2013) numbering).
"""
from __future__ import annotations

import functools
import math

import numpy as np

# ---------------------------------------------------------------------------
# Core transform matrices (spec 8.6.4.2).  Construction: the HEVC integer
# DCT-II matrices are defined by per-size canonical constant lists (verified
# numerically in SURVEY.md Appendix A) plus the standard DCT symmetry
#   T[k][N-1-n] = (-1)^k T[k][n]        (row symmetry)
#   T_2N[2k][n] = T_N[k][n], n < N       (even rows subsample)
# Odd rows of T_N draw from ODD_CONSTS[N][j] ~ cos((2j+1)*pi/(2N)) scaled.
# ---------------------------------------------------------------------------

# canonical odd-row constants, indexed by angle j: value ~ 64*sqrt(2)*cos((2j+1)pi/2N)
_ODD_CONSTS = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
}


def _build_dct_matrix(n: int) -> np.ndarray:
    """Build the NxN HEVC core (forward) transform matrix, int32."""
    if n == 1:
        return np.array([[64]], dtype=np.int64)
    m = np.zeros((n, n), dtype=np.int64)
    half = _build_dct_matrix(n // 2)
    # even rows: subsampled smaller transform + symmetry
    for k in range(0, n, 2):
        for col in range(n // 2):
            m[k][col] = half[k // 2][col]
            # row symmetry, even k -> +
            m[k][n - 1 - col] = half[k // 2][col] if k % 2 == 0 else -half[k // 2][col]
    # odd rows: fold angle index into canonical constant list
    consts = _ODD_CONSTS[n]
    for k in range(1, n, 2):
        for col in range(n):
            a = ((2 * col + 1) * k) % (4 * n)  # angle numerator: cos(a*pi/2N)
            if a > 2 * n:
                a = 4 * n - a
            sign = 1
            if a > n:
                sign = -1
                a = 2 * n - a
            # a is odd (odd*odd), a in (0, n]
            m[k][col] = sign * consts[(a - 1) // 2]
    return m


DCT4 = _build_dct_matrix(4).astype(np.int32)
DCT8 = _build_dct_matrix(8).astype(np.int32)
DCT16 = _build_dct_matrix(16).astype(np.int32)
DCT32 = _build_dct_matrix(32).astype(np.int32)
DCT = {4: DCT4, 8: DCT8, 16: DCT16, 32: DCT32}

# DST-VII 4x4 (spec 8.6.4.1, used for 4x4 intra luma) [VERIFIED-NUM]
DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)

# Dequant level scale (spec 8.6.3): levelScale[qp % 6] [VERIFIED-NUM]
LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

# Forward-quant scale used by our test encoder (inverse ladder of LEVEL_SCALE,
# HM-style f[qp%6]; encoder choice only -- any coded level is legal).  [MEM]
QUANT_SCALE = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)

# ---------------------------------------------------------------------------
# Inter-prediction interpolation filters (spec 8.5.4.2.2) [VERIFIED-NUM]
# ---------------------------------------------------------------------------

# luma 8-tap at quarter-pel: index by fracational position 0..3
LUMA_FILTER = np.array(
    [
        [0, 0, 0, 64, 0, 0, 0, 0],
        [-1, 4, -10, 58, 17, -5, 1, 0],
        [-1, 4, -11, 40, 40, -11, 4, -1],
        [0, 1, -5, 17, 58, -10, 4, -1],
    ],
    dtype=np.int32,
)

# chroma 4-tap at eighth-pel: index by fractional position 0..7
CHROMA_FILTER = np.array(
    [
        [0, 64, 0, 0],
        [-2, 58, 10, -2],
        [-4, 54, 16, -2],
        [-6, 46, 28, -4],
        [-4, 36, 36, -4],
        [-4, 28, 46, -6],
        [-2, 16, 54, -4],
        [-2, 10, 58, -2],
    ],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Intra prediction (spec 8.4.4.2.6)
# ---------------------------------------------------------------------------

# intraPredAngle for modes 2..34 (index mode-2)
INTRA_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32,
)

# invAngle = round(8192/angle) for modes 11..25 (index mode-11)
INV_ANGLE = np.array(
    [-4096, -1638, -910, -630, -482, -390, -315, -256,
     -315, -390, -482, -630, -910, -1638, -4096],
    dtype=np.int32,
)

# [1 2 1] reference smoothing threshold: min(|mode-26|,|mode-10|) must EXCEED
# this per-size threshold for filtering (spec 8.4.4.2.3)  [MEM]
INTRA_HOR_VER_DIST_THRES = {8: 7, 16: 1, 32: 0}

# ---------------------------------------------------------------------------
# CABAC arithmetic engine tables (spec 9.3.4.3)
# ---------------------------------------------------------------------------

# rangeTabLPS[pStateIdx][qRangeIdx] (Table 9-46)  [MEM - spot-checked:
# [0][0]=128, [63]={2,2,2,2}, monotone decay; same table as H.264]
RANGE_TAB_LPS = np.array(
    [
        [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
        [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
        [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
        [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
        [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
        [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
        [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
        [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
        [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
        [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
        [30, 37, 43, 50], [28, 35, 41, 47], [27, 33, 39, 45],
        [25, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
        [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
        [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
        [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
        [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
        [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
        [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
        [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
        [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
        [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
    ],
    dtype=np.int32,
)

# transIdxLps[pStateIdx] (Table 9-47)  [MEM - entries 28/29 (23,22) carry the
# known non-monotone quirk of the published table; LOWEST confidence entries]
TRANS_IDX_LPS = np.array(
    [0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
     13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 23, 22, 23, 24,
     24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
     33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63],
    dtype=np.int32,
)

# transIdxMps[pStateIdx] = min(pStateIdx+1, 62)
TRANS_IDX_MPS = np.minimum(np.arange(64) + 1, 62).astype(np.int32)


def ctx_init_state(init_value: int, qp: int) -> tuple[int, int]:
    """Context initialization (spec 9.3.2.2) -> (pStateIdx, valMps).

    [VERIFIED-NUM]: initValue 154 -> (0, 1) at all QPs.
    """
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * min(max(0, qp), 51)) >> 4) + offset), 126)
    if pre <= 63:
        return 63 - pre, 0
    return pre - 64, 1


# ---------------------------------------------------------------------------
# CABAC context model init values (spec Tables 9-5..9-32)  [MEM]
#
# Layout: name -> [I_vals, P_vals, B_vals], i.e. indexed by initType
# (initType 0 = I slice, 1 = P (cabac_init_flag=0), 2 = B (cabac_init_flag=0);
# cabac_init_flag=1 swaps 1<->2 per spec 9.3.2.2).
# CNU (= 154) marks "context not used" for that slice type.
# ---------------------------------------------------------------------------

CNU = 154

CTX_INIT = {
    # ctxInc = (left deeper) + (above deeper), 3 contexts
    "split_cu_flag": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "cu_transquant_bypass_flag": [[154], [154], [154]],
    # ctxInc from neighbor skip flags, 3 contexts
    "cu_skip_flag": [[CNU, CNU, CNU], [197, 185, 201], [197, 185, 201]],
    "merge_flag": [[CNU], [110], [154]],
    "merge_idx": [[CNU], [122], [137]],
    # bins 0..3 (AMP last bin is bypass)
    "part_mode": [[184, CNU, CNU, CNU], [154, 139, 154, 154], [154, 139, 154, 154]],
    "pred_mode_flag": [[CNU], [149], [134]],
    "prev_intra_luma_pred_flag": [[184], [154], [183]],
    "intra_chroma_pred_mode": [[63], [152], [152]],
    # bin0 ctxInc = CtDepth (0..3), bin1 ctx 4
    "inter_pred_idc": [[CNU] * 5, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]],
    # [abs_mvd_greater0_flag, abs_mvd_greater1_flag]
    "abs_mvd_greater_flag": [[CNU, CNU], [140, 198], [169, 198]],
    "ref_idx": [[CNU, CNU], [153, 153], [153, 153]],
    "mvp_flag": [[CNU], [168], [168]],
    # cu_qp_delta_abs: bin0 ctx0, bins 1..4 ctx1
    "cu_qp_delta_abs": [[154, 154], [154, 154], [154, 154]],
    # cbf_luma: ctxInc = (trafoDepth == 0)
    "cbf_luma": [[111, 141], [153, 111], [153, 111]],
    # cbf_cb / cbf_cr: ctxInc = trafoDepth (0..4)
    "cbf_chroma": [[94, 138, 182, 154, 154], [149, 107, 167, 154, 154],
                   [149, 92, 167, 154, 154]],
    "rqt_root_cbf": [[CNU], [79], [79]],
    # last_sig_coeff_{x,y}_prefix: 15 luma + 3 chroma contexts, x and y sets
    # initialized with the same values
    "last_sig_coeff_x_prefix": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
         108, 123, 93]],
    "last_sig_coeff_y_prefix": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
         108, 123, 93]],
    # coded_sub_block_flag: 2 luma + 2 chroma
    "coded_sub_block_flag": [[91, 171, 134, 141], [121, 140, 61, 154],
                             [121, 140, 61, 154]],
    # sig_coeff_flag: 27 luma + 15 chroma = 42
    "sig_coeff_flag": [
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
         139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140]],
    # coeff_abs_level_greater1_flag: 16 luma + 8 chroma = 24
    "coeff_abs_level_greater1_flag": [
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182]],
    # coeff_abs_level_greater2_flag: 4 luma + 2 chroma = 6
    "coeff_abs_level_greater2_flag": [
        [138, 153, 136, 167, 152, 152],
        [107, 167, 91, 122, 107, 167],
        [107, 167, 91, 107, 107, 167]],
    "sao_merge_flag": [[153], [153], [153]],
    "sao_type_idx": [[200], [185], [160]],
    # split_transform_flag: ctxInc = 5 - log2TrafoSize
    "split_transform_flag": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    "transform_skip_flag": [[139, 139], [139, 139], [139, 139]],  # [luma, chroma]
    "end_of_slice_segment_flag": [[], [], []],  # terminate bin, no context
}

# offsets of each element's context block in the flat context array
CTX_OFFSET: dict[str, int] = {}
_off = 0
for _name, _vals in CTX_INIT.items():
    CTX_OFFSET[_name] = _off
    _off += len(_vals[0])
NUM_CTX = _off


def init_context_array(init_type: int, qp: int) -> np.ndarray:
    """Flat [NUM_CTX, 2] array of (pStateIdx, valMps) for a slice."""
    out = np.zeros((NUM_CTX, 2), dtype=np.int32)
    for name, vals in CTX_INIT.items():
        base = CTX_OFFSET[name]
        for i, iv in enumerate(vals[init_type]):
            s, m = ctx_init_state(iv, qp)
            out[base + i, 0] = s
            out[base + i, 1] = m
    return out


# sig_coeff_flag 4x4 position->context map (spec 9.3.4.2.5)  [MEM]
SIG_CTX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32
)

# ---------------------------------------------------------------------------
# Deblocking filter tables (spec Table 8-12)  [MEM]
# ---------------------------------------------------------------------------

BETA_TABLE = np.array(
    [0] * 16
    + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]      # Q 16..27
    + list(range(18, 66, 2)),                             # Q 28..51 -> 18..64
    dtype=np.int32,
)
assert len(BETA_TABLE) == 52

TC_TABLE = np.array(
    [0] * 18
    + [1] * 9          # Q 18..26
    + [2] * 4          # Q 27..30
    + [3] * 4          # Q 31..34
    + [4] * 3          # Q 35..37
    + [5] * 2          # Q 38..39
    + [6] * 2          # Q 40..41
    + [7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],   # Q 42..53
    dtype=np.int32,
)
assert len(TC_TABLE) == 54

# ---------------------------------------------------------------------------
# Chroma QP mapping for 4:2:0 (spec Table 8-10)  [MEM]
# qPi < 30 -> qPi; 30..43 -> table; > 43 -> qPi - 6
# ---------------------------------------------------------------------------

_CHROMA_QP_MID = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]


def chroma_qp_from_luma(qpi: int) -> int:
    if qpi < 30:
        return qpi
    if qpi <= 43:
        return _CHROMA_QP_MID[qpi - 30]
    return qpi - 6


CHROMA_QP_TABLE = np.array([chroma_qp_from_luma(q) for q in range(58)], dtype=np.int32)

# ---------------------------------------------------------------------------
# Scan orders (spec 6.5.3-6.5.5).  scanIdx: 0=up-right diagonal, 1=horizontal,
# 2=vertical.  Arrays map scan position -> (x, y).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def diag_scan(blk: int) -> np.ndarray:
    """Up-right diagonal scan order, spec 6.5.3 pseudocode, [blk*blk, 2](x,y)."""
    out = []
    x = y = 0
    while len(out) < blk * blk:
        while y >= 0:
            if x < blk and y < blk:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def horiz_scan(blk: int) -> np.ndarray:
    return np.array([(x, y) for y in range(blk) for x in range(blk)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def vert_scan(blk: int) -> np.ndarray:
    return np.array([(x, y) for x in range(blk) for y in range(blk)], dtype=np.int32)


def scan_order(scan_idx: int, blk: int) -> np.ndarray:
    return (diag_scan, horiz_scan, vert_scan)[scan_idx](blk)


def residual_scan_idx(pred_mode_intra: int | None, log2_size: int, c_idx: int) -> int:
    """scanIdx derivation for residual_coding (spec 7.4.9.11).

    Intra 4x4/8x8 luma (and 4x4 chroma in 4:2:0): modes 6..14 -> vertical,
    modes 22..30 -> horizontal, else diagonal.  Inter / large blocks: diagonal.
    """
    if pred_mode_intra is not None and (
        (c_idx == 0 and log2_size in (2, 3)) or (c_idx > 0 and log2_size == 2)
    ):
        if 6 <= pred_mode_intra <= 14:
            return 2
        if 22 <= pred_mode_intra <= 30:
            return 1
    return 0


# ---------------------------------------------------------------------------
# Misc derived helpers
# ---------------------------------------------------------------------------


def last_sig_prefix_ctx(log2_size: int, c_idx: int, bin_idx: int) -> int:
    """ctxInc for last_sig_coeff_{x,y}_prefix (spec 9.3.4.2.3)."""
    if c_idx == 0:
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
        shift = (log2_size + 1) >> 2
    else:
        offset = 15
        shift = log2_size - 2
    return (bin_idx >> shift) + offset


def clip3(lo: int, hi: int, v: int) -> int:
    return lo if v < lo else hi if v > hi else v


# ---------------------------------------------------------------------------
# Default quantization scaling matrices (spec Tables 7-5, 7-6)  [MEM]
# 4x4 default is flat 16; 16x16/32x32 derive from the 8x8 lists by 2x/4x
# sample repetition with DC forced to 16 (spec 7.4.5).
# ---------------------------------------------------------------------------

DEFAULT_SCALING_4x4 = np.full((4, 4), 16, np.int32)

DEFAULT_SCALING_8x8_INTRA = np.array([
    [16, 16, 16, 16, 17, 18, 21, 24],
    [16, 16, 16, 16, 17, 19, 22, 25],
    [16, 16, 17, 18, 20, 22, 25, 29],
    [16, 16, 18, 21, 24, 27, 31, 36],
    [17, 17, 20, 24, 30, 35, 41, 47],
    [18, 19, 22, 27, 35, 44, 54, 65],
    [21, 22, 25, 31, 41, 54, 70, 88],
    [24, 25, 29, 36, 47, 65, 88, 115]], np.int32)

DEFAULT_SCALING_8x8_INTER = np.array([
    [16, 16, 16, 16, 17, 18, 20, 24],
    [16, 16, 16, 17, 18, 20, 24, 25],
    [16, 16, 17, 18, 20, 24, 25, 28],
    [16, 17, 18, 20, 24, 25, 28, 33],
    [17, 18, 20, 24, 25, 28, 33, 41],
    [18, 20, 24, 25, 28, 33, 41, 54],
    [20, 24, 25, 28, 33, 41, 54, 71],
    [24, 25, 28, 33, 41, 54, 71, 91]], np.int32)


def upsample_scaling(m8: np.ndarray, factor: int, dc: int) -> np.ndarray:
    """16x16/32x32 scaling matrix from an 8x8 list (spec 7.4.5)."""
    m = np.repeat(np.repeat(m8, factor, axis=0), factor, axis=1)
    m[0, 0] = dc
    return m.astype(np.int32)


BIT_DEPTH = 8
PIXEL_MAX = (1 << BIT_DEPTH) - 1
