"""Scalar/NumPy golden transforms: dequant, inverse + forward DCT/DST, quant.

All integer arithmetic, bit-exact per spec 8.6.  These are the oracle for the
Pallas kernels in p265_tpu.kernels.itransform.
"""
from __future__ import annotations

import numpy as np

from p265_tpu_torch.tables import DCT, DST4, LEVEL_SCALE, QUANT_SCALE

BIT_DEPTH = 8


def dequant(levels: np.ndarray, qp: int, log2_size: int,
            scale_m: np.ndarray | None = None) -> np.ndarray:
    """Scaling process for transform coefficients (spec 8.6.3).

    d = Clip3(-2^15, 2^15-1,
              ((c * m * levelScale[qp%6] << (qp/6)) + (1 << (bdShift-1))) >> bdShift)
    with m = 16 (flat) or a scaling-list matrix; bdShift = BitDepth + log2 - 5.
    """
    bd_shift = BIT_DEPTH + log2_size - 5
    scale = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    m = 16 if scale_m is None else scale_m.astype(np.int64)
    c = levels.astype(np.int64) * m * scale
    d = (c + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def inverse_transform(coeffs: np.ndarray, log2_size: int, is_dst: bool) -> np.ndarray:
    """Inverse transform (spec 8.6.4.2): two-stage partial butterfly as matmul.

    Stage 1 (vertical): shift 7 with 16-bit clamp; stage 2 (horizontal):
    shift 20 - BitDepth.  coeffs layout: coeffs[y][x].
    """
    n = 1 << log2_size
    m = (DST4 if is_dst else DCT[n]).astype(np.int64)
    shift1 = 7
    shift2 = 20 - BIT_DEPTH
    c = coeffs.astype(np.int64)
    # stage 1: e[x][y] = sum_k m[k][x] * c[k][y] -> columns transform
    tmp = (m.T @ c + (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, -32768, 32767)
    # stage 2: r[y][x] = sum_k tmp[y][k] * m[k][x]
    res = (tmp @ m + (1 << (shift2 - 1))) >> shift2
    return np.clip(res, -32768, 32767).astype(np.int32)


def transform_skip_residual(levels_dequant: np.ndarray) -> np.ndarray:
    """transform_skip 4x4 path (spec 8.6.4.2): r = (d << 7 + offset) >> shift."""
    bd_shift = 20 - BIT_DEPTH
    r = (levels_dequant.astype(np.int64) << 7)
    r = (r + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(r, -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# Forward path (testgen encoder only -- any resulting levels are legal)
# ---------------------------------------------------------------------------


def forward_transform(residual: np.ndarray, log2_size: int, is_dst: bool) -> np.ndarray:
    """HM-style forward transform: stage shifts log2-2+bd-8+... per HM.

    shift1 = log2_size - 1 + BIT_DEPTH - 8; shift2 = log2_size + 6.
    """
    n = 1 << log2_size
    m = (DST4 if is_dst else DCT[n]).astype(np.int64)
    shift1 = log2_size - 1 + BIT_DEPTH - 8
    shift2 = log2_size + 6
    r = residual.astype(np.int64)
    tmp = (m @ r + (1 << (shift1 - 1)) if shift1 > 0 else m @ r) >> max(shift1, 0)
    out = (tmp @ m.T + (1 << (shift2 - 1))) >> shift2
    return np.clip(out, -32768, 32767).astype(np.int32)


def quantize(coeffs: np.ndarray, qp: int, log2_size: int) -> np.ndarray:
    """Simple RDO-free quantizer (HM baseline): level = (|c|*f + off) >> qbits."""
    qbits = 29 + qp // 6 - BIT_DEPTH - log2_size
    f = int(QUANT_SCALE[qp % 6])
    offset = (1 << qbits) // 3  # ~intra rounding offset
    a = np.abs(coeffs.astype(np.int64))
    lv = (a * f + offset) >> qbits
    lv = np.clip(lv, 0, 32767)
    return (np.sign(coeffs) * lv).astype(np.int32)


def quantize_transform_skip(residual: np.ndarray, qp: int) -> np.ndarray:
    """Forward of the transform-skip path: c = (r << (bd-8+...)): HM tskip fwd
    applies shift so that dequant+skip-inverse round-trips; use shift 7 analog.
    """
    # forward transform-skip per HM: coeff = residual << (15 - bd - log2) = << 5
    c = residual.astype(np.int64) << 5
    return quantize(np.clip(c, -32768, 32767).astype(np.int32), qp, 2)
