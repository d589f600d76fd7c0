"""residual_coding syntax: CABAC decode (spec 7.3.8.11, 9.3.4.2.4-9.3.4.2.7,
9.3.3.9).

Parses quantized coefficient levels into a dense [size, size] int32 array
(levels[y][x]).
"""
from __future__ import annotations

import functools

import numpy as np

from decode_bench.reference.entropy.engine import CabacDecoder
from decode_bench.reference.tables import SIG_CTX_MAP_4x4, scan_order


@functools.lru_cache(maxsize=None)
def tb_scan(scan_idx: int, size: int) -> np.ndarray:
    """Two-level scan: 4x4 coefficient groups in scan order, 4x4 coeffs within
    each group in the same scan order (spec 6.5.3).  [size*size, 2] (x, y)."""
    if size == 4:
        return scan_order(scan_idx, 4)
    cgs = scan_order(scan_idx, size // 4)
    inner = scan_order(scan_idx, 4)
    parts = [inner + cg * 4 for cg in cgs]
    return np.concatenate(parts, axis=0)


def sig_ctx_inc(x_c: int, y_c: int, log2_size: int, c_idx: int, scan_idx: int,
                csbf_right: int, csbf_below: int) -> int:
    """sig_coeff_flag ctxInc (spec 9.3.4.2.5)."""
    if log2_size == 2:
        sig = int(SIG_CTX_MAP_4x4[(y_c << 2) + x_c])
    elif x_c + y_c == 0:
        sig = 0
    else:
        prev = csbf_right + 2 * csbf_below
        x_p, y_p = x_c & 3, y_c & 3
        if prev == 0:
            sig = 2 if x_p + y_p == 0 else (1 if x_p + y_p < 3 else 0)
        elif prev == 1:
            sig = 2 if y_p == 0 else (1 if y_p == 1 else 0)
        elif prev == 2:
            sig = 2 if x_p == 0 else (1 if x_p == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if (x_c >> 2, y_c >> 2) != (0, 0):
                sig += 3
            if log2_size == 3:
                sig += 9 if scan_idx == 0 else 15
            else:
                sig += 21
        else:
            sig += 9 if log2_size == 3 else 12
    return sig + (27 if c_idx else 0)


def last_prefix_params(log2_size: int, c_idx: int) -> tuple[int, int, int]:
    """(cMax, ctxOffset, ctxShift) for last_sig_coeff prefixes (9.3.4.2.3)."""
    c_max = (log2_size << 1) - 1
    if c_idx == 0:
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
        shift = (log2_size + 1) >> 2
    else:
        offset = 15
        shift = log2_size - 2
    return c_max, offset, shift


def _last_from_prefix_suffix(prefix: int, suffix: int) -> int:
    if prefix <= 3:
        return prefix
    return (1 << ((prefix >> 1) - 1)) * (2 + (prefix & 1)) + suffix


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_residual(dec: CabacDecoder, log2_size: int, c_idx: int, scan_idx: int,
                    *, transform_skip_allowed: bool, sign_data_hiding: bool,
                    tq_bypass: bool) -> tuple[np.ndarray, bool]:
    if hasattr(dec, "native_residual"):
        return dec.native_residual(log2_size, c_idx, scan_idx,
                                   transform_skip_allowed, sign_data_hiding,
                                   tq_bypass)
    size = 1 << log2_size
    levels = np.zeros((size, size), dtype=np.int32)

    tskip = False
    if transform_skip_allowed and not tq_bypass and log2_size == 2:
        tskip = bool(dec.decode("transform_skip_flag", 0 if c_idx == 0 else 1))

    # last significant coefficient position
    c_max, offset, shift = last_prefix_params(log2_size, c_idx)
    name_x, name_y = "last_sig_coeff_x_prefix", "last_sig_coeff_y_prefix"
    px = 0
    while px < c_max and dec.decode(name_x, (px >> shift) + offset):
        px += 1
    py = 0
    while py < c_max and dec.decode(name_y, (py >> shift) + offset):
        py += 1
    sx = dec.decode_bypass_bits((px >> 1) - 1) if px > 3 else 0
    sy = dec.decode_bypass_bits((py >> 1) - 1) if py > 3 else 0
    last_x = _last_from_prefix_suffix(px, sx)
    last_y = _last_from_prefix_suffix(py, sy)
    if scan_idx == 2:
        last_x, last_y = last_y, last_x

    scan = tb_scan(scan_idx, size)
    n_cgs = (size * size) >> 4
    cg_scan = scan_order(scan_idx, size >> 2) if size > 4 else np.array([[0, 0]])
    # find last scan pos
    lookup = {(int(x), int(y)): i for i, (x, y) in enumerate(scan)}
    last_pos = lookup[(last_x, last_y)]
    last_cg = last_pos >> 4

    csbf = np.zeros((size >> 2 or 1, size >> 2 or 1), dtype=np.int32)
    c1 = 1  # greater1 context state carried across CGs

    for i in range(last_cg, -1, -1):
        xs, ys = (int(cg_scan[i][0]), int(cg_scan[i][1]))
        infer_dc_sig = False
        if i == last_cg or i == 0:
            csbf[ys, xs] = 1
        else:
            right = int(csbf[ys, xs + 1]) if xs + 1 < csbf.shape[1] else 0
            below = int(csbf[ys + 1, xs]) if ys + 1 < csbf.shape[0] else 0
            inc = min(1, right + below) + (2 if c_idx else 0)
            csbf[ys, xs] = dec.decode("coded_sub_block_flag", inc)
            infer_dc_sig = True
        if not csbf[ys, xs]:
            continue

        start_n = (last_pos - 1 - (i << 4)) if i == last_cg else 15
        sig_pos: list[int] = []  # within-CG n values with sig==1, reverse order
        if i == last_cg:
            sig_pos.append(last_pos & 15)
        right = int(csbf[ys, xs + 1]) if xs + 1 < csbf.shape[1] else 0
        below = int(csbf[ys + 1, xs]) if ys + 1 < csbf.shape[0] else 0
        for n in range(start_n, -1, -1):
            x_c, y_c = (int(v) for v in scan[(i << 4) + n])
            if n > 0 or not infer_dc_sig:
                inc = sig_ctx_inc(x_c, y_c, log2_size, c_idx, scan_idx, right, below)
                if dec.decode("sig_coeff_flag", inc):
                    sig_pos.append(n)
                    infer_dc_sig = False
            else:
                sig_pos.append(n)  # inferred DC significant
        if not sig_pos:
            continue  # CG 0 inferred coded but actually empty

        # greater1 / greater2
        ctx_set = 0 if (i == 0 or c_idx > 0) else 2
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        gt1 = {}
        gt2_pos = -1
        for k, n in enumerate(sig_pos):
            if k >= 8:
                break
            base = (ctx_set * 4 + min(c1, 3)) + (16 if c_idx else 0)
            f = dec.decode("coeff_abs_level_greater1_flag", base)
            gt1[n] = f
            if f:
                if gt2_pos < 0:
                    gt2_pos = n
                c1 = 0
            elif 0 < c1 < 3:
                c1 += 1
        gt2 = 0
        if gt2_pos >= 0:
            gt2 = dec.decode("coeff_abs_level_greater2_flag",
                             ctx_set + (4 if c_idx else 0))

        first_sig = sig_pos[-1]
        last_sig = sig_pos[0]
        sign_hidden = (sign_data_hiding and not tq_bypass
                       and (last_sig - first_sig) > 3)
        signs = {}
        for n in sig_pos:
            if sign_hidden and n == first_sig:
                continue
            signs[n] = dec.decode_bypass()

        rice = 0
        sum_abs = 0
        vals = {}
        for k, n in enumerate(sig_pos):
            had_gt1 = k < 8
            is_gt2_pos = n == gt2_pos
            base_level = 1 + (gt1.get(n, 0) if had_gt1 else 0) + (gt2 if is_gt2_pos else 0)
            threshold = (3 if is_gt2_pos else 2) if had_gt1 else 1
            level = base_level
            if base_level == threshold:
                rem = _decode_remaining(dec, rice)
                level += rem
                if level > 3 << rice:
                    rice = min(rice + 1, 4)
            sum_abs += level
            vals[n] = level
        for n, level in vals.items():
            x_c, y_c = (int(v) for v in scan[(i << 4) + n])
            if sign_hidden and n == first_sig:
                neg = (sum_abs & 1) == 1
            else:
                neg = bool(signs[n])
            levels[y_c, x_c] = -level if neg else level
    return levels, tskip


def _decode_remaining(dec: CabacDecoder, rice: int) -> int:
    """coeff_abs_level_remaining: TR(cMax=4<<rice) prefix + EG(rice+1) escape."""
    prefix = 0
    while prefix < 4 and dec.decode_bypass():
        prefix += 1
    if prefix < 4:
        suffix = dec.decode_bypass_bits(rice) if rice else 0
        return (prefix << rice) + suffix
    return (4 << rice) + dec.decode_eg_bypass(rice + 1)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


