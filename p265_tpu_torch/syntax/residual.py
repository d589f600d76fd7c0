"""residual_coding syntax: symmetric CABAC decode/encode (spec 7.3.8.11,
9.3.4.2.4-9.3.4.2.7, 9.3.3.9).

Decode parses quantized coefficient levels into a dense [size, size] int32
array (levels[y][x]); encode emits the exact bin sequence the decoder parses.
The two share every context-derivation helper so a table slip cannot
desynchronize them.
"""
from __future__ import annotations

import functools

import numpy as np

from p265_tpu_torch.entropy.engine import CabacDecoder, CabacEncoder
from p265_tpu_torch.tables import SIG_CTX_MAP_4x4, scan_order


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


def _prefix_suffix_from_last(v: int) -> tuple[int, int, int]:
    """-> (prefix, suffix, suffix_bits)."""
    if v <= 3:
        return v, 0, 0
    # prefix p > 3: v in [ (1<<(p>>1 -1)) * (2 + (p&1)), ... )
    msb = v.bit_length() - 1
    # group base: 2^(k)*2 or 2^k*3 with k = msb-1
    k = msb - 1
    if v >= 3 << k:
        prefix = 2 * (k + 1) + 1
        suffix = v - (3 << k)
    else:
        prefix = 2 * (k + 1)
        suffix = v - (2 << k)
    return prefix, suffix, k


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


def encode_residual(enc: CabacEncoder, levels: np.ndarray, log2_size: int,
                    c_idx: int, scan_idx: int, *, transform_skip_allowed: bool,
                    sign_data_hiding: bool, tq_bypass: bool,
                    tskip: bool = False) -> None:
    size = 1 << log2_size
    assert levels.any(), "encode_residual requires at least one nonzero level"

    if transform_skip_allowed and not tq_bypass and log2_size == 2:
        enc.encode("transform_skip_flag", 0 if c_idx == 0 else 1, int(tskip))

    scan = tb_scan(scan_idx, size)
    cg_scan = scan_order(scan_idx, size >> 2) if size > 4 else np.array([[0, 0]])
    vals_in_scan = levels[scan[:, 1], scan[:, 0]]
    nz = np.flatnonzero(vals_in_scan)
    last_pos = int(nz[-1])
    last_cg = last_pos >> 4

    lx, ly = int(scan[last_pos][0]), int(scan[last_pos][1])
    if scan_idx == 2:
        lx, ly = ly, lx
    c_max, offset, shift = last_prefix_params(log2_size, c_idx)
    for name, v in (("last_sig_coeff_x_prefix", lx), ("last_sig_coeff_y_prefix", ly)):
        prefix, suffix, sbits = _prefix_suffix_from_last(v)
        for b in range(prefix):
            enc.encode(name, (b >> shift) + offset, 1)
        if prefix < c_max:
            enc.encode(name, (prefix >> shift) + offset, 0)
    for v in (lx, ly):
        prefix, suffix, sbits = _prefix_suffix_from_last(v)
        if prefix > 3:
            enc.encode_bypass_bits(suffix, sbits)

    csbf = np.zeros((max(size >> 2, 1), max(size >> 2, 1)), dtype=np.int32)
    # precompute csbf values
    for i in range(last_cg + 1):
        seg = vals_in_scan[i << 4:(i + 1) << 4]
        xs, ys = (int(cg_scan[i][0]), int(cg_scan[i][1]))
        csbf[ys, xs] = 1 if np.any(seg) else 0
    c1 = 1

    for i in range(last_cg, -1, -1):
        xs, ys = (int(cg_scan[i][0]), int(cg_scan[i][1]))
        infer_dc_sig = False
        if i == last_cg or i == 0:
            csbf[ys, xs] = 1  # inferred 1 even if CG 0 is empty (DC sig coded 0)
        else:
            right = int(csbf[ys, xs + 1]) if xs + 1 < csbf.shape[1] else 0
            below = int(csbf[ys + 1, xs]) if ys + 1 < csbf.shape[0] else 0
            inc = min(1, right + below) + (2 if c_idx else 0)
            enc.encode("coded_sub_block_flag", inc, int(csbf[ys, xs]))
            infer_dc_sig = True
        if not csbf[ys, xs]:
            continue

        start_n = (last_pos - 1 - (i << 4)) if i == last_cg else 15
        sig_pos: list[int] = []
        if i == last_cg:
            sig_pos.append(last_pos & 15)
        right = int(csbf[ys, xs + 1]) if xs + 1 < csbf.shape[1] else 0
        below = int(csbf[ys + 1, xs]) if ys + 1 < csbf.shape[0] else 0
        for n in range(start_n, -1, -1):
            x_c, y_c = (int(v) for v in scan[(i << 4) + n])
            sig = int(levels[y_c, x_c] != 0)
            if n > 0 or not infer_dc_sig:
                inc = sig_ctx_inc(x_c, y_c, log2_size, c_idx, scan_idx, right, below)
                enc.encode("sig_coeff_flag", inc, sig)
                if sig:
                    sig_pos.append(n)
                    infer_dc_sig = False
            else:
                # DC sig inferred = 1; encoder must have ensured a nonzero DC
                assert sig == 1, "inferred-significant DC must be nonzero"
                sig_pos.append(n)
        if not sig_pos:
            continue  # CG 0 inferred coded but actually empty

        ctx_set = 0 if (i == 0 or c_idx > 0) else 2
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        abs_vals = {}
        for n in sig_pos:
            x_c, y_c = (int(v) for v in scan[(i << 4) + n])
            abs_vals[n] = abs(int(levels[y_c, x_c]))
        gt2_pos = -1
        for k, n in enumerate(sig_pos):
            if k >= 8:
                break
            f = int(abs_vals[n] > 1)
            base = (ctx_set * 4 + min(c1, 3)) + (16 if c_idx else 0)
            enc.encode("coeff_abs_level_greater1_flag", base, f)
            if f:
                if gt2_pos < 0:
                    gt2_pos = n
                c1 = 0
            elif 0 < c1 < 3:
                c1 += 1
        if gt2_pos >= 0:
            enc.encode("coeff_abs_level_greater2_flag",
                       ctx_set + (4 if c_idx else 0), int(abs_vals[gt2_pos] > 2))

        first_sig = sig_pos[-1]
        last_sig = sig_pos[0]
        sign_hidden = (sign_data_hiding and not tq_bypass
                       and (last_sig - first_sig) > 3)
        sum_abs = sum(abs_vals.values())
        for n in sig_pos:
            x_c, y_c = (int(v) for v in scan[(i << 4) + n])
            neg = levels[y_c, x_c] < 0
            if sign_hidden and n == first_sig:
                assert (sum_abs & 1) == int(neg), (
                    "sign-data-hiding parity violated; run apply_sign_data_hiding")
                continue
            enc.encode_bypass(int(neg))

        rice = 0
        for k, n in enumerate(sig_pos):
            had_gt1 = k < 8
            is_gt2_pos = n == gt2_pos
            v = abs_vals[n]
            g1 = int(v > 1) if had_gt1 else 0
            g2 = int(v > 2) if is_gt2_pos else 0
            base_level = 1 + g1 + g2
            threshold = (3 if is_gt2_pos else 2) if had_gt1 else 1
            if base_level == threshold:
                _encode_remaining(enc, v - base_level, rice)
                if v > 3 << rice:
                    rice = min(rice + 1, 4)
            else:
                assert v == base_level, (v, base_level, threshold)


def _encode_remaining(enc: CabacEncoder, value: int, rice: int) -> None:
    prefix = value >> rice
    if prefix < 4:
        for _ in range(prefix):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        if rice:
            enc.encode_bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        for _ in range(4):
            enc.encode_bypass(1)
        enc.encode_eg_bypass(rice + 1, value - (4 << rice))


def apply_sign_data_hiding(levels: np.ndarray, log2_size: int, scan_idx: int
                           ) -> np.ndarray:
    """Adjust quantized levels so SDH parity holds in every CG (encoder side).

    For each CG where the hidden-sign condition triggers, if parity(sum |lv|)
    disagrees with sign(first sig), nudge the first sig level by +/-1.
    """
    size = 1 << log2_size
    out = levels.copy()
    scan = tb_scan(scan_idx, size)
    n_cgs = max((size * size) >> 4, 1)
    for i in range(n_cgs):
        seg_idx = scan[i << 4:(i + 1) << 4]
        seg = out[seg_idx[:, 1], seg_idx[:, 0]]
        nz = np.flatnonzero(seg)
        if len(nz) == 0:
            continue
        first, last = int(nz[0]), int(nz[-1])
        if last - first <= 3:
            continue
        sum_abs = int(np.abs(seg).sum())
        neg = seg[first] < 0
        if (sum_abs & 1) != int(neg):
            # flip parity: adjust magnitude of the hidden coeff by 1 (keep nonzero)
            x, y = int(seg_idx[first][0]), int(seg_idx[first][1])
            v = int(out[y, x])
            if abs(v) == 1:
                out[y, x] = 2 if v > 0 else -2
            else:
                out[y, x] = v - 1 if v > 0 else v + 1
    return out
