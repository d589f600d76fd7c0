"""Batched dequant + inverse transform (spec 8.6.2-8.6.4), bit-exact.

Counterpart of p265_tpu/kernels/itransform.py (`batch_residual_ref`, the
plain version) and p265_tpu/kernels/pallas_itransform.py (the kernel:
csrc/itransform.cu behind `batch_residual`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from p265_tpu.tables import DCT, DST4, LEVEL_SCALE
from p265_tpu_torch.kernels import _build

BIT_DEPTH = 8
_SHIFT2 = 20 - BIT_DEPTH


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(x, s)


def _dequant(levels, qp, log2: int, scale_m=None):
    """levels [n,s,s] int32, qp [n] -> int32 clamped to +-2^15.

    The spec's 43-bit product staged exactly in int32, as in
    p265_tpu/kernels/itransform.py _dequant: a rounded right shift by
    bd - qp/6, or a left shift by qp/6 - bd of the value clamped to
    +-2^27 first (so 255-valued scaling matrices cannot overflow).
    """
    bd = BIT_DEPTH + log2 - 5
    e = (qp // 6)[:, None, None]
    ls = _level_scale(levels.device)[(qp % 6).long()][:, None, None]
    if scale_m is None:
        x = levels * (16 * ls)
    else:
        x = (levels * scale_m) * ls
    one = torch.ones_like(e)
    rsh = (bd - e).clamp(min=0)
    rnd = torch.where(e < bd, _shl(one, (bd - 1 - e).clamp(min=0)), 0)
    d_rs = torch.bitwise_right_shift(x + rnd, rsh)
    d_ls = _shl(x.clamp(-(1 << 27), 1 << 27), (e - bd).clamp(min=0))
    return torch.where(e > bd, d_ls, d_rs).clamp(-32768, 32767)


@functools.lru_cache(maxsize=None)
def _level_scale(device: torch.device) -> torch.Tensor:
    return torch.tensor(LEVEL_SCALE, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _mats(log2: int, device: torch.device):
    """(DCT, DST-or-DCT) as float64: exact for these integer products, and
    torch has no int32/int64 matmul on CUDA."""
    n = 1 << log2
    dst = DST4 if n == 4 else DCT[n]
    return tuple(torch.tensor(np.asarray(m), dtype=torch.float64,
                              device=device) for m in (DCT[n], dst))


def _itx(d, m):
    """Two-stage inverse transform with the spec's clamps.  Every partial
    sum is below 32 * 90 * 2^15 < 2^27, so float64 is exact."""
    t = torch.matmul(m.T, d.double()).to(torch.int32)          # M^T d
    t = ((t + 64) >> 7).clamp(-32768, 32767)
    r = torch.matmul(t.double(), m).to(torch.int32)             # t M
    return ((r + (1 << (_SHIFT2 - 1))) >> _SHIFT2).clamp(-32768, 32767)


def batch_residual_ref(levels, qp, is_dst, tskip, log2: int, bypass=None,
                       scale_m=None):
    """Plain torch version: [n,s,s] int32 levels -> [n,s,s] int32 residual.

    qp [n] int32; is_dst, tskip, bypass [n] bool; scale_m [n,s,s] int32 or
    None (flat 16).  is_dst and tskip only act at log2 == 2."""
    d = _dequant(levels, qp, log2, scale_m)
    dct, dst = _mats(log2, levels.device)
    res = _itx(d, dct)
    if log2 == 2:
        res = torch.where(is_dst[:, None, None], _itx(d, dst), res)
        # transform skip: r = (d << 7 + off) >> shift2 on the flat dequant
        d_flat = _dequant(levels, qp, log2) if scale_m is not None else d
        ts = ((d_flat * 128 + (1 << (_SHIFT2 - 1))) >> _SHIFT2).clamp(
            -32768, 32767)
        res = torch.where(tskip[:, None, None], ts, res)
    if bypass is not None:
        res = torch.where(bypass[:, None, None], levels, res)
    return res


@functools.lru_cache(maxsize=None)
def _consts(log2: int, device: torch.device) -> torch.Tensor:
    """Kernel constants: [s*s DCT][16 DST (4x4) or zeros][6 levelScale]."""
    n = 1 << log2
    dst = np.asarray(DST4 if n == 4 else np.zeros((4, 4)))
    flat = np.concatenate([np.asarray(DCT[n]).ravel(), dst.ravel(),
                           np.asarray(LEVEL_SCALE)]).astype(np.int32)
    return torch.from_numpy(flat).to(device)


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"batch_residual: {name} must be {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def batch_residual(levels, qp, is_dst, tskip, log2: int, bypass=None,
                   scale_m=None):
    """Same contract as batch_residual_ref.  A CPU tensor takes the plain
    version; a CUDA tensor launches csrc/itransform.cu."""
    if levels.device.type == "cpu":
        return batch_residual_ref(levels, qp, is_dst, tskip, log2,
                                  bypass=bypass, scale_m=scale_m)
    if levels.device.type != "cuda":
        raise ValueError(f"batch_residual: no kernel for {levels.device}")
    if log2 not in (2, 3, 4, 5):
        raise ValueError(f"batch_residual: log2 {log2} not in 2..5")
    n, s, dev = levels.shape[0], 1 << log2, levels.device
    levels = _check(levels, "levels", torch.int32, (n, s, s), dev)
    qp = _check(qp, "qp", torch.int32, (n,), dev)
    is_dst = _check(is_dst, "is_dst", torch.bool, (n,), dev)
    tskip = _check(tskip, "tskip", torch.bool, (n,), dev)
    if bypass is not None:
        bypass = _check(bypass, "bypass", torch.bool, (n,), dev)
    if scale_m is not None:
        scale_m = _check(scale_m, "scale_m", torch.int32, (n, s, s), dev)
    out = torch.empty_like(levels)
    if n == 0:
        return out
    lib = _build.library()
    consts = _consts(log2, dev)
    with torch.cuda.device(dev):
        err = lib.p265_itransform(
            levels.data_ptr(), qp.data_ptr(), is_dst.data_ptr(),
            tskip.data_ptr(), None if bypass is None else bypass.data_ptr(),
            None if scale_m is None else scale_m.data_ptr(),
            consts.data_ptr(), out.data_ptr(), n, log2,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "itransform")
    _build.LAUNCHES["itransform"] += 1
    return out
