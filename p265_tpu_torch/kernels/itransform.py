"""Batched dequant + inverse transform (spec 8.6.2-8.6.4), bit-exact.

Counterpart of p265_tpu/kernels/itransform.py (`batch_residual_ref`, the
plain version) and p265_tpu/kernels/pallas_itransform.py (the kernel:
csrc/itransform.cu behind `batch_residual_grouped`, which computes the TUs
of every size of one call site in one launch; `batch_residual` is its
one-size call).  The kernel reads the reference's wire dtypes as a
dispatch stages them (kernels/staging.py): levels int16 (or int32), qp and
scale_m uint8, positions uint16 or int32; its wrapper refuses any other
dtype.  The plain versions take the same fields and widen them.  With a
`plane`, the residuals are added in place to the plane at each TU's
position and clipped (the hoisted inter TUs, the counterpart of the
reference's flat scatter and clip in p265_tpu/pipeline/batch_decode.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from p265_tpu_torch.tables import DCT, DST4, LEVEL_SCALE
from p265_tpu_torch.kernels import _build
from p265_tpu_torch.kernels.staging import widen

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
    """Plain torch version: [n,s,s] levels -> [n,s,s] int32 residual.

    levels int16 or int32; qp [n] uint8 (the wire dtype) or any wider
    integer; is_dst (None: no DST), tskip, bypass [n] bool; scale_m
    [n,s,s] uint8 (or wider) or None (flat 16).  Every integer field is
    widened to int32 here (int16 products would overflow).  is_dst and
    tskip only act at log2 == 2."""
    levels, qp = widen(levels, torch.int32), widen(qp, torch.int32)
    if scale_m is not None:
        scale_m = widen(scale_m, torch.int32)
    d = _dequant(levels, qp, log2, scale_m)
    dct, dst = _mats(log2, levels.device)
    res = _itx(d, dct)
    if log2 == 2:
        if is_dst is not None:
            res = torch.where(is_dst[:, None, None], _itx(d, dst), res)
        # transform skip: r = (d << 7 + off) >> shift2 on the flat dequant
        d_flat = _dequant(levels, qp, log2) if scale_m is not None else d
        ts = ((d_flat * 128 + (1 << (_SHIFT2 - 1))) >> _SHIFT2).clamp(
            -32768, 32767)
        res = torch.where(tskip[:, None, None], ts, res)
    if bypass is not None:
        res = torch.where(bypass[:, None, None], levels, res)
    return res


def batch_residual_grouped_ref(groups: dict, plane=None):
    """Plain version of batch_residual_grouped: one batch_residual_ref call
    per size, then (with a plane) clip(plane + residual, 0, 255) written
    back at each TU's samples."""
    res = {log2: batch_residual_ref(f["coeffs"], f["qp"], f.get("is_dst"),
                                    f["tskip"], log2,
                                    bypass=f.get("bypass"),
                                    scale_m=f.get("scale_m"))
           for log2, f in groups.items()}
    if plane is None:
        return res
    flat, pw = plane.view(-1), plane.shape[1]
    for log2, f in groups.items():
        ar = torch.arange(1 << log2, device=plane.device)
        pos = widen(f["pos"], torch.int64)
        idx = ((pos[:, 0, None, None] + ar[None, :, None]) * pw
               + pos[:, 1, None, None] + ar[None, None, :]).reshape(-1)
        flat[idx] = (flat[idx] + res[log2].reshape(-1)).clamp(0, 255)
    return plane


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> torch.Tensor:
    """Kernel tables: [DCT 4x4][8x8][16x16][32x32][DST 4x4][levelScale]."""
    flat = np.concatenate([np.asarray(DCT[n]).ravel() for n in (4, 8, 16, 32)]
                          + [np.asarray(DST4).ravel(),
                             np.asarray(LEVEL_SCALE)]).astype(np.int32)
    return torch.from_numpy(flat).to(device)


def _check(t, name, dtypes, shape, device):
    """t as the kernel reads it: one of `dtypes` (never cast here), shape
    and device; a mismatch raises."""
    if (t.dtype not in dtypes or tuple(t.shape) != shape
            or t.device != device):
        raise ValueError(f"batch_residual: {name} must be {dtypes} {shape} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def _aligned(t):
    """t, or a copy of it that starts on 16 bytes (the kernel stages levels
    and scale_m by 16-byte cp.async)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def batch_residual_grouped(groups: dict, plane=None):
    """Residuals of TUs of several sizes: {log2: fields} -> {log2: [n,s,s]
    int32}, views of one flat buffer; or, with `plane` ([rows, pw] int32,
    contiguous), the plane, each TU's residual added in place at its
    position and clipped to 0..255.

    fields: coeffs [n,s,s] int16 or int32, qp [n] uint8, tskip [n] bool,
    optionally is_dst and bypass [n] bool and scale_m [n,s,s] uint8, and
    with a plane pos [n,2] (row, col) uint16 or int32 (one dtype for all
    sizes); other keys are ignored.  Each size computes exactly
    batch_residual_grouped_ref.  A CPU tensor takes the plain version;
    CUDA tensors launch csrc/itransform.cu once for all sizes, at these
    dtypes only (any other raises)."""
    if not groups:
        return {} if plane is None else plane
    dev = next(iter(groups.values()))["coeffs"].device
    if dev.type == "cpu":
        return batch_residual_grouped_ref(groups, plane)
    if dev.type != "cuda":
        raise ValueError(f"batch_residual: no kernel for {dev}")
    return _grouped_kernel(groups, dev, plane)


def _grouped_kernel(groups: dict, dev, plane=None):
    u8, b8 = (torch.uint8,), (torch.bool,)
    coords = (torch.uint16, torch.int32)
    if plane is not None and (plane.dtype != torch.int32 or plane.dim() != 2
                              or not plane.is_contiguous()
                              or plane.device != dev):
        raise ValueError(f"batch_residual: plane must be contiguous int32 "
                         f"[rows, pw] on {dev}, got {plane.dtype} "
                         f"{tuple(plane.shape)} on {plane.device}")
    pos_dt = None
    table = np.zeros((len(groups), 11), np.int64)
    alive, views, off = [], {}, 0
    for row, (log2, f) in enumerate(groups.items()):
        if log2 not in (2, 3, 4, 5):
            raise ValueError(f"batch_residual: log2 {log2} not in 2..5")
        n, s = f["coeffs"].shape[0], 1 << log2
        lv = _aligned(_check(f["coeffs"], "coeffs",
                             (torch.int16, torch.int32), (n, s, s), dev))
        ts = [_check(f["qp"], "qp", u8, (n,), dev),
              _check(f["tskip"], "tskip", b8, (n,), dev)]
        opt = [None if f.get(k) is None else _check(f[k], k, dt, shape, dev)
               for k, dt, shape in (("is_dst", b8, (n,)),
                                    ("bypass", b8, (n,)),
                                    ("scale_m", u8, (n, s, s)))]
        opt[2] = _aligned(opt[2])
        pos = None
        if plane is not None:
            pos = _check(f["pos"], "pos", (pos_dt,) if pos_dt else coords,
                         (n, 2), dev)
            pos_dt = pos.dtype
        alive += [lv, *ts, *opt, pos]
        ptr = [0 if t is None else t.data_ptr() for t in (*opt, pos)]
        table[row] = (lv.data_ptr(), ts[0].data_ptr(), ptr[0],
                      ts[1].data_ptr(), ptr[1], ptr[2], off, n, log2,
                      lv.dtype == torch.int32, ptr[3])
        views[log2] = (off, n, s)
        off += n * s * s
    out = (torch.empty(off, dtype=torch.int32, device=dev) if plane is None
           else None)
    if off:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.p265_itransform_grouped(
                table.ctypes.data, len(groups), _consts(dev).data_ptr(),
                0 if out is None else out.data_ptr(),
                0 if plane is None else plane.data_ptr(),
                0 if plane is None else plane.shape[1],
                int(pos_dt == torch.int32),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "itransform")
        _build.LAUNCHES["itransform"] += 1
    if plane is not None:
        return plane
    return {log2: out[o:o + n * s * s].view(n, s, s)
            for log2, (o, n, s) in views.items()}


def batch_residual(levels, qp, is_dst, tskip, log2: int, bypass=None,
                   scale_m=None):
    """Same contract as batch_residual_ref: batch_residual_grouped with one
    size."""
    return batch_residual_grouped({log2: dict(
        coeffs=levels, qp=qp, is_dst=is_dst, tskip=tskip, bypass=bypass,
        scale_m=scale_m)})[log2]
