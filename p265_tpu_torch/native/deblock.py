"""The deblocking edge parameters in C: ctypes bindings for deblock.c, one
call a picture.

`edge_params` hands deblock.c a picture's int32 maps (intra, cbf, QP,
edge flags and, for an inter picture, the motion grids) where they are,
with the slice's beta and tc offsets and the PPS's chroma QP offsets; the
C derives the boundary strengths once, for luma and chroma alike, and
writes both directions' bS, beta, tc and chroma tc as int16 straight into
the picture's slice of a batch's grids (kernels/loopfilter.py
`pack_filter_params`).  The grids equal what `luma_edge_params` and
`chroma_edge_params` return, bit for bit.  The library is loaded with
`ctypes.CDLL`, so the interpreter lock is released for the whole call and
the parse thread's Python runs meanwhile.
"""
from __future__ import annotations

import ctypes

import numpy as np

from p265_tpu_torch.native import _load
from p265_tpu_torch.tables import BETA_TABLE, CHROMA_QP_TABLE, TC_TABLE

_I32P = ctypes.POINTER(ctypes.c_int32)
_I16P = ctypes.POINTER(ctypes.c_int16)


class _NDeblock(ctypes.Structure):
    _fields_ = [
        ("w", ctypes.c_int32), ("h", ctypes.c_int32),
        ("h4", ctypes.c_int32), ("w4", ctypes.c_int32),
        ("intra_map", _I32P), ("cbf_map", _I32P), ("qp_map", _I32P),
        ("edge_flags", _I32P), ("mv", _I32P), ("ref_poc", _I32P),
        ("beta_off", ctypes.c_int32), ("tc_off", ctypes.c_int32),
        ("c_off", ctypes.c_int32 * 2),
        ("beta_table", _I32P), ("tc_table", _I32P), ("qpc_table", _I32P),
        ("bs", _I16P * 2), ("beta", _I16P * 2), ("tc", _I16P * 2),
        ("tcc", (_I16P * 2) * 2)]


_lib = None
_TABLES = tuple(np.ascontiguousarray(t, np.int32)
                for t in (BETA_TABLE, TC_TABLE, CHROMA_QP_TABLE))


def _deblock_load():
    global _lib
    if _lib is None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native parse library unavailable")
        lib.deblock_params.argtypes = [ctypes.POINTER(_NDeblock)]
        lib.deblock_params.restype = None
        _lib = lib
    return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ct)


def grid_shapes(w: int, h: int) -> dict:
    """{direction: (luma [n_s, n_e], chroma [n_cs, n_ce])} of a w x h
    picture's grids, as luma_edge_params and chroma_edge_params shape
    them (no edge: n_e or n_ce 0)."""
    return {"v": ((h // 4, len(range(8, w, 8))),
                  (h // 8, len(range(16, w, 16)))),
            "h": ((w // 4, len(range(8, h, 8))),
                  (w // 8, len(range(16, h, 16))))}


def edge_params(plan, out: list) -> None:
    """Write one picture's grids in one C call.  out: per direction
    (vertical, then horizontal) the picture's int16 C-contiguous grids
    [bS, beta, tc, tc_cb, tc_cr], of grid_shapes' shapes."""
    sps, sh, pps = plan.sps, plan.sh, plan.pps
    w, h = sps.pic_width, sps.pic_height
    h4, w4 = (h + 3) >> 2, (w + 3) >> 2
    keep = []

    def ro(a, shape):
        a = np.ascontiguousarray(a, np.int32)
        if a.shape != shape:
            raise ValueError(f"deblocking parameters: a map of shape "
                             f"{a.shape}, not {shape}")
        keep.append(a)
        return _ptr(a, _I32P)

    d = _NDeblock(
        w=w, h=h, h4=h4, w4=w4,
        intra_map=ro(plan.intra_map, (h4, w4)),
        cbf_map=ro(plan.cbf_map, (h4, w4)),
        qp_map=ro(plan.qp_map, (h4, w4)),
        edge_flags=ro(plan.edge_flags, (h4, w4)),
        beta_off=sh.beta_offset_div2 * 2, tc_off=sh.tc_offset_div2 * 2,
        beta_table=_ptr(_TABLES[0], _I32P), tc_table=_ptr(_TABLES[1], _I32P),
        qpc_table=_ptr(_TABLES[2], _I32P))
    d.c_off[0], d.c_off[1] = pps.cb_qp_offset, pps.cr_qp_offset
    if plan.mv_map is not None:
        d.mv = ro(plan.mv_map, (h4, w4, 2, 2))
        d.ref_poc = ro(plan.ref_map, (h4, w4, 2))
    for i, (luma, chroma) in enumerate(grid_shapes(w, h).values()):
        grids = out[i]
        for g, shape in zip(grids, (luma,) * 3 + (chroma,) * 2):
            if (g.dtype != np.int16 or g.shape != shape
                    or not g.flags["C_CONTIGUOUS"]):
                raise ValueError(f"deblocking parameters: a {g.dtype} grid "
                                 f"of shape {g.shape} where int16 {shape}, "
                                 "contiguous, is written")
        d.bs[i], d.beta[i], d.tc[i] = (_ptr(g, _I16P) for g in grids[:3])
        d.tcc[i][0], d.tcc[i][1] = (_ptr(g, _I16P) for g in grids[3:])
    _deblock_load().deblock_params(ctypes.byref(d))
