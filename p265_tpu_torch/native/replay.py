"""The motion replay of the native parse, in C: ctypes bindings for
replay.c, one call a picture.

The C parser (ctu.c) records the motion SYNTAX of P and B slices as CU/PU
events; `replay_motion` hands them, with the picture's maps, reference
lists and collocated grids, to replay.c, which derives every PU's merge or
AMVP motion (golden/mv.py mirrored bit for bit), writes the MotionCtx
grids in place and returns one row a PU.  The library is loaded with
`ctypes.CDLL`, so the interpreter lock is released for the whole call and
the recon worker's NumPy and Python run meanwhile.  The table stays the
picture's plan.pus (`PuList`): the MC pack reads it as it is, and PuRec
objects are built only for a reader that iterates it.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np

from p265_tpu_torch.native import _load

# a row of the PU table: x, y, w, h, mv[2][2], ref_idx[2], ref_poc[2], lt[2]
PU_W = 14

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class _NReplay(ctypes.Structure):
    _fields_ = [
        ("ev", _I32P), ("n_ev", ctypes.c_int32),
        ("pic_width", ctypes.c_int32), ("pic_height", ctypes.c_int32),
        ("log2_ctb", ctypes.c_int32), ("wc", ctypes.c_int32),
        ("h4", ctypes.c_int32), ("w4", ctypes.c_int32),
        ("tile_map4", _I32P), ("slice_of_ctb", _I32P), ("intra_map", _I32P),
        ("list_poc", _I32P * 2), ("list_lt", _U8P * 2),
        ("n_poc", ctypes.c_int32 * 2), ("n_lt", ctypes.c_int32 * 2),
        ("poc", ctypes.c_int32), ("no_backward", ctypes.c_int32),
        ("tmvp", ctypes.c_int32), ("collocated_from_l0", ctypes.c_int32),
        ("col_mv", _I32P), ("col_ref_poc", _I32P), ("col_lt", _U8P),
        ("col_h", ctypes.c_int32), ("col_w", ctypes.c_int32),
        ("col_poc", ctypes.c_int32),
        ("mv", _I32P), ("ref_idx", _I32P), ("ref_poc", _I32P), ("lt", _U8P),
        ("motion_coded", _I64P), ("cur_cu", ctypes.c_int64),
        ("pus", _I32P), ("n_pus", ctypes.c_int32),
        ("cap_pus", ctypes.c_int32)]


_lib = None


def _replay_load():
    global _lib
    if _lib is None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native parse library unavailable")
        lib.replay_motion.argtypes = [ctypes.POINTER(_NReplay)]
        lib.replay_motion.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ct)


def _check(a: np.ndarray, shape: tuple) -> np.ndarray:
    if a.shape != shape:
        raise ValueError(f"motion replay: shape {a.shape}, not {shape}")
    return a


def _grid(a, dtype, shape) -> np.ndarray:
    """A MotionCtx grid the C writes in place: checked, never copied."""
    if a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"motion replay: a {a.dtype} grid, or not "
                         f"contiguous, where {np.dtype(dtype)} is written")
    return _check(a, shape)


def replay_motion(events: np.ndarray, plan, mctx) -> np.ndarray:
    """Derive the motion of every PU of `events` (the C parser's [n, EV_W]
    CU/PU records, in parse order) into mctx's grids (mv, ref_idx,
    ref_poc, lt, motion_coded; cur_cu advanced) in one C call.
    -> the PU table, [n_pus, PU_W] int32, in event order."""
    sps, sh = mctx.sps, mctx.sh
    h4, w4 = (sps.pic_height + 3) >> 2, (sps.pic_width + 3) >> 2
    ev = np.ascontiguousarray(events, np.int32)
    keep = [ev]

    def ro(a, dtype, shape=None):
        a = np.ascontiguousarray(a, dtype)
        keep.append(a)
        return a if shape is None else _check(a, shape)

    r = _NReplay(
        ev=_ptr(ev, _I32P), n_ev=len(ev),
        pic_width=sps.pic_width, pic_height=sps.pic_height,
        log2_ctb=sps.log2_ctb_size, wc=sps.pic_width_ctbs, h4=h4, w4=w4,
        tile_map4=_ptr(ro(plan.tile_map4, np.int32, (h4, w4)), _I32P),
        slice_of_ctb=_ptr(ro(plan.slice_of_ctb, np.int32, (sps.num_ctbs,)),
                          _I32P),
        intra_map=_ptr(ro(plan.intra_map, np.int32, (h4, w4)), _I32P),
        poc=mctx.poc, no_backward=int(mctx.no_backward),
        tmvp=int(bool(sps.temporal_mvp_enabled and sh.temporal_mvp_enabled)),
        collocated_from_l0=int(bool(sh.collocated_from_l0)))
    for lx in (0, 1):
        pocs = ro(mctx.list_pocs[lx], np.int32)
        lts = ro(np.asarray(mctx.list_lt[lx], bool), np.uint8)
        r.list_poc[lx], r.n_poc[lx] = _ptr(pocs, _I32P), len(pocs)
        r.list_lt[lx], r.n_lt[lx] = _ptr(lts, _U8P), len(lts)
    if mctx.col_mv is not None:
        col_rp = ro(mctx.col_ref_poc, np.int32)
        ch, cw = col_rp.shape[:2]
        r.col_ref_poc = _ptr(_check(col_rp, (ch, cw, 2)), _I32P)
        r.col_mv = _ptr(ro(mctx.col_mv, np.int32, (ch, cw, 2, 2)), _I32P)
        if mctx.col_lt is not None:
            r.col_lt = _ptr(ro(mctx.col_lt, np.uint8, (ch, cw, 2)), _U8P)
        r.col_h, r.col_w, r.col_poc = ch, cw, mctx.col_poc
    r.mv = _ptr(_grid(mctx.mv, np.int32, (h4, w4, 2, 2)), _I32P)
    r.ref_idx = _ptr(_grid(mctx.ref_idx, np.int32, (h4, w4, 2)), _I32P)
    r.ref_poc = _ptr(_grid(mctx.ref_poc, np.int32, (h4, w4, 2)), _I32P)
    r.lt = _ptr(_grid(mctx.lt, np.bool_, (h4, w4, 2)), _U8P)
    r.motion_coded = _ptr(_grid(mctx.motion_coded, np.int64, (h4, w4)),
                          _I64P)
    r.cur_cu = mctx.cur_cu
    table = np.empty((len(ev), PU_W), np.int32)
    r.pus, r.cap_pus = _ptr(table, _I32P), len(table)
    n = _replay_load().replay_motion(ctypes.byref(r))
    if n < 0:
        raise ValueError(f"native motion replay failed (code {n})")
    mctx.cur_cu = int(r.cur_cu)
    return table[:n]


def pu_records(table: np.ndarray) -> list:
    """PuRec objects of a PU table, in its order: what iterating plan.pus
    yields to the golden recon and the census."""
    from p265_tpu_torch.golden.mv import Motion
    from p265_tpu_torch.syntax.ctu import PuRec
    return [PuRec(x, y, w, h, Motion([(a, b), (c, d)], [r0, r1], [p0, p1],
                                     [l0 != 0, l1 != 0]))
            for x, y, w, h, a, b, c, d, r0, r1, p0, p1, l0, l1
            in table.tolist()]


def pu_table(pus) -> np.ndarray:
    """The PU table of a picture's plan.pus: a PuList's own table, else
    one built from the PuRec objects (the Python parse, the encoder);
    list 0 or 1 unused where ref_idx < 0."""
    if isinstance(pus, PuList):
        return pus.table
    return np.array([(p.x, p.y, p.w, p.h, *p.motion.mv[0], *p.motion.mv[1],
                      *p.motion.ref_idx, *p.motion.ref_poc, *p.motion.lt)
                     for p in pus], np.int32).reshape(-1, PU_W)


class PuList(Sequence):
    """plan.pus of a picture the native parse replayed: the PU table, read
    only, and the PuRec objects built from it on first use.

    len() and bool() read the table, so the decoders' hot path (the MC
    pack reads `table`) builds no object; indexing and iteration build
    the objects once (pu_records).  Copies and pickles keep the table."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self._records = None

    def __len__(self) -> int:
        return len(self.table)

    def __getitem__(self, i):
        if self._records is None:
            self._records = pu_records(self.table)
        return self._records[i]

    def __iter__(self):
        return iter(self[:])
