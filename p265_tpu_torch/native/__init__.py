# Copy of p265_tpu/native/__init__.py.  Deviations: the library is built
# into p265_tpu_torch/build/ (gitignored), not beside its source, and is
# written under a temporary name and renamed into place, so processes
# that build at once never load a half-written file.
"""Native CABAC fast lane: builds cabac.c with the system compiler, loads it
via ctypes, and exposes drop-in decoder/context classes.

The pure-Python engine (entropy/engine.py) remains the reference; tests
assert exact agreement.  If no compiler is available the import degrades
gracefully (available() -> False) and everything runs pure Python.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from p265_tpu_torch.tables import CTX_OFFSET, NUM_CTX, init_context_array

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cabac.c")
_SRC_CTU = os.path.join(_DIR, "ctu.c")  # includes cabac.c (single TU)
_SO = os.path.join(os.path.dirname(_DIR), "build", "_cabac.so")

_lib = None


class _Cabac(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.c_void_p),
        ("nbits", ctypes.c_int64),
        ("pos", ctypes.c_int64),
        ("range", ctypes.c_uint32),
        ("offset", ctypes.c_uint32),
        ("state", ctypes.POINTER(ctypes.c_uint8)),
        ("mps", ctypes.POINTER(ctypes.c_uint8)),
        ("err", ctypes.c_int),
    ]


class _CtxOffsets(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in
                ("transform_skip_flag", "last_x", "last_y", "csbf",
                 "sig", "gt1", "gt2")]


def _build() -> bool:
    try:
        src = _SRC_CTU if os.path.exists(_SRC_CTU) else _SRC
        newest = max(os.path.getmtime(p) for p in (_SRC, _SRC_CTU)
                     if os.path.exists(p))
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest:
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["cc", "-O3", "-fPIC", "-shared", "-o", tmp, src],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_SO)
    lib.cabac_init.argtypes = [ctypes.POINTER(_Cabac), ctypes.c_char_p,
                               ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_uint8)]
    lib.cabac_init.restype = ctypes.c_int
    for name, args, res in (
            ("cabac_bin", [ctypes.POINTER(_Cabac), ctypes.c_int], ctypes.c_int),
            ("cabac_bypass", [ctypes.POINTER(_Cabac)], ctypes.c_int),
            ("cabac_bypass_bits", [ctypes.POINTER(_Cabac), ctypes.c_int],
             ctypes.c_int),
            ("cabac_terminate", [ctypes.POINTER(_Cabac)], ctypes.c_int),
            ("cabac_eg", [ctypes.POINTER(_Cabac), ctypes.c_int], ctypes.c_int),
            ("cabac_pos", [ctypes.POINTER(_Cabac)], ctypes.c_int64),
            ("cabac_err", [ctypes.POINTER(_Cabac)], ctypes.c_int)):
        f = getattr(lib, name)
        f.argtypes = args
        f.restype = res
    lib.residual_coding.argtypes = [
        ctypes.POINTER(_Cabac), ctypes.POINTER(_CtxOffsets),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.residual_coding.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


_OFFS = None


def _ctx_offsets():
    global _OFFS
    if _OFFS is None:
        _OFFS = _CtxOffsets(
            transform_skip_flag=CTX_OFFSET["transform_skip_flag"],
            last_x=CTX_OFFSET["last_sig_coeff_x_prefix"],
            last_y=CTX_OFFSET["last_sig_coeff_y_prefix"],
            csbf=CTX_OFFSET["coded_sub_block_flag"],
            sig=CTX_OFFSET["sig_coeff_flag"],
            gt1=CTX_OFFSET["coeff_abs_level_greater1_flag"],
            gt2=CTX_OFFSET["coeff_abs_level_greater2_flag"])
    return _OFFS


class NativeContextModels:
    """ContextModels with numpy uint8 storage shared with the C engine."""

    def __init__(self, init_type: int, qp: int):
        arr = init_context_array(init_type, qp)
        self.state = np.ascontiguousarray(arr[:, 0], np.uint8)
        self.mps = np.ascontiguousarray(arr[:, 1], np.uint8)

    def reinit(self, init_type: int, qp: int) -> None:
        arr = init_context_array(init_type, qp)
        self.state[:] = arr[:, 0]
        self.mps[:] = arr[:, 1]

    def snapshot(self):
        return (self.state.copy(), self.mps.copy())

    def restore(self, snap) -> None:
        self.state[:] = snap[0]
        self.mps[:] = snap[1]

    def idx(self, name: str, inc: int = 0) -> int:
        return CTX_OFFSET[name] + inc


class NativeCabacDecoder:
    """Drop-in replacement for entropy.engine.CabacDecoder backed by C."""

    def __init__(self, reader, ctx: NativeContextModels):
        lib = _load()
        assert lib is not None, "native cabac unavailable"
        self._lib = lib
        self.r = reader
        self.ctx = ctx
        self._buf = bytes(reader.data)
        self._c = _Cabac()
        sp = ctx.state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        mp = ctx.mps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        start = reader.pos
        assert start % 8 == 0, "native engine must start byte-aligned"
        # keep the sliced buffer alive: the C struct stores a raw pointer
        self._cbuf = self._buf[start // 8:]
        lib.cabac_init(ctypes.byref(self._c), self._cbuf,
                       len(self._cbuf), sp, mp)
        self._start_bits = start

    # -- engine ops ---------------------------------------------------------
    def decode_bin(self, idx: int) -> int:
        return self._lib.cabac_bin(ctypes.byref(self._c), idx)

    def decode(self, name: str, inc: int = 0) -> int:
        return self.decode_bin(CTX_OFFSET[name] + inc)

    def decode_bypass(self) -> int:
        return self._lib.cabac_bypass(ctypes.byref(self._c))

    def decode_bypass_bits(self, n: int) -> int:
        return self._lib.cabac_bypass_bits(ctypes.byref(self._c), n)

    def decode_terminate(self) -> int:
        t = self._lib.cabac_terminate(ctypes.byref(self._c))
        if self._lib.cabac_err(ctypes.byref(self._c)):
            raise ValueError("CABAC bit starvation (corrupt stream)")
        return t

    def decode_eg_bypass(self, k: int) -> int:
        return self._lib.cabac_eg(ctypes.byref(self._c), k)

    def save_ctx(self):
        return self.ctx.snapshot()

    def sync_reader(self) -> None:
        """Propagate the C-side bit position back into the BitReader (PCM)."""
        self.r.pos = self._start_bits + int(
            self._lib.cabac_pos(ctypes.byref(self._c)))

    # -- hot loop -----------------------------------------------------------
    def native_residual(self, log2: int, c_idx: int, scan_idx: int,
                        tskip_allowed: bool, sdh: bool, tq_bypass: bool):
        size = 1 << log2
        levels = np.zeros((size, size), np.int32)
        ret = self._lib.residual_coding(
            ctypes.byref(self._c), ctypes.byref(_ctx_offsets()),
            log2, c_idx, scan_idx, int(tskip_allowed), int(sdh),
            int(tq_bypass),
            levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if ret < 0:
            raise ValueError("corrupt residual block (native CABAC)")
        return levels, bool(ret)
