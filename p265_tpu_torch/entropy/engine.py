"""CABAC arithmetic coding engine (spec 9.3.4.3 decode; encoder mirrors the
informative encoding process so that testgen streams are conformant).

The decoder is the normative HEVC binary arithmetic decoder: 9-bit offset,
range in [256, 510], context-coded / bypass / terminate bins.  The encoder is
the classic put-bit + outstanding-bits formulation whose output the normative
decoder accepts (same engine as H.264/HEVC reference encoders).

Pure Python here is the correctness baseline; the batched/native fast lanes
live alongside it and are tested against it (SURVEY.md section 7.5).
"""
from __future__ import annotations

import numpy as np

from p265_tpu_torch.tables import (
    CTX_OFFSET,
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
    init_context_array,
)
from p265_tpu_torch.hls.bitio import BitReader, BitWriter

_RANGE_LPS = RANGE_TAB_LPS.tolist()
_TRANS_LPS = TRANS_IDX_LPS.tolist()


class ContextModels:
    """Flat context state array: [NUM_CTX] pStateIdx, valMps packed as ints."""

    def __init__(self, init_type: int, qp: int):
        arr = init_context_array(init_type, qp)
        self.state = arr[:, 0].tolist()
        self.mps = arr[:, 1].tolist()

    def snapshot(self) -> tuple[list[int], list[int]]:
        return list(self.state), list(self.mps)

    def reinit(self, init_type: int, qp: int) -> None:
        arr = init_context_array(init_type, qp)
        self.state = arr[:, 0].tolist()
        self.mps = arr[:, 1].tolist()

    def restore(self, snap: tuple[list[int], list[int]]) -> None:
        self.state = list(snap[0])
        self.mps = list(snap[1])

    def idx(self, name: str, inc: int = 0) -> int:
        return CTX_OFFSET[name] + inc


class CabacDecoder:
    def __init__(self, reader: BitReader, ctx: ContextModels):
        self.r = reader
        self.ctx = ctx
        self.range = 510
        self.offset = reader.read_bits(9)

    def decode_bin(self, ctx_idx: int) -> int:
        ctx = self.ctx
        state = ctx.state[ctx_idx]
        lps = _RANGE_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            # LPS path
            bin_val = 1 - ctx.mps[ctx_idx]
            self.offset -= self.range
            self.range = lps
            if state == 0:
                ctx.mps[ctx_idx] = 1 - ctx.mps[ctx_idx]
            ctx.state[ctx_idx] = _TRANS_LPS[state]
        else:
            bin_val = ctx.mps[ctx_idx]
            if state < 62:
                ctx.state[ctx_idx] = state + 1
        # renormalize
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.r.read_bit()
        return bin_val

    def decode(self, name: str, inc: int = 0) -> int:
        return self.decode_bin(CTX_OFFSET[name] + inc)

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self.r.read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.r.read_bit()
        return 0

    # -- common binarizations ----------------------------------------------
    def decode_unary_ctx(self, name: str, incs: list[int], c_max: int) -> int:
        """Truncated-unary with per-bin context increments (last inc repeats)."""
        v = 0
        while v < c_max:
            inc = incs[min(v, len(incs) - 1)]
            if self.decode(name, inc) == 0:
                break
            v += 1
        return v

    def decode_eg_bypass(self, k: int) -> int:
        """Exp-Golomb order k, bypass bins (spec 9.3.3.3)."""
        n = 0
        while self.decode_bypass() == 1:
            n += 1
            if n > 32:
                raise ValueError("EGk prefix too long (corrupt stream)")
        # value = (2^n - 1) * 2^k + suffix(n+k bits)
        suffix = self.decode_bypass_bits(n + k) if (n + k) else 0
        return (((1 << n) - 1) << k) + suffix

    # WPP / tiles support
    def save_ctx(self):
        return self.ctx.snapshot()


class CabacEncoder:
    def __init__(self, writer: BitWriter, ctx: ContextModels):
        self.w = writer
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self.w.write_bit(b)
        while self.bits_outstanding > 0:
            self.w.write_bit(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put_bit(0)
            elif self.low >= 512:
                self.low -= 512
                self._put_bit(1)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def encode_bin(self, ctx_idx: int, bin_val: int) -> None:
        ctx = self.ctx
        state = ctx.state[ctx_idx]
        lps = _RANGE_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if bin_val != ctx.mps[ctx_idx]:
            self.low += self.range
            self.range = lps
            if state == 0:
                ctx.mps[ctx_idx] = 1 - ctx.mps[ctx_idx]
            ctx.state[ctx_idx] = _TRANS_LPS[state]
        else:
            if state < 62:
                ctx.state[ctx_idx] = state + 1
        self._renorm()

    def encode(self, name: str, inc: int, bin_val: int) -> None:
        self.encode_bin(CTX_OFFSET[name] + inc, bin_val)

    def encode_bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put_bit(1)
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def encode_bypass_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.encode_bypass((v >> i) & 1)

    def encode_terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put_bit((self.low >> 9) & 1)
            # WriteBits(((low >> 7) & 3) | 1, 2): direct write incl. stop '1'
            b = ((self.low >> 7) & 3) | 1
            self.w.write_bit((b >> 1) & 1)
            self.w.write_bit(b & 1)
        else:
            self._renorm()

    def encode_unary_ctx(self, name: str, incs: list[int], c_max: int, v: int) -> None:
        for i in range(v):
            self.encode(name, incs[min(i, len(incs) - 1)], 1)
        if v < c_max:
            self.encode(name, incs[min(v, len(incs) - 1)], 0)

    def encode_eg_bypass(self, k: int, v: int) -> None:
        n = 0
        while v >= (1 << (n + k)):
            v -= 1 << (n + k)
            n += 1
        for _ in range(n):
            self.encode_bypass(1)
        self.encode_bypass(0)
        if n + k:
            self.encode_bypass_bits(v, n + k)

    def save_ctx(self):
        return self.ctx.snapshot()
