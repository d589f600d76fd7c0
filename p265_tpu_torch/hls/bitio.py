"""MSB-first bit reader/writer with Exp-Golomb codes (spec 9.2, 7.2).

Host-side only; NumPy-friendly byte buffers.  The reader operates on RBSP
(emulation-prevention already removed by p265_tpu.hls.nal).
"""
from __future__ import annotations


class BitReader:
    def __init__(self, data: bytes | bytearray | memoryview):
        self.data = bytes(data)
        self.pos = 0  # bit position

    # -- core ---------------------------------------------------------------
    def read_bit(self) -> int:
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def u(self, n: int) -> int:
        return self.read_bits(n)

    def ue(self) -> int:
        zeros = 0
        while self.read_bit() == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("invalid exp-golomb code")
        return (1 << zeros) - 1 + (self.read_bits(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    # -- alignment / state --------------------------------------------------
    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data before the rbsp_stop_one_bit (spec 7.2)."""
        if self.bits_left() <= 0:
            return False
        last_one = _last_set_bit_pos(self.data)  # the rbsp_stop_one_bit
        return self.pos < last_one

    def byte_pos(self) -> int:
        return self.pos >> 3


def _last_set_bit_pos(data: bytes) -> int:
    for byte_idx in range(len(data) - 1, -1, -1):
        b = data[byte_idx]
        if b:
            for bit in range(8):  # lowest-order set bit = last in MSB-first order
                if b & (1 << bit):
                    return byte_idx * 8 + (7 - bit)
    return 0


class BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bit(self, b: int) -> None:
        self.cur = (self.cur << 1) | (b & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.bytes.append(self.cur)
            self.cur = 0
            self.nbits = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def u(self, v: int, n: int) -> None:
        self.write_bits(v, n)

    def ue(self, v: int) -> None:
        assert v >= 0
        code = v + 1
        n = code.bit_length()
        self.write_bits(0, n - 1)
        self.write_bits(code, n)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def byte_aligned(self) -> bool:
        return self.nbits == 0

    def align_zero(self) -> None:
        while self.nbits:
            self.write_bit(0)

    def align_one_then_zero(self) -> None:
        """byte_alignment(): alignment_bit_equal_to_one then zeros (7.3.2.10)."""
        self.write_bit(1)
        self.align_zero()

    def rbsp_trailing_bits(self) -> None:
        self.write_bit(1)
        self.align_zero()

    def bit_pos(self) -> int:
        return len(self.bytes) * 8 + self.nbits

    def get_bytes(self) -> bytes:
        assert self.nbits == 0, "unaligned writer"
        return bytes(self.bytes)
