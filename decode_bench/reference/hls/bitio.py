"""MSB-first bit reader with Exp-Golomb codes (spec 9.2, 7.2).

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


