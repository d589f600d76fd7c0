"""Annex-B byte stream and NAL unit layer (spec B.2, 7.3.1, 7.4.2).

NumPy-vectorized start-code scan and emulation-prevention removal.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# NAL unit types (spec Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_STSA_N = 4
NAL_STSA_R = 5
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_BLA_W_RADL = 17
NAL_BLA_N_LP = 18
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_SEI_PREFIX = 39
NAL_SEI_SUFFIX = 40


def is_slice_nal(t: int) -> bool:
    return t <= 21


def is_irap(t: int) -> bool:
    return 16 <= t <= 23


def is_idr(t: int) -> bool:
    return t in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def is_reference_nal(t: int) -> bool:
    """Sub-layer reference picture (spec 7.4.2.2): odd VCL types < 16 are _R."""
    if t >= 16:
        return True
    return (t & 1) == 1


@dataclass
class NalUnit:
    nal_type: int
    layer_id: int
    temporal_id: int  # TemporalId = nuh_temporal_id_plus1 - 1
    rbsp: bytes


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation_prevention_three_bytes (spec 7.4.2: 00 00 03 -> 00 00)."""
    arr = np.frombuffer(ebsp, dtype=np.uint8)
    if len(arr) < 3:
        return bytes(ebsp)
    z = arr == 0
    # positions i where arr[i]==3 and arr[i-1]==0 and arr[i-2]==0
    is_ep = np.zeros(len(arr), dtype=bool)
    is_ep[2:] = (arr[2:] == 3) & z[1:-1] & z[:-2]
    # an escaped 0x03 must not itself count as a zero for the NEXT window:
    # 00 00 03 00 00 03 -> both 03s are EP bytes; the vector test above already
    # handles this because the 03 breaks the zero run.
    return arr[~is_ep].tobytes()


def split_nal_units(stream: bytes) -> list[NalUnit]:
    """Scan an Annex-B stream into NAL units (vectorized start-code search)."""
    arr = np.frombuffer(stream, dtype=np.uint8)
    n = len(arr)
    if n < 4:
        return []
    # find all 00 00 01 positions
    sc = np.flatnonzero((arr[:-2] == 0) & (arr[1:-1] == 0) & (arr[2:] == 1))
    if len(sc) == 0:
        return []
    units = []
    starts = sc + 3  # first payload byte (NAL header)
    for i, s in enumerate(starts):
        end = sc[i + 1] if i + 1 < len(sc) else n
        # trailing zeros before the next start code belong to it (4-byte codes)
        while end > s and arr[end - 1] == 0:
            end -= 1
        payload = arr[s:end].tobytes()
        if len(payload) < 2:
            continue
        ebsp = ebsp_to_rbsp(payload)
        h0, h1 = ebsp[0], ebsp[1]
        units.append(NalUnit(
            nal_type=(h0 >> 1) & 63,
            layer_id=((h0 & 1) << 5) | (h1 >> 3),
            temporal_id=(h1 & 7) - 1,
            rbsp=ebsp[2:],
        ))
    return units
