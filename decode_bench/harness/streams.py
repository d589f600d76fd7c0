"""The pool's inputs: committed Annex-B streams, checked against the
benchmark's own table of SHA-256 sums, and the segments cut from them.

A pool item is a stream name (the whole stream is one segment) or
`<stream>.<cut>`, a segment cut from that stream by CUTS[cut].  Streams
are read from the program's committed data directory and never encoded:
a missing stream, or one whose bytes do not match `streams.sha256` here,
raises.
"""
from __future__ import annotations

import hashlib
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
DATA_DIR = os.path.join(REPO_DIR, "p265_tpu_torch", "data")
SUMS = os.path.join(BENCH_DIR, "streams.sha256")

NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34
PARAMETER_SETS = (NAL_VPS, NAL_SPS, NAL_PPS)


def sums(path: str = SUMS) -> dict:
    """{stream: sha256 hex} of the sums file (`sha256sum` format)."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                digest, name = line.split()
                out[name.removesuffix(".265")] = digest
    return out


def read_stream(name: str, data_dir: str = DATA_DIR,
                sums_path: str = SUMS) -> bytes:
    """The committed stream `name`, its sha256 checked."""
    want = sums(sums_path).get(name)
    if want is None:
        raise ValueError(f"stream {name!r} has no sum in {sums_path}")
    path = os.path.join(data_dir, name + ".265")
    if not os.path.exists(path):
        raise FileNotFoundError(f"stream {name!r} is not committed at {path}")
    with open(path, "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != want:
        raise ValueError(f"stream {name!r}: sha256 {got} is not {want}")
    return data


def nal_units(data: bytes) -> list:
    """[(nal_type, first_slice_segment_in_pic_flag, raw bytes)] of an
    Annex-B stream, each unit with its start code (a 4-byte start code
    keeps its leading zero)."""
    starts, i = [], data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\x00\x00\x01", i + 3)
    units = []
    for k, s in enumerate(starts):
        begin = s - 1 if s > 0 and data[s - 1] == 0 else s
        end = starts[k + 1] if k + 1 < len(starts) else len(data)
        if k + 1 < len(starts) and data[end - 1] == 0:
            end -= 1             # the next unit's 4-byte start code
        hdr = s + 3
        if hdr + 2 >= len(data):
            continue
        t = (data[hdr] >> 1) & 63
        first = bool(data[hdr + 2] & 0x80)
        units.append((t, first, data[begin:end]))
    return units


def is_slice(t: int) -> bool:
    return t <= 9 or 16 <= t <= 21


def is_irap(t: int) -> bool:
    return 16 <= t <= 23


def first_irap_access_unit(data: bytes) -> bytes:
    """The first IRAP picture of a stream as a segment of its own: every
    parameter set before it, then the picture's slice units."""
    units = nal_units(data)
    params, pic, inside = [], [], False
    for t, first, raw in units:
        if inside:
            if is_slice(t) and not first:
                pic.append(raw)
                continue
            break
        if t in PARAMETER_SETS:
            params.append(raw)
        elif is_irap(t) and first:
            inside = True
            pic.append(raw)
    if not pic:
        raise ValueError("no IRAP picture in the stream")
    return b"".join(params + pic)


CUTS = {"idr": first_irap_access_unit}


def segment_bytes(item: str, **kw) -> bytes:
    """The bytes of pool item `item`: a stream, or `<stream>.<cut>`."""
    stream, _, cut = item.partition(".")
    data = read_stream(stream, **kw)
    if not cut:
        return data
    if cut not in CUTS:
        raise ValueError(f"pool item {item!r}: no cut {cut!r} "
                         f"(known: {sorted(CUTS)})")
    return CUTS[cut](data)
