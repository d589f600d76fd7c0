"""The pool's inputs: committed Annex-B streams, each checked against the
benchmark's own SHA-256 sum of it, and the segments cut from them.

A pool item is a stream name (the whole stream is one segment) or
`<stream>.<cut>`, a segment cut from that stream by CUTS[cut].  Streams
are read from the program's committed data directory and never encoded.
The sum of stream `<stream>` is the one line of `sums/<stream>.sha256`
(`sha256sum` format: `<hex>  <stream>.265`), so adding a stream to the
pool takes one new file there.  A stream with no sum file, a sum file
that is not one such line naming its own stream, a missing stream, or
one whose bytes do not match its sum, raises.
"""
from __future__ import annotations

import hashlib
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
DATA_DIR = os.path.join(REPO_DIR, "p265_tpu_torch", "data")
SUMS_DIR = os.path.join(BENCH_DIR, "sums")
SUM_SUFFIX = ".sha256"

NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34
PARAMETER_SETS = (NAL_VPS, NAL_SPS, NAL_PPS)


def read_sum(name: str) -> str:
    """The sha256 hex of stream `name`: the one line of
    `<SUMS_DIR>/<name>.sha256`, checked to name that stream.  SUMS_DIR is
    read at each call, so a test can point it elsewhere."""
    path = os.path.join(SUMS_DIR, name + SUM_SUFFIX)
    if not os.path.exists(path):
        raise ValueError(f"stream {name!r} has no sum: {path} is not there")
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) != 1:
        raise ValueError(f"{path}: {len(lines)} lines, not one")
    digest, *named = lines[0].split() or [""]
    if named != [name + ".265"]:
        raise ValueError(f"{path}: the line names {' '.join(named)!r}, "
                         f"not {name + '.265'!r}")
    if not re.fullmatch("[0-9a-f]{64}", digest):
        raise ValueError(f"{path}: the digest {digest!r} is not 64 "
                         f"lowercase hex digits")
    return digest


def sums() -> dict:
    """{stream: sha256 hex} over every sum file of SUMS_DIR."""
    names = [f.removesuffix(SUM_SUFFIX) for f in sorted(os.listdir(SUMS_DIR))
             if f.endswith(SUM_SUFFIX)]
    return {name: read_sum(name) for name in names}


def read_stream(name: str, data_dir: str = DATA_DIR) -> bytes:
    """The committed stream `name`, its sha256 checked against its sum
    file."""
    want = read_sum(name)
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
    """The bytes of pool item `item`: a stream, or `<stream>.<cut>`.
    kw: read_stream's `data_dir`."""
    stream, _, cut = item.partition(".")
    data = read_stream(stream, **kw)
    if not cut:
        return data
    if cut not in CUTS:
        raise ValueError(f"pool item {item!r}: no cut {cut!r} "
                         f"(known: {sorted(CUTS)})")
    return CUTS[cut](data)
