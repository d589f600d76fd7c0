"""The repo's named benchmark streams, made with the port's own encoder.

The counterpart of `tools/make_streams.py`: the same names, sizes, QPs,
seeds and PPS flags in `GENERATORS`, so both write the same bytes for a
name.  `get_stream(name)` reads `p265_tpu_torch/data/<name>.265` when it is
committed (checked against `data/SHA256SUMS`); otherwise it encodes the
stream once into a cache directory under the system's temporary directory
(the pure-Python encoder takes minutes at 1080p and 4K).

    python -m p265_tpu_torch.testgen.streams [name ...]   (default: all)

writes each named stream that is not committed into the cache and prints
its size, time and sha256; `--out DIR` writes them into DIR instead (how
the committed ones were made).
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import time

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def cache_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "p265_torch_streams")


def _enc(w, h, qp=32, **kw):
    from p265_tpu_torch.hls.params import PPS, SPS
    from p265_tpu_torch.testgen.encoder import Encoder
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    return Encoder(sps, pps, qp=qp, **kw), sps, pps


def _intra(w, h, seed=3, qp=32, **pps_kw):
    from p265_tpu_torch.hls.params import PPS, SPS
    from p265_tpu_torch.testgen.encoder import IntraEncoder, make_test_image
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=qp, sign_data_hiding=True, **pps_kw)
    img = make_test_image(w, h, seed)
    stream, _, _ = IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(img)
    return stream


def _gop(w, h, n, structure, seed=5, qp=32):
    from p265_tpu_torch.testgen.encoder import make_moving_sequence
    enc, sps, pps = _enc(w, h, qp=qp, seed=seed)
    frames = make_moving_sequence(w, h, n, seed=seed)
    stream, _ = enc.encode_sequence(frames, structure)
    return stream


GENERATORS = {
    "s1080": lambda: _intra(1920, 1080),
    "s1080_ldp4": lambda: _gop(1920, 1080, 4, "LDP"),
    "s1080_ldp16": lambda: _gop(1920, 1080, 16, "LDP"),
    "s1080_ra8": lambda: _gop(1920, 1080, 8, "RA"),
    "s416_ldp4": lambda: _gop(416, 240, 4, "LDP"),
    "s832_ldp4": lambda: _gop(832, 480, 4, "LDP"),
    "s4k": lambda: _intra(3840, 2160),
    "s1080_t8": lambda: _intra(1920, 1080, tiles_enabled=True,
                               num_tile_columns=4, num_tile_rows=2),
    "s1080_t8w": lambda: _intra(1920, 1080, tiles_enabled=True,
                                num_tile_columns=4, num_tile_rows=2,
                                entropy_coding_sync_enabled=True),
}


def committed_sums() -> dict:
    """file name -> sha256 hex of every committed stream."""
    with open(os.path.join(DATA, "SHA256SUMS")) as f:
        return dict(reversed(line.split()) for line in f if line.strip())


def committed(name: str) -> bytes | None:
    """The committed bytes of stream `name`, checked against SHA256SUMS;
    None if it is not committed."""
    fn = name + ".265"
    sums = committed_sums()
    if fn not in sums:
        return None
    with open(os.path.join(DATA, fn), "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != sums[fn]:
        raise ValueError(f"{fn} does not match its sha256 in SHA256SUMS")
    return data


def stream_info(data: bytes) -> dict:
    """What a stream's headers say: the picture size, the number of
    pictures (slices with first_slice_segment_in_pic_flag), the tile grid
    (columns, rows; (1, 1) without tiles) and the WPP flag of its first
    SPS and PPS."""
    from p265_tpu_torch.hls import nal
    from p265_tpu_torch.hls.params import parse_pps, parse_sps
    sps = pps = None
    frames = 0
    for u in nal.split_nal_units(data):
        if u.nal_type == nal.NAL_SPS and sps is None:
            sps = parse_sps(u.rbsp)
        elif u.nal_type == nal.NAL_PPS and pps is None:
            pps = parse_pps(u.rbsp)
        elif nal.is_slice_nal(u.nal_type):
            frames += u.rbsp[0] >> 7
    tiles = ((pps.num_tile_columns, pps.num_tile_rows) if pps.tiles_enabled
             else (1, 1))
    return dict(width=sps.pic_width, height=sps.pic_height, frames=frames,
                tiles=tiles, wpp=bool(pps.entropy_coding_sync_enabled))


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def get_stream(name: str) -> bytes:
    """The named stream: committed (the GENERATORS' streams and the small
    streams of data/, e.g. s96x64_ldp5), cached, or encoded into the
    cache."""
    data = committed(name)
    if data is not None:
        return data
    if name not in GENERATORS:
        raise KeyError(f"unknown stream {name!r}; known: "
                       f"{', '.join(GENERATORS)} and the committed "
                       f"{', '.join(sorted(committed_sums()))}")
    path = os.path.join(cache_dir(), name + ".265")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    data = GENERATORS[name]()
    _write(path, data)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="default: every stream")
    ap.add_argument("--out", help="write every named stream here, "
                    "committed or not (default: the cache)")
    args = ap.parse_args(argv)
    for name in args.names or list(GENERATORS):
        t0 = time.perf_counter()
        if args.out:
            if name not in GENERATORS:
                raise KeyError(f"unknown stream {name!r}")
            data = GENERATORS[name]()
            _write(os.path.join(args.out, name + ".265"), data)
        else:
            data = get_stream(name)
        print(f"{name}: {len(data)} bytes in {time.perf_counter() - t0:.1f} "
              f"s, sha256 {hashlib.sha256(data).hexdigest()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
