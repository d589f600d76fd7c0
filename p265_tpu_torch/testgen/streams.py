"""The repo's named benchmark streams, made with the port's own encoder.

The counterpart of `tools/make_streams.py`: the same names, sizes, QPs,
seeds and PPS flags in `GENERATORS`, so both write the same bytes for a
name; the names of `PORT_ONLY` follow them, streams only the port's
encoder makes (`s1080_ra17`: the CTC's random access, testgen/ctc.py).
`CONFIG5` holds the streams of BASELINE configuration 5 (4K random-access
multi-stream decode): four one-segment RA GOPs of 5 pictures (IDR, P at
POC 4, B at 2, 1, 3) from four seeds.
`get_stream(name)` serves both tables: it reads
`p265_tpu_torch/data/<name>.265` when it is committed (checked against `data/SHA256SUMS`); otherwise it encodes the
stream once into a cache directory under the system's temporary directory
(the pure-Python encoder takes minutes at 1080p and 4K).

    python -m p265_tpu_torch.testgen.streams [name ...] [--out DIR]
        [--golden-md5]      (default: every GENERATORS stream; CONFIG5's
                             streams by name)

writes each named stream that is not committed into the cache and prints
its size, time and sha256; `--out DIR` writes them into DIR instead (how
the committed ones were made).  `--golden-md5` then decodes each with the
port's GoldenDecoder and merges the MD5 of every plane of every picture,
before and after the loop filters, into `GOLDEN_MD5` (in DIR, else in
data/): the committed `data/GOLDEN_MD5` lets a 4K decode be gated without
a pure-Python golden decode.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import time

import numpy as np

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


def _ra_ctc(w, h, n, seed=5, qp=32, jobs=1):
    """The CTC's random access (testgen/ctc.py "RA-CTC"): an IDR, then
    GOPs of 8 hierarchical B pictures with their QP offsets, two active
    references a list, AMP and TMVP; `jobs` worker processes (the bytes do
    not depend on it)."""
    from p265_tpu_torch.hls.params import PPS
    from p265_tpu_torch.testgen.ctc import N_REF, CtcEncoder, ra_ctc_sps
    from p265_tpu_torch.testgen.encoder import make_moving_sequence
    sps = ra_ctc_sps(w, h)
    pps = PPS(init_qp=qp, sign_data_hiding=True,
              num_ref_idx_l0_default=N_REF[0],
              num_ref_idx_l1_default=N_REF[1])
    frames = make_moving_sequence(w, h, n, seed=seed)
    stream, _ = CtcEncoder(sps, pps, qp=qp, seed=seed).encode_sequence(
        frames, "RA-CTC", jobs=jobs)
    return stream


# make_streams' names first, in its order; the port's own recipes after
# them (PORT_ONLY)
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
    # up to five pictures of a GOP have all their references coded at once
    "s1080_ra17": lambda: _ra_ctc(1920, 1080, 17, jobs=5),
}
PORT_ONLY = ("s1080_ra17",)

# BASELINE configuration 5: 4K random-access streams, one IRAP segment
# (one hierarchical mini-GOP) each, decoded over the stream axis and the
# space axis.  Not in GENERATORS, which stays make_streams' list.
CONFIG5 = {f"s4k_ra5_s{s}": (lambda s=s: _gop(3840, 2160, 5, "RA", seed=s))
           for s in (5, 6, 7, 8)}


def generator(name: str):
    """The recipe of stream `name`, from GENERATORS or CONFIG5."""
    if name in GENERATORS:
        return GENERATORS[name]
    if name in CONFIG5:
        return CONFIG5[name]
    raise KeyError(f"unknown stream {name!r}; known: "
                   f"{', '.join([*GENERATORS, *CONFIG5])} and the committed "
                   f"{', '.join(sorted(committed_sums()))}")


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


def decode_order(data: bytes) -> list:
    """(poc, slice type, width, height) of every picture in decode order
    (slice type 0 B, 1 P, 2 I), from the port's native CTU parse alone,
    with no reconstruction."""
    from p265_tpu_torch.run_config import parse_only
    plans = []
    parse_only(plans.append).decode_stream(data)
    return [(p.poc, p.sh.slice_type, p.sps.pic_width, p.sps.pic_height)
            for p in plans]


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
    make = generator(name)
    path = os.path.join(cache_dir(), name + ".265")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    data = make()
    _write(path, data)
    return data


PLANE_STAGES = ("pre", "post")


def plane_md5(plane) -> str:
    """MD5 of a plane's samples as uint8, row-major (full coded size)."""
    a = np.asarray(plane)
    if a.min() < 0 or a.max() > 255:
        raise ValueError("sample outside 0..255")
    return hashlib.md5(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def planes_md5(frames) -> dict:
    """{(poc, stage, plane): md5} of decoded frames: every plane, before
    ("pre") and after ("post") the loop filters, host arrays or
    tensors."""
    out = {}
    for f in frames:
        for stage, planes in zip(PLANE_STAGES, (f.prefilter, f.planes)):
            for c in range(3):
                p = planes[c]
                out[(f.poc, stage, c)] = plane_md5(
                    p.cpu().numpy() if hasattr(p, "cpu") else p)
    return out


def golden_md5(data: bytes) -> dict:
    """planes_md5 of the port's GoldenDecoder on `data`."""
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    return planes_md5(GoldenDecoder().decode_stream(data))


def read_md5(path: str | None = None) -> dict:
    """name -> {(poc, stage, plane): md5} from a GOLDEN_MD5 file (default:
    the committed data/GOLDEN_MD5; lines `name poc stage plane md5`)."""
    out = {}
    path = path or os.path.join(DATA, "GOLDEN_MD5")
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                name, poc, stage, c, md5 = line.split()
                out.setdefault(name, {})[(int(poc), stage, int(c))] = md5
    return out


def write_md5(path: str, table: dict) -> None:
    lines = ["# name poc stage plane md5: the port's GoldenDecoder planes "
             "(uint8, full coded size, row-major); stage pre/post the loop "
             "filters; plane 0 Y, 1 Cb, 2 Cr\n"]
    for name in sorted(table):
        for (poc, stage, c), md5 in sorted(table[name].items()):
            lines.append(f"{name} {poc} {stage} {c} {md5}\n")
    _write(path, "".join(lines).encode())


def golden_md5_of(name: str) -> dict:
    """The committed golden MD5s of stream `name`; KeyError if it has
    none."""
    table = read_md5()
    if name not in table:
        raise KeyError(f"{name} has no lines in data/GOLDEN_MD5")
    return table[name]


def check_md5(frames, expected: dict, what: str,
              complete: bool = True) -> None:
    """Every plane of every decoded frame (planes_md5) against `expected`
    ({(poc, stage, plane): md5}), and, where `complete`, every expected
    picture decoded; raises on a difference."""
    got = planes_md5(frames)
    for (poc, stage, c), md5 in got.items():
        if (poc, stage, c) not in expected:
            raise RuntimeError(f"{what}: poc {poc} has no golden MD5")
        if md5 != expected[(poc, stage, c)]:
            raise RuntimeError(f"{what}: poc {poc} {stage} plane {c} "
                               "differs from golden's MD5")
    if complete and set(got) != set(expected):
        raise RuntimeError(f"{what}: {len(got)} planes decoded, golden's "
                           f"MD5 has {len(expected)}")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="default: every GENERATORS "
                    "stream")
    ap.add_argument("--out", help="write every named stream here, "
                    "committed or not (default: the cache)")
    ap.add_argument("--golden-md5", action="store_true",
                    help="decode each with GoldenDecoder and merge its "
                    "planes' MD5s into GOLDEN_MD5 (in --out, else data/)")
    args = ap.parse_args(argv)
    md5_path = os.path.join(args.out or DATA, "GOLDEN_MD5")
    for name in args.names or list(GENERATORS):
        t0 = time.perf_counter()
        if args.out:
            data = generator(name)()
            _write(os.path.join(args.out, name + ".265"), data)
        else:
            data = get_stream(name)
        print(f"{name}: {len(data)} bytes in {time.perf_counter() - t0:.1f} "
              f"s, sha256 {hashlib.sha256(data).hexdigest()}", flush=True)
        if args.golden_md5:
            t0 = time.perf_counter()
            lines = golden_md5(data)
            table = read_md5(md5_path)
            table[name] = lines
            write_md5(md5_path, table)
            print(f"{name}: golden MD5 of {len(lines)} planes in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
