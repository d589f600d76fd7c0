"""Command line of the PyTorch/CUDA port: decode / encode / info.

    python -m p265_tpu_torch.cli decode -i in.265 -o out.yuv --md5 \
        [--device cuda] [--pipelined] [--resilient] [--metrics m.jsonl]
    python -m p265_tpu_torch.cli decode -i in.265 --backend golden --md5
    python -m p265_tpu_torch.cli encode -i in.yuv --size 416x240 -o out.265 \
        --qp 32 --gop RA --frames 9
    python -m p265_tpu_torch.cli info -i in.265

Counterpart of p265_tpu/cli.py, with its subcommands and flags.  `decode`
takes `--backend torch` (default; TorchDecoder, or PipelinedTorchDecoder
with `--pipelined`) or `golden`.  The torch backend reconstructs on
`--device`, `cuda` by default; a machine without a CUDA card must ask for
`--device cpu` (the default fails there in torch, with no fallback).
`encode` is the port's copy of the test encoder.
"""
from __future__ import annotations

import argparse
import sys


def _cmd_decode(args) -> int:
    import numpy as np

    from p265_tpu_torch import yuv
    if args.backend == "torch":
        if args.pipelined:
            from p265_tpu_torch.pipeline.async_decoder import \
                PipelinedTorchDecoder as Dec
        else:
            from p265_tpu_torch.pipeline.decoder import TorchDecoder as Dec
        dec = Dec(args.device)
    else:
        from p265_tpu_torch.golden.decoder import GoldenDecoder
        dec = GoldenDecoder()
    dec.error_resilient = args.resilient
    with open(args.input, "rb") as f:
        data = f.read()
    frames = dec.decode_stream(data)
    out = [[np.clip(p, 0, 255) for p in f.cropped_planes()] for f in frames]
    if args.output:
        yuv.write_yuv(args.output, out)
    if args.md5:
        print("MD5:", yuv.sequence_md5(out))
    if args.metrics:
        dec.write_metrics(args.metrics)
    if dec.errors:
        print(f"{len(dec.errors)} corrupt slices skipped (resynced at IRAP)",
              file=sys.stderr)
    # the torch backend's stages: recon is the pack + device dispatch, the
    # filters run inside it, and the copy to the host is its own stage
    last = (f"{dec.stats['fetch_s']:.2f}s fetch" if "fetch_s" in dec.stats
            else f"{dec.stats['filter_s']:.2f}s filters")
    print(f"decoded {len(frames)} frames "
          f"({dec.stats['parse_s']:.2f}s parse, "
          f"{dec.stats['recon_s']:.2f}s recon, {last})")
    return 0


def _cmd_encode(args) -> int:
    from p265_tpu_torch import yuv
    from p265_tpu_torch.hls.params import PPS, SPS
    from p265_tpu_torch.testgen.encoder import Encoder, make_moving_sequence

    w, h = (int(v) for v in args.size.split("x"))
    sps = SPS(pic_width=w, pic_height=h,
              temporal_mvp_enabled=args.gop != "AI",
              long_term_ref_pics_present=args.gop == "LDP-LT",
              num_reorder_pics=2 if args.gop in ("RA", "CRA-RASL") else 0,
              max_dec_pic_buffering=5)
    pps = PPS(init_qp=args.qp, sign_data_hiding=True)
    if args.tiles:
        tc, tr = (int(v) for v in args.tiles.split("x"))
        pps.tiles_enabled = True
        pps.num_tile_columns = tc
        pps.num_tile_rows = tr
    if args.wpp:
        pps.entropy_coding_sync_enabled = True
    if args.input == "synthetic":
        frames = make_moving_sequence(w, h, args.frames, seed=args.seed)
    else:
        frames = yuv.read_yuv(args.input, w, h)[:args.frames or None]
    enc = Encoder(sps, pps, qp=args.qp, seed=args.seed)
    if args.gop == "AI":
        from p265_tpu_torch.hls import nal as N
        from p265_tpu_torch.hls.bitio import BitWriter
        from p265_tpu_torch.hls.params import write_pps, write_sps, write_vps
        stream = b""
        for nal_type, write, arg in ((N.NAL_VPS, write_vps, ()),
                                     (N.NAL_SPS, write_sps, (sps,)),
                                     (N.NAL_PPS, write_pps, (pps,))):
            wtr = BitWriter()
            write(wtr, *arg)
            stream += N.make_nal(nal_type, wtr.get_bytes())
        for f in frames:
            nb, *_ = enc.encode_frame(f, poc=0, slice_type=2)
            stream += nb
    else:
        stream, _ = enc.encode_sequence(frames, structure=args.gop,
                                        num_slices=args.slices)
    with open(args.output, "wb") as f:
        f.write(stream)
    print(f"encoded {len(frames)} frames -> {len(stream)} bytes")
    return 0


def _cmd_info(args) -> int:
    from p265_tpu_torch.hls import nal
    from p265_tpu_torch.hls.params import parse_pps, parse_sps

    with open(args.input, "rb") as f:
        data = f.read()
    counts = {}
    for u in nal.split_nal_units(data):
        counts[u.nal_type] = counts.get(u.nal_type, 0) + 1
        if u.nal_type == nal.NAL_SPS:
            s = parse_sps(u.rbsp)
            print(f"SPS: {s.pic_width}x{s.pic_height} CTB {s.ctb_size} "
                  f"SAO={s.sao_enabled} TMVP={s.temporal_mvp_enabled}")
        elif u.nal_type == nal.NAL_PPS:
            p = parse_pps(u.rbsp)
            print(f"PPS: qp={p.init_qp} tiles={p.tiles_enabled} "
                  f"wpp={p.entropy_coding_sync_enabled} "
                  f"sdh={p.sign_data_hiding}")
    print("NAL units:", dict(sorted(counts.items())))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="p265_tpu_torch",
        description="HEVC decoder, PyTorch/CUDA reconstruction")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode an Annex-B HEVC stream")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output")
    d.add_argument("--backend", choices=("golden", "torch"), default="torch")
    d.add_argument("--device", default="cuda",
                   help="torch device of the reconstruction: cuda "
                        "(default), cuda:N or cpu")
    d.add_argument("--md5", action="store_true")
    d.add_argument("--metrics", help="append JSONL run metrics to this file")
    d.add_argument("--resilient", action="store_true",
                   help="skip corrupt slices, resync at next IRAP")
    d.add_argument("--pipelined", action="store_true",
                   help="overlap host parse with device reconstruction")
    d.set_defaults(fn=_cmd_decode)

    e = sub.add_parser("encode", help="encode YUV (or synthetic) to HEVC")
    e.add_argument("-i", "--input", default="synthetic",
                   help="planar YUV420 file or 'synthetic'")
    e.add_argument("-o", "--output", required=True)
    e.add_argument("--size", required=True, help="WxH")
    e.add_argument("--qp", type=int, default=32)
    e.add_argument("--frames", type=int, default=5)
    e.add_argument("--gop", choices=("AI", "LDP", "LDP2", "LDP-LT", "RA",
                                     "CRA-RASL"),
                   default="LDP")
    e.add_argument("--tiles", help="CxR tile grid")
    e.add_argument("--wpp", action="store_true")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--slices", type=int, default=1,
                   help="independent slices per picture")
    e.set_defaults(fn=_cmd_encode)

    i = sub.add_parser("info", help="inspect an Annex-B stream")
    i.add_argument("-i", "--input", required=True)
    i.set_defaults(fn=_cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
