"""Command line of the PyTorch/CUDA port: decode.

    python -m p265_tpu_torch.cli decode -i in.265 -o out.yuv --md5 --device cuda

Counterpart of the `decode` subcommand of p265_tpu/cli.py, through
PipelinedTorchDecoder.  The device is explicit: a machine without a CUDA
card must ask for `--device cpu`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _cmd_decode(args) -> int:
    from p265_tpu_torch import yuv
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    dec = PipelinedTorchDecoder(args.device)
    with open(args.input, "rb") as f:
        data = f.read()
    frames = dec.decode_stream(data)
    out = [[np.clip(p, 0, 255) for p in f.cropped_planes()] for f in frames]
    if args.output:
        yuv.write_yuv(args.output, out)
    if args.md5:
        print("MD5:", yuv.sequence_md5(out))
    print(f"decoded {len(frames)} frames on {dec.device} "
          f"({dec.stats['parse_s']:.2f}s parse, "
          f"{dec.stats['recon_s']:.2f}s recon dispatch, "
          f"{dec.stats['fetch_s']:.2f}s fetch)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="p265_tpu_torch",
        description="HEVC decoder, PyTorch/CUDA reconstruction")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="decode an Annex-B HEVC stream")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output")
    d.add_argument("--md5", action="store_true")
    d.add_argument("--device", required=True,
                   help="torch device of the reconstruction: cuda, cuda:N "
                        "or cpu")
    d.set_defaults(fn=_cmd_decode)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
