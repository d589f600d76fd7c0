"""Speed-of-light account of a decode: the census of a stream's work, the
bytes and multiply-adds of each stage and of each hand kernel, and the
least time a card could take for them.

    python -m p265_tpu_torch.roofline [stream] [measured.json]
        [--card NAME]

The counterpart of profiling/mfu_accounting.py, with the peaks of the card
(`--card`, default the CUDA card of this machine; an unknown card, or no
card, raises).  stream: a name of `p265_tpu_torch.testgen.streams`
(default s1080_ldp4).  measured.json: optional {stage: seconds a pass},
e.g. summed from profile_decode.py's stage table; each stage's share of
its bound is then printed beside it.

The census (`census(data)`) parses the stream with the port's
GoldenDecoder (native CTU parse, no reconstruction) and takes, for every
picture, what the main path is handed: the MC blocks of every (plane,
bucket, list) (kernels/mc.py mc_block_counts's tiling), the TUs of every
size from build_tensor_plan, split into inter TUs (hoisted out of the scan)
and intra TUs (the scan's), each counted in one class: bypass, transform
skip, 4x4 DST or DCT; the intra TUs' prediction modes, smoothed references
and available reference samples; the scan steps; the plane shapes.  The
census is of the work the stream needs, whatever implements it; the
calls of the main path carry the same TUs and blocks (mc_pred_planes
interpolates list 1 only for the blocks that read it, and skips pad
rows).

Rules of the count (`work(census)`; each stage and kernel is the function
it computes, so a narrower or fused implementation does not move its own
bound):

- Bytes: each value at the narrowest type that holds its spec range:
  levels, residuals and MC intermediates (14-bit) two bytes; reference,
  prediction and output samples one byte; a TU's qp one byte and its flags
  one byte; a block's position and its MV four bytes each (two 16-bit
  halves) and its reference index one byte; an intra TU's mode one byte,
  its flags one byte, its position four bytes.  Each input is read once
  and each output written once.  The reference samples of MC are the union
  of the blocks' (B+taps-1)^2 windows, clamped to the picture, over each
  reference picture and plane (what this stream's MVs need: a sample two
  blocks read counts once).  A scaling list counts its matrices once a
  picture (six a size, two at 32x32), one byte a coefficient.
- Operations (multiply-adds): the residual: a dequant multiply-add a
  coefficient (none for bypass), then the partial-butterfly transform, s^3
  a TU, 2 s^3 for a 4x4 DST, none for transform skip or bypass; an MC
  block: taps * ((B+taps-1) * B + B^2) a list (the separable filter); the
  MC combine adds one a sample of a list-1 block; the scan: planar 4 a
  sample, angular 2 a sample, DC none, and a smoothed reference 2 a
  sample of its 4s+2.  Deblocking, SAO and the fetch count bytes only.
- Stages: `mc` reads the references and the block records and writes the
  uint8 prediction samples of the inter PUs (K2 and the combine);
  `residual` is K1 over every TU (levels in, residuals out; since K1
  adds the hoisted inter TUs' residuals to their prediction itself, those
  read a prediction sample and write a reconstructed one where they
  wrote a residual: two bytes a sample either way); `scan` reads
  each intra TU's residual, its record and its available reference
  samples (each once a TU) and writes its samples; `deblock` reads and
  writes every plane and reads one byte of edge parameters a 4x4 luma
  block; `sao` reads and writes each plane it filters and reads 6 bytes
  of parameters a CTB and plane; `fetch` moves the output planes over the
  host link.
- Kernels: `itransform` (K1) is the residual stage; `mc` (K2) is the MC
  stage, since it interpolates, combines and places the samples in one
  launch (the 14-bit intermediates stay inside it); `scan` is the scan
  stage; `deblock` (the luma and chroma kernels, both directions) is the
  deblocking stage and `sao` the SAO stage: each filter kernel is the
  whole of its stage.
- Operation types: each function's operations are counted at the rate
  of the narrowest type that computes them exactly.  The MC filter
  multiplies 8-bit samples (first pass) or 16-bit intermediates (second
  pass) by 8-bit taps, and its sums stay below 2^24 in magnitude (at most
  96 * 2^15 for the luma taps); the combine adds two 15-bit values; the
  scan's prediction weights 8-bit samples by weights of at most 64.  All
  are exact in float32, so `mc` (K2 and the stage) and `scan` run at the
  card's float32 FMA rate (`Work.fp32`).  The first MC pass would also fit
  the int8 tensor cores; a faster rate can only lower the operations'
  time, and K2 on s1080_ldp4 is bound by its bytes at the float32 rate
  already.  The transform's sums of 16-bit coefficients times 8-bit
  matrix entries exceed 2^24, so `residual` stays at the int32 rate.
- Bound: the larger of bytes over the card's memory rate (the fetch: its
  host link) and operations over the rate of their type (`PEAKS`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from types import SimpleNamespace

import numpy as np

from p265_tpu_torch.kernels.mc import (CHROMA_BUCKETS, LUMA_BUCKETS,
                                       mc_block_counts)

# name (torch.cuda.get_device_name) -> peaks: HBM bytes/s, int32 and
# float32 multiply-adds/s on the CUDA cores, host-link bytes/s one way.
# H100 SXM (NVIDIA's data sheet): 3.35 TB/s HBM3; 132 SMs x 64 int32 lanes
# x 1.98 GHz boost; 132 SMs x 128 float32 lanes x 1.98 GHz (the sheet's
# 67 TFLOP/s, two flops an FMA); PCIe 5.0 x16, 64 GB/s each way.  At a
# power limit of 700 W; a card set lower runs slower under load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes_per_s=3.35e12,
                                  int32_per_s=132 * 64 * 1.98e9,
                                  fp32_per_s=132 * 128 * 1.98e9,
                                  link_bytes_per_s=64e9),
}
# a bound over a measured time above this is no card's: a fault of the
# count or of the measurement
MAX_SHARE = 1.05
STAGES = ("mc", "residual", "scan", "deblock", "sao", "fetch")
KERNELS = ("itransform", "mc", "scan", "deblock", "sao")
PLANES = ("y", "cb", "cr")
# a TU is counted in exactly one class, in this order of precedence
TU_CLASSES = ("bypass", "tskip", "dst", "dct")


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes and multiply-adds of one function; link: its bytes cross the
    host link (the fetch), not the card's memory; fp32: its operations are
    exact in float32 and run at that rate, else at the int32 rate."""
    bytes: int
    ops: int
    link: bool = False
    fp32: bool = False

    def __add__(self, other: "Work") -> "Work":
        if self.ops and other.ops and self.fp32 != other.fp32:
            raise ValueError("roofline: operations of two types in one sum")
        return Work(self.bytes + other.bytes, self.ops + other.ops,
                    self.link or other.link,
                    self.fp32 if self.ops else other.fp32)


def peaks(card: str) -> dict:
    if card not in PEAKS:
        raise ValueError(f"roofline: no peaks for card {card!r} (known: "
                         f"{sorted(PEAKS)})")
    return PEAKS[card]


def bound(work: Work, card: str) -> tuple:
    """(least ms the card could take for `work`, "bytes" or
    "operations": which of the two sets it)."""
    p = peaks(card)
    rate = p["link_bytes_per_s"] if work.link else p["bytes_per_s"]
    ops_rate = p["fp32_per_s"] if work.fp32 else p["int32_per_s"]
    t_bytes, t_ops = work.bytes / rate * 1e3, work.ops / ops_rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_ms(work: Work, card: str) -> float:
    return bound(work, card)[0]


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------


def tu_class(is_dst, tskip, bypass) -> np.ndarray:
    """Per TU its index in TU_CLASSES (flags as bool arrays)."""
    is_dst, tskip, bypass = (np.asarray(a, bool) for a in (is_dst, tskip,
                                                           bypass))
    return np.where(bypass, 0, np.where(tskip, 1, np.where(is_dst, 2, 3)))


def tu_counts(is_dst, tskip, bypass) -> dict:
    """{class: TUs} of a set of TUs of one size."""
    cls = tu_class(is_dst, tskip, bypass)
    return {c: int((cls == i).sum()) for i, c in enumerate(TU_CLASSES)}


def window_samples(rects, shape) -> int:
    """Distinct samples of a plane of `shape` that the rectangles (y0, x0,
    y1, x1; exclusive ends, may lie outside) read with coordinates clamped
    to the plane."""
    H, W = shape
    mask = np.zeros((H, W), bool)
    for y0, x0, y1, x1 in rects:
        mask[min(max(y0, 0), H - 1):min(max(y1 - 1, 0), H - 1) + 1,
             min(max(x0, 0), W - 1):min(max(x1 - 1, 0), W - 1) + 1] = True
    return int(mask.sum())


def mc_windows(pus, shapes) -> list:
    """Per plane the reference samples the MC of `pus` reads: the union,
    over each reference picture, of the PUs' interpolation windows (a PU's
    blocks share its MV, so the union of their windows is the PU's
    window)."""
    out = []
    for c, shape in enumerate(shapes):
        # integer-MV shift, window lead before and after the block
        unit, lead, tail = (2, 3, 4) if c == 0 else (3, 1, 2)
        rects = {}
        for p in pus:
            x, y, w, h = ((p.x, p.y, p.w, p.h) if c == 0 else
                          (p.x >> 1, p.y >> 1, p.w >> 1, p.h >> 1))
            for lx in (0, 1):
                if not p.motion.uses(lx):
                    continue
                mvx, mvy = p.motion.mv[lx]
                y0, x0 = y + (mvy >> unit) - lead, x + (mvx >> unit) - lead
                rects.setdefault(p.motion.ref_poc[lx], []).append(
                    (y0, x0, y0 + h + lead + tail, x0 + w + lead + tail))
        out.append(sum(window_samples(r, shape) for r in rects.values()))
    return out


def picture_census(plan, tplan) -> dict:
    """The census of one picture: its FramePlan and its TensorPlan (built
    from the parse, no prediction planes)."""
    sps = plan.sps
    H, W = sps.pic_height, sps.pic_width
    shapes = [(H, W), (H >> 1, W >> 1), (H >> 1, W >> 1)]
    mc = {}
    bi = SimpleNamespace(pus=[p for p in plan.pus
                              if p.motion.uses(0) and p.motion.uses(1)])
    for lx, pl in ((0, plan), (1, bi)):
        cnt = mc_block_counts(pl)
        for c, plane in enumerate(PLANES):
            grp, buckets = ("y", LUMA_BUCKETS) if c == 0 else ("c",
                                                              CHROMA_BUCKETS)
            for b in buckets:
                mc[plane, b, lx] = cnt[f"{grp}{b}"]
    tus, scan = {}, {}
    for pp in tplan.planes:
        for log2, b in pp.batches.items():
            inter = np.asarray(b.inter, bool)
            for split, m in (("inter", inter), ("intra", ~inter)):
                if not m.any():
                    continue
                t = tus.setdefault(log2, {}).setdefault(
                    split, dict.fromkeys(TU_CLASSES, 0))
                for k, v in tu_counts(b.is_dst[m], b.tskip[m],
                                      b.bypass[m]).items():
                    t[k] += v
            if inter.all():
                continue
            s = scan.setdefault(log2, dict(planar=0, angular=0, filtered=0,
                                           refs=0))
            mode = np.asarray(b.mode)[~inter]
            s["planar"] += int((mode == 0).sum())
            s["angular"] += int((mode >= 2).sum())
            s["filtered"] += int(np.asarray(b.filter_flag)[~inter].sum())
            s["refs"] += int(np.asarray(b.ok_scan)[~inter].sum())
    pred = [0, 0, 0]
    for p in plan.pus:
        pred[0] += p.w * p.h
        pred[1] += (p.w >> 1) * (p.h >> 1)
        pred[2] += (p.w >> 1) * (p.h >> 1)
    from p265_tpu_torch.kernels.loopfilter import filter_flags
    deblock, sao_luma, sao_chroma = filter_flags(plan)
    return dict(poc=plan.poc, inter=bool(plan.pus), shapes=shapes,
                ctbs=sps.num_ctbs, steps=max(pp.n_steps for pp in
                                             tplan.planes),
                mc=mc, ref_samples=mc_windows(plan.pus, shapes),
                pred_samples=pred, tus=tus, scan=scan,
                scaling=plan.scaling is not None,
                filters=dict(deblock=deblock, sao=[sao_luma, sao_chroma,
                                                   sao_chroma]))


def census(data: bytes) -> list:
    """Per picture, in decode order, its census (picture_census): the
    stream parsed by the port's GoldenDecoder with the native CTU parse
    and no reconstruction."""
    from p265_tpu_torch.plan.frame_plan import build_tensor_plan
    from p265_tpu_torch.run_config import parse_only
    pictures = []
    parse_only(lambda plan: pictures.append(picture_census(
        plan, build_tensor_plan(plan, skip_pred=True)))).decode_stream(data)
    return pictures


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------


def residual_work(log2: int, counts: dict) -> Work:
    """K1 over TUs of one size, {class: TUs} (TU_CLASSES)."""
    s = 1 << log2
    n = sum(counts.values())
    ops = (s * s * (n - counts["bypass"]) + s ** 3 * counts["dct"]
           + 2 * s ** 3 * counts["dst"])
    return Work(n * (4 * s * s + 2), ops)


def scaling_work(log2s) -> Work:
    """The scaling matrices of the sizes used, once."""
    return Work(sum((2 if log2 == 5 else 6) << 2 * log2 for log2 in log2s),
                0)


def mc_block_work(block: int, taps: int, n: int) -> Work:
    """The MC filter over n blocks of one geometry and list, references not
    counted: the block records in, the int16 intermediates out, the filter
    (the work of mc_blocks_grouped; the MC stage keeps the intermediates
    inside and writes samples)."""
    return Work(n * (4 + 4 + 1 + 2 * block * block),
                n * taps * ((block + taps - 1) * block + block * block),
                fp32=True)


def scan_work(log2: int, n: int, s: dict) -> Work:
    """The scan over n intra TUs of one size; s: scan census of them."""
    size = 1 << log2
    nbytes = n * (2 * size * size + 1 + 1 + 4 + size * size) + s["refs"]
    ops = (size * size * (4 * s["planar"] + 2 * s["angular"])
           + 2 * (4 * size + 2) * s["filtered"])
    return Work(nbytes, ops, fp32=True)


def picture_work(pic: dict) -> dict:
    """{stage or "k:" + kernel: Work} of one picture's census."""
    out = {k: Work(0, 0) for k in STAGES}
    interp = Work(sum(pic["ref_samples"]), 0, fp32=True)
    inter = combine = 0     # the filter's int16 outputs; the combine's adds
    for (plane, block, lx), n in pic["mc"].items():
        interp += mc_block_work(block, 8 if plane == "y" else 4, n)
        inter += 2 * n * block * block
        combine += n * block * block if lx else 0
    # the MC stage keeps the intermediates inside and writes uint8 samples
    out["mc"] = Work(interp.bytes - inter + sum(pic["pred_samples"]),
                     interp.ops + combine, fp32=True)
    res = Work(0, 0)
    for log2, split in pic["tus"].items():
        for counts in split.values():
            res += residual_work(log2, counts)
    if pic["scaling"]:
        res += scaling_work(pic["tus"])
    out["residual"] = res
    scan = Work(0, 0, fp32=True)
    for log2, s in pic["scan"].items():
        scan += scan_work(log2, sum(pic["tus"][log2]["intra"].values()), s)
    out["scan"] = scan
    plane_bytes = [h * w for h, w in pic["shapes"]]
    H, W = pic["shapes"][0]
    f = pic["filters"]
    if f["deblock"]:
        out["deblock"] = Work(2 * sum(plane_bytes) + H * W // 16, 0)
    out["sao"] = Work(sum(2 * b + 6 * pic["ctbs"] for b, on in
                          zip(plane_bytes, f["sao"]) if on), 0)
    out["fetch"] = Work(sum(plane_bytes), 0, link=True)
    out["k:itransform"], out["k:mc"], out["k:scan"] = res, out["mc"], scan
    out["k:deblock"], out["k:sao"] = out["deblock"], out["sao"]
    return out


def work(pictures: list) -> dict:
    """{"stages": {stage: Work}, "kernels": {kernel: Work}} summed over
    the pictures of a census (one pass of the stream)."""
    tot = {}
    for pic in pictures:
        for k, w in picture_work(pic).items():
            tot[k] = tot[k] + w if k in tot else w
    return dict(stages={k: tot.get(k, Work(0, 0, k == "fetch"))
                        for k in STAGES},
                kernels={k: tot.get("k:" + k, Work(0, 0)) for k in KERNELS})


def card_name() -> str:
    """The CUDA card of this machine; raises where there is none."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("roofline: no CUDA card; pass --card")
    return torch.cuda.get_device_name(0)


def table(name: str, pictures: list, card: str, measured: dict) -> str:
    """The per-stage table of one pass of a stream, as text."""
    w = work(pictures)
    lines = [f"{name}: one pass, {len(pictures)} pictures ("
             f"{sum(p['inter'] for p in pictures)} inter), {card}",
             f"{'stage':9s} {'MB':>10s} {'M MA':>11s} {'type':>5s} "
             f"{'bound ms':>9s} {'by':>10s} {'measured':>9s} {'share':>8s}"]
    for st, wk in [*w["stages"].items(),
                   *((f"K:{k}", v) for k, v in w["kernels"].items())]:
        ms, by = bound(wk, card)
        got = measured.get(st)
        lines.append(
            f"{st:12s} {wk.bytes / 1e6:10.4f} {wk.ops / 1e6:11.4f} "
            f"{('fp32' if wk.fp32 else 'int32') if wk.ops else '--':>5s} "
            f"{ms:9.5f} {by:>10s} "
            + (f"{got * 1e3:8.4f}ms {ms / (got * 1e3):8.4f}" if got else
               f"{'--':>9s} {'--':>8s}"))
    lines.append("scan steps a picture (sequential): "
                 + ", ".join(f"poc {p['poc']} {p['steps']}"
                             for p in pictures))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stream", nargs="?", default="s1080_ldp4")
    ap.add_argument("measured", nargs="?",
                    help="JSON {stage: seconds a pass}")
    ap.add_argument("--card", help="peaks of this card (default: the CUDA "
                    "card of this machine)")
    args = ap.parse_args(argv)
    card = args.card or card_name()
    peaks(card)
    measured = {}
    if args.measured:
        with open(args.measured) as f:
            measured = json.load(f)
    from p265_tpu_torch.testgen.streams import get_stream
    print(table(args.stream, census(get_stream(args.stream)), card,
                measured))
    return 0


if __name__ == "__main__":
    sys.exit(main())
