"""The work of a decode, frozen: bytes and multiply-adds of each stage and
kernel, and the least time a card could take for them.

A copy of the arithmetic of `p265_tpu_torch/roofline.py` (`Work`,
`bound`, `residual_work`, `scaling_work`, `mc_block_work`, `scan_work`,
`picture_work`, `work`), so that a later change of the program cannot
move the yardstick; tests/test_work.py holds it equal to the program's
on a committed stream.  The rules of the count are that module's
docstring: each input read once and each output written once, at the
narrowest type that holds its spec range; operations at the rate of the
narrowest type that computes them exactly.

tools/freeze_work.py applies `work` to the census of each pool item and
writes the sums to work/<item>.json; timed and traced runs only read
those files (`load`).  The peaks of each card are peaks.json.
"""
from __future__ import annotations

import dataclasses
import json
import os

from decode_bench.harness.streams import BENCH_DIR

WORK_DIR = os.path.join(BENCH_DIR, "work")
PEAKS_PATH = os.path.join(BENCH_DIR, "peaks.json")
STAGES = ("mc", "residual", "scan", "deblock", "sao", "fetch")
KERNELS = ("itransform", "mc", "scan", "deblock", "sao")


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
            raise ValueError("work: operations of two types in one sum")
        return Work(self.bytes + other.bytes, self.ops + other.ops,
                    self.link or other.link,
                    self.fp32 if self.ops else other.fp32)


def peaks(card: str, path: str = PEAKS_PATH) -> dict | None:
    """The card's peaks (peaks.json), None for a card not in the table."""
    with open(path) as f:
        return json.load(f).get(card)


def bound_ms(work: Work, peak: dict) -> float:
    """The least ms a card of peaks `peak` could take for `work`: the
    larger of its bytes over the memory (or host-link) rate and its
    operations over the rate of their type."""
    rate = peak["link_bytes_per_s"] if work.link else peak["bytes_per_s"]
    ops_rate = peak["fp32_per_s"] if work.fp32 else peak["int32_per_s"]
    return max(work.bytes / rate, work.ops / ops_rate) * 1e3


def residual_work(log2: int, counts: dict) -> Work:
    """K1 over TUs of one size, {class: TUs}."""
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
    counted: the block records in, the int16 intermediates out."""
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
    inter = combine = 0
    for (plane, block, lx), n in pic["mc"].items():
        interp += mc_block_work(block, 8 if plane == "y" else 4, n)
        inter += 2 * n * block * block
        combine += n * block * block if lx else 0
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
    the pictures of a census (one decode of the segment)."""
    tot = {}
    for pic in pictures:
        for k, w in picture_work(pic).items():
            tot[k] = tot[k] + w if k in tot else w
    return dict(stages={k: tot.get(k, Work(0, 0, k == "fetch"))
                        for k in STAGES},
                kernels={k: tot.get("k:" + k, Work(0, 0)) for k in KERNELS})


def to_json(w: dict) -> dict:
    return {kind: {k: dataclasses.asdict(v) for k, v in d.items()}
            for kind, d in w.items()}


def load(item: str, work_dir: str = WORK_DIR) -> dict | None:
    """{"stages": {stage: Work}, "kernels": {kernel: Work}} of one decode
    of pool item `item` (work/<item>.json); None where it was not frozen."""
    path = os.path.join(work_dir, item + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    return {kind: {k: Work(**v) for k, v in rec[kind].items()}
            for kind in ("stages", "kernels")}
