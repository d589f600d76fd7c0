"""Tile geometry and substream segmentation (spec 6.5.1, 7.4.7.1).

Computes CTB decode order (tile-raster), per-CTB tile ids, and the substream
segmentation used for tiles (one substream per tile) and WPP (one per CTB
row).  Entry point offsets are byte counts in the RBSP domain (emulation
prevention removed) -- internally consistent between our encoder and decoder;
provenance note: no spec text on disk to confirm the EPB counting convention
(SURVEY.md 7.7).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from decode_bench.reference.hls.params import PPS, SPS


def _uniform_split(total: int, n: int) -> list[int]:
    """Spec 6.5.1 uniform tile spacing: sizes of n columns covering total."""
    return [((i + 1) * total) // n - (i * total) // n for i in range(n)]


@dataclass
class TileInfo:
    col_widths: list[int]          # in CTBs
    row_heights: list[int]
    col_bounds: list[int]          # cumulative starts + end
    row_bounds: list[int]
    ctb_scan: list[int]            # raster-scan CTB addresses in decode order
    tile_of_ctb: np.ndarray        # [num_ctbs] tile index by raster address
    segments: list[list[int]]      # decode-order CTB addrs per substream
    wpp: bool = False

    def tile_id_at(self, x_ctb: int, y_ctb: int) -> int:
        ci = next(i for i in range(len(self.col_widths))
                  if self.col_bounds[i] <= x_ctb < self.col_bounds[i + 1])
        ri = next(i for i in range(len(self.row_heights))
                  if self.row_bounds[i] <= y_ctb < self.row_bounds[i + 1])
        return ri * len(self.col_widths) + ci


def build_tile_info(sps: SPS, pps: PPS) -> TileInfo:
    wc, hc = sps.pic_width_ctbs, sps.pic_height_ctbs
    if pps.tiles_enabled:
        nc, nr = pps.num_tile_columns, pps.num_tile_rows
        if pps.uniform_spacing:
            cw = _uniform_split(wc, nc)
            rh = _uniform_split(hc, nr)
        else:
            cw = list(pps.tile_column_widths)
            cw = cw + [wc - sum(cw)]
            rh = list(pps.tile_row_heights)
            rh = rh + [hc - sum(rh)]
    else:
        cw, rh = [wc], [hc]
    cb = [0]
    for w in cw:
        cb.append(cb[-1] + w)
    rb = [0]
    for h in rh:
        rb.append(rb[-1] + h)

    tile_of = np.zeros(wc * hc, np.int32)
    scan: list[int] = []
    segments: list[list[int]] = []
    for ri in range(len(rh)):
        for ci in range(len(cw)):
            seg = []
            for y in range(rb[ri], rb[ri + 1]):
                for x in range(cb[ci], cb[ci + 1]):
                    addr = y * wc + x
                    tile_of[addr] = ri * len(cw) + ci
                    scan.append(addr)
                    seg.append(addr)
            segments.append(seg)
    wpp = pps.entropy_coding_sync_enabled
    if wpp:
        # one substream per CTB row of each tile (spec 7.4.7.1: with both
        # tiles and entropy_coding_sync enabled, substreams are the rows
        # within each tile, in tile decode order)
        segments = []
        for ri in range(len(rh)):
            for ci in range(len(cw)):
                for y in range(rb[ri], rb[ri + 1]):
                    segments.append([y * wc + x
                                     for x in range(cb[ci], cb[ci + 1])])
    elif not pps.tiles_enabled:
        segments = [scan]
    return TileInfo(cw, rh, cb, rb, scan, tile_of, segments, wpp)
