"""CTU-level syntax: coding quadtree, CU/PU/TU, SAO params (spec 7.3.8).

Stage-A design (SURVEY.md 7.1): parsing emits a flat FramePlan (TU records in
reconstruction z-order, PU motion records, per-4x4 metadata maps).
Reconstruction is a separate pass (golden scalar or TPU kernels) over the
plan.  The encoder serializes a pre-built FramePlan through the same traversal
(CtuCoder with is_enc=True and planner callbacks), so decode/encode stay
bit-symmetric by construction.  Motion-vector candidate derivation
(golden/mv.py) runs identically in both directions.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from p265_tpu_torch.golden.intra import derive_mpm
from p265_tpu_torch.golden.mv import Motion, MotionCtx, derive_amvp, derive_merge_list
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.hls.slice_header import SLICE_B, SLICE_I, SliceHeader
from p265_tpu_torch.syntax.qp import QpState
from p265_tpu_torch.syntax.residual import decode_residual, encode_residual
from p265_tpu_torch.syntax.tiles import TileInfo, build_tile_info
from p265_tpu_torch.tables import residual_scan_idx

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2


def parse_workers() -> int:
    """Host-parallel Stage-A lane count.  Default: one lane per CPU when
    the host has at least 4 cores; below that the parallel paths stand
    down (measured on this 2-CPU host: 16 lanes 0.66x, 2 lanes 0.61x of
    sequential -- per-lane engine/state setup and GIL-held syntax Python
    swamp the ~50 ms of 1080p parse work; VERDICT.md round 4 weak #4).
    Override with P265_TPU_PARSE_WORKERS (0/1 forces sequential, N>=2
    forces N lanes regardless of core count)."""
    import os
    v = os.environ.get("P265_TPU_PARSE_WORKERS")
    if v is not None:
        return int(v)
    n = os.cpu_count() or 1
    return n if n >= 4 else 1

# part mode -> list of PU rects (fractions of CU size in 1/4 units)
_PART_RECTS = {
    "2Nx2N": [(0, 0, 4, 4)],
    "2NxN": [(0, 0, 4, 2), (0, 2, 4, 2)],
    "Nx2N": [(0, 0, 2, 4), (2, 0, 2, 4)],
    "NxN": [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)],
    "2NxnU": [(0, 0, 4, 1), (0, 1, 4, 3)],
    "2NxnD": [(0, 0, 4, 3), (0, 3, 4, 1)],
    "nLx2N": [(0, 0, 1, 4), (1, 0, 3, 4)],
    "nRx2N": [(0, 0, 3, 4), (3, 0, 1, 4)],
}


def pu_rects(part: str, x0: int, y0: int, size: int):
    q = size >> 2
    return [(x0 + fx * q, y0 + fy * q, fw * q, fh * q)
            for (fx, fy, fw, fh) in _PART_RECTS[part]]


def wrap_mv(v: int) -> int:
    """16-bit wrap-around of mvp + mvd (spec 8.5.3.1 eq 8-95)."""
    u = (v + (1 << 16)) % (1 << 16)
    return u - (1 << 16) if u >= (1 << 15) else u


@dataclass
class TuRec:
    """One transform block in reconstruction order."""
    x: int              # plane coords (luma plane for c_idx 0, chroma plane else)
    y: int
    log2: int
    c_idx: int
    mode: int           # intra pred mode; -1 for inter blocks
    levels: np.ndarray | None
    tskip: bool = False
    qp: int = 26
    pred_only: bool = False
    is_inter: bool = False
    tile: int = 0
    slice_idx: int = 0
    bypass: bool = False   # cu_transquant_bypass: levels ARE the residual
    pcm: bool = False      # raw PCM samples in `levels` (is_inter-class exec)
    matrix_id: int = 0     # scaling-list matrix id (0..5; 32x32: 0..1)


@dataclass
class PuRec:
    x: int
    y: int
    w: int
    h: int
    motion: Motion


@dataclass
class SaoRec:
    type: list[int] = field(default_factory=lambda: [SAO_OFF] * 3)
    cls: list[int] = field(default_factory=lambda: [0] * 3)
    offsets: list[list[int]] = field(default_factory=lambda: [[0] * 4 for _ in range(3)])
    merge_left: bool = False
    merge_up: bool = False


@dataclass
class FramePlan:
    sps: SPS
    pps: PPS
    sh: SliceHeader
    tus: list[TuRec] = field(default_factory=list)
    pus: list[PuRec] = field(default_factory=list)
    sao: list[SaoRec] = field(default_factory=list)
    poc: int = 0
    l0_pocs: list[int] = field(default_factory=list)
    l1_pocs: list[int] = field(default_factory=list)
    # per-4x4 luma-grid metadata
    intra_mode_map: np.ndarray | None = None
    ct_depth_map: np.ndarray | None = None
    qp_map: np.ndarray | None = None
    intra_map: np.ndarray | None = None
    cbf_map: np.ndarray | None = None
    edge_flags: np.ndarray | None = None
    skip_map: np.ndarray | None = None
    mv_map: np.ndarray | None = None     # [h4,w4,2,2] (wired from MotionCtx)
    ref_map: np.ndarray | None = None    # [h4,w4,2] ref POCs, NO_REF unused
    tile_map4: np.ndarray | None = None  # [h4,w4] tile id per 4x4 luma block
    bypass_map: np.ndarray | None = None # [h4,w4] cu_transquant_bypass
    scaling: dict | None = None          # (log2, matrix_id) -> [s,s] dequant m
    slice_of_ctb: np.ndarray | None = None  # [num_ctbs] slice index (multi-slice)
    tile_tu_starts: list[int] = field(default_factory=list)  # TU idx per tile start

    def grid_shape(self) -> tuple[int, int]:
        return ((self.sps.pic_height + 3) >> 2, (self.sps.pic_width + 3) >> 2)

    def alloc_maps(self) -> None:
        h4, w4 = self.grid_shape()
        self.intra_mode_map = np.full((h4, w4), -1, np.int32)
        self.ct_depth_map = np.zeros((h4, w4), np.int32)
        self.qp_map = np.full((h4, w4), self.sh.slice_qp, np.int32)
        self.intra_map = np.zeros((h4, w4), np.int32)
        self.cbf_map = np.zeros((h4, w4), np.int32)
        self.edge_flags = np.zeros((h4, w4), np.int32)
        self.skip_map = np.zeros((h4, w4), np.int32)
        self.bypass_map = np.zeros((h4, w4), np.int32)  # lossless CUs: no filters


class _SyntaxIO:
    """Symmetric syntax front-end: decode reads; encode writes given values."""

    def __init__(self, engine, is_enc: bool):
        self.e = engine
        self.is_enc = is_enc

    def flag(self, name: str, inc: int, value: int | None = None) -> int:
        if self.is_enc:
            self.e.encode(name, inc, value)
            return value
        return self.e.decode(name, inc)

    def bypass(self, value: int | None = None) -> int:
        if self.is_enc:
            self.e.encode_bypass(value)
            return value
        return self.e.decode_bypass()

    def bypass_bits(self, n: int, value: int | None = None) -> int:
        if self.is_enc:
            self.e.encode_bypass_bits(value, n)
            return value
        return self.e.decode_bypass_bits(n)

    def terminate(self, value: int | None = None) -> int:
        if self.is_enc:
            self.e.encode_terminate(value)
            return value
        return self.e.decode_terminate()

    def tr_bypass(self, c_max: int, value: int | None = None) -> int:
        if self.is_enc:
            for _ in range(value):
                self.e.encode_bypass(1)
            if value < c_max:
                self.e.encode_bypass(0)
            return value
        v = 0
        while v < c_max and self.e.decode_bypass():
            v += 1
        return v

    def eg_bypass(self, k: int, value: int | None = None) -> int:
        if self.is_enc:
            self.e.encode_eg_bypass(k, value)
            return value
        return self.e.decode_eg_bypass(k)


class DecodeSubstreams:
    """Substream engine provider for decoding (tiles / WPP entry points)."""

    def __init__(self, data: bytes, entry_sizes: list[int], ctx):
        bounds = [0]
        for sz in entry_sizes:
            bounds.append(bounds[-1] + sz)
        bounds.append(len(data))
        self.chunks = [data[bounds[i]:bounds[i + 1]]
                       for i in range(len(bounds) - 1)]
        self.ctx = ctx

    def get(self, i: int):
        from p265_tpu_torch.hls.bitio import BitReader
        from p265_tpu_torch import native as native_mod
        if isinstance(self.ctx, native_mod.NativeContextModels):
            return native_mod.NativeCabacDecoder(BitReader(self.chunks[i]),
                                                 self.ctx)
        from p265_tpu_torch.entropy.engine import CabacDecoder
        return CabacDecoder(BitReader(self.chunks[i]), self.ctx)


class EncodeSubstreams:
    """Substream engine provider for encoding; collects byte-aligned chunks."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.writers = []

    def get(self, i: int):
        from p265_tpu_torch.entropy.engine import CabacEncoder
        from p265_tpu_torch.hls.bitio import BitWriter
        self._seal_last()
        w = BitWriter()
        self.writers.append(w)
        return CabacEncoder(w, self.ctx)

    def _seal_last(self):
        if self.writers:
            self.writers[-1].rbsp_trailing_bits()  # byte_alignment pattern

    def finalize(self):
        self._seal_last()
        chunks = [w.get_bytes() for w in self.writers]
        entry_sizes = [len(c) for c in chunks[:-1]]
        return b"".join(chunks), entry_sizes


class CtuCoder:
    """Walks one slice's CTUs, decoding into / encoding from a FramePlan.

    For encoding, a planner object supplies the decisions (see
    testgen.encoder.EncPlanner); plan.tus/pus/sao hold the records to
    serialize in traversal order.  mctx is the (fresh) MotionCtx for P/B
    slices; motion derivation re-runs during serialization and is asserted
    against the planned motion.
    """

    def __init__(self, engine, sps: SPS, pps: PPS, sh: SliceHeader,
                 plan: FramePlan, is_enc: bool, planner=None,
                 mctx: MotionCtx | None = None, substreams=None,
                 start_ctb: int = 0, slice_idx: int = 0, iters=None,
                 carry_avail=None, wpp_carry=None):
        self.substreams = substreams
        if substreams is not None:
            engine = substreams.get(0)
        self.io = _SyntaxIO(engine, is_enc)
        self.engine = engine
        self.is_enc = is_enc
        self.sps, self.pps, self.sh = sps, pps, sh
        self.plan = plan
        self.planner = planner
        if plan.intra_mode_map is None:
            plan.alloc_maps()
        if is_enc:
            assert planner is not None
        self.mode_map = plan.intra_mode_map
        self.depth_map = plan.ct_depth_map
        h4, w4 = plan.grid_shape()
        self.avail = (carry_avail if carry_avail is not None
                      else np.zeros((h4, w4), bool))
        self.tile_info = build_tile_info(sps, pps)
        self.cur_tile = 0
        # static tile-id map at 4x4 granularity
        tm = np.zeros((h4, w4), np.int32)
        for addr in range(sps.num_ctbs):
            xc = (addr % sps.pic_width_ctbs) << sps.log2_ctb_size
            yc = (addr // sps.pic_width_ctbs) << sps.log2_ctb_size
            x1 = min(xc + sps.ctb_size, sps.pic_width)
            y1 = min(yc + sps.ctb_size, sps.pic_height)
            tm[yc >> 2:(y1 + 3) >> 2, xc >> 2:(x1 + 3) >> 2] =                 self.tile_info.tile_of_ctb[addr]
        plan.tile_map4 = tm
        self.tile_map4 = tm
        if sps.scaling_list_enabled:
            from p265_tpu_torch.hls.params import resolve_scaling_matrices
            sld = pps.scaling_list_data or sps.scaling_list_data
            plan.scaling = resolve_scaling_matrices(sld)
        self.start_ctb = start_ctb
        self.slice_idx = slice_idx
        # WPP context snapshots keyed by CTB row; carried across dependent
        # slice segments of the same slice (spec 9.3.1 sync storage)
        self.wpp_snapshots: dict = {} if wpp_carry is None else wpp_carry
        if plan.slice_of_ctb is None:
            plan.slice_of_ctb = np.full(sps.num_ctbs, -1, np.int32)
        self.cu_bypass = False
        self.qps = QpState(sps, pps, plan.qp_map, self._avail_at)
        self.mctx = mctx
        if mctx is not None:
            plan.mv_map = mctx.mv
            plan.ref_map = mctx.ref_poc
            mctx.avail = self._avail_at
            mctx.intra_map = plan.intra_map
        if iters is not None:
            self._tu_iter, self._pu_iter = iters
        else:
            self._tu_iter = iter(plan.tus) if is_enc else None
            self._pu_iter = iter(plan.pus) if is_enc else None
        # native Stage-A fast lane: the whole CTU (SAO + quadtree + residual)
        # parses in one C call when the slice qualifies (I slice, no PCM) and
        # the caller opted in; segment/WPP orchestration stays here.
        self.native = None
        if not is_enc and getattr(plan, "use_native_parse", False):
            from p265_tpu_torch import native as native_mod
            from p265_tpu_torch.native import parse as nparse
            if (nparse.supports(sps, pps, sh)
                    and isinstance(self.engine, native_mod.NativeCabacDecoder)):
                ns = getattr(plan, "nstate", None)
                if ns is None:
                    ns = nparse.NativeParseState(sps, pps)
                    plan.nstate = ns
                ns.begin_slice(sps, pps, sh, plan, self.avail, slice_idx)
                self.native = ns
        # plan.sao is raster-indexed (length num_ctbs); decode pre-allocates
        # once per picture (multi-slice pictures share the list)
        if not is_enc and self.native is None \
                and len(plan.sao) != sps.num_ctbs:
            plan.sao = [SaoRec() for _ in range(sps.num_ctbs)]

    # -- helpers -------------------------------------------------------------
    def _avail_at(self, x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= self.sps.pic_width or y >= self.sps.pic_height:
            return False
        if self.tile_map4[y >> 2, x >> 2] != self.cur_tile:
            return False  # prediction never crosses tile boundaries
        addr = ((y >> self.sps.log2_ctb_size) * self.sps.pic_width_ctbs
                + (x >> self.sps.log2_ctb_size))
        if self.plan.slice_of_ctb[addr] != self.slice_idx:
            return False  # prediction never crosses slice boundaries
        return bool(self.avail[y >> 2, x >> 2])

    def _mark(self, x0: int, y0: int, size: int) -> None:
        x1 = min(x0 + size, self.sps.pic_width)
        y1 = min(y0 + size, self.sps.pic_height)
        self.avail[y0 >> 2:(y1 + 3) >> 2, x0 >> 2:(x1 + 3) >> 2] = True

    def _set_map(self, m: np.ndarray, x0: int, y0: int, w: int, h: int | None = None,
                 v: int = 0) -> None:
        if h is None:
            h = w
        x1 = min(x0 + w, self.sps.pic_width)
        y1 = min(y0 + h, self.sps.pic_height)
        m[y0 >> 2:(y1 + 3) >> 2, x0 >> 2:(x1 + 3) >> 2] = v

    def _set_edges(self, x0: int, y0: int, w: int, h: int | None = None) -> None:
        if h is None:
            h = w
        ef = self.plan.edge_flags
        x1 = min(x0 + w, self.sps.pic_width)
        y1 = min(y0 + h, self.sps.pic_height)
        ef[y0 >> 2:(y1 + 3) >> 2, x0 >> 2] |= 1
        ef[y0 >> 2, x0 >> 2:(x1 + 3) >> 2] |= 2

    # -- slice main loop -----------------------------------------------------
    def _switch_engine(self, seg_idx: int) -> None:
        self.engine = self.substreams.get(seg_idx)
        self.io.e = self.engine

    def code_slice_data(self, n_ctbs: int | None = None) -> int:
        """Code this slice's CTUs.  n_ctbs: encoder-side CTU count for this
        slice (None = to picture end); the decoder stops at the
        end_of_slice_segment_flag.  Returns the number of CTUs coded."""
        if self._tiles_parallel_ok(n_ctbs):
            return self._code_tiles_parallel()
        if self._wpp_parallel_ok(n_ctbs):
            return self._code_wpp_parallel()
        sps = self.sps
        ti = self.tile_info
        wc = sps.pic_width_ctbs
        scan = ti.ctb_scan
        start_pos = scan.index(self.start_ctb) if self.start_ctb else 0
        if n_ctbs is None and self.is_enc:
            n_ctbs = len(scan) - start_pos
        end_pos_enc = (start_pos + n_ctbs) if n_ctbs is not None else None
        last_addr = scan[end_pos_enc - 1] if end_pos_enc else scan[-1]
        wpp_snapshots = self.wpp_snapshots
        ctx = self.engine.ctx
        n_segs = len(ti.segments)
        coded = 0
        done = False
        local_seg = 0  # substream index WITHIN this slice segment's data
        for seg_idx, seg in enumerate(ti.segments):
            full_seg_start = seg[0] if seg else -1
            if self.start_ctb:
                seg = [a for a in seg if scan.index(a) >= start_pos]
            if not seg:
                continue
            self.qps.start_segment(self.sh.slice_qp)
            if self.native is not None:
                self.native.start_segment(self.sh.slice_qp)
            first_of_slice = local_seg == 0
            if not first_of_slice:
                assert self.substreams is not None, "need entry points"
                self._switch_engine(local_seg)
            seg_tile = int(ti.tile_of_ctb[seg[0]])
            n_cols = len(ti.col_widths)
            tile_w = ti.col_widths[seg_tile % n_cols]
            tile_row0 = ti.row_bounds[seg_tile // n_cols]
            # WPP snapshot point: 2nd CTU of this tile-row (spec 9.3.1)
            wpp_snap_addr = full_seg_start + 1 if ti.wpp else -1
            if ti.wpp and seg[0] == full_seg_start and not (
                    first_of_slice and self.sh.first_slice_in_pic):
                # tile-row start: restore the row-above snapshot (same tile)
                # when the sync source CTB (above-right) is in the same slice
                # (spec 9.3.1); otherwise contexts re-initialize -- except
                # for a dependent segment's own first substream, which
                # keeps the carried end-of-previous-segment state
                row = seg[0] // wc
                snap = wpp_snapshots.get((seg_tile, row - 1))
                src_ok = (tile_w > 1 and snap is not None and row > tile_row0
                          and self.plan.slice_of_ctb[seg[0] - wc + 1]
                          == self.slice_idx)
                if src_ok:
                    ctx.restore(snap)
                elif not (first_of_slice
                          and self.sh.dependent_slice_segment):
                    ctx.reinit(self.sh.init_type(), self.sh.slice_qp)
            elif not ti.wpp and not first_of_slice:
                ctx.reinit(self.sh.init_type(), self.sh.slice_qp)
            elif (not ti.wpp and first_of_slice
                  and self.sh.dependent_slice_segment
                  and self.pps.tiles_enabled
                  and seg[0] == full_seg_start):
                # dependent segment starting exactly at a tile start: the
                # tile context reset wins over the dependent-segment restore
                ctx.reinit(self.sh.init_type(), self.sh.slice_qp)
            local_seg += 1
            do_sao = sps.sao_enabled and (self.sh.sao_luma
                                          or self.sh.sao_chroma)
            for addr in seg:
                xc = (addr % wc) << sps.log2_ctb_size
                yc = (addr // wc) << sps.log2_ctb_size
                self.cur_tile = int(ti.tile_of_ctb[addr])
                if self.native is not None:
                    # one C call: SAO + quadtree + residuals + terminate
                    term = self.native.parse_ctu(self.engine, addr,
                                                 self.cur_tile, do_sao)
                    if addr == wpp_snap_addr:
                        wpp_snapshots[(seg_tile, addr // wc)] = ctx.snapshot()
                    coded += 1
                    if term:
                        done = True
                        break
                    continue
                self.plan.slice_of_ctb[addr] = self.slice_idx
                if not self.is_enc and self.plan.tile_tu_starts is not None:
                    if seg_idx > 0 and addr == seg[0] and not ti.wpp:
                        self.plan.tile_tu_starts.append(len(self.plan.tus))
                if do_sao:
                    self._code_sao(addr)
                self._coding_quadtree(xc, yc, sps.log2_ctb_size, 0)
                if addr == wpp_snap_addr:
                    wpp_snapshots[(seg_tile, addr // wc)] = ctx.snapshot()
                coded += 1
                if self.is_enc:
                    last = addr == last_addr
                    self.io.terminate(int(last))
                    if last:
                        done = True
                        break
                else:
                    if self.io.terminate():
                        done = True
                        break
            if done:
                break
            if seg_idx < n_segs - 1:
                # end_of_subset_one_bit (always 1) + byte alignment
                got = self.io.terminate(1)
                if not self.is_enc and not got:
                    raise ValueError("end_of_subset_one_bit mismatch")
        if self.pps.tiles_enabled and not self.pps.loop_filter_across_tiles:
            ef = self.plan.edge_flags
            for cb in ti.col_bounds[1:-1]:
                ef[:, (cb << sps.log2_ctb_size) >> 2] &= ~1
            for rb in ti.row_bounds[1:-1]:
                ef[(rb << sps.log2_ctb_size) >> 2, :] &= ~2
        return coded

    # -- tile-parallel native Stage-A ----------------------------------------
    def _tiles_parallel_ok(self, n_ctbs) -> bool:
        """Tiles are the codec-native host-parallel axis (SURVEY.md 7.5(a)):
        entropy + prediction fully independent per tile.  The parallel lane
        applies when the native parser handles the slice, tiles (not WPP)
        are on, this is a whole-picture single independent segment with one
        entry point per remaining tile, and context carry-in is the plain
        per-tile reinit."""
        ti = self.tile_info
        return (parse_workers() >= 2
                and self.native is not None and not self.is_enc
                and n_ctbs is None and self.pps.tiles_enabled and not ti.wpp
                and not self.sh.dependent_slice_segment
                and self.start_ctb == 0 and self.sh.first_slice_in_pic
                and self.substreams is not None
                and len(ti.segments) > 1
                and len(self.sh.entry_point_offsets) == len(ti.segments) - 1)

    def _code_tiles_parallel(self) -> int:
        """Parse every tile substream on its own worker thread: per-lane
        CABAC engine + fresh context init (== the sequential per-tile
        reinit) + private bucket/wavefront state; shared picture maps are
        written to disjoint tile regions.  The C whole-CTU call releases
        the GIL, so lanes genuinely overlap.  Bit-exact vs the sequential
        path by construction (identical per-tile decode order)."""
        from concurrent.futures import ThreadPoolExecutor

        from p265_tpu_torch import native as native_mod
        from p265_tpu_torch.hls.bitio import BitReader
        from p265_tpu_torch.native.parse import NativeParseState

        sps, sh, ti = self.sps, self.sh, self.tile_info
        wc = sps.pic_width_ctbs
        segs = ti.segments
        do_sao = sps.sao_enabled and (sh.sao_luma or sh.sao_chroma)
        main = self.native

        n_cols = len(ti.col_widths)

        def work(seg_idx: int):
            seg = segs[seg_idx]
            ctx = native_mod.NativeContextModels(sh.init_type(), sh.slice_qp)
            engine = native_mod.NativeCabacDecoder(
                BitReader(self.substreams.chunks[seg_idx]), ctx)
            tile = int(ti.tile_of_ctb[seg[0]])
            region = (ti.col_widths[tile % n_cols] << sps.log2_ctb_size,
                      ti.row_heights[tile // n_cols] << sps.log2_ctb_size)
            lane = NativeParseState(sps, self.pps, shared_sao=main.sao,
                                    region=region)
            lane.begin_slice(sps, self.pps, sh, self.plan, self.avail,
                             self.slice_idx)
            lane.start_segment(sh.slice_qp)
            coded = 0
            term = 0
            for addr in seg:
                term = lane.parse_ctu(engine, addr,
                                      int(ti.tile_of_ctb[addr]), do_sao)
                coded += 1
                if term:
                    break
            if not term and seg_idx < len(segs) - 1:
                if not engine.decode_terminate():
                    raise ValueError("end_of_subset_one_bit mismatch")
            return coded, term, lane

        with ThreadPoolExecutor(max_workers=min(len(segs),
                                                parse_workers())) as ex:
            results = list(ex.map(work, range(len(segs))))
        main.absorb([lane for _, _, lane in results])
        if self.pps.tiles_enabled and not self.pps.loop_filter_across_tiles:
            ef = self.plan.edge_flags
            for cb in ti.col_bounds[1:-1]:
                ef[:, (cb << sps.log2_ctb_size) >> 2] &= ~1
            for rb in ti.row_bounds[1:-1]:
                ef[(rb << sps.log2_ctb_size) >> 2, :] &= ~2
        return sum(c for c, _, _ in results)

    def _wpp_parallel_ok(self, n_ctbs) -> bool:
        """WPP rows are the second codec-native host-parallel axis (SURVEY.md
        7.5(a)-(b) row wavefront).  Applies when the native parser handles
        the slice, WPP (not tiles) is on, this is a whole-picture single
        independent segment with one entry point per remaining row, and the
        host has enough cores (parse_workers)."""
        ti = self.tile_info
        return (parse_workers() >= 2
                and self.native is not None and not self.is_enc
                and n_ctbs is None and ti.wpp and not self.pps.tiles_enabled
                and not self.sh.dependent_slice_segment
                and self.start_ctb == 0 and self.sh.first_slice_in_pic
                and self.substreams is not None
                and len(ti.segments) > 1
                and len(self.sh.entry_point_offsets) == len(ti.segments) - 1)

    def _code_wpp_parallel(self) -> int:
        """Parse WPP row substreams on worker threads with the spec's 2-CTU
        skew (9.3.1): lane r parses CTU x only after lane r-1 completed CTU
        x+1, and starts only after lane r-1's post-CTU-1 context snapshot.
        The wavefront-step grids and picture maps are SHARED across lanes
        (rows reference the row above; the skew makes every cross-row read
        happen-after its write -- that reach is exactly what the skew
        bounds), while CABAC engine/contexts, buckets and motion events are
        lane-private and absorbed in row order, which equals raster order.
        Bit-exact vs the sequential path by construction."""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from p265_tpu_torch import native as native_mod
        from p265_tpu_torch.hls.bitio import BitReader
        from p265_tpu_torch.native.parse import NativeParseState

        sps, sh = self.sps, self.sh
        wc = sps.pic_width_ctbs
        segs = self.tile_info.segments
        do_sao = sps.sao_enabled and (sh.sao_luma or sh.sao_chroma)
        main = self.native
        n_rows = len(segs)
        progress = [0] * n_rows      # CTUs completed per row lane
        snaps: list = [None] * n_rows
        err: list = []
        cond = threading.Condition()

        def work(r: int):
            try:
                return self._wpp_lane(r, segs, wc, do_sao, main,
                                      progress, snaps, err, cond,
                                      native_mod, BitReader,
                                      NativeParseState)
            except Exception as e:
                with cond:
                    err.append(e)
                    cond.notify_all()
                raise

        with ThreadPoolExecutor(max_workers=min(n_rows,
                                                parse_workers())) as ex:
            results = list(ex.map(work, range(n_rows)))
        if err:
            raise err[0]
        main.absorb([lane for _, lane in results])
        return sum(c for c, _ in results)

    def _wpp_lane(self, r, segs, wc, do_sao, main, progress, snaps, err,
                  cond, native_mod, BitReader, NativeParseState):
        sps, sh = self.sps, self.sh
        seg = segs[r]
        ctx = native_mod.NativeContextModels(sh.init_type(), sh.slice_qp)
        if r > 0 and wc > 1:
            # start only after the row above snapshotted its post-CTU-1
            # state (spec 9.3.1 sync); single slice => source always ok
            with cond:
                cond.wait_for(lambda: progress[r - 1] >= 2 or err)
                if err:
                    return 0, None
                snap = snaps[r - 1]
            ctx.restore(snap)
        engine = native_mod.NativeCabacDecoder(
            BitReader(self.substreams.chunks[r]), ctx)
        lane = NativeParseState(sps, self.pps, shared_sao=main.sao,
                                region=(sps.pic_width, sps.ctb_size),
                                shared_planes=main)
        lane.begin_slice(sps, self.pps, sh, self.plan, self.avail,
                         self.slice_idx)
        lane.start_segment(sh.slice_qp)
        lane.pin_plane_context(0, self.slice_idx)
        coded = 0
        term = 0
        for i, addr in enumerate(seg):
            if r > 0:
                need = min(i + 2, len(segs[r - 1]))
                with cond:
                    cond.wait_for(lambda: progress[r - 1] >= need or err)
                    if err:
                        return coded, lane
            term = lane.parse_ctu(engine, addr, 0, do_sao)
            coded += 1
            with cond:
                progress[r] = coded
                if coded == 2:
                    snaps[r] = ctx.snapshot()
                cond.notify_all()
            if term:
                break
        with cond:
            # unblock waiters even on early termination (corrupt stream):
            # the downstream bit-exact/terminate checks own the error path
            progress[r] = len(seg)
            cond.notify_all()
        if not term and r < len(segs) - 1:
            if not engine.decode_terminate():
                raise ValueError("end_of_subset_one_bit mismatch")
        return coded, lane

    # -- SAO (spec 7.3.8.3) --------------------------------------------------
    def _code_sao(self, ctb_addr: int) -> None:
        sh = self.sh
        rec = self.plan.sao[ctb_addr]
        wc = self.sps.pic_width_ctbs
        tof = self.tile_info.tile_of_ctb
        sof = self.plan.slice_of_ctb
        left_ok = (ctb_addr % wc != 0
                   and tof[ctb_addr - 1] == tof[ctb_addr]
                   and sof[ctb_addr - 1] == self.slice_idx)
        up_ok = (ctb_addr >= wc
                 and tof[ctb_addr - wc] == tof[ctb_addr]
                 and sof[ctb_addr - wc] == self.slice_idx)
        merge = False
        if left_ok:
            rec.merge_left = bool(self.io.flag("sao_merge_flag", 0,
                                               int(rec.merge_left)))
            merge = rec.merge_left
        if not merge and up_ok:
            rec.merge_up = bool(self.io.flag("sao_merge_flag", 0,
                                             int(rec.merge_up)))
            merge = rec.merge_up
        if merge:
            if not self.is_enc:
                src = (self.plan.sao[ctb_addr - 1] if rec.merge_left
                       else self.plan.sao[ctb_addr - wc])
                rec.type = list(src.type)
                rec.cls = list(src.cls)
                rec.offsets = [list(o) for o in src.offsets]
            return
        for c in range(3):
            enabled = sh.sao_luma if c == 0 else sh.sao_chroma
            if not enabled:
                continue
            if c == 2:
                rec.type[2] = rec.type[1]  # cr inherits type idx from cb
            else:
                t = rec.type[c] if self.is_enc else None
                bin0 = self.io.flag("sao_type_idx", 0,
                                    None if t is None else int(t > 0))
                if bin0:
                    bin1 = self.io.bypass(None if t is None else int(t == SAO_EDGE))
                    ty = SAO_EDGE if bin1 else SAO_BAND
                else:
                    ty = SAO_OFF
                rec.type[c] = ty
                if c == 1 and not self.is_enc:
                    rec.type[2] = ty
            ty = rec.type[c]
            if ty == SAO_OFF:
                continue
            mags = [self.io.tr_bypass(7, abs(rec.offsets[c][i]) if self.is_enc else None)
                    for i in range(4)]
            if ty == SAO_BAND:
                offs = []
                for i in range(4):
                    v = mags[i]
                    if v:
                        sgn = self.io.bypass(
                            int(rec.offsets[c][i] < 0) if self.is_enc else None)
                        v = -v if sgn else v
                    offs.append(v)
                rec.offsets[c] = offs
                rec.cls[c] = self.io.bypass_bits(
                    5, rec.cls[c] if self.is_enc else None)
            else:
                rec.offsets[c] = [mags[0], mags[1], -mags[2], -mags[3]]
                if c == 2:
                    rec.cls[2] = rec.cls[1]
                else:
                    rec.cls[c] = self.io.bypass_bits(
                        2, rec.cls[c] if self.is_enc else None)
                    if c == 1 and not self.is_enc:
                        rec.cls[2] = rec.cls[1]

    # -- coding quadtree (spec 7.3.8.4) --------------------------------------
    def _coding_quadtree(self, x0: int, y0: int, log2_size: int, depth: int) -> None:
        sps = self.sps
        size = 1 << log2_size
        self.qps.maybe_start_qg(x0, y0, log2_size)
        inside = (x0 + size <= sps.pic_width) and (y0 + size <= sps.pic_height)
        can_split = log2_size > sps.log2_min_cb_size
        if inside and can_split:
            inc = 0
            if self._avail_at(x0 - 1, y0):
                inc += int(self.depth_map[y0 >> 2, (x0 - 1) >> 2] > depth)
            if self._avail_at(x0, y0 - 1):
                inc += int(self.depth_map[(y0 - 1) >> 2, x0 >> 2] > depth)
            want = int(self.planner.cu_split(x0, y0, log2_size, depth)) \
                if self.is_enc else None
            split = self.io.flag("split_cu_flag", inc, want)
        else:
            split = int(can_split)
        if split:
            half = size >> 1
            for dy in (0, half):
                for dx in (0, half):
                    x1, y1 = x0 + dx, y0 + dy
                    if x1 < sps.pic_width and y1 < sps.pic_height:
                        self._coding_quadtree(x1, y1, log2_size - 1, depth + 1)
            return
        self._set_map(self.depth_map, x0, y0, size, v=depth)
        self._coding_unit(x0, y0, log2_size)

    # -- coding unit (spec 7.3.8.5) ------------------------------------------
    def _coding_unit(self, x0: int, y0: int, log2_size: int) -> None:
        sps = self.sps
        size = 1 << log2_size
        if self.mctx is not None:
            self.mctx.begin_cu()
        self.cu_bypass = False
        if self.pps.transquant_bypass_enabled:
            want = (int(self.planner.cu_bypass(x0, y0)) if self.is_enc else None)
            self.cu_bypass = bool(self.io.flag("cu_transquant_bypass_flag", 0,
                                               want))
            if self.cu_bypass:
                self._set_map(self.plan.bypass_map, x0, y0, size, v=1)
        if self.sh.slice_type != SLICE_I:
            inc = 0
            if self._avail_at(x0 - 1, y0):
                inc += int(self.plan.skip_map[y0 >> 2, (x0 - 1) >> 2])
            if self._avail_at(x0, y0 - 1):
                inc += int(self.plan.skip_map[(y0 - 1) >> 2, x0 >> 2])
            want = (int(self.planner.cu_skip(x0, y0)) if self.is_enc else None)
            skip = self.io.flag("cu_skip_flag", inc, want)
            if skip:
                self._set_map(self.plan.skip_map, x0, y0, size, v=1)
                self._set_map(self.plan.intra_map, x0, y0, size, v=0)
                self._set_map(self.plan.qp_map, x0, y0, size, v=self.qps.qp())
                self._set_edges(x0, y0, size)
                self._prediction_unit(x0, y0, size, size, 0, "2Nx2N",
                                      x0, y0, log2_size, merge_only=True)
                self._emit_inter_pred_only(x0, y0, size)
                self._mark(x0, y0, size)
                self.qps.end_cu()
                return
        pred_intra = True
        if self.sh.slice_type != SLICE_I:
            want = (int(self.planner.pred_mode_intra(x0, y0))
                    if self.is_enc else None)
            pred_intra = bool(self.io.flag("pred_mode_flag", 0, want))
        if pred_intra:
            self._intra_cu(x0, y0, log2_size)
        else:
            self._inter_cu(x0, y0, log2_size)

    # ------------------------------------------------------------------ intra
    def _pcm_cu(self, x0: int, y0: int, log2_size: int) -> None:
        """pcm_sample parsing/writing (spec 7.3.8.7) + engine restart (9.3.1).

        Framing note: after the encoder's terminate-flush the decoder's raw
        bit position equals the encoder's written bit count exactly (verified
        property of this engine pair), so byte alignment on both sides lands
        on the same boundary.
        """
        sps = self.sps
        size = 1 << log2_size
        shift = 8 - sps.pcm_bit_depth
        recs = [(x0, y0, log2_size, 0, size),
                (x0 >> 1, y0 >> 1, log2_size - 1, 1, size >> 1),
                (x0 >> 1, y0 >> 1, log2_size - 1, 2, size >> 1)]
        if self.is_enc:
            eng = self.engine
            w = eng.w
            w.align_zero()  # pcm_alignment_zero_bit
            for (px, py, plog2, c, psz) in recs:
                tu = next(self._tu_iter)
                assert tu.pcm and (tu.x, tu.y, tu.c_idx) == (px, py, c)
                for row in np.asarray(tu.levels) >> shift:
                    for v in row:
                        w.u(int(v), sps.pcm_bit_depth)
            from p265_tpu_torch.entropy.engine import CabacEncoder
            self.engine = CabacEncoder(w, eng.ctx)
        else:
            if hasattr(self.engine, "sync_reader"):
                self.engine.sync_reader()
            r = self.engine.r
            r.align()
            for (px, py, plog2, c, psz) in recs:
                samples = np.empty((psz, psz), np.int32)
                for yy in range(psz):
                    for xx in range(psz):
                        samples[yy, xx] = r.read_bits(sps.pcm_bit_depth) << shift
                self.plan.tus.append(
                    TuRec(px, py, plog2, c, 1, samples, qp=self.sh.slice_qp,
                          pred_only=True, is_inter=True, pcm=True,
                          tile=self.cur_tile, slice_idx=self.slice_idx))
            from p265_tpu_torch import native as native_mod
            if isinstance(self.engine.ctx, native_mod.NativeContextModels):
                self.engine = native_mod.NativeCabacDecoder(r, self.engine.ctx)
            else:
                from p265_tpu_torch.entropy.engine import CabacDecoder
                self.engine = CabacDecoder(r, self.engine.ctx)
        self.io.e = self.engine
        # neighbor-facing state: PCM CUs count as intra with DC mode
        self._set_map(self.plan.intra_map, x0, y0, size, v=1)
        self._set_map(self.mode_map, x0, y0, size, v=1)
        self._set_map(self.plan.qp_map, x0, y0, size, v=self.qps.qp())
        self._set_map(self.plan.cbf_map, x0, y0, size, v=0)
        if sps.pcm_loop_filter_disabled:
            self._set_map(self.plan.bypass_map, x0, y0, size, v=1)
        self._set_edges(x0, y0, size)
        self._mark(x0, y0, size)
        self.qps.end_cu()

    def _intra_cu(self, x0: int, y0: int, log2_size: int) -> None:
        sps = self.sps
        size = 1 << log2_size
        part_nxn = 0
        if log2_size == sps.log2_min_cb_size:
            want = (int(self.planner.part_nxn(x0, y0)) if self.is_enc else None)
            bin0 = self.io.flag("part_mode", 0,
                                None if want is None else 1 - want)
            part_nxn = 1 - bin0
        if (sps.pcm_enabled and not part_nxn and not self.cu_bypass
                and sps.pcm_log2_min_size <= log2_size <= sps.pcm_log2_max_size):
            want = (int(self.planner.pcm(x0, y0)) if self.is_enc else None)
            if self.io.terminate(want):  # pcm_flag is a terminate bin
                self._pcm_cu(x0, y0, log2_size)
                return
        n_pu = 4 if part_nxn else 1
        pb = size >> 1 if part_nxn else size
        pus = [(x0 + (i & 1) * pb, y0 + (i >> 1) * pb) for i in range(n_pu)]

        modes: list[int | None] = [None] * n_pu
        if self.is_enc:
            modes = list(self.planner.luma_modes(x0, y0))
            assert len(modes) == n_pu
        prev_flags = [0] * n_pu
        for i, (px, py) in enumerate(pus):
            if self.is_enc:
                cands = self._mpm_for(i, pus, modes, x0, y0, size)
                prev_flags[i] = int(modes[i] in cands)
                self.io.flag("prev_intra_luma_pred_flag", 0, prev_flags[i])
            else:
                prev_flags[i] = self.io.flag("prev_intra_luma_pred_flag", 0)
        for i, (px, py) in enumerate(pus):
            cands = self._mpm_for(i, pus, modes, x0, y0, size)
            if prev_flags[i]:
                if self.is_enc:
                    self.io.tr_bypass(2, cands.index(modes[i]))
                else:
                    modes[i] = cands[self.io.tr_bypass(2)]
            else:
                scands = sorted(cands)
                if self.is_enc:
                    rem = modes[i]
                    for c in reversed(scands):
                        if rem > c:
                            rem -= 1
                    self.io.bypass_bits(5, rem)
                else:
                    rem = self.io.bypass_bits(5)
                    for c in scands:
                        if rem >= c:
                            rem += 1
                    modes[i] = rem
            self._set_map(self.mode_map, px, py, pb, v=modes[i])
        want_idx = (self.planner.chroma_mode_idx(x0, y0) if self.is_enc else None)
        bin0 = self.io.flag("intra_chroma_pred_mode", 0,
                            None if want_idx is None else int(want_idx != 4))
        if bin0:
            cidx = self.io.bypass_bits(2, None if want_idx is None else want_idx)
        else:
            cidx = 4
        chroma_mode = self._chroma_mode_from_idx(cidx, modes[0])

        self._set_map(self.plan.intra_map, x0, y0, size, v=1)
        if self.plan.skip_map is not None:
            self._set_map(self.plan.skip_map, x0, y0, size, v=0)
        self._set_edges(x0, y0, size)
        intra_split = part_nxn
        max_depth = sps.max_transform_hierarchy_depth_intra + intra_split
        self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0, modes, chroma_mode,
                             bool(intra_split), max_depth, True)
        self._set_map(self.plan.qp_map, x0, y0, size, v=self.qps.qp())
        self._mark(x0, y0, size)
        self.qps.end_cu()

    def _mpm_for(self, i: int, pus, modes, x0: int, y0: int, cu_size: int):
        px, py = pus[i]

        def neighbor(nx: int, ny: int, is_above: bool):
            if nx < 0 or ny < 0:
                return None
            if is_above and (ny >> self.sps.log2_ctb_size) != (py >> self.sps.log2_ctb_size):
                return None
            if x0 <= nx < x0 + cu_size and y0 <= ny < y0 + cu_size:
                pb = cu_size >> 1 if len(modes) > 1 else cu_size
                j = (((ny - y0) // pb) << 1) | ((nx - x0) // pb)
                return modes[j] if j < len(modes) else None
            if not self._avail_at(nx, ny):
                return None
            m = int(self.mode_map[ny >> 2, nx >> 2])
            return m if m >= 0 else None

        left = neighbor(px - 1, py, False)
        above = neighbor(px, py - 1, True)
        return derive_mpm(left, above)

    @staticmethod
    def _chroma_mode_from_idx(cidx: int, luma_mode: int) -> int:
        if cidx == 4:
            return luma_mode
        cand = (0, 26, 10, 1)[cidx]
        return 34 if cand == luma_mode else cand

    # ------------------------------------------------------------------ inter
    def _part_mode_inter(self, x0: int, y0: int, log2_size: int) -> str:
        sps = self.sps
        at_min = log2_size == sps.log2_min_cb_size
        amp = sps.amp_enabled and not at_min
        want = self.planner.inter_part(x0, y0) if self.is_enc else None

        def bit(inc, b, bypass=False):
            if bypass:
                return self.io.bypass(b if self.is_enc else None)
            return self.io.flag("part_mode", inc, b if self.is_enc else None)

        if bit(0, int(want == "2Nx2N") if want else None):
            return "2Nx2N"
        horiz = bit(1, int(want in ("2NxN", "2NxnU", "2NxnD")) if want else None)
        if not at_min:
            if amp:
                plain = bit(3, int(want in ("2NxN", "Nx2N")) if want else None)
                if plain:
                    return "2NxN" if horiz else "Nx2N"
                second = bit(0, int(want in ("2NxnD", "nRx2N")) if want else None,
                             bypass=True)
                if horiz:
                    return "2NxnD" if second else "2NxnU"
                return "nRx2N" if second else "nLx2N"
            return "2NxN" if horiz else "Nx2N"
        if horiz:
            return "2NxN"
        if log2_size == 3:
            return "Nx2N"  # inter NxN forbidden for 8x8 CUs
        third = bit(2, int(want == "Nx2N") if want else None)
        return "Nx2N" if third else "NxN"

    def _inter_cu(self, x0: int, y0: int, log2_size: int) -> None:
        sps = self.sps
        size = 1 << log2_size
        part = self._part_mode_inter(x0, y0, log2_size)
        rects = pu_rects(part, x0, y0, size)
        merge0 = False
        for i, (px, py, w, h) in enumerate(rects):
            m = self._prediction_unit(px, py, w, h, i, part, x0, y0, log2_size,
                                      merge_only=False)
            if i == 0:
                merge0 = m
            self._set_edges(px, py, w, h)
        self._set_map(self.plan.intra_map, x0, y0, size, v=0)
        self._set_map(self.plan.skip_map, x0, y0, size, v=0)
        self._set_map(self.mode_map, x0, y0, size, v=-1)
        self._set_edges(x0, y0, size)
        rqt_root = 1
        if not (part == "2Nx2N" and merge0):
            want = (int(self.planner.rqt_root(x0, y0)) if self.is_enc else None)
            rqt_root = self.io.flag("rqt_root_cbf", 0, want)
        if rqt_root:
            max_depth = sps.max_transform_hierarchy_depth_inter
            inter_split = max_depth == 0 and part != "2Nx2N"
            self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0, None, -1,
                                 inter_split, max_depth, False)
        else:
            self._emit_inter_pred_only(x0, y0, size)
        self._set_map(self.plan.qp_map, x0, y0, size, v=self.qps.qp())
        self._mark(x0, y0, size)
        self.qps.end_cu()

    def _emit_inter_pred_only(self, x0: int, y0: int, size: int) -> None:
        """No-residual inter CU: emit pred_only TU records covering the CU so
        the reconstruction pass writes MC prediction and availability in
        z-order."""
        qp = self.qps.qp()
        recs = [(x0, y0, (size).bit_length() - 1, 0),
                (x0 >> 1, y0 >> 1, (size >> 1).bit_length() - 1, 1),
                (x0 >> 1, y0 >> 1, (size >> 1).bit_length() - 1, 2)]
        for (x, y, log2, c) in recs:
            self._pred_only(x, y, log2, c, -1, qp, is_inter=True)
        self._set_map(self.plan.cbf_map, x0, y0, size, v=0)

    def _prediction_unit(self, x: int, y: int, w: int, h: int, part_idx: int,
                         part: str, x_cu: int, y_cu: int, cu_log2: int,
                         merge_only: bool) -> bool:
        sh = self.sh
        mctx = self.mctx
        is_b = sh.slice_type == SLICE_B
        pu_plan = self.planner.pu(x, y) if self.is_enc else None
        if merge_only:
            merge = 1
        else:
            merge = self.io.flag("merge_flag", 0,
                                 int(pu_plan["merge"]) if self.is_enc else None)
        if merge:
            midx = 0
            c_max = sh.max_num_merge_cand - 1
            if c_max > 0:
                v = pu_plan["merge_idx"] if self.is_enc else None
                bin0 = self.io.flag("merge_idx", 0,
                                    None if v is None else int(v > 0))
                if bin0:
                    midx = 1 + self.io.tr_bypass(
                        c_max - 1, None if v is None else v - 1)
            cands = derive_merge_list(mctx, x_cu, y_cu, 1 << cu_log2, x, y,
                                      w, h, part, part_idx,
                                      sh.max_num_merge_cand)
            motion = cands[midx].copy()
        else:
            if is_b:
                if w + h != 12:
                    ct_depth = self.sps.log2_ctb_size - cu_log2
                    want = pu_plan["inter_dir"] if self.is_enc else None
                    b0 = self.io.flag("inter_pred_idc", ct_depth,
                                      None if want is None else int(want == 2))
                    if b0:
                        idc = 2
                    else:
                        b1 = self.io.flag("inter_pred_idc", 4,
                                          None if want is None else int(want == 1))
                        idc = 1 if b1 else 0
                else:
                    want = pu_plan["inter_dir"] if self.is_enc else None
                    b = self.io.flag("inter_pred_idc", 4,
                                     None if want is None else int(want == 1))
                    idc = 1 if b else 0
            else:
                idc = 0
            motion = Motion()
            for lx in (0, 1):
                if (idc == 0 and lx == 1) or (idc == 1 and lx == 0):
                    continue
                n_ref = (sh.num_ref_idx_l0_active if lx == 0
                         else sh.num_ref_idx_l1_active)
                ridx = self._ref_idx_syntax(
                    n_ref, pu_plan["ref_idx"][lx] if self.is_enc else None)
                if lx == 1 and sh.mvd_l1_zero and idc == 2:
                    mvd = (0, 0)
                else:
                    mvd = self._mvd_coding(
                        pu_plan["mvd"][lx] if self.is_enc else None)
                mvp = self.io.flag(
                    "mvp_flag", 0,
                    pu_plan["mvp_flag"][lx] if self.is_enc else None)
                amvp = derive_amvp(mctx, x, y, w, h, lx, ridx)
                mv = (wrap_mv(amvp[mvp][0] + mvd[0]),
                      wrap_mv(amvp[mvp][1] + mvd[1]))
                motion.mv[lx] = mv
                motion.ref_idx[lx] = ridx
                motion.ref_poc[lx] = mctx.list_pocs[lx][ridx]
        mctx.store_pu(x, y, w, h, motion)
        rec = PuRec(x, y, w, h, motion)
        if self.is_enc:
            planned = next(self._pu_iter)
            assert planned.motion.same_motion(motion), (
                "encoder planning / serialization motion drift",
                (x, y, w, h), planned.motion, motion)
        else:
            self.plan.pus.append(rec)
        return bool(merge)

    def _ref_idx_syntax(self, n_ref: int, value: int | None) -> int:
        """ref_idx_lX: TR cMax=n_ref-1; bins 0,1 context-coded, rest bypass."""
        c_max = n_ref - 1
        if c_max == 0:
            return 0
        v = 0
        while v < c_max:
            b = (int(value > v) if self.is_enc else None)
            if v < 2:
                got = self.io.flag("ref_idx", v, b)
            else:
                got = self.io.bypass(b)
            if not got:
                break
            v += 1
        return v

    def _mvd_coding(self, value: tuple[int, int] | None) -> tuple[int, int]:
        """mvd_coding (spec 7.3.8.9)."""
        ax = abs(value[0]) if self.is_enc else None
        ay = abs(value[1]) if self.is_enc else None
        g0x = self.io.flag("abs_mvd_greater_flag", 0,
                           None if ax is None else int(ax > 0))
        g0y = self.io.flag("abs_mvd_greater_flag", 0,
                           None if ay is None else int(ay > 0))
        g1x = g1y = 0
        if g0x:
            g1x = self.io.flag("abs_mvd_greater_flag", 1,
                               None if ax is None else int(ax > 1))
        if g0y:
            g1y = self.io.flag("abs_mvd_greater_flag", 1,
                               None if ay is None else int(ay > 1))
        out = []
        for g0, g1, av, sv in ((g0x, g1x, ax, value[0] if value else None),
                               (g0y, g1y, ay, value[1] if value else None)):
            if not g0:
                out.append(0)
                continue
            mag = 1
            if g1:
                rem = self.io.eg_bypass(1, None if av is None else av - 2)
                mag = 2 + rem
            sgn = self.io.bypass(None if sv is None else int(sv < 0))
            if not self.is_enc:
                out.append(-mag if sgn else mag)
            else:
                out.append(sv)
        return (out[0], out[1])

    # -- transform tree (spec 7.3.8.8) ---------------------------------------
    def _transform_tree(self, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                        modes, chroma_mode, split0, max_depth, is_intra,
                        parent_cbf=(1, 1)):
        sps = self.sps
        size = 1 << log2_size
        if (log2_size <= sps.log2_max_tb_size
                and log2_size > sps.log2_min_tb_size
                and depth < max_depth
                and not (split0 and depth == 0)):
            want = (int(self.planner.tt_split(x0, y0, log2_size, depth))
                    if self.is_enc else None)
            split = self.io.flag("split_transform_flag", 5 - log2_size, want)
        else:
            split = int(log2_size > sps.log2_max_tb_size
                        or (split0 and depth == 0))
        cbf_cb, cbf_cr = parent_cbf
        if log2_size > 2:
            if cbf_cb:
                want = (int(self.planner.cbf(x0 >> 1, y0 >> 1, log2_size - 1, 1))
                        if self.is_enc else None)
                cbf_cb = self.io.flag("cbf_chroma", depth, want)
            if cbf_cr:
                want = (int(self.planner.cbf(x0 >> 1, y0 >> 1, log2_size - 1, 2))
                        if self.is_enc else None)
                cbf_cr = self.io.flag("cbf_chroma", depth, want)
        if split:
            half = size >> 1
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half), (half, half))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0, log2_size - 1,
                                     depth + 1, i, modes, chroma_mode,
                                     split0, max_depth, is_intra,
                                     parent_cbf=(cbf_cb, cbf_cr))
            return
        # leaf: cbf_luma (inferred 1 for inter depth-0 with no chroma cbf)
        if is_intra or depth != 0 or cbf_cb or cbf_cr:
            want = (int(self.planner.cbf(x0, y0, log2_size, 0))
                    if self.is_enc else None)
            cbf_luma = self.io.flag("cbf_luma", int(depth == 0), want)
        else:
            cbf_luma = 1
        self._transform_unit(x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                             modes, chroma_mode, cbf_luma, cbf_cb, cbf_cr,
                             is_intra)

    # -- transform unit (spec 7.3.8.10) --------------------------------------
    def _transform_unit(self, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                        modes, chroma_mode, cbf_luma, cbf_cb, cbf_cr, is_intra):
        if is_intra:
            if len(modes) == 1:
                lmode = modes[0]
            else:
                assert depth >= 1
                lmode = modes[blk_idx] if depth == 1 else modes[0]
        else:
            lmode = None
        if (self.qps.enabled and not self.qps.delta_coded
                and (cbf_luma or cbf_cb or cbf_cr)):
            self._cu_qp_delta_syntax()
        qp = self.qps.qp()
        if cbf_luma:
            scan = residual_scan_idx(lmode if is_intra else None, log2_size, 0)
            self._code_residual(x0, y0, log2_size, 0, scan,
                                lmode if is_intra else -1, qp, not is_intra)
        else:
            self._pred_only(x0, y0, log2_size, 0,
                            lmode if is_intra else -1, qp, not is_intra)
        self._set_map(self.plan.cbf_map, x0, y0, 1 << log2_size, v=int(cbf_luma))
        self._set_edges(x0, y0, 1 << log2_size)
        if log2_size > 2:
            do_chroma, cx, cy, clog2 = True, x0 >> 1, y0 >> 1, log2_size - 1
        elif blk_idx == 3:
            do_chroma, cx, cy, clog2 = True, x_base >> 1, y_base >> 1, 2
        else:
            do_chroma = False
        if do_chroma:
            for c_idx, cbf in ((1, cbf_cb), (2, cbf_cr)):
                if cbf:
                    scan = residual_scan_idx(
                        chroma_mode if is_intra else None, clog2, c_idx)
                    self._code_residual(cx, cy, clog2, c_idx, scan,
                                        chroma_mode if is_intra else -1, qp,
                                        not is_intra)
                else:
                    self._pred_only(cx, cy, clog2, c_idx,
                                    chroma_mode if is_intra else -1, qp,
                                    not is_intra)

    def _cu_qp_delta_syntax(self) -> None:
        """cu_qp_delta_abs / sign (spec 7.3.8.10, 9.3.3): TR(5) ctx + EG0."""
        if self.is_enc:
            want = int(self.planner.cu_qp_delta(*self.qps.qg_xy))
            a = abs(want)
            self.io.flag("cu_qp_delta_abs", 0, int(a > 0))
            if a > 0:
                for k in range(1, min(a, 5)):
                    self.io.flag("cu_qp_delta_abs", 1, 1)
                if a < 5:
                    self.io.flag("cu_qp_delta_abs", 1, 0)
                else:
                    self.io.eg_bypass(0, a - 5)
                self.io.bypass(int(want < 0))
            self.qps.set_delta(want)
        else:
            a = 0
            if self.io.flag("cu_qp_delta_abs", 0):
                a = 1
                while a < 5 and self.io.flag("cu_qp_delta_abs", 1):
                    a += 1
                if a == 5:
                    a += self.io.eg_bypass(0)
            v = 0
            if a:
                v = -a if self.io.bypass() else a
            self.qps.set_delta(v)

    def _pred_only(self, x, y, log2, c_idx, mode, qp, is_inter=False) -> None:
        if self.is_enc:
            got = next(self._tu_iter)
            assert got.pred_only and (got.x, got.y, got.log2, got.c_idx) == \
                (x, y, log2, c_idx), ("plan/traversal mismatch",
                                      (got.x, got.y, got.log2, got.c_idx),
                                      (x, y, log2, c_idx))
        else:
            self.plan.tus.append(
                TuRec(x, y, log2, c_idx, mode, None, qp=qp, pred_only=True,
                      is_inter=is_inter, tile=self.cur_tile, slice_idx=self.slice_idx))

    def _code_residual(self, x, y, log2, c_idx, scan, mode, qp,
                       is_inter=False) -> None:
        pps = self.pps
        if self.is_enc:
            tu = next(self._tu_iter)
            assert not tu.pred_only and (tu.x, tu.y, tu.log2, tu.c_idx) == \
                (x, y, log2, c_idx), ("plan/traversal mismatch",
                                      (tu.x, tu.y, tu.log2, tu.c_idx),
                                      (x, y, log2, c_idx))
            encode_residual(self.engine, tu.levels, log2, c_idx, scan,
                            transform_skip_allowed=pps.transform_skip_enabled,
                            sign_data_hiding=pps.sign_data_hiding,
                            tq_bypass=self.cu_bypass, tskip=tu.tskip)
        else:
            levels, tskip = decode_residual(
                self.engine, log2, c_idx, scan,
                transform_skip_allowed=pps.transform_skip_enabled,
                sign_data_hiding=pps.sign_data_hiding,
                tq_bypass=self.cu_bypass)
            mid = ((1 if is_inter else 0) if log2 == 5
                   else 3 * (1 if is_inter else 0) + c_idx)
            self.plan.tus.append(TuRec(x, y, log2, c_idx, mode, levels, tskip,
                                       qp, is_inter=is_inter,
                                       tile=self.cur_tile, slice_idx=self.slice_idx,
                                       bypass=self.cu_bypass, matrix_id=mid))


def parse_slice_data(dec, sps: SPS, pps: PPS, sh: SliceHeader,
                     mctx: MotionCtx | None = None,
                     substreams=None, plan: FramePlan | None = None,
                     slice_idx: int = 0, carry_avail=None, wpp_carry=None):
    if plan is None:
        plan = FramePlan(sps, pps, sh)
    coder = CtuCoder(dec, sps, pps, sh, plan, is_enc=False, mctx=mctx,
                     substreams=substreams,
                     start_ctb=sh.slice_segment_address,
                     slice_idx=slice_idx, carry_avail=carry_avail,
                     wpp_carry=wpp_carry)
    coded = coder.code_slice_data()
    return plan, coded, coder
