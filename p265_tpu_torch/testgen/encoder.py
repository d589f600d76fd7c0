"""Minimal conformant HEVC encoder (testgen): IDR intra + low-delay P GOPs.

Purpose (SURVEY.md 4.2): no conformance streams or reference encoders exist in
this environment, so this encoder produces the legal Main-profile bitstreams
everything else is tested against.  It must be conformant and varied, not
good: SAD mode decisions, small-range motion search, seeded-RNG structure
choices for syntax coverage.

Round-trip contract: decode(encode(imgs)) == encoder's own recon, bit-exact,
because the encoder reconstructs through the same golden ops and derives
motion through the same golden/mv.py code as the decoder.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from p265_tpu_torch.entropy.engine import CabacEncoder, ContextModels
from p265_tpu_torch.golden.decoder import apply_loop_filters
from p265_tpu_torch.golden.inter import (combine_bi, combine_pu, combine_uni,
                                   mc_chroma, mc_luma)
from p265_tpu_torch.golden.intra import intra_predict_tu
from p265_tpu_torch.golden.mv import (Motion, MotionCtx, NO_REF, derive_amvp,
                                derive_merge_list)
from p265_tpu_torch.golden.recon import tu_qp
from p265_tpu_torch.golden.transform import (dequant, forward_transform,
                                       inverse_transform, quantize,
                                       quantize_transform_skip,
                                       transform_skip_residual)
from p265_tpu_torch.hls import nal
from p265_tpu_torch.hls.bitio import BitWriter
from p265_tpu_torch.hls.params import (PPS, SPS, ShortTermRPS, write_pps, write_sps,
                                 write_vps)
from p265_tpu_torch.hls.slice_header import (SLICE_B, SLICE_I, SLICE_P, SliceHeader,
                                       WeightTable, write_slice_header)
from p265_tpu_torch.syntax.ctu import (CtuCoder, EncodeSubstreams, FramePlan, PuRec,
                                 SaoRec, TuRec, pu_rects, wrap_mv)
from p265_tpu_torch.syntax.qp import QpState
from p265_tpu_torch.syntax.tiles import build_tile_info
from p265_tpu_torch.syntax.residual import apply_sign_data_hiding
from p265_tpu_torch.tables import residual_scan_idx


@dataclass
class EncPlanner:
    """Decision tables filled during planning, consumed during serialization."""
    cu_splits: dict = field(default_factory=dict)
    part_nxns: dict = field(default_factory=dict)
    modes: dict = field(default_factory=dict)
    chroma_idxs: dict = field(default_factory=dict)
    tt_splits: dict = field(default_factory=dict)
    cbfs: dict = field(default_factory=dict)
    cu_skips: dict = field(default_factory=dict)
    pred_modes: dict = field(default_factory=dict)   # (x,y) -> intra?
    inter_parts: dict = field(default_factory=dict)
    pu_plans: dict = field(default_factory=dict)     # (x,y) -> dict
    rqt_roots: dict = field(default_factory=dict)
    cu_bypasses: dict = field(default_factory=dict)
    pcms: dict = field(default_factory=dict)
    qp_deltas: dict = field(default_factory=dict)

    def cu_split(self, x0, y0, log2, depth):
        return self.cu_splits[(x0, y0, log2)]

    def part_nxn(self, x0, y0):
        return self.part_nxns[(x0, y0)]

    def luma_modes(self, x0, y0):
        return self.modes[(x0, y0)]

    def chroma_mode_idx(self, x0, y0):
        return self.chroma_idxs[(x0, y0)]

    def tt_split(self, x0, y0, log2, depth):
        return self.tt_splits[(x0, y0, log2)]

    def cbf(self, x, y, log2, c_idx):
        return self.cbfs[(x, y, log2, c_idx)]

    def cu_skip(self, x0, y0):
        return self.cu_skips[(x0, y0)]

    def pred_mode_intra(self, x0, y0):
        return self.pred_modes[(x0, y0)]

    def inter_part(self, x0, y0):
        return self.inter_parts[(x0, y0)]

    def pu(self, x, y):
        return self.pu_plans[(x, y)]

    def rqt_root(self, x0, y0):
        return self.rqt_roots[(x0, y0)]

    def cu_bypass(self, x0, y0):
        return self.cu_bypasses.get((x0, y0), False)

    def pcm(self, x0, y0):
        return self.pcms.get((x0, y0), False)

    def cu_qp_delta(self, x0, y0):
        return self.qp_deltas.get((x0, y0), 0)


@dataclass
class _RefPic:
    poc: int
    planes: list            # post-filter
    col_mv: np.ndarray
    col_ref_poc: np.ndarray
    col_lt: np.ndarray = None


class Encoder:
    def __init__(self, sps: SPS, pps: PPS, qp: int = 32, seed: int = 0,
                 full_mode_search: bool = False):
        self.sps, self.pps, self.qp = sps, pps, qp
        self.seed = seed
        self.full_search = full_mode_search
        self.refs: list[_RefPic] = []

    # -- public --------------------------------------------------------------
    def encode_frame(self, yuv, *, poc: int = 0, slice_type: int = SLICE_I,
                     used_pocs: list[int] | None = None,
                     keep_pocs: list[int] | None = None,
                     n_ref: tuple[int, int] = (1, 1), num_slices: int = 1,
                     dependent_slices: bool = False,
                     lt_pocs: list[int] | None = None,
                     nal_type: int | None = None):
        """Encode one frame -> (nal_bytes, plan, prefilter_recon, filtered).

        used_pocs: reference POCs for this picture; keep_pocs: POCs that must
        stay in the DPB for later pictures (RPS used flag 0).  Reference list
        order replicates the decoder's derivation (before-desc + after-asc).
        """
        sps, pps = self.sps, self.pps
        used_pocs = used_pocs or []
        keep_pocs = keep_pocs or []
        lt_pocs = lt_pocs or []          # long-term refs, appended after ST
        before = sorted((p for p in used_pocs if p < poc), reverse=True)
        after = sorted(p for p in used_pocs if p > poc)
        tmp0 = before + after + lt_pocs
        tmp1 = after + before + lt_pocs
        lt_set = set(lt_pocs)
        n0 = min(n_ref[0], len(tmp0)) or (1 if tmp0 else 0)
        l0_pocs = [tmp0[i % len(tmp0)] for i in range(n0)] if tmp0 else []
        l1_pocs = []
        if slice_type == SLICE_B:
            n1 = min(n_ref[1], len(tmp1)) or (1 if tmp1 else 0)
            l1_pocs = [tmp1[i % len(tmp1)] for i in range(n1)] if tmp1 else []
        # exercise ref_pic_list_modification: reverse L0 order occasionally
        mod_l0 = None
        if (pps.lists_modification_present and len(tmp0) > 1 and n0 > 1
                and np.random.default_rng(self.seed + poc).random() < 0.7):
            mod_l0 = [n0 - 1 - i for i in range(n0)]
            l0_pocs = [tmp0[e] for e in mod_l0]
        self.rng = np.random.default_rng(self.seed + poc * 1031)
        self.orig = [p.astype(np.int32) for p in yuv]
        w, h = sps.pic_width, sps.pic_height
        cw, ch = w >> 1, h >> 1
        self.rec = [np.zeros((h, w), np.int32),
                    np.zeros((ch, cw), np.int32),
                    np.zeros((ch, cw), np.int32)]
        self.avail = [np.zeros(((h + 3) >> 2, (w + 3) >> 2), bool),
                      np.zeros(((ch + 3) >> 2, (cw + 3) >> 2), bool),
                      np.zeros(((ch + 3) >> 2, (cw + 3) >> 2), bool)]

        if nal_type is None:
            nal_type = (nal.NAL_IDR_W_RADL if slice_type == SLICE_I
                        else nal.NAL_TRAIL_R)
        is_idr = nal.is_idr(nal_type)
        sh = SliceHeader(
            nal_type=nal_type,
            slice_type=slice_type, slice_qp=self.qp,
            sao_luma=sps.sao_enabled, sao_chroma=sps.sao_enabled,
            pic_order_cnt_lsb=poc & (sps.max_poc_lsb - 1),
            temporal_mvp_enabled=(sps.temporal_mvp_enabled
                                  and slice_type != SLICE_I))
        sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
        sh.beta_offset_div2 = pps.beta_offset_div2
        sh.tc_offset_div2 = pps.tc_offset_div2
        sh.num_ref_idx_l0_active = max(1, len(l0_pocs))
        sh.num_ref_idx_l1_active = max(1, len(l1_pocs))
        self.l0_lt = [p in lt_set for p in l0_pocs]
        self.l1_lt = [p in lt_set for p in l1_pocs]
        self.weights = None
        if ((pps.weighted_pred and slice_type == SLICE_P)
                or (pps.weighted_bipred and slice_type == SLICE_B)):
            # exercise explicit WP with mild per-ref weights/offsets
            wrng = np.random.default_rng(self.seed + poc * 7 + 5)
            wt = WeightTable(luma_log2_denom=6, chroma_log2_denom=6)
            for lx, pocs in ((0, l0_pocs), (1, l1_pocs)):
                for _ in pocs:
                    lw = 64 + int(wrng.integers(-8, 9))
                    lo = int(wrng.integers(-10, 11))
                    cw = 64 + int(wrng.integers(-6, 7))
                    co = int(wrng.integers(-6, 7))
                    wt.entries[lx].append((lw, lo, cw, co, cw, co))
            sh.pred_weights = wt
            self.weights = wt
        if not is_idr:
            # explicit RPS: current refs (used=1) + later-needed pics (used=0)
            all_pocs = sorted(set(used_pocs) | set(keep_pocs))
            neg = [p for p in all_pocs if p < poc]
            pos = [p for p in all_pocs if p > poc]
            rps = ShortTermRPS(
                delta_poc_s0=[p - poc for p in sorted(neg, reverse=True)],
                used_s0=[int(p in used_pocs) for p in sorted(neg, reverse=True)],
                delta_poc_s1=[p - poc for p in sorted(pos)],
                used_s1=[int(p in used_pocs) for p in sorted(pos)])
            sh.st_rps_explicit = rps
            sh.st_rps_sps_flag = False
            # long-term entries: always msb_present (decoder matches full POC;
            # the writer's delta accumulation is exercised for >1 entry)
            max_lsb = sps.max_poc_lsb
            poc_msb_cur = poc - (poc & (max_lsb - 1))
            # a head run of entries matching SPS LT candidates is signaled
            # via lt_idx_sps (they must precede slice-signaled entries, so
            # stop at the first non-match to preserve reference order)
            sps_avail = list(range(sps.num_long_term_ref_pics))
            head = True
            for ref in lt_pocs:
                lsb = ref & (max_lsb - 1)
                cycle = (poc_msb_cur + lsb - ref) // max_lsb
                e = {"poc_lsb": lsb, "used": True,
                     "msb_present": True, "msb_cycle": cycle}
                if head:
                    m = next((i for i in sps_avail
                              if sps.lt_ref_poc_lsb[i] == lsb
                              and sps.lt_used_by_curr[i]), None)
                    if m is None:
                        head = False
                    else:
                        e["sps_idx"] = m
                        sps_avail.remove(m)
                sh.lt_entries.append(e)
            sh.num_pic_total_curr = (sum(rps.used_s0) + sum(rps.used_s1)
                                     + len(lt_pocs))
            sh.ref_pic_list_modification_l0 = mod_l0

        plan = FramePlan(sps, pps, sh)
        plan.alloc_maps()
        if sps.scaling_list_enabled:
            from p265_tpu_torch.hls.params import resolve_scaling_matrices
            plan.scaling = resolve_scaling_matrices(
                pps.scaling_list_data or sps.scaling_list_data)
        plan.poc = poc
        plan.l0_pocs = list(l0_pocs)
        plan.l1_pocs = list(l1_pocs)
        self.plan = plan
        self.planner = EncPlanner()
        self.sh = sh
        self.slice_type = slice_type
        self.ref_by_poc = {r.poc: r for r in self.refs}
        self.mctx = self._make_mctx(sh, poc, l0_pocs, l1_pocs)

        self.tile_info = build_tile_info(sps, pps)
        self.cur_tile = 0
        self.dependent_slices = dependent_slices
        if num_slices > 1 and dependent_slices:
            assert pps.dependent_slice_segments_enabled
        scan = self.tile_info.ctb_scan
        if num_slices > 1 and (pps.tiles_enabled
                               or pps.entropy_coding_sync_enabled):
            # slice boundaries align with substream starts (whole tiles /
            # whole WPP rows per slice -- the spec's slices-contain-tiles
            # conformance shape)
            segs = self.tile_info.segments
            per = (len(segs) + num_slices - 1) // num_slices
            self.slice_chunks = [
                [a for s in segs[i * per:(i + 1) * per] for a in s]
                for i in range(num_slices) if segs[i * per:(i + 1) * per]]
        else:
            per = (len(scan) + num_slices - 1) // num_slices
            self.slice_chunks = [
                scan[i * per:(i + 1) * per]
                for i in range(num_slices) if scan[i * per:(i + 1) * per]]
        self.slice_of_ctb_plan = np.zeros(sps.num_ctbs, np.int32)
        if not dependent_slices:
            for si, ch in enumerate(self.slice_chunks):
                for a_ in ch:
                    self.slice_of_ctb_plan[a_] = si
        # dependent segments continue one slice: no prediction barriers
        slice_starts = (set() if dependent_slices
                        else {ch[0] for ch in self.slice_chunks[1:]})
        self.cur_slice = 0
        plan.sao = [SaoRec() for _ in range(sps.num_ctbs)]
        self._qp_scratch = np.full(plan.grid_shape(), self.qp, np.int32)
        self.qp_plan = QpState(sps, pps, self._qp_scratch,
                               lambda x, y: (0 <= x < sps.pic_width
                                             and 0 <= y < sps.pic_height
                                             and bool(self.avail[0][y >> 2,
                                                                   x >> 2])))
        seg_starts = {seg[0] for seg in self.tile_info.segments if seg}
        for ctb_addr in self.tile_info.ctb_scan:
            if ctb_addr in seg_starts:
                self.qp_plan.start_segment(self.qp)
            self.cur_slice = int(self.slice_of_ctb_plan[ctb_addr])
            if ctb_addr in slice_starts:
                # prediction never crosses slice boundaries
                for a_ in self.avail:
                    a_[:] = False
                self.qp_plan.start_segment(self.qp)
            t_id = int(self.tile_info.tile_of_ctb[ctb_addr])
            if t_id != self.cur_tile:
                self.cur_tile = t_id
                for a in self.avail:
                    a[:] = False  # prediction never crosses tile boundaries
            xc = (ctb_addr % sps.pic_width_ctbs) << sps.log2_ctb_size
            yc = (ctb_addr // sps.pic_width_ctbs) << sps.log2_ctb_size
            if sps.sao_enabled and (sh.sao_luma or sh.sao_chroma):
                plan.sao[ctb_addr] = self._plan_sao(ctb_addr)
            self._plan_cq(xc, yc, sps.log2_ctb_size, 0)

        nal_bytes = self._serialize(plan, sh, poc, l0_pocs, l1_pocs)
        prefilter = [p.copy() for p in self.rec]
        filtered = apply_loop_filters(plan, [p.copy() for p in self.rec])
        # register as reference for future frames
        if self.mctx is not None:
            col_mv = self.mctx.mv[::4, ::4].copy()
            col_rp = self.mctx.ref_poc[::4, ::4].copy()
            col_lt = self.mctx.lt[::4, ::4].copy()
        else:
            h16, w16 = (h + 15) >> 4, (w + 15) >> 4
            col_mv = np.zeros((h16, w16, 2, 2), np.int32)
            col_rp = np.full((h16, w16, 2), NO_REF, np.int32)
            col_lt = np.zeros((h16, w16, 2), bool)
        self.refs.append(_RefPic(poc, filtered, col_mv, col_rp, col_lt))
        return nal_bytes, plan, prefilter, filtered

    def _make_mctx(self, sh, poc, l0_pocs, l1_pocs):
        if sh.slice_type == SLICE_I:
            return None
        sps = self.sps
        col_mv = col_rp = col_lt = None
        col_poc = None
        if sh.temporal_mvp_enabled:
            col_pocs = l0_pocs if sh.collocated_from_l0 else l1_pocs
            col = self.ref_by_poc[col_pocs[sh.collocated_ref_idx]]
            col_mv, col_rp, col_poc = col.col_mv, col.col_ref_poc, col.poc
            col_lt = col.col_lt
        h4 = (sps.pic_height + 3) >> 2
        w4 = (sps.pic_width + 3) >> 2
        m = MotionCtx(sps, sh, poc, list(l0_pocs), list(l1_pocs), (h4, w4),
                      col_mv=col_mv, col_ref_poc=col_rp, col_poc=col_poc,
                      l0_lt=list(self.l0_lt), l1_lt=list(self.l1_lt),
                      col_lt=col_lt)
        m.avail = lambda x, y: (0 <= x < sps.pic_width
                                and 0 <= y < sps.pic_height
                                and bool(self.avail[0][y >> 2, x >> 2]))
        m.intra_map = self.plan.intra_map
        return m

    def encode_sequence(self, frames, structure: str = "LDP",
                        num_slices: int = 1):
        """Encode a GOP: frame 0 IDR, rest P referencing the previous frame
        (LDP) or the two nearest (LDP2).  Returns (stream, recon list in
        decode order)."""
        w = BitWriter()
        write_vps(w)
        out = nal.make_nal(nal.NAL_VPS, w.get_bytes())
        w = BitWriter()
        write_sps(w, self.sps)
        out += nal.make_nal(nal.NAL_SPS, w.get_bytes())
        w = BitWriter()
        write_pps(w, self.pps)
        out += nal.make_nal(nal.NAL_PPS, w.get_bytes())
        recons = {}
        if structure in ("LDP", "LDP2"):
            for i, f in enumerate(frames):
                if i == 0:
                    nb, _, _, filt = self.encode_frame(
                        f, poc=0, slice_type=SLICE_I, num_slices=num_slices)
                else:
                    n_refs = 2 if structure == "LDP2" else 1
                    l0 = [i - k for k in range(1, min(i, n_refs) + 1)]
                    nb, _, _, filt = self.encode_frame(
                        f, poc=i, slice_type=SLICE_P, used_pocs=l0,
                        n_ref=(len(l0), 0), num_slices=num_slices)
                out += nb
                recons[i] = filt
        elif structure == "LDP-LT":
            # low-delay P where every frame also references frame 0 as a
            # long-term picture: P frames use L0 = [prev(ST), 0(LT)], which
            # exercises LT marking, mixed ST/LT AMVP (no scaling across
            # lt-ness), TMVP lt gates and LT ref-list construction
            for i, f in enumerate(frames):
                if i == 0:
                    nb, _, _, filt = self.encode_frame(
                        f, poc=0, slice_type=SLICE_I, num_slices=num_slices)
                else:
                    l0 = [i - 1] if i > 1 else []
                    nb, _, _, filt = self.encode_frame(
                        f, poc=i, slice_type=SLICE_P, used_pocs=l0,
                        lt_pocs=[0], n_ref=(len(l0) + 1, 0),
                        num_slices=num_slices)
                out += nb
                recons[i] = filt
        elif structure == "RA":
            # hierarchical mini-GOPs of 4: decode order 0, 4, 2, 1, 3, 8, 6, ...
            n = len(frames)
            nb, _, _, filt = self.encode_frame(frames[0], poc=0,
                                               slice_type=SLICE_I,
                                               num_slices=num_slices)
            out += nb
            recons[0] = filt
            base = 0
            while base + 1 < n:
                anchor = min(base + 4, n - 1)
                if anchor == base:
                    break
                nb, _, _, filt = self.encode_frame(
                    frames[anchor], poc=anchor, slice_type=SLICE_P,
                    used_pocs=[base], n_ref=(1, 0), num_slices=num_slices)
                out += nb
                recons[anchor] = filt
                mids = [p for p in range(base + 1, anchor)]
                if len(mids) == 3:  # full mini-GOP: B2(b,a) then B1, B3
                    m = base + 2
                    for poc_b, refs, keeps in (
                            (m, [base, anchor], []),
                            (base + 1, [base, m], [anchor]),
                            (base + 3, [m, anchor], [])):
                        nb, _, _, filt = self.encode_frame(
                            frames[poc_b], poc=poc_b, slice_type=SLICE_B,
                            used_pocs=refs, keep_pocs=keeps, n_ref=(1, 1),
                            num_slices=num_slices)
                        out += nb
                        recons[poc_b] = filt
                else:
                    for poc_b in mids:
                        nb, _, _, filt = self.encode_frame(
                            frames[poc_b], poc=poc_b, slice_type=SLICE_B,
                            used_pocs=[base, anchor],
                            keep_pocs=[], n_ref=(1, 1),
                            num_slices=num_slices)
                        out += nb
                        recons[poc_b] = filt
                base = anchor
        elif structure == "CRA-RASL":
            # open-GOP splice shape (spec 8.1.3): IDR(0), P(1), then a CRA at
            # POC 4 whose leading pictures 2,3 are RASL B-frames referencing
            # the pre-CRA picture 1 -- decodable only when decode starts at
            # the IDR; discarded when decode starts at the CRA (or when the
            # CRA is rewritten to BLA).  Trailing P frames reference only the
            # CRA, keeping it a clean random-access point.
            assert len(frames) >= 6, "CRA-RASL needs >= 6 frames"
            nb, _, _, filt = self.encode_frame(
                frames[0], poc=0, slice_type=SLICE_I, num_slices=num_slices)
            out += nb
            recons[0] = filt
            nb, _, _, filt = self.encode_frame(
                frames[1], poc=1, slice_type=SLICE_P, used_pocs=[0],
                n_ref=(1, 0), num_slices=num_slices)
            out += nb
            recons[1] = filt
            # CRA at poc 4: empty "curr" RPS, but keeps poc 1 for the RASLs
            nb, _, _, filt = self.encode_frame(
                frames[4], poc=4, slice_type=SLICE_I, keep_pocs=[1],
                nal_type=nal.NAL_CRA, num_slices=num_slices)
            out += nb
            recons[4] = filt
            # leading pictures: RASL first (may reference pre-CRA pic 1),
            # then RADL (references only the CRA -- always decodable); RASL
            # precedes RADL in decode order per spec 7.4.2.2
            nb, _, _, filt = self.encode_frame(
                frames[2], poc=2, slice_type=SLICE_B, used_pocs=[1, 4],
                n_ref=(1, 1), nal_type=nal.NAL_RASL_R,
                num_slices=num_slices)
            out += nb
            recons[2] = filt
            nb, _, _, filt = self.encode_frame(
                frames[3], poc=3, slice_type=SLICE_P, used_pocs=[4],
                n_ref=(1, 0), nal_type=nal.NAL_RADL_R,
                num_slices=num_slices)
            out += nb
            recons[3] = filt
            for poc_t in range(5, len(frames)):  # trailing, CRA-anchored
                nb, _, _, filt = self.encode_frame(
                    frames[poc_t], poc=poc_t, slice_type=SLICE_P,
                    used_pocs=[poc_t - 1 if poc_t > 5 else 4], n_ref=(1, 0),
                    num_slices=num_slices)
                out += nb
                recons[poc_t] = filt
        else:
            raise ValueError(structure)
        return out, [recons[i] for i in sorted(recons)]

    # -- SAO planning --------------------------------------------------------
    def _plan_sao(self, ctb_addr: int) -> SaoRec:
        rec = SaoRec()
        r = self.rng.random()
        tof = self.tile_info.tile_of_ctb
        sof = self.slice_of_ctb_plan
        wc = self.sps.pic_width_ctbs
        left_same = (ctb_addr % wc != 0 and tof[ctb_addr - 1] == tof[ctb_addr]
                     and sof[ctb_addr - 1] == sof[ctb_addr])
        up_same = (ctb_addr >= wc and tof[ctb_addr - wc] == tof[ctb_addr]
                   and sof[ctb_addr - wc] == sof[ctb_addr])
        if left_same and r < 0.15:
            rec.merge_left = True
            src = self.plan.sao[ctb_addr - 1]  # raster-indexed
            rec.type, rec.cls = list(src.type), list(src.cls)
            rec.offsets = [list(o) for o in src.offsets]
            return rec
        if up_same and r < 0.25:
            rec.merge_up = True
            src = self.plan.sao[ctb_addr - self.sps.pic_width_ctbs]
            rec.type, rec.cls = list(src.type), list(src.cls)
            rec.offsets = [list(o) for o in src.offsets]
            return rec
        for c in range(3):
            t = int(self.rng.integers(0, 3))
            if c == 2:
                t = rec.type[1]
            rec.type[c] = t
            if t == 1:
                rec.offsets[c] = [int(v) for v in self.rng.integers(-7, 8, 4)]
                rec.cls[c] = int(self.rng.integers(0, 29))
            elif t == 2:
                mags = [int(v) for v in self.rng.integers(0, 8, 4)]
                rec.offsets[c] = [mags[0], mags[1], -mags[2], -mags[3]]
                rec.cls[c] = (int(self.rng.integers(0, 4)) if c < 2
                              else rec.cls[1])
        return rec

    # -- CU quadtree planning ------------------------------------------------
    def _plan_cq(self, x0, y0, log2_size, depth):
        sps = self.sps
        size = 1 << log2_size
        if self.qp_plan.enabled and log2_size >= self.qp_plan.min_qg_log2:
            self.qp_plan.maybe_start_qg(x0, y0, log2_size)
            if (x0, y0) not in self.planner.qp_deltas:
                self.planner.qp_deltas[(x0, y0)] = int(self.rng.integers(-2, 3))
        inside = (x0 + size <= sps.pic_width) and (y0 + size <= sps.pic_height)
        can_split = log2_size > sps.log2_min_cb_size
        if inside and can_split:
            split = bool(self.rng.random() < (0.6 if log2_size >= 5 else 0.4))
            self.planner.cu_splits[(x0, y0, log2_size)] = split
        else:
            split = can_split
        if split:
            half = size >> 1
            for dy in (0, half):
                for dx in (0, half):
                    x1, y1 = x0 + dx, y0 + dy
                    if x1 < sps.pic_width and y1 < sps.pic_height:
                        self._plan_cq(x1, y1, log2_size - 1, depth + 1)
            return
        self._plan_cu(x0, y0, log2_size)

    # -- CU planning ---------------------------------------------------------
    def _plan_cu(self, x0, y0, log2_size):
        if self.mctx is not None:
            self.mctx.begin_cu()
        self._cur_bypass = False
        if self.pps.transquant_bypass_enabled:
            self._cur_bypass = bool(self.rng.random() < 0.25)
            self.planner.cu_bypasses[(x0, y0)] = self._cur_bypass
        if self.slice_type == SLICE_I:
            self.planner.cu_skips[(x0, y0)] = False
            self._plan_intra_cu(x0, y0, log2_size)
            return
        self._plan_pb_cu(x0, y0, log2_size)

    # ---- intra -------------------------------------------------------------
    def _best_mode(self, c_idx, x, y, size, cand_modes):
        plane, avail = self.rec[c_idx], self.avail[c_idx]
        orig = self.orig[c_idx][y:y + size, x:x + size]
        best, best_cost = cand_modes[0], None
        for m in cand_modes:
            pred = intra_predict_tu(plane, avail, x, y, size, m, c_idx,
                                    self.sps.strong_intra_smoothing)
            cost = int(np.abs(
                orig - pred[:orig.shape[0], :orig.shape[1]]).sum())
            if best_cost is None or cost < best_cost:
                best, best_cost = m, cost
        return best, best_cost

    def _plan_intra_cu(self, x0, y0, log2_size):
        sps = self.sps
        size = 1 << log2_size
        self.planner.pred_modes[(x0, y0)] = True
        part_nxn = False
        if log2_size == sps.log2_min_cb_size:
            part_nxn = bool(self.rng.random() < 0.4)
            self.planner.part_nxns[(x0, y0)] = part_nxn
        if (sps.pcm_enabled and not part_nxn and not self._cur_bypass
                and sps.pcm_log2_min_size <= log2_size <= sps.pcm_log2_max_size):
            use_pcm = bool(self.rng.random() < 0.3)
            self.planner.pcms[(x0, y0)] = use_pcm
            if use_pcm:
                self._plan_pcm_cu(x0, y0, log2_size)
                return
        n_pu = 4 if part_nxn else 1
        pb = size >> 1 if part_nxn else size

        cand = (list(range(35)) if self.full_search
                else sorted({0, 1, 10, 26, 2, 18, 34,
                             int(self.rng.integers(2, 35)),
                             int(self.rng.integers(2, 35))}))
        modes = []
        for i in range(n_pu):
            px, py = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
            modes.append(self._best_mode(0, px, py, pb, cand)[0])
        self.planner.modes[(x0, y0)] = modes
        cidx = 4 if self.rng.random() < 0.7 else int(self.rng.integers(0, 4))
        self.planner.chroma_idxs[(x0, y0)] = cidx
        chroma_mode = CtuCoder._chroma_mode_from_idx(cidx, modes[0])

        self._set_intra_maps(x0, y0, size, modes, pb)
        intra_split = part_nxn
        max_depth = sps.max_transform_hierarchy_depth_intra + intra_split
        self._plan_tt(x0, y0, x0, y0, log2_size, 0, 0, modes, chroma_mode,
                      intra_split, max_depth, None)
        self._end_cu_qp(x0, y0, size)

    def _plan_pcm_cu(self, x0, y0, log2_size):
        sps = self.sps
        size = 1 << log2_size
        shift = 8 - sps.pcm_bit_depth
        for (px, py, plog2, c, psz) in ((x0, y0, log2_size, 0, size),
                                        (x0 >> 1, y0 >> 1, log2_size - 1, 1,
                                         size >> 1),
                                        (x0 >> 1, y0 >> 1, log2_size - 1, 2,
                                         size >> 1)):
            samples = ((self.orig[c][py:py + psz, px:px + psz] >> shift)
                       << shift).astype(np.int32)
            self.plan.tus.append(TuRec(px, py, plog2, c, 1, samples,
                                       qp=self.qp, pred_only=True,
                                       is_inter=True, pcm=True,
                                       tile=self.cur_tile,
                                       slice_idx=self.cur_slice))
            self.rec[c][py:py + psz, px:px + psz] = samples
            self.avail[c][py >> 2:(py + psz) >> 2, px >> 2:(px + psz) >> 2] = True
        self.plan.intra_mode_map[y0 >> 2:(y0 + size) >> 2,
                                 x0 >> 2:(x0 + size) >> 2] = 1
        self.plan.intra_map[y0 >> 2:(y0 + size) >> 2,
                            x0 >> 2:(x0 + size) >> 2] = 1
        self._end_cu_qp(x0, y0, size)

    def _set_intra_maps(self, x0, y0, size, modes, pb):
        g = self.plan
        x1 = min(x0 + size, self.sps.pic_width)
        y1 = min(y0 + size, self.sps.pic_height)
        g.intra_map[y0 >> 2:(y1 + 3) >> 2, x0 >> 2:(x1 + 3) >> 2] = 1
        for i, m in enumerate(modes):
            px, py = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
            g.intra_mode_map[py >> 2:(py + pb) >> 2, px >> 2:(px + pb) >> 2] = m

    # ---- inter -------------------------------------------------------------
    def _mc_pred_pu(self, m: Motion, x, y, w, h):
        """MC prediction for a PU -> (luma, cb, cr) blocks."""
        luma, cbs, crs = [], [], []
        for lx in range(2):
            if not m.uses(lx):
                continue
            ref = self.ref_by_poc[m.ref_poc[lx]].planes
            mvx, mvy = m.mv[lx]
            luma.append(mc_luma(ref[0], x, y, w, h, mvx, mvy))
            cbs.append(mc_chroma(ref[1], x >> 1, y >> 1, w >> 1, h >> 1, mvx, mvy))
            crs.append(mc_chroma(ref[2], x >> 1, y >> 1, w >> 1, h >> 1, mvx, mvy))
        return combine_pu(luma, cbs, crs, m, self.weights)

    def _luma_mc_cost(self, ref_plane, x, y, w, h, mvx, mvy, orig):
        pred = combine_uni(mc_luma(ref_plane, x, y, w, h, mvx, mvy))
        # boundary CUs: orig is cropped at the picture edge; cost only the
        # in-picture samples
        return int(np.abs(orig - pred[:orig.shape[0], :orig.shape[1]]).sum())

    def _motion_search(self, x, y, w, h, lx, ridx, starts):
        """Small-range ME: full-pel around start candidates + quarter refine."""
        ref = self.ref_by_poc[self.mctx.list_pocs[lx][ridx]].planes[0]
        orig = self.orig[0][y:y + h, x:x + w]
        # full-pel: clamp starts, search +-3 raster
        best_mv, best_cost = (0, 0), None
        tried = set()
        for sx, sy in starts:
            fx, fy = (sx >> 2) << 2, (sy >> 2) << 2
            for dy in range(-3, 4):
                for dx in range(-3, 4):
                    mv = (fx + 4 * dx, fy + 4 * dy)
                    if mv in tried:
                        continue
                    tried.add(mv)
                    c = self._luma_mc_cost(ref, x, y, w, h, mv[0], mv[1], orig)
                    if best_cost is None or c < best_cost:
                        best_mv, best_cost = mv, c
        # quarter-pel refine
        improved = True
        while improved:
            improved = False
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    mv = (best_mv[0] + dx, best_mv[1] + dy)
                    if mv in tried:
                        continue
                    tried.add(mv)
                    c = self._luma_mc_cost(ref, x, y, w, h, mv[0], mv[1], orig)
                    if c < best_cost:
                        best_mv, best_cost = mv, c
                        improved = True
        return best_mv, best_cost

    def _plan_pb_cu(self, x0, y0, log2_size):
        sps, sh = self.sps, self.sh
        size = 1 << log2_size
        orig_y = self.orig[0][y0:y0 + size, x0:x0 + size]

        # --- candidate A: 2Nx2N merge ---
        merge_cands = derive_merge_list(self.mctx, x0, y0, size, x0, y0,
                                        size, size, "2Nx2N", 0,
                                        sh.max_num_merge_cand)
        best_midx, best_mcost = 0, None
        for i, mc in enumerate(merge_cands):
            py_, _, _ = self._mc_pred_pu(mc, x0, y0, size, size)
            c = int(np.abs(orig_y
                           - py_[:orig_y.shape[0], :orig_y.shape[1]]).sum())
            if best_mcost is None or c < best_mcost:
                best_midx, best_mcost = i, c

        # --- candidate B: 2Nx2N AMVP ---
        is_b = self.slice_type == SLICE_B and len(self.mctx.list_pocs[1]) > 0
        amvp0 = derive_amvp(self.mctx, x0, y0, size, size, 0, 0)
        mv0, me_cost0 = self._motion_search(
            x0, y0, size, size, 0, 0, [amvp0[0], amvp0[1], (0, 0)])
        amvp_dir, amvp_mvs = 0, (mv0, (0, 0))
        me_cost = me_cost0 + 20  # crude bit-cost penalty vs merge
        if is_b:
            amvp1 = derive_amvp(self.mctx, x0, y0, size, size, 1, 0)
            mv1, me_cost1 = self._motion_search(
                x0, y0, size, size, 1, 0, [amvp1[0], amvp1[1], (0, 0)])
            # bi-prediction cost (true 14-bit intermediate average)
            ref0 = self.ref_by_poc[self.mctx.list_pocs[0][0]].planes[0]
            ref1 = self.ref_by_poc[self.mctx.list_pocs[1][0]].planes[0]
            bi = combine_bi(mc_luma(ref0, x0, y0, size, size, *mv0),
                            mc_luma(ref1, x0, y0, size, size, *mv1))
            bi_cost = int(np.abs(
                orig_y - bi[:orig_y.shape[0], :orig_y.shape[1]]).sum()) + 40
            options = ((0, me_cost0 + 20, (mv0, (0, 0))),
                       (1, me_cost1 + 20, ((0, 0), mv1)),
                       (2, bi_cost, (mv0, mv1)))
            amvp_dir, me_cost, amvp_mvs = min(options, key=lambda o: o[1])

        # --- candidate C: intra ---
        cand_modes = sorted({0, 1, 10, 26, int(self.rng.integers(2, 35))})
        best_imode, icost = self._best_mode(0, x0, y0, size, cand_modes)
        icost += 30

        choice = min((("merge", best_mcost), ("amvp", me_cost),
                      ("intra", icost)), key=lambda kv: kv[1])[0]
        if self.rng.random() < 0.06:
            choice = "intra"  # coverage: occasional intra in P/B

        if choice == "intra":
            self.planner.cu_skips[(x0, y0)] = False
            self._plan_intra_cu(x0, y0, log2_size)
            return

        # occasionally exercise 2-PU partitions with AMVP per PU
        part = "2Nx2N"
        if choice == "amvp" and size <= 32 and self.rng.random() < 0.3:
            part = "2NxN" if self.rng.random() < 0.5 else "Nx2N"

        self.planner.pred_modes[(x0, y0)] = False
        self.planner.inter_parts[(x0, y0)] = part
        rects = pu_rects(part, x0, y0, size)
        motions = []
        for i, (px, py, w, h) in enumerate(rects):
            if choice == "merge" and part == "2Nx2N":
                m = merge_cands[best_midx].copy()
                self.planner.pu_plans[(px, py)] = {
                    "merge": True, "merge_idx": best_midx}
            else:
                cands = derive_merge_list(self.mctx, x0, y0, size, px, py,
                                          w, h, part, i, sh.max_num_merge_cand)
                if part == "2Nx2N":
                    idc, mvs = amvp_dir, amvp_mvs
                else:
                    # sub-partitions: re-search per PU, uni L0 for simplicity
                    a = derive_amvp(self.mctx, px, py, w, h, 0, 0)
                    mv, _ = self._motion_search(px, py, w, h, 0, 0,
                                                [a[0], a[1], (0, 0)])
                    idc, mvs = 0, (mv, (0, 0))
                # merge shortcut if a candidate matches exactly
                want = Motion()
                for lx in range(2):
                    if (idc == 2) or (idc == lx):
                        want.mv[lx] = mvs[lx]
                        want.ref_idx[lx] = 0
                        want.ref_poc[lx] = self.mctx.list_pocs[lx][0]
                use_merge = False
                for ci, mc in enumerate(cands):
                    if mc.same_motion(want):
                        use_merge = True
                        self.planner.pu_plans[(px, py)] = {
                            "merge": True, "merge_idx": ci}
                        m = mc.copy()
                        break
                if not use_merge:
                    m = Motion()
                    mvds = [(0, 0), (0, 0)]
                    mvps = [0, 0]
                    for lx in range(2):
                        if not ((idc == 2) or (idc == lx)):
                            continue
                        a = derive_amvp(self.mctx, px, py, w, h, lx, 0)
                        mv = mvs[lx]
                        d0 = abs(mv[0] - a[0][0]) + abs(mv[1] - a[0][1])
                        d1 = abs(mv[0] - a[1][0]) + abs(mv[1] - a[1][1])
                        mvp_flag = 1 if d1 < d0 else 0
                        mvd = (mv[0] - a[mvp_flag][0], mv[1] - a[mvp_flag][1])
                        m.mv[lx] = (wrap_mv(a[mvp_flag][0] + mvd[0]),
                                    wrap_mv(a[mvp_flag][1] + mvd[1]))
                        m.ref_idx[lx] = 0
                        m.ref_poc[lx] = self.mctx.list_pocs[lx][0]
                        mvds[lx] = mvd
                        mvps[lx] = mvp_flag
                    self.planner.pu_plans[(px, py)] = {
                        "merge": False, "inter_dir": idc, "ref_idx": [0, 0],
                        "mvd": mvds, "mvp_flag": mvps}
            self.mctx.store_pu(px, py, w, h, m)
            motions.append(m)
            self.plan.pus.append(PuRec(px, py, w, h, m))

        # prediction + residual planning
        pred = [np.zeros((size, size), np.int32),
                np.zeros((size >> 1, size >> 1), np.int32),
                np.zeros((size >> 1, size >> 1), np.int32)]
        for (px, py, w, h), m in zip(rects, motions):
            py_, pcb, pcr = self._mc_pred_pu(m, px, py, w, h)
            pred[0][py - y0:py - y0 + h, px - x0:px - x0 + w] = py_
            pred[1][(py - y0) >> 1:((py - y0) + h) >> 1,
                    (px - x0) >> 1:((px - x0) + w) >> 1] = pcb
            pred[2][(py - y0) >> 1:((py - y0) + h) >> 1,
                    (px - x0) >> 1:((px - x0) + w) >> 1] = pcr
        self._pred_cu = (x0, y0, pred)

        g = self.plan
        x1 = min(x0 + size, sps.pic_width)
        y1 = min(y0 + size, sps.pic_height)
        g.intra_map[y0 >> 2:(y1 + 3) >> 2, x0 >> 2:(x1 + 3) >> 2] = 0
        g.intra_mode_map[y0 >> 2:(y1 + 3) >> 2, x0 >> 2:(x1 + 3) >> 2] = -1

        # TU planning: collect records, detect all-zero
        max_depth = sps.max_transform_hierarchy_depth_inter
        inter_split = max_depth == 0 and part != "2Nx2N"
        tus_before = len(self.plan.tus)
        cbf_before = dict(self.planner.cbfs)
        self._plan_tt(x0, y0, x0, y0, log2_size, 0, 0, None, -1,
                      inter_split, max_depth, pred)
        new_tus = self.plan.tus[tus_before:]
        any_cbf = any(not t.pred_only for t in new_tus)
        is_merge_2n = part == "2Nx2N" and self.planner.pu_plans[
            (x0, y0)].get("merge", False)
        if not any_cbf:
            # drop TU records; encode as skip (merge 2Nx2N) or rqt_root_cbf=0
            del self.plan.tus[tus_before:]
            self.planner.cbfs = cbf_before
            self._emit_pred_only_cu(x0, y0, size, pred)
            if is_merge_2n:
                self.planner.cu_skips[(x0, y0)] = True
                # skip CUs carry no pred_mode/part entries
                del self.planner.pred_modes[(x0, y0)]
                del self.planner.inter_parts[(x0, y0)]
            else:
                self.planner.cu_skips[(x0, y0)] = False
                self.planner.rqt_roots[(x0, y0)] = False
        else:
            self.planner.cu_skips[(x0, y0)] = False
            self.planner.rqt_roots[(x0, y0)] = True
            if is_merge_2n:
                pass  # rqt_root_cbf inferred 1 for 2Nx2N merge
        self._end_cu_qp(x0, y0, size)

    def _emit_pred_only_cu(self, x0, y0, size, pred):
        """Write MC prediction as recon; emit CU-covering pred_only records."""
        log2 = size.bit_length() - 1
        for (c, px, py, plog2) in ((0, x0, y0, log2),
                                   (1, x0 >> 1, y0 >> 1, log2 - 1),
                                   (2, x0 >> 1, y0 >> 1, log2 - 1)):
            psz = 1 << plog2
            self.rec[c][py:py + psz, px:px + psz] = pred[c]
            self.avail[c][py >> 2:(py + psz) >> 2, px >> 2:(px + psz) >> 2] = True
            self.plan.tus.append(TuRec(px, py, plog2, c, -1, None, qp=self.qp,
                                       pred_only=True, is_inter=True,
                                       tile=self.cur_tile,
                                       slice_idx=self.cur_slice))

    # -- transform tree planning (intra pred_src=None; inter pred_src=planes) -
    def _plan_tt(self, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                 modes, chroma_mode, split0, max_depth, pred_src):
        sps = self.sps
        size = 1 << log2_size
        if (log2_size <= sps.log2_max_tb_size
                and log2_size > sps.log2_min_tb_size
                and depth < max_depth
                and not (split0 and depth == 0)):
            split = bool(self.rng.random() < 0.3)
            self.planner.tt_splits[(x0, y0, log2_size)] = split
        else:
            split = (log2_size > sps.log2_max_tb_size
                     or (split0 and depth == 0))
        if split:
            half = size >> 1
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half), (half, half))):
                self._plan_tt(x0 + dx, y0 + dy, x0, y0, log2_size - 1,
                              depth + 1, i, modes, chroma_mode, split0,
                              max_depth, pred_src)
            self._derive_node_chroma_cbf(x0, y0, log2_size)
            return
        is_intra = pred_src is None
        if is_intra:
            lmode = modes[blk_idx] if (len(modes) > 1 and depth == 1) else modes[0]
        else:
            lmode = -1
        self._plan_tu(x0, y0, log2_size, 0, lmode, pred_src)
        if log2_size > 2:
            self._plan_tu(x0 >> 1, y0 >> 1, log2_size - 1, 1,
                          chroma_mode, pred_src)
            self._plan_tu(x0 >> 1, y0 >> 1, log2_size - 1, 2,
                          chroma_mode, pred_src)
        elif blk_idx == 3:
            self._plan_tu(x_base >> 1, y_base >> 1, 2, 1, chroma_mode, pred_src)
            self._plan_tu(x_base >> 1, y_base >> 1, 2, 2, chroma_mode, pred_src)
        self._derive_node_chroma_cbf(x0, y0, log2_size)

    def _derive_node_chroma_cbf(self, x0, y0, log2_size):
        for c in (1, 2):
            cx, cy, clog2 = x0 >> 1, y0 >> 1, log2_size - 1
            key = (cx, cy, clog2, c)
            if key in self.planner.cbfs:
                continue
            csize = 1 << clog2
            val = False
            for (kx, ky, kl, kc), v in list(self.planner.cbfs.items()):
                if kc == c and cx <= kx < cx + csize and cy <= ky < cy + csize:
                    val = val or v
            self.planner.cbfs[key] = val

    def _end_cu_qp(self, x0, y0, size):
        h4w = self._qp_scratch.shape
        x1 = min(x0 + size, self.sps.pic_width)
        y1 = min(y0 + size, self.sps.pic_height)
        self._qp_scratch[y0 >> 2:(y1 + 3) >> 2,
                         x0 >> 2:(x1 + 3) >> 2] = self.qp_plan.qp()
        self.qp_plan.end_cu()

    def _luma_qp_now(self):
        """Planning-side luma QP: the QG's intended delta applies tentatively
        before the first coded TU makes it official (mirrors decode order)."""
        qs = self.qp_plan
        if qs.enabled and not qs.delta_coded:
            intended = self.planner.qp_deltas.get(qs.qg_xy, 0)
            return (qs.pred + intended + 52) % 52
        return qs.qp()

    def _commit_qp_delta(self):
        qs = self.qp_plan
        if qs.enabled and not qs.delta_coded:
            qs.set_delta(self.planner.qp_deltas.get(qs.qg_xy, 0))

    def _plan_tu(self, x, y, log2, c_idx, mode, pred_src):
        size = 1 << log2
        plane, avail = self.rec[c_idx], self.avail[c_idx]
        orig = self.orig[c_idx][y:y + size, x:x + size]
        is_intra = pred_src is None
        if is_intra:
            pred = intra_predict_tu(plane, avail, x, y, size, mode, c_idx,
                                    self.sps.strong_intra_smoothing)
        else:
            cu_x, cu_y, planes_ = self._pred_cu
            ox = x - (cu_x >> (0 if c_idx == 0 else 1))
            oy = y - (cu_y >> (0 if c_idx == 0 else 1))
            pred = planes_[c_idx][oy:oy + size, ox:ox + size]
        resid = orig - pred
        luma_qp = self._luma_qp_now()
        qp = tu_qp(self.plan, c_idx, luma_qp)
        tskip = False
        bypass = getattr(self, "_cur_bypass", False)
        if bypass:
            levels = resid.astype(np.int32)  # lossless: levels ARE the residual
        elif (self.pps.transform_skip_enabled and log2 == 2
                and self.rng.random() < 0.2):
            tskip = True
            levels = quantize_transform_skip(resid, qp)
        else:
            is_dst = is_intra and c_idx == 0 and log2 == 2
            coeffs = forward_transform(resid, log2, is_dst)
            levels = quantize(coeffs, qp, log2)
        if self.pps.sign_data_hiding and levels.any() and not bypass:
            scan = residual_scan_idx(mode if is_intra else None, log2, c_idx)
            levels = apply_sign_data_hiding(levels, log2, scan)
        cbf = bool(levels.any())
        self.planner.cbfs[(x, y, log2, c_idx)] = cbf
        if cbf:
            self._commit_qp_delta()
            if bypass:
                res = levels
            else:
                sm = None
                if self.plan.scaling is not None and not tskip:
                    mid = ((0 if is_intra else 1) if log2 == 5
                           else 3 * (0 if is_intra else 1) + c_idx)
                    sm = self.plan.scaling[(log2, mid)]
                d = dequant(levels, qp, log2, sm)
                res = (transform_skip_residual(d) if tskip
                       else inverse_transform(
                           d, log2, is_intra and c_idx == 0 and log2 == 2))
            rec = np.clip(pred + res, 0, 255)
            self.plan.tus.append(TuRec(x, y, log2, c_idx, mode, levels, tskip,
                                       luma_qp, is_inter=not is_intra,
                                       tile=self.cur_tile, slice_idx=self.cur_slice,
                                       bypass=bypass))
        else:
            rec = pred
            self.plan.tus.append(TuRec(x, y, log2, c_idx, mode, None,
                                       qp=luma_qp, pred_only=True,
                                       is_inter=not is_intra,
                                       tile=self.cur_tile,
                                       slice_idx=self.cur_slice))
        plane[y:y + size, x:x + size] = rec
        avail[y >> 2:(y + size) >> 2, x >> 2:(x + size) >> 2] = True

    # -- serialization -------------------------------------------------------
    def _serialize(self, plan: FramePlan, sh: SliceHeader, poc, l0_pocs,
                   l1_pocs) -> bytes:
        sps, pps = self.sps, self.pps
        ctx = ContextModels(sh.init_type(), sh.slice_qp)
        mctx = None
        if sh.slice_type != SLICE_I:
            mctx = self._make_mctx(sh, poc, l0_pocs, l1_pocs)
        if len(self.slice_chunks) > 1:
            import copy
            out = b""
            iters = (iter(plan.tus), iter(plan.pus))
            dep = self.dependent_slices
            substreamed = (pps.tiles_enabled
                           or pps.entropy_coding_sync_enabled)
            carry = None
            wpp_carry = None
            for si, chunk in enumerate(self.slice_chunks):
                shs = copy.copy(sh)
                shs.first_slice_in_pic = si == 0
                shs.slice_segment_address = chunk[0]
                shs.dependent_slice_segment = dep and si > 0
                if not (dep and si > 0):
                    ctx.reinit(sh.init_type(), sh.slice_qp)
                kwargs = dict(planner=self.planner, mctx=mctx,
                              start_ctb=chunk[0],
                              slice_idx=0 if dep else si, iters=iters,
                              carry_avail=carry if dep and si > 0 else None,
                              wpp_carry=wpp_carry if dep and si > 0 else None)
                if substreamed:
                    provider = EncodeSubstreams(ctx)
                    coder = CtuCoder(None, sps, pps, shs, plan, is_enc=True,
                                     substreams=provider, **kwargs)
                    coder.code_slice_data(n_ctbs=len(chunk))
                    data, entry_sizes = provider.finalize()
                    shs.entry_point_offsets = entry_sizes
                    w = BitWriter()
                    write_slice_header(w, shs, sps, pps)
                    out += nal.make_nal(sh.nal_type, w.get_bytes() + data)
                else:
                    w = BitWriter()
                    write_slice_header(w, shs, sps, pps)
                    enc = CabacEncoder(w, ctx)
                    coder = CtuCoder(enc, sps, pps, shs, plan, is_enc=True,
                                     **kwargs)
                    coder.code_slice_data(n_ctbs=len(chunk))
                    w.rbsp_trailing_bits()
                    out += nal.make_nal(sh.nal_type, w.get_bytes())
                carry = coder.avail
                wpp_carry = coder.wpp_snapshots
            return out
        if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
            provider = EncodeSubstreams(ctx)
            coder = CtuCoder(None, sps, pps, sh, plan, is_enc=True,
                             planner=self.planner, mctx=mctx,
                             substreams=provider)
            coder.code_slice_data()
            data, entry_sizes = provider.finalize()
            sh.entry_point_offsets = entry_sizes
            w = BitWriter()
            write_slice_header(w, sh, sps, pps)
            return nal.make_nal(sh.nal_type, w.get_bytes() + data)
        w = BitWriter()
        write_slice_header(w, sh, sps, pps)
        enc = CabacEncoder(w, ctx)
        coder = CtuCoder(enc, sps, pps, sh, plan, is_enc=True,
                         planner=self.planner, mctx=mctx)
        coder.code_slice_data()
        w.rbsp_trailing_bits()
        return nal.make_nal(sh.nal_type, w.get_bytes())


# Backwards-compatible alias used by the intra tests/benches
class IntraEncoder(Encoder):
    def encode_frame(self, yuv):  # type: ignore[override]
        nb, plan, prefilter, _ = super().encode_frame(
            yuv, poc=0, slice_type=SLICE_I)
        w = BitWriter()
        write_vps(w)
        stream = nal.make_nal(nal.NAL_VPS, w.get_bytes())
        w = BitWriter()
        write_sps(w, self.sps)
        stream += nal.make_nal(nal.NAL_SPS, w.get_bytes())
        w = BitWriter()
        write_pps(w, self.pps)
        stream += nal.make_nal(nal.NAL_PPS, w.get_bytes())
        return stream + nb, plan, prefilter


def make_test_image(w: int, h: int, seed: int = 0) -> list[np.ndarray]:
    """Synthesizes a structured YUV 4:2:0 test frame (gradients + shapes + noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (xx * 255 // max(w - 1, 1) + yy * 128 // max(h - 1, 1)) // 2
    for _ in range(8):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        ww, hh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
        y[y0:y0 + hh, x0:x0 + ww] = int(rng.integers(0, 256))
    cy, cx, r = h // 2, w // 2, min(h, w) // 3
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    y[mask] = (y[mask] + 128) % 256
    y = np.clip(y + rng.integers(-8, 9, size=y.shape), 0, 255)
    cb = np.full((h >> 1, w >> 1), 128)
    cr = np.full((h >> 1, w >> 1), 128)
    cb = np.clip(cb + (xx[::2, ::2] * 64 // max(w - 1, 1)) - 32
                 + rng.integers(-4, 5, size=cb.shape), 0, 255)
    cr = np.clip(cr + (yy[::2, ::2] * 64 // max(h - 1, 1)) - 32
                 + rng.integers(-4, 5, size=cr.shape), 0, 255)
    return [y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32)]


def make_moving_sequence(w: int, h: int, n: int, seed: int = 0):
    """n-frame sequence with global pan + a moving square (P-frame fodder)."""
    rng = np.random.default_rng(seed)
    base = make_test_image(w + 64, h + 64, seed)
    frames = []
    for i in range(n):
        # wrap the pan inside the 64-px margin so long sequences (30+
        # frames, DPB stress tests) keep full-size frames
        dx, dy = (2 * i + (i % 2)) % 64, (3 * i) % 64
        y = base[0][dy:dy + h, dx:dx + w].copy()
        cb = base[1][dy >> 1:(dy >> 1) + (h >> 1), dx >> 1:(dx >> 1) + (w >> 1)].copy()
        cr = base[2][dy >> 1:(dy >> 1) + (h >> 1), dx >> 1:(dx >> 1) + (w >> 1)].copy()
        # moving square with changing content
        sx, sy = (7 * i) % max(w - 24, 1), (5 * i) % max(h - 24, 1)
        y[sy:sy + 24, sx:sx + 24] = (50 + 13 * i) % 256
        noise = rng.integers(-2, 3, size=y.shape)
        y = np.clip(y + noise, 0, 255)
        frames.append([y.astype(np.int32), cb, cr])
    return frames
