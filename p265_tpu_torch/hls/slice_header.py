"""Slice segment header parse + write (spec 7.3.6.1)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from p265_tpu_torch.hls import nal
from p265_tpu_torch.hls.bitio import BitReader, BitWriter
from p265_tpu_torch.hls.params import PPS, SPS, ShortTermRPS, parse_st_rps, write_st_rps

SLICE_B = 0
SLICE_P = 1
SLICE_I = 2


@dataclass
class WeightTable:
    """Explicit weighted prediction parameters (spec 7.3.6.3, 7.4.7.3)."""
    luma_log2_denom: int = 6
    chroma_log2_denom: int = 6
    # per list, per ref idx: (luma_w, luma_o, cb_w, cb_o, cr_w, cr_o)
    entries: list = field(default_factory=lambda: [[], []])

    def get(self, lx: int, ridx: int):
        ents = self.entries[lx]
        if ridx < len(ents):
            return ents[ridx]
        return (1 << self.luma_log2_denom, 0,
                1 << self.chroma_log2_denom, 0,
                1 << self.chroma_log2_denom, 0)


def write_pred_weight_table(w: BitWriter, wt: WeightTable, h: "SliceHeader") -> None:
    w.ue(wt.luma_log2_denom)
    w.se(wt.chroma_log2_denom - wt.luma_log2_denom)
    n_lists = 2 if h.slice_type == SLICE_B else 1
    for lx in range(n_lists):
        n_ref = h.num_ref_idx_l0_active if lx == 0 else h.num_ref_idx_l1_active
        ents = [wt.get(lx, i) for i in range(n_ref)]
        ld = 1 << wt.luma_log2_denom
        cd = 1 << wt.chroma_log2_denom
        lflags = [int(e[0] != ld or e[1] != 0) for e in ents]
        cflags = [int(e[2] != cd or e[3] != 0 or e[4] != cd or e[5] != 0)
                  for e in ents]
        for f in lflags:
            w.u(f, 1)
        for f in cflags:
            w.u(f, 1)
        for e, lf, cf in zip(ents, lflags, cflags):
            if lf:
                w.se(e[0] - ld)
                w.se(e[1])
            if cf:
                for (cw, co) in ((e[2], e[3]), (e[4], e[5])):
                    w.se(cw - cd)
                    # invert eq 7-34: delta = o + ((128*w)>>denom) - 128
                    w.se(co + ((128 * cw) >> wt.chroma_log2_denom) - 128)


def parse_pred_weight_table(r: BitReader, h: "SliceHeader") -> WeightTable:
    wt = WeightTable()
    wt.luma_log2_denom = r.ue()
    wt.chroma_log2_denom = wt.luma_log2_denom + r.se()
    n_lists = 2 if h.slice_type == SLICE_B else 1
    for lx in range(n_lists):
        n_ref = h.num_ref_idx_l0_active if lx == 0 else h.num_ref_idx_l1_active
        lflags = [r.u(1) for _ in range(n_ref)]
        cflags = [r.u(1) for _ in range(n_ref)]
        ld = 1 << wt.luma_log2_denom
        cd = 1 << wt.chroma_log2_denom
        for i in range(n_ref):
            lw, lo = ld, 0
            cbw, cbo, crw, cro = cd, 0, cd, 0
            if lflags[i]:
                lw = ld + r.se()
                lo = r.se()
            if cflags[i]:
                cbw = cd + r.se()
                d = r.se()
                cbo = max(-128, min(127, d - ((128 * cbw)
                                              >> wt.chroma_log2_denom) + 128))
                crw = cd + r.se()
                d = r.se()
                cro = max(-128, min(127, d - ((128 * crw)
                                              >> wt.chroma_log2_denom) + 128))
            wt.entries[lx].append((lw, lo, cbw, cbo, crw, cro))
    return wt


@dataclass
class SliceHeader:
    nal_type: int = nal.NAL_IDR_W_RADL
    first_slice_in_pic: bool = True
    no_output_of_prior_pics: bool = False
    pps_id: int = 0
    dependent_slice_segment: bool = False
    slice_segment_address: int = 0
    slice_type: int = SLICE_I
    pic_output_flag: bool = True
    pic_order_cnt_lsb: int = 0
    # RPS selection
    st_rps_sps_flag: bool = True
    st_rps_idx: int = 0
    st_rps_explicit: ShortTermRPS | None = None
    # long-term refs (slice-signaled): list of dicts
    # {poc_lsb, used, msb_present, msb_cycle(accumulated)}
    lt_entries: list = field(default_factory=list)
    num_long_term_pics: int = 0
    temporal_mvp_enabled: bool = False
    sao_luma: bool = True
    sao_chroma: bool = True
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    # ref_pic_list_modification (spec 7.3.6.2): list_entry indices into
    # RefPicListTemp, or None when the flag is 0
    ref_pic_list_modification_l0: list[int] | None = None
    ref_pic_list_modification_l1: list[int] | None = None
    num_pic_total_curr: int = 0  # derived at parse/write for entry bit width
    mvd_l1_zero: bool = False
    cabac_init_flag: bool = False
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    five_minus_max_num_merge_cand: int = 0
    pred_weights: "WeightTable | None" = None
    slice_qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    deblocking_filter_override: bool = False
    deblocking_filter_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: bool = True
    entry_point_offsets: list[int] = field(default_factory=list)

    @property
    def max_num_merge_cand(self) -> int:
        return 5 - self.five_minus_max_num_merge_cand

    def is_irap(self) -> bool:
        return nal.is_irap(self.nal_type)

    def is_idr(self) -> bool:
        return nal.is_idr(self.nal_type)

    def init_type(self) -> int:
        """CABAC initType (spec 9.3.2.2): I->0, P->1/2, B->2/1 by cabac_init_flag."""
        if self.slice_type == SLICE_I:
            return 0
        if self.slice_type == SLICE_P:
            return 2 if self.cabac_init_flag else 1
        return 1 if self.cabac_init_flag else 2


def _addr_bits(sps: SPS) -> int:
    return max(1, math.ceil(math.log2(max(2, sps.num_ctbs))))


def write_slice_header(w: BitWriter, h: SliceHeader, sps: SPS, pps: PPS) -> None:
    w.u(int(h.first_slice_in_pic), 1)
    if nal.is_irap(h.nal_type):
        w.u(int(h.no_output_of_prior_pics), 1)
    w.ue(h.pps_id)
    if not h.first_slice_in_pic:
        if pps.dependent_slice_segments_enabled:
            w.u(int(h.dependent_slice_segment), 1)
        w.u(h.slice_segment_address, _addr_bits(sps))
    if not h.dependent_slice_segment:
        for _ in range(pps.num_extra_slice_header_bits):
            w.u(0, 1)
        w.ue(h.slice_type)
        if pps.output_flag_present:
            w.u(int(h.pic_output_flag), 1)
        if not nal.is_idr(h.nal_type):
            w.u(h.pic_order_cnt_lsb, sps.log2_max_poc_lsb)
            if h.st_rps_explicit is not None:
                w.u(0, 1)
                write_st_rps(w, h.st_rps_explicit, len(sps.st_rps))
            else:
                w.u(1, 1)
                if len(sps.st_rps) > 1:
                    w.u(h.st_rps_idx, max(1, math.ceil(math.log2(len(sps.st_rps)))))
            if sps.long_term_ref_pics_present:
                # SPS-referenced entries (lt_idx_sps) must precede
                # slice-signaled ones (spec 7.3.6.1 loop order)
                sps_ents = [e for e in h.lt_entries if "sps_idx" in e]
                pic_ents = [e for e in h.lt_entries if "sps_idx" not in e]
                if sps.num_long_term_ref_pics > 0:
                    w.ue(len(sps_ents))
                else:
                    assert not sps_ents, "lt_idx_sps without SPS candidates"
                w.ue(len(pic_ents))
                num_lt_sps = len(sps_ents)
                prev_cycle = 0
                for i, e in enumerate(sps_ents + pic_ents):
                    if i < num_lt_sps:
                        assert (sps.lt_ref_poc_lsb[e["sps_idx"]]
                                == e["poc_lsb"])
                        if sps.num_long_term_ref_pics > 1:
                            w.u(e["sps_idx"], math.ceil(
                                math.log2(sps.num_long_term_ref_pics)))
                    else:
                        w.u(e["poc_lsb"], sps.log2_max_poc_lsb)
                        w.u(int(e["used"]), 1)
                    w.u(int(e["msb_present"]), 1)
                    if e["msb_present"]:
                        # DeltaPocMsbCycleLt accumulation resets at i == 0
                        # and i == num_long_term_sps (spec 7.4.7.1)
                        base = prev_cycle if i not in (0, num_lt_sps) else 0
                        w.ue(e["msb_cycle"] - base)
                        prev_cycle = e["msb_cycle"]
            if sps.temporal_mvp_enabled:
                w.u(int(h.temporal_mvp_enabled), 1)
        if sps.sao_enabled:
            w.u(int(h.sao_luma), 1)
            w.u(int(h.sao_chroma), 1)
        if h.slice_type in (SLICE_P, SLICE_B):
            default = (pps.num_ref_idx_l0_default, pps.num_ref_idx_l1_default)
            override = (h.num_ref_idx_l0_active != default[0]
                        or (h.slice_type == SLICE_B
                            and h.num_ref_idx_l1_active != default[1]))
            w.u(int(override), 1)
            if override:
                w.ue(h.num_ref_idx_l0_active - 1)
                if h.slice_type == SLICE_B:
                    w.ue(h.num_ref_idx_l1_active - 1)
            npc = h.num_pic_total_curr
            if pps.lists_modification_present and npc > 1:
                bits = max(1, math.ceil(math.log2(npc)))
                for lx, mod, n_ref in ((0, h.ref_pic_list_modification_l0,
                                        h.num_ref_idx_l0_active),
                                       (1, h.ref_pic_list_modification_l1,
                                        h.num_ref_idx_l1_active)):
                    if lx == 1 and h.slice_type != SLICE_B:
                        break
                    w.u(int(mod is not None), 1)
                    if mod is not None:
                        assert len(mod) == n_ref
                        for e in mod:
                            w.u(e, bits)
            if h.slice_type == SLICE_B:
                w.u(int(h.mvd_l1_zero), 1)
            if pps.cabac_init_present:
                w.u(int(h.cabac_init_flag), 1)
            if h.temporal_mvp_enabled:
                if h.slice_type == SLICE_B:
                    w.u(int(h.collocated_from_l0), 1)
                nref = (h.num_ref_idx_l0_active if h.collocated_from_l0
                        else h.num_ref_idx_l1_active)
                if nref > 1:
                    w.ue(h.collocated_ref_idx)
            if ((pps.weighted_pred and h.slice_type == SLICE_P)
                    or (pps.weighted_bipred and h.slice_type == SLICE_B)):
                write_pred_weight_table(w, h.pred_weights or WeightTable(), h)
            w.ue(h.five_minus_max_num_merge_cand)
        w.se(h.slice_qp - 26 - (pps.init_qp - 26))
        if pps.slice_chroma_qp_offsets_present:
            w.se(h.cb_qp_offset)
            w.se(h.cr_qp_offset)
        if pps.deblocking_filter_control_present:
            if pps.deblocking_filter_override_enabled:
                w.u(int(h.deblocking_filter_override), 1)
            if h.deblocking_filter_override:
                w.u(int(h.deblocking_filter_disabled), 1)
                if not h.deblocking_filter_disabled:
                    w.se(h.beta_offset_div2)
                    w.se(h.tc_offset_div2)
        # effective deblock-disabled state (inherited from PPS unless overridden)
        eff_disabled = (h.deblocking_filter_disabled if h.deblocking_filter_override
                        else pps.deblocking_filter_disabled)
        if (pps.loop_filter_across_slices
                and (h.sao_luma or h.sao_chroma or not eff_disabled)):
            w.u(int(h.loop_filter_across_slices), 1)
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        w.ue(len(h.entry_point_offsets))
        if h.entry_point_offsets:
            offset_len = max(1, max(o.bit_length() for o in h.entry_point_offsets))
            w.ue(offset_len - 1)
            for o in h.entry_point_offsets:
                w.u(o - 1, offset_len)
    w.align_one_then_zero()  # byte_alignment()


def parse_slice_header(rbsp: bytes, nal_type: int, sps_map: dict[int, SPS],
                       pps_map: dict[int, PPS]) -> tuple[SliceHeader, SPS, PPS, int]:
    """Returns (header, sps, pps, byte offset of slice data in rbsp)."""
    r = BitReader(rbsp)
    h = SliceHeader(nal_type=nal_type)
    h.first_slice_in_pic = bool(r.u(1))
    if nal.is_irap(nal_type):
        h.no_output_of_prior_pics = bool(r.u(1))
    h.pps_id = r.ue()
    pps = pps_map[h.pps_id]
    sps = sps_map[pps.sps_id]
    h.dependent_slice_segment = False
    if not h.first_slice_in_pic:
        if pps.dependent_slice_segments_enabled:
            h.dependent_slice_segment = bool(r.u(1))
        h.slice_segment_address = r.u(_addr_bits(sps))
    if not h.dependent_slice_segment:
        for _ in range(pps.num_extra_slice_header_bits):
            r.u(1)
        h.slice_type = r.ue()
        if pps.output_flag_present:
            h.pic_output_flag = bool(r.u(1))
        if not nal.is_idr(nal_type):
            h.pic_order_cnt_lsb = r.u(sps.log2_max_poc_lsb)
            h.st_rps_sps_flag = bool(r.u(1))
            if not h.st_rps_sps_flag:
                h.st_rps_explicit = parse_st_rps(
                    r, len(sps.st_rps), sps.st_rps, len(sps.st_rps))
            elif len(sps.st_rps) > 1:
                h.st_rps_idx = r.u(max(1, math.ceil(math.log2(len(sps.st_rps)))))
            if sps.long_term_ref_pics_present:
                num_lt_sps = 0
                if sps.num_long_term_ref_pics > 0:
                    num_lt_sps = r.ue()
                h.num_long_term_pics = r.ue()
                prev_cycle = 0
                for i in range(num_lt_sps + h.num_long_term_pics):
                    if i < num_lt_sps:
                        idx = 0
                        if sps.num_long_term_ref_pics > 1:
                            idx = r.u(math.ceil(
                                math.log2(sps.num_long_term_ref_pics)))
                        e = {"poc_lsb": sps.lt_ref_poc_lsb[idx],
                             "used": bool(sps.lt_used_by_curr[idx]),
                             "msb_present": False, "msb_cycle": 0,
                             "sps_idx": idx}
                    else:
                        e = {"poc_lsb": r.u(sps.log2_max_poc_lsb),
                             "used": bool(r.u(1)), "msb_present": False,
                             "msb_cycle": 0}
                    e["msb_present"] = bool(r.u(1))
                    if e["msb_present"]:
                        # accumulation resets at i == 0 and
                        # i == num_long_term_sps (spec 7.4.7.1)
                        base = prev_cycle if i not in (0, num_lt_sps) else 0
                        cyc = r.ue() + base
                        e["msb_cycle"] = cyc
                        prev_cycle = cyc
                    h.lt_entries.append(e)
            if sps.temporal_mvp_enabled:
                h.temporal_mvp_enabled = bool(r.u(1))
        else:
            h.pic_order_cnt_lsb = 0
        if sps.sao_enabled:
            h.sao_luma = bool(r.u(1))
            h.sao_chroma = bool(r.u(1))
        else:
            h.sao_luma = h.sao_chroma = False
        rps_cur = (h.st_rps_explicit if h.st_rps_explicit is not None
                   else (sps.st_rps[h.st_rps_idx] if sps.st_rps else None))
        if rps_cur is not None:
            h.num_pic_total_curr = (sum(rps_cur.used_s0)
                                    + sum(rps_cur.used_s1)
                                    + sum(1 for e in h.lt_entries if e["used"]))
        h.num_ref_idx_l0_active = pps.num_ref_idx_l0_default
        h.num_ref_idx_l1_active = pps.num_ref_idx_l1_default
        if h.slice_type in (SLICE_P, SLICE_B):
            if r.u(1):  # num_ref_idx_active_override_flag
                h.num_ref_idx_l0_active = r.ue() + 1
                if h.slice_type == SLICE_B:
                    h.num_ref_idx_l1_active = r.ue() + 1
            npc = h.num_pic_total_curr
            if pps.lists_modification_present and npc > 1:
                bits = max(1, math.ceil(math.log2(npc)))
                if r.u(1):
                    h.ref_pic_list_modification_l0 = [
                        r.u(bits) for _ in range(h.num_ref_idx_l0_active)]
                if h.slice_type == SLICE_B and r.u(1):
                    h.ref_pic_list_modification_l1 = [
                        r.u(bits) for _ in range(h.num_ref_idx_l1_active)]
            if h.slice_type == SLICE_B:
                h.mvd_l1_zero = bool(r.u(1))
            if pps.cabac_init_present:
                h.cabac_init_flag = bool(r.u(1))
            if h.temporal_mvp_enabled:
                if h.slice_type == SLICE_B:
                    h.collocated_from_l0 = bool(r.u(1))
                nref = (h.num_ref_idx_l0_active if h.collocated_from_l0
                        else h.num_ref_idx_l1_active)
                if nref > 1:
                    h.collocated_ref_idx = r.ue()
            if ((pps.weighted_pred and h.slice_type == SLICE_P)
                    or (pps.weighted_bipred and h.slice_type == SLICE_B)):
                h.pred_weights = parse_pred_weight_table(r, h)
            h.five_minus_max_num_merge_cand = r.ue()
        h.slice_qp = 26 + (pps.init_qp - 26) + r.se()
        if pps.slice_chroma_qp_offsets_present:
            h.cb_qp_offset = r.se()
            h.cr_qp_offset = r.se()
        h.deblocking_filter_disabled = pps.deblocking_filter_disabled
        h.beta_offset_div2 = pps.beta_offset_div2
        h.tc_offset_div2 = pps.tc_offset_div2
        if pps.deblocking_filter_control_present:
            if pps.deblocking_filter_override_enabled:
                h.deblocking_filter_override = bool(r.u(1))
            if h.deblocking_filter_override:
                h.deblocking_filter_disabled = bool(r.u(1))
                if not h.deblocking_filter_disabled:
                    h.beta_offset_div2 = r.se()
                    h.tc_offset_div2 = r.se()
        h.loop_filter_across_slices = pps.loop_filter_across_slices
        if (pps.loop_filter_across_slices
                and (h.sao_luma or h.sao_chroma
                     or not h.deblocking_filter_disabled)):
            h.loop_filter_across_slices = bool(r.u(1))
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        n = r.ue()
        if n:
            offset_len = r.ue() + 1
            h.entry_point_offsets = [r.u(offset_len) + 1 for _ in range(n)]
    # byte_alignment()
    assert r.u(1) == 1, "alignment_bit_equal_to_one missing"
    r.align()
    return h, sps, pps, r.byte_pos()
