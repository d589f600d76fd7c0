"""Parameter sets: VPS/SPS/PPS parse (spec 7.3.2, 7.3.3, 7.3.7).

Main profile: chroma 4:2:0, 8-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from decode_bench.reference.hls.bitio import BitReader
from decode_bench.reference.tables import (DEFAULT_SCALING_4x4, DEFAULT_SCALING_8x8_INTER,
                             DEFAULT_SCALING_8x8_INTRA, diag_scan,
                             upsample_scaling)


# ---------------------------------------------------------------------------
# profile_tier_level (spec 7.3.3) - Main profile defaults
# ---------------------------------------------------------------------------


def parse_profile_tier_level(r: BitReader, max_sub_layers_minus1: int = 0) -> dict:
    out = {
        "profile_space": r.u(2),
        "tier_flag": r.u(1),
        "profile_idc": r.u(5),
        "compat_flags": r.u(32),
        "progressive": r.u(1),
        "interlaced": r.u(1),
        "non_packed": r.u(1),
        "frame_only": r.u(1),
    }
    r.u(32)
    r.u(12)
    out["level_idc"] = r.u(8)
    if max_sub_layers_minus1:
        present = [(r.u(1), r.u(1)) for _ in range(max_sub_layers_minus1)]
        if max_sub_layers_minus1 < 8:
            r.u(2 * (8 - max_sub_layers_minus1))
        for pp, lp in present:
            if pp:
                r.u(32), r.u(32), r.u(24)  # sub-layer PTL: 88 bits
            if lp:
                r.u(8)
    return out


# ---------------------------------------------------------------------------
# short-term reference picture set (spec 7.3.7 / 7.4.8)
# ---------------------------------------------------------------------------


@dataclass
class ShortTermRPS:
    # stored fully resolved (after inter-RPS prediction if any)
    delta_poc_s0: list[int] = field(default_factory=list)  # negative deltas (<0)
    used_s0: list[int] = field(default_factory=list)
    delta_poc_s1: list[int] = field(default_factory=list)  # positive deltas (>0)
    used_s1: list[int] = field(default_factory=list)

    @property
    def num_negative(self) -> int:
        return len(self.delta_poc_s0)

    @property
    def num_positive(self) -> int:
        return len(self.delta_poc_s1)

    @property
    def num_delta_pocs(self) -> int:
        return self.num_negative + self.num_positive


def parse_st_rps(r: BitReader, idx: int, prev_sets: list[ShortTermRPS],
                 num_sets: int) -> ShortTermRPS:
    """Parse one st_ref_pic_set, including inter-RPS prediction (7.4.8)."""
    inter_pred = r.u(1) if idx != 0 else 0
    rps = ShortTermRPS()
    if inter_pred:
        delta_idx_minus1 = r.ue() if idx == num_sets else 0
        ref = prev_sets[idx - 1 - delta_idx_minus1]
        delta_rps_sign = r.u(1)
        abs_delta_rps_minus1 = r.ue()
        delta_rps = (1 - 2 * delta_rps_sign) * (abs_delta_rps_minus1 + 1)
        n = ref.num_delta_pocs
        used_flags = []
        use_delta = []
        for j in range(n + 1):
            used = r.u(1)
            ud = 1
            if not used:
                ud = r.u(1)
            used_flags.append(used)
            use_delta.append(ud)
        # derive (spec 7.4.8 equations 7-47..7-50)
        ref_all = ([(d, u) for d, u in zip(ref.delta_poc_s0, ref.used_s0)]
                   + [(d, u) for d, u in zip(ref.delta_poc_s1, ref.used_s1)])
        s0, u0, s1, u1 = [], [], [], []
        # i = num_positive..1 of ref mapped first (spec order) for S0
        for j in range(ref.num_positive - 1, -1, -1):
            d_poc = ref.delta_poc_s1[j] + delta_rps
            k = ref.num_negative + j
            if d_poc < 0 and use_delta[k]:
                s0.append(d_poc)
                u0.append(used_flags[k])
        if delta_rps < 0 and use_delta[n]:
            s0.append(delta_rps)
            u0.append(used_flags[n])
        for j in range(ref.num_negative):
            d_poc = ref.delta_poc_s0[j] + delta_rps
            if d_poc < 0 and use_delta[j]:
                s0.append(d_poc)
                u0.append(used_flags[j])
        for j in range(ref.num_negative - 1, -1, -1):
            d_poc = ref.delta_poc_s0[j] + delta_rps
            if d_poc > 0 and use_delta[j]:
                s1.append(d_poc)
                u1.append(used_flags[j])
        if delta_rps > 0 and use_delta[n]:
            s1.append(delta_rps)
            u1.append(used_flags[n])
        for j in range(ref.num_positive):
            d_poc = ref.delta_poc_s1[j] + delta_rps
            if d_poc > 0 and use_delta[k := ref.num_negative + j]:
                s1.append(d_poc)
                u1.append(used_flags[k])
        rps.delta_poc_s0, rps.used_s0 = s0, u0
        rps.delta_poc_s1, rps.used_s1 = s1, u1
        return rps
    num_neg = r.ue()
    num_pos = r.ue()
    prev = 0
    for _ in range(num_neg):
        prev = prev - (r.ue() + 1)
        rps.delta_poc_s0.append(prev)
        rps.used_s0.append(r.u(1))
    prev = 0
    for _ in range(num_pos):
        prev = prev + r.ue() + 1
        rps.delta_poc_s1.append(prev)
        rps.used_s1.append(r.u(1))
    return rps


# ---------------------------------------------------------------------------
# scaling_list_data (spec 7.3.4, 7.4.5)
# ---------------------------------------------------------------------------


@dataclass
class ScalingListData:
    """Signaled scaling lists.  lists[(sizeId, matrixId)] = flat coef array in
    up-right diagonal scan order (length min(64, size*size)); dc[(2|3, mId)]
    for 16x16/32x32."""
    lists: dict = field(default_factory=dict)
    dc: dict = field(default_factory=dict)


def default_scaling_list(size_id: int, matrix_id: int) -> np.ndarray:
    """Default list coefficients in diagonal scan order (spec 7.4.5)."""
    if size_id == 0:
        m = DEFAULT_SCALING_4x4
        blk = 4
    else:
        m = (DEFAULT_SCALING_8x8_INTRA
             if (matrix_id < 3 if size_id < 3 else matrix_id == 0)
             else DEFAULT_SCALING_8x8_INTER)
        blk = 8
    scan = diag_scan(blk)
    return np.array([m[y, x] for (x, y) in scan], np.int32)


def parse_scaling_list_data(r: BitReader) -> ScalingListData:
    sld = ScalingListData()
    for size_id in range(4):
        n_mat = 2 if size_id == 3 else 6
        for matrix_id in range(n_mat):
            pred_mode = r.u(1)
            if not pred_mode:
                delta = r.ue()
                if delta == 0:
                    sld.lists[(size_id, matrix_id)] =                         default_scaling_list(size_id, matrix_id)
                    if size_id > 1:
                        sld.dc[(size_id, matrix_id)] = 16
                else:
                    ref = matrix_id - delta
                    sld.lists[(size_id, matrix_id)] =                         sld.lists[(size_id, ref)].copy()
                    if size_id > 1:
                        sld.dc[(size_id, matrix_id)] = sld.dc[(size_id, ref)]
            else:
                n = min(64, 1 << (4 + (size_id << 1)))
                next_coef = 8
                if size_id > 1:
                    dc = r.se() + 8
                    sld.dc[(size_id, matrix_id)] = dc
                    next_coef = dc
                coefs = np.empty(n, np.int32)
                for i in range(n):
                    next_coef = (next_coef + r.se() + 256) % 256
                    coefs[i] = next_coef
                sld.lists[(size_id, matrix_id)] = coefs
    return sld


def resolve_scaling_matrices(sld: ScalingListData | None):
    """-> dict (log2_size, matrix_id) -> [s, s] int32 dequant matrix m.

    sld None -> defaults for every entry (sps scaling_list_enabled, no data).
    16x16/32x32 expand the 8x8 coefficient list by 2x/4x repetition with the
    signaled DC at [0,0] (spec 7.4.5)."""
    out = {}
    for size_id in range(4):
        n_mat = 2 if size_id == 3 else 6
        log2 = size_id + 2
        blk = 4 if size_id == 0 else 8
        scan = diag_scan(blk)
        for matrix_id in range(n_mat):
            if sld is not None and (size_id, matrix_id) in sld.lists:
                coefs = sld.lists[(size_id, matrix_id)]
                dc = sld.dc.get((size_id, matrix_id), 16)
            else:
                coefs = default_scaling_list(size_id, matrix_id)
                dc = 16
            m = np.zeros((blk, blk), np.int32)
            for i, (x, y) in enumerate(scan):
                m[y, x] = coefs[i]
            if size_id >= 2:
                m = upsample_scaling(m, 1 << (size_id - 1), dc)
            out[(log2, matrix_id)] = m
    return out


# ---------------------------------------------------------------------------
# SPS (spec 7.3.2.2)
# ---------------------------------------------------------------------------


@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    chroma_format_idc: int = 1
    pic_width: int = 416
    pic_height: int = 240
    conf_win: tuple[int, int, int, int] = (0, 0, 0, 0)  # l, r, t, b
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: int = 5  # minus1 stored +1 here
    num_reorder_pics: int = 0
    log2_min_cb_size: int = 3
    log2_ctb_size: int = 6
    log2_min_tb_size: int = 2
    log2_max_tb_size: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: bool = False
    scaling_list_data: "ScalingListData | None" = None
    amp_enabled: bool = False
    sao_enabled: bool = True
    pcm_enabled: bool = False
    pcm_bit_depth: int = 8
    pcm_log2_min_size: int = 3
    pcm_log2_max_size: int = 3
    pcm_loop_filter_disabled: bool = False
    st_rps: list[ShortTermRPS] = field(default_factory=list)
    long_term_ref_pics_present: bool = False
    num_long_term_ref_pics: int = 0
    lt_ref_poc_lsb: list[int] = field(default_factory=list)
    lt_used_by_curr: list[int] = field(default_factory=list)
    temporal_mvp_enabled: bool = False
    strong_intra_smoothing: bool = True

    # derived
    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctb_size

    @property
    def pic_width_ctbs(self) -> int:
        return (self.pic_width + self.ctb_size - 1) >> self.log2_ctb_size

    @property
    def pic_height_ctbs(self) -> int:
        return (self.pic_height + self.ctb_size - 1) >> self.log2_ctb_size

    @property
    def num_ctbs(self) -> int:
        return self.pic_width_ctbs * self.pic_height_ctbs

    @property
    def max_poc_lsb(self) -> int:
        return 1 << self.log2_max_poc_lsb


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp)
    s = SPS()
    s.vps_id = r.u(4)
    max_sub_layers_minus1 = r.u(3)
    r.u(1)
    parse_profile_tier_level(r, max_sub_layers_minus1)
    s.sps_id = r.ue()
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        r.u(1)
    s.pic_width = r.ue()
    s.pic_height = r.ue()
    if r.u(1):
        s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    s.bit_depth = r.ue() + 8
    r.ue()  # chroma bit depth
    s.log2_max_poc_lsb = r.ue() + 4
    sub_layer_ordering = r.u(1)
    for i in range(0 if sub_layer_ordering else max_sub_layers_minus1,
                   max_sub_layers_minus1 + 1):
        s.max_dec_pic_buffering = r.ue() + 1
        s.num_reorder_pics = r.ue()
        r.ue()
    s.log2_min_cb_size = r.ue() + 3
    s.log2_ctb_size = s.log2_min_cb_size + r.ue()
    s.log2_min_tb_size = r.ue() + 2
    s.log2_max_tb_size = s.log2_min_tb_size + r.ue()
    s.max_transform_hierarchy_depth_inter = r.ue()
    s.max_transform_hierarchy_depth_intra = r.ue()
    s.scaling_list_enabled = bool(r.u(1))
    if s.scaling_list_enabled:
        if r.u(1):  # sps_scaling_list_data_present_flag
            s.scaling_list_data = parse_scaling_list_data(r)
    s.amp_enabled = bool(r.u(1))
    s.sao_enabled = bool(r.u(1))
    s.pcm_enabled = bool(r.u(1))
    if s.pcm_enabled:
        s.pcm_bit_depth = r.u(4) + 1
        r.u(4)
        s.pcm_log2_min_size = r.ue() + 3
        s.pcm_log2_max_size = s.pcm_log2_min_size + r.ue()
        s.pcm_loop_filter_disabled = bool(r.u(1))
    num_sets = r.ue()
    s.st_rps = []
    for i in range(num_sets):
        s.st_rps.append(parse_st_rps(r, i, s.st_rps, num_sets))
    s.long_term_ref_pics_present = bool(r.u(1))
    if s.long_term_ref_pics_present:
        s.num_long_term_ref_pics = r.ue()
        for _ in range(s.num_long_term_ref_pics):
            s.lt_ref_poc_lsb.append(r.u(s.log2_max_poc_lsb))
            s.lt_used_by_curr.append(r.u(1))
    s.temporal_mvp_enabled = bool(r.u(1))
    s.strong_intra_smoothing = bool(r.u(1))
    # vui / extensions ignored
    return s


# ---------------------------------------------------------------------------
# PPS (spec 7.3.2.3)
# ---------------------------------------------------------------------------


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: bool = False
    output_flag_present: bool = False
    num_extra_slice_header_bits: int = 0
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip_enabled: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass_enabled: bool = False
    tiles_enabled: bool = False
    entropy_coding_sync_enabled: bool = False  # WPP
    num_tile_columns: int = 1
    num_tile_rows: int = 1
    uniform_spacing: bool = True
    tile_column_widths: list[int] = field(default_factory=list)  # in CTBs
    tile_row_heights: list[int] = field(default_factory=list)
    loop_filter_across_tiles: bool = True
    loop_filter_across_slices: bool = True
    deblocking_filter_control_present: bool = False
    deblocking_filter_override_enabled: bool = False
    deblocking_filter_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    scaling_list_data: "ScalingListData | None" = None
    lists_modification_present: bool = False
    log2_parallel_merge_level: int = 2
    slice_segment_header_extension_present: bool = False


def parse_pps(rbsp: bytes) -> PPS:
    r = BitReader(rbsp)
    p = PPS()
    p.pps_id = r.ue()
    p.sps_id = r.ue()
    p.dependent_slice_segments_enabled = bool(r.u(1))
    p.output_flag_present = bool(r.u(1))
    p.num_extra_slice_header_bits = r.u(3)
    p.sign_data_hiding = bool(r.u(1))
    p.cabac_init_present = bool(r.u(1))
    p.num_ref_idx_l0_default = r.ue() + 1
    p.num_ref_idx_l1_default = r.ue() + 1
    p.init_qp = 26 + r.se()
    p.constrained_intra_pred = bool(r.u(1))
    p.transform_skip_enabled = bool(r.u(1))
    p.cu_qp_delta_enabled = bool(r.u(1))
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets_present = bool(r.u(1))
    p.weighted_pred = bool(r.u(1))
    p.weighted_bipred = bool(r.u(1))
    p.transquant_bypass_enabled = bool(r.u(1))
    p.tiles_enabled = bool(r.u(1))
    p.entropy_coding_sync_enabled = bool(r.u(1))
    if p.tiles_enabled:
        p.num_tile_columns = r.ue() + 1
        p.num_tile_rows = r.ue() + 1
        p.uniform_spacing = bool(r.u(1))
        if not p.uniform_spacing:
            p.tile_column_widths = [r.ue() + 1 for _ in range(p.num_tile_columns - 1)]
            p.tile_row_heights = [r.ue() + 1 for _ in range(p.num_tile_rows - 1)]
        p.loop_filter_across_tiles = bool(r.u(1))
    p.loop_filter_across_slices = bool(r.u(1))
    p.deblocking_filter_control_present = bool(r.u(1))
    if p.deblocking_filter_control_present:
        p.deblocking_filter_override_enabled = bool(r.u(1))
        p.deblocking_filter_disabled = bool(r.u(1))
        if not p.deblocking_filter_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    if r.u(1):  # pps_scaling_list_data_present_flag
        p.scaling_list_data = parse_scaling_list_data(r)
    p.lists_modification_present = bool(r.u(1))
    p.log2_parallel_merge_level = r.ue() + 2
    p.slice_segment_header_extension_present = bool(r.u(1))
    return p


# ---------------------------------------------------------------------------
# VPS: minimal legal instance (decoder ignores its content)
# ---------------------------------------------------------------------------


