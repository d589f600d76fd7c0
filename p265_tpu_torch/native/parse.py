"""Native Stage-A slice parsing: ctypes bindings for ctu.c's per-CTU parser
plus vectorized tensor-plan assembly.

Per picture, a NativeParseState owns the output buffers (size-bucketed TU
record arrays, SAO records, motion-syntax events, wavefront state); CtuCoder
calls parse_ctu once per CTU (segment/WPP/tile orchestration stays in
Python, where it is cheap).  build_tensor_plan() consumes the buckets
directly -- no per-TU Python objects anywhere on this path.

Supported natively: I, P and B slices without PCM (syntax/ctu.py remains
the reference and the fallback; tests assert the two parsers agree
bit-exactly on the decoded YUV).  For inter slices the C parser records
per-PU SYNTAX only (merge idx / mvd / ref idx / mvp flags): candidate
derivation never affects the bitstream, so replay_motion() re-runs
golden/mv.py's merge/AMVP derivation over the event stream afterwards,
reproducing the parse-time availability neighborhood with a replay grid.
"""
from __future__ import annotations

import ctypes

import numpy as np

from p265_tpu_torch.tables import (CHROMA_QP_TABLE, CTX_OFFSET,
                             INTRA_HOR_VER_DIST_THRES)
from p265_tpu_torch.native import _Cabac, _load


class _NCtx(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "split_cu_flag", "cu_transquant_bypass_flag", "cu_skip_flag",
        "merge_flag", "merge_idx", "part_mode", "pred_mode_flag",
        "prev_intra_luma_pred_flag", "intra_chroma_pred_mode",
        "inter_pred_idc", "abs_mvd_greater_flag", "ref_idx", "mvp_flag",
        "cu_qp_delta_abs", "cbf_luma", "cbf_chroma", "rqt_root_cbf",
        "sao_merge_flag", "sao_type_idx", "split_transform_flag",
        "transform_skip_flag", "last_x", "last_y", "csbf", "sig", "gt1",
        "gt2")]


class _NParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "pic_width", "pic_height", "log2_ctb", "log2_min_cb", "log2_min_tb",
        "log2_max_tb", "max_tt_depth_intra", "w4", "h4", "wc",
        "transform_skip_enabled", "sign_data_hiding", "cu_qp_delta_enabled",
        "min_qg_log2", "transquant_bypass_enabled", "strong_intra_smoothing",
        "scaling_enabled", "slice_qp", "slice_idx", "slice_type",
        "sao_luma", "sao_chroma",
        "max_merge_cand", "num_ref_l0", "num_ref_l1", "mvd_l1_zero",
        "amp_enabled", "max_tt_depth_inter")]


_I32P = ctypes.POINTER(ctypes.c_int32)
_I16P = ctypes.POINTER(ctypes.c_int16)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class _NMaps(ctypes.Structure):
    _fields_ = [
        ("mode_map", _I32P), ("depth_map", _I32P), ("qp_map", _I32P),
        ("intra_map", _I32P), ("cbf_map", _I32P), ("edge_flags", _I32P),
        ("skip_map", _I32P), ("bypass_map", _I32P), ("avail", _U8P),
        ("tile_map4", _I32P), ("slice_of_ctb", _I32P)]


class _NQp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "last_cu_qp", "pred", "delta", "delta_coded", "qg_x", "qg_y")]


class _NBucket(ctypes.Structure):
    _fields_ = [
        ("meta", _I32P), ("coeffs", _I16P), ("ref_ys", _I16P),
        ("ref_xs", _I16P), ("ref_ok", _U8P), ("ok_scan", _U8P),
        ("count", ctypes.c_int32), ("cap", ctypes.c_int32)]


EV_W = 20
EV_CU, EV_PU = 0, 1
PART_NAMES = ("2Nx2N", "2NxN", "Nx2N", "NxN", "2NxnU", "2NxnD",
              "nLx2N", "nRx2N")


class _NEv(ctypes.Structure):
    _fields_ = [("ev", _I32P), ("count", ctypes.c_int32),
                ("cap", ctypes.c_int32)]


class _NPlane(ctypes.Structure):
    _fields_ = [
        ("tavail", _U8P), ("tstep", _I32P),
        ("pw", ctypes.c_int32), ("ph", ctypes.c_int32),
        ("pw4", ctypes.c_int32), ("ph4", ctypes.c_int32),
        ("last_tile", ctypes.c_int32), ("last_slice", ctypes.c_int32),
        ("n_steps", ctypes.c_int32)]


_NCTX = None


def _nctx():
    global _NCTX
    if _NCTX is None:
        _NCTX = _NCtx(
            split_cu_flag=CTX_OFFSET["split_cu_flag"],
            cu_transquant_bypass_flag=CTX_OFFSET["cu_transquant_bypass_flag"],
            cu_skip_flag=CTX_OFFSET["cu_skip_flag"],
            merge_flag=CTX_OFFSET["merge_flag"],
            merge_idx=CTX_OFFSET["merge_idx"],
            part_mode=CTX_OFFSET["part_mode"],
            pred_mode_flag=CTX_OFFSET["pred_mode_flag"],
            prev_intra_luma_pred_flag=CTX_OFFSET["prev_intra_luma_pred_flag"],
            intra_chroma_pred_mode=CTX_OFFSET["intra_chroma_pred_mode"],
            inter_pred_idc=CTX_OFFSET["inter_pred_idc"],
            abs_mvd_greater_flag=CTX_OFFSET["abs_mvd_greater_flag"],
            ref_idx=CTX_OFFSET["ref_idx"],
            mvp_flag=CTX_OFFSET["mvp_flag"],
            cu_qp_delta_abs=CTX_OFFSET["cu_qp_delta_abs"],
            cbf_luma=CTX_OFFSET["cbf_luma"],
            cbf_chroma=CTX_OFFSET["cbf_chroma"],
            rqt_root_cbf=CTX_OFFSET["rqt_root_cbf"],
            sao_merge_flag=CTX_OFFSET["sao_merge_flag"],
            sao_type_idx=CTX_OFFSET["sao_type_idx"],
            split_transform_flag=CTX_OFFSET["split_transform_flag"],
            transform_skip_flag=CTX_OFFSET["transform_skip_flag"],
            last_x=CTX_OFFSET["last_sig_coeff_x_prefix"],
            last_y=CTX_OFFSET["last_sig_coeff_y_prefix"],
            csbf=CTX_OFFSET["coded_sub_block_flag"],
            sig=CTX_OFFSET["sig_coeff_flag"],
            gt1=CTX_OFFSET["coeff_abs_level_greater1_flag"],
            gt2=CTX_OFFSET["coeff_abs_level_greater2_flag"])
    return _NCTX


_ctu_lib = None


def _ctu_load():
    global _ctu_lib
    if _ctu_lib is not None:
        return _ctu_lib
    lib = _load()
    if lib is None or not hasattr(lib, "ctu_parse"):
        return None
    lib.ctu_parse.argtypes = [
        ctypes.POINTER(_Cabac), ctypes.POINTER(_NParams),
        ctypes.POINTER(_NMaps), ctypes.POINTER(_NQp),
        ctypes.POINTER(_NBucket), ctypes.POINTER(_NPlane), _I32P,
        ctypes.POINTER(_NEv),
        ctypes.POINTER(_NCtx), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ctu_parse.restype = ctypes.c_int
    _ctu_lib = lib
    return lib


def native_parse_available() -> bool:
    return _ctu_load() is not None


def supports(sps, pps, sh) -> bool:
    """Can this slice be parsed natively?  (any slice type; PCM falls back
    to the Python parser -- it restarts the entropy engine mid-CTU.)"""
    return not sps.pcm_enabled and native_parse_available()


def _ptr(a, ct):
    return a.ctypes.data_as(ct)


LOG2_SIZES = (2, 3, 4, 5)


class NativeParseState:
    """Per-picture native parse output: bucketed TU records + SAO + planes.

    shared_sao: lane mode -- write SAO records into the given picture-wide
    array (disjoint per-CTB rows) instead of allocating one.  Tile lanes
    (one per tile substream, parsed on worker threads) use this together
    with absorb(): buckets/planes/QP state are lane-private, while the
    per-4x4 maps, availability grid, slice_of_ctb and SAO array are shared
    picture state written to disjoint tile regions."""

    def __init__(self, sps, pps, shared_sao=None, region=None,
                 shared_planes=None):
        """shared_planes: WPP-row lane mode -- alias another state's
        tavail/tstep wavefront grids instead of allocating private ones.
        Tile lanes keep PRIVATE grids (tiles are prediction-independent);
        WPP rows share them because a row's intra TUs reference the row
        above, and the 2-CTU skew makes every cross-row read
        happen-after its write (spec 9.3.1 -- the skew exists precisely
        to cover the above-right reference reach)."""
        self.sps, self.pps = sps, pps
        h, w = sps.pic_height, sps.pic_width
        # region: (w, h) record-capacity bound for a tile lane -- lane
        # buckets/events only need the tile's worth of records (a full-pic
        # lane allocation costs ~35 MB x n_tiles per picture otherwise)
        rw, rh = region if region is not None else (w, h)
        shapes = [(h, w), (h >> 1, w >> 1), (h >> 1, w >> 1)]
        self.shapes = shapes
        self.buckets = {}           # (p_idx, log2) -> dict of numpy arrays
        self._bk = (_NBucket * 12)()
        for p in range(3):
            ph, pw = shapes[p]
            cw, ch = (rw, rh) if p == 0 else (rw >> 1, rh >> 1)
            for log2 in LOG2_SIZES:
                s = 1 << log2
                cap = max(((cw + s - 1) // s) * ((ch + s - 1) // s), 1)
                nref2 = 2 * (2 * s + 1)
                n41 = 4 * s + 1
                d = dict(
                    meta=np.zeros((cap, 8), np.int32),
                    coeffs=np.zeros((cap, s * s), np.int16),
                    ref_ys=np.zeros((cap, nref2), np.int16),
                    ref_xs=np.zeros((cap, nref2), np.int16),
                    ref_ok=np.zeros((cap, nref2), np.uint8),
                    ok_scan=np.zeros((cap, n41), np.uint8),
                )
                self.buckets[(p, log2)] = d
                b = self._bk[p * 4 + (log2 - 2)]
                b.meta = _ptr(d["meta"], _I32P)
                b.coeffs = _ptr(d["coeffs"], _I16P)
                b.ref_ys = _ptr(d["ref_ys"], _I16P)
                b.ref_xs = _ptr(d["ref_xs"], _I16P)
                b.ref_ok = _ptr(d["ref_ok"], _U8P)
                b.ok_scan = _ptr(d["ok_scan"], _U8P)
                b.count = 0
                b.cap = cap
        self._pl = (_NPlane * 3)()
        self._pl_bufs = []
        for p in range(3):
            ph, pw = shapes[p]
            ph4, pw4 = (ph + 3) >> 2, (pw + 3) >> 2
            if shared_planes is not None:
                tavail, tstep = shared_planes._pl_bufs[p]
            else:
                tavail = np.zeros(ph4 * pw4, np.uint8)
                tstep = np.zeros(ph4 * pw4, np.int32)
            self._pl_bufs.append((tavail, tstep))
            pl = self._pl[p]
            pl.tavail = _ptr(tavail, _U8P)
            pl.tstep = _ptr(tstep, _I32P)
            pl.pw, pl.ph, pl.pw4, pl.ph4 = pw, ph, pw4, ph4
            pl.last_tile = -1
            pl.last_slice = -1
            pl.n_steps = 0
        self.sao = (shared_sao if shared_sao is not None
                    else np.zeros(sps.num_ctbs * 20, np.int32))
        # motion-syntax events: <=1 CU event per 8x8 block + <=4 PU events
        # per CU; h4*w4 + 64 covers the worst legal mix at any min-CB size
        h4, w4 = (rh + 3) >> 2, (rw + 3) >> 2
        self.ev = np.zeros((h4 * w4 + 64, EV_W), np.int32)
        self._ev = _NEv(ev=_ptr(self.ev, _I32P), count=0,
                        cap=self.ev.shape[0])
        self._qp = _NQp()
        self._params = None
        self._maps = None
        self._maps_keepalive = None

    def pin_plane_context(self, cur_tile: int, slice_idx: int) -> None:
        """Mark the plane grids as already belonging to (tile, slice) so the
        C parser's reset-on-change memset never fires in this lane -- it
        would wipe the SHARED grids other WPP row lanes are reading."""
        for p in range(3):
            self._pl[p].last_tile = cur_tile
            self._pl[p].last_slice = slice_idx

    # -- per-slice setup ------------------------------------------------------
    def begin_slice(self, sps, pps, sh, plan, avail, slice_idx: int) -> None:
        self._params = _NParams(
            pic_width=sps.pic_width, pic_height=sps.pic_height,
            log2_ctb=sps.log2_ctb_size, log2_min_cb=sps.log2_min_cb_size,
            log2_min_tb=sps.log2_min_tb_size, log2_max_tb=sps.log2_max_tb_size,
            max_tt_depth_intra=sps.max_transform_hierarchy_depth_intra,
            w4=(sps.pic_width + 3) >> 2, h4=(sps.pic_height + 3) >> 2,
            wc=sps.pic_width_ctbs,
            transform_skip_enabled=int(pps.transform_skip_enabled),
            sign_data_hiding=int(pps.sign_data_hiding),
            cu_qp_delta_enabled=int(pps.cu_qp_delta_enabled),
            min_qg_log2=sps.log2_ctb_size - pps.diff_cu_qp_delta_depth,
            transquant_bypass_enabled=int(pps.transquant_bypass_enabled),
            strong_intra_smoothing=int(sps.strong_intra_smoothing),
            scaling_enabled=int(sps.scaling_list_enabled),
            slice_qp=sh.slice_qp, slice_idx=slice_idx,
            slice_type=sh.slice_type,
            sao_luma=int(sh.sao_luma), sao_chroma=int(sh.sao_chroma),
            max_merge_cand=sh.max_num_merge_cand,
            num_ref_l0=sh.num_ref_idx_l0_active,
            num_ref_l1=sh.num_ref_idx_l1_active,
            mvd_l1_zero=int(sh.mvd_l1_zero),
            amp_enabled=int(sps.amp_enabled),
            max_tt_depth_inter=sps.max_transform_hierarchy_depth_inter)
        maps = (plan.intra_mode_map, plan.ct_depth_map, plan.qp_map,
                plan.intra_map, plan.cbf_map, plan.edge_flags,
                plan.skip_map, plan.bypass_map)
        for m in maps:
            assert m.dtype == np.int32 and m.flags["C_CONTIGUOUS"]
        assert avail.dtype == np.bool_ and avail.flags["C_CONTIGUOUS"]
        assert plan.tile_map4.dtype == np.int32
        assert plan.slice_of_ctb.dtype == np.int32
        self._maps_keepalive = (maps, avail, plan.tile_map4, plan.slice_of_ctb)
        self._maps = _NMaps(
            mode_map=_ptr(maps[0], _I32P), depth_map=_ptr(maps[1], _I32P),
            qp_map=_ptr(maps[2], _I32P), intra_map=_ptr(maps[3], _I32P),
            cbf_map=_ptr(maps[4], _I32P), edge_flags=_ptr(maps[5], _I32P),
            skip_map=_ptr(maps[6], _I32P), bypass_map=_ptr(maps[7], _I32P),
            avail=avail.ctypes.data_as(_U8P),
            tile_map4=_ptr(plan.tile_map4, _I32P),
            slice_of_ctb=_ptr(plan.slice_of_ctb, _I32P))

    def start_segment(self, slice_qp: int) -> None:
        q = self._qp
        q.last_cu_qp = slice_qp
        q.pred = slice_qp
        q.delta = 0
        q.delta_coded = int(not self.pps.cu_qp_delta_enabled)
        q.qg_x = q.qg_y = 0

    def parse_ctu(self, engine, ctb_addr: int, cur_tile: int,
                  do_sao: bool) -> int:
        """-> end_of_slice_segment_flag; raises on corrupt stream."""
        lib = _ctu_load()
        r = lib.ctu_parse(
            ctypes.byref(engine._c), ctypes.byref(self._params),
            ctypes.byref(self._maps), ctypes.byref(self._qp),
            self._bk, self._pl, _ptr(self.sao, _I32P),
            ctypes.byref(self._ev),
            ctypes.byref(_nctx()), ctb_addr, cur_tile, int(do_sao))
        if r < 0:
            raise ValueError(f"native CTU parse failed (code {r}) "
                             f"at CTB {ctb_addr}")
        return r

    def absorb(self, lanes: list) -> None:
        """Concatenate tile-lane records (in tile order) into this state --
        buckets, plane wavefront maxima and motion events.  The shared
        picture arrays (maps/avail/sao/slice_of_ctb) were written in place
        by the lanes to disjoint tile regions."""
        for p in range(3):
            for log2 in LOG2_SIZES:
                bi = p * 4 + (log2 - 2)
                dst = self._bk[bi]
                dd = self.buckets[(p, log2)]
                for lane in lanes:
                    src = lane._bk[bi]
                    m = int(src.count)
                    if m == 0:
                        continue
                    o = int(dst.count)
                    assert o + m <= dst.cap, (p, log2, o, m, dst.cap)
                    sd = lane.buckets[(p, log2)]
                    for k, a in dd.items():
                        a[o:o + m] = sd[k][:m]
                    dst.count = o + m
            pl = self._pl[p]
            pl.n_steps = max([int(pl.n_steps)]
                             + [int(lane._pl[p].n_steps) for lane in lanes])
        for lane in lanes:
            m = int(lane._ev.count)
            if m:
                o = int(self._ev.count)
                assert o + m <= self._ev.cap
                self.ev[o:o + m] = lane.ev[:m]
                self._ev.count = o + m

    # -- per-picture finalization ---------------------------------------------
    def total_tus(self) -> int:
        return sum(self._bk[i].count for i in range(12))

    def finalize(self, plan, mctx=None) -> None:
        """Convert the native SAO array into plan.sao SaoRec records and, for
        inter pictures, replay the motion-syntax events into plan.pus + the
        MotionCtx grids (candidate derivation, spec 8.5.3.2).  Idempotent:
        callers on both the sequential and pipelined paths may invoke it
        before using plan.sao."""
        if getattr(self, "_finalized", False):
            return
        self._finalized = True
        self.replay_motion(plan, mctx)
        from p265_tpu_torch.syntax.ctu import SaoRec
        rec = self.sao.reshape(-1, 20)
        out = []
        for a in range(rec.shape[0]):
            r = rec[a]
            out.append(SaoRec(
                type=[int(r[0]), int(r[1]), int(r[2])],
                cls=[int(r[3]), int(r[4]), int(r[5])],
                offsets=[[int(v) for v in r[6 + 4 * c:10 + 4 * c]]
                         for c in range(3)],
                merge_left=bool(r[18]), merge_up=bool(r[19])))
        plan.sao = out

    def replay_motion(self, plan, mctx) -> None:
        """Walk the C parser's CU/PU event stream in z-order, re-deriving
        merge/AMVP candidates (which never affect the bitstream) with a
        replay availability grid that reproduces the parse-time neighborhood
        (golden/mv.py motion_at semantics)."""
        n_ev = int(self._ev.count)
        if n_ev == 0:
            return
        assert mctx is not None, "inter events need a MotionCtx"
        from p265_tpu_torch.golden.mv import Motion, derive_amvp, derive_merge_list
        from p265_tpu_torch.syntax.ctu import PuRec, wrap_mv
        sps = self.sps
        w4 = (sps.pic_width + 3) >> 2
        h4 = (sps.pic_height + 3) >> 2
        avail = np.zeros((h4, w4), bool)
        tile_map4 = plan.tile_map4
        slice_of_ctb = plan.slice_of_ctb
        log2_ctb, wc = sps.log2_ctb_size, sps.pic_width_ctbs
        cur = {"tile": 0, "slice": 0}

        def avail_at(x: int, y: int) -> bool:
            if x < 0 or y < 0 or x >= sps.pic_width or y >= sps.pic_height:
                return False
            if tile_map4[y >> 2, x >> 2] != cur["tile"]:
                return False
            addr = (y >> log2_ctb) * wc + (x >> log2_ctb)
            if slice_of_ctb[addr] != cur["slice"]:
                return False
            return bool(avail[y >> 2, x >> 2])

        mctx.avail = avail_at
        mctx.intra_map = plan.intra_map
        ev = self.ev[:n_ev]
        pending = None  # (x0, y0, size) of the CU awaiting availability mark
        for r in ev:
            if r[0] == EV_CU:
                if pending is not None:
                    x0, y0, size = pending
                    x1 = min(x0 + size, sps.pic_width)
                    y1 = min(y0 + size, sps.pic_height)
                    avail[y0 >> 2:(y1 + 3) >> 2, x0 >> 2:(x1 + 3) >> 2] = True
                x0, y0, size = int(r[1]), int(r[2]), 1 << int(r[3])
                pending = (x0, y0, size)
                cur["tile"] = int(tile_map4[y0 >> 2, x0 >> 2])
                cur["slice"] = int(
                    slice_of_ctb[(y0 >> log2_ctb) * wc + (x0 >> log2_ctb)])
                mctx.begin_cu()
                continue
            x, y, w, h = (int(r[1]), int(r[2]), int(r[3]), int(r[4]))
            part, part_idx = PART_NAMES[int(r[5])], int(r[6])
            if r[7]:  # merge
                cx0, cy0, csize = pending
                cu_log2 = csize.bit_length() - 1
                cands = derive_merge_list(mctx, cx0, cy0, csize, x, y, w, h,
                                          part, part_idx, int(r[18]))
                motion = cands[int(r[8])].copy()
            else:
                idc = int(r[9])
                motion = Motion()
                for lx in (0, 1):
                    if (idc == 0 and lx == 1) or (idc == 1 and lx == 0):
                        continue
                    ridx = int(r[10 + lx])
                    mvd = (int(r[12 + 2 * lx]), int(r[13 + 2 * lx]))
                    amvp = derive_amvp(mctx, x, y, w, h, lx, ridx)
                    mvp = amvp[int(r[16 + lx])]
                    motion.mv[lx] = (wrap_mv(mvp[0] + mvd[0]),
                                     wrap_mv(mvp[1] + mvd[1]))
                    motion.ref_idx[lx] = ridx
                    motion.ref_poc[lx] = mctx.list_pocs[lx][ridx]
                    # NOTE: lt stays False here, matching the Python parser
                    # (_prediction_unit leaves Motion.lt default on the AMVP
                    # path; the grids must agree bit-for-bit)
            mctx.store_pu(x, y, w, h, motion)
            plan.pus.append(PuRec(x, y, w, h, motion))

    def tensor_plan(self, plan):
        """Vectorized TuBatch assembly (mirrors frame_plan.build_tensor_plan
        for the all-intra case)."""
        from p265_tpu_torch.plan.frame_plan import PlanePlan, TensorPlan, TuBatch
        sps, pps, sh = plan.sps, plan.pps, plan.sh
        planes = []
        for p_idx in range(3):
            pl = self._pl[p_idx]
            pp = PlanePlan(p_idx, self.shapes[p_idx], int(pl.n_steps))
            for log2 in LOG2_SIZES:
                bk = self._bk[p_idx * 4 + (log2 - 2)]
                m = int(bk.count)
                if m == 0:
                    continue
                size = 1 << log2
                d = self.buckets[(p_idx, log2)]
                meta = d["meta"][:m]
                order = np.argsort(meta[:, 2], kind="stable")
                meta = meta[order]
                flags = meta[:, 5]
                qp = meta[:, 4]
                if p_idx:
                    off = ((pps.cb_qp_offset if p_idx == 1 else pps.cr_qp_offset)
                           + (sh.cb_qp_offset if p_idx == 1 else sh.cr_qp_offset))
                    qp = CHROMA_QP_TABLE[np.clip(qp + off, 0, 57)]
                mode = meta[:, 3]
                has_res = (flags & 2) == 0
                tskip = (flags & 1) != 0
                inter = (flags & 4) != 0
                bypass = (flags & 8) != 0
                if p_idx == 0 and size != 4:
                    thresh = INTRA_HOR_VER_DIST_THRES.get(size, 10)
                    mdist = np.minimum(np.abs(mode - 26), np.abs(mode - 10))
                    ff = (mode != 1) & (mdist > thresh)
                else:
                    ff = np.zeros(m, bool)
                scale_m = None
                if plan.scaling is not None:
                    nmid = 2 if log2 == 5 else 6
                    lut = np.stack([plan.scaling[(log2, mid)]
                                    for mid in range(nmid)])
                    scale_m = lut[meta[:, 6]]
                b = TuBatch(
                    size=size,
                    pos=np.ascontiguousarray(meta[:, 0:2]),
                    step=np.ascontiguousarray(meta[:, 2]),
                    coeffs=d["coeffs"][:m][order].astype(np.int32).reshape(
                        m, size, size),
                    qp=qp.astype(np.int32),
                    mode=mode.astype(np.int32),
                    c_idx=np.full(m, p_idx, np.int32),
                    is_dst=(np.full(m, p_idx == 0 and log2 == 2, bool)
                            & ~inter),
                    tskip=tskip,
                    has_res=has_res,
                    bypass=bypass,
                    scale_m=scale_m,
                    inter=inter,
                    filter_flag=ff,
                    strong_allowed=(ff if (p_idx == 0 and size == 32
                                           and sps.strong_intra_smoothing)
                                    else np.zeros(m, bool)),
                    dc_edge=np.full(m, p_idx == 0 and size < 32, bool),
                    ref_ys=d["ref_ys"][:m][order].astype(np.int32),
                    ref_xs=d["ref_xs"][:m][order].astype(np.int32),
                    ref_ok=d["ref_ok"][:m][order].astype(bool),
                    ok_scan=d["ok_scan"][:m][order].astype(bool),
                )
                pp.batches[log2] = b
            planes.append(pp)
        return TensorPlan(planes, plan)
