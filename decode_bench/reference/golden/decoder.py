"""Golden scalar HEVC decoder: Annex-B stream -> YUV frames (output order).

This is the oracle (SURVEY.md 4.2): spec-first, sequential, NumPy.  The TPU
pipeline subclasses DecoderBase with a device reconstruction hook; both share
Stage-A parsing, the DPB, and motion-context plumbing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from decode_bench.reference.dpb.dpb import DPB, NO_REF, Picture
from decode_bench.reference.entropy.engine import CabacDecoder, ContextModels
from decode_bench.reference.golden import recon as grecon
from decode_bench.reference.golden.mv import MotionCtx
from decode_bench.reference.hls import nal
from decode_bench.reference.hls.bitio import BitReader
from decode_bench.reference.hls.params import parse_pps, parse_sps
from decode_bench.reference.hls.slice_header import SLICE_I, parse_slice_header
from decode_bench.reference.syntax.ctu import FramePlan, parse_slice_data


@dataclass
class DecodedFrame:
    poc: int
    planes: list[np.ndarray]        # post-filter [y, cb, cr] (full coded size)
    prefilter: list[np.ndarray]
    plan: FramePlan

    def cropped_planes(self) -> list[np.ndarray]:
        """Apply the SPS conformance window (spec 7.4.3.2; offsets are in
        chroma units for 4:2:0, x2 for luma)."""
        cw = self.plan.sps.conf_win
        if not any(cw):
            return self.planes
        l, r, t, b = cw
        y = self.planes[0]
        out = [y[2 * t:y.shape[0] - 2 * b, 2 * l:y.shape[1] - 2 * r]]
        for c in (1, 2):
            p = self.planes[c]
            out.append(p[t:p.shape[0] - b, l:p.shape[1] - r])
        return out


class DecoderBase:
    """Shared decoder scaffolding: parsing, DPB, motion context, resilience,
    checkpoint/resume, and per-run metrics (SURVEY.md 5 auxiliary subsystems).

    error_resilient: on a corrupt slice (CABAC desync, illegal syntax), drop
    data until the next IRAP and resume there -- the codec-native recovery
    point (SURVEY.md 5 "failure detection / elastic recovery").
    """

    def __init__(self, apply_filters: bool = True,
                 error_resilient: bool = False, use_native_cabac: bool = True,
                 use_native_parse: bool = False):
        # use_native_parse: whole-CTU parse in C (native/ctu.c) emitting the
        # tensor-plan buckets directly; only for pipelines that reconstruct
        # from tensor plans (the golden scalar recon needs plan.tus).
        self.use_native_parse = use_native_parse
        self.sps_map = {}
        self.pps_map = {}
        self.apply_filters = apply_filters
        self.error_resilient = error_resilient
        self.use_native_cabac = use_native_cabac
        self.dpb: DPB | None = None
        self._decoded: list[DecodedFrame] = []
        self._skip_until_irap = False
        # CRA/BLA leading-picture state (spec 8.1.3): the first picture of
        # the decode (or after EOS) has NoRaslOutputFlag=1, as do all BLA
        # pictures; RASL pictures associated with such an IRAP are discarded.
        self._first_pic_in_seq = True
        self._discard_rasl = False
        self._pic = None
        self.errors: list[str] = []
        self.stats = {"frames": 0, "parse_s": 0.0, "recon_s": 0.0,
                      "filter_s": 0.0, "slice_bytes": 0, "tus": 0, "ctbs": 0}

    # -- overridable reconstruction hooks -----------------------------------
    def _reconstruct(self, plan: FramePlan, refs: dict,
                     tplan=None) -> list[np.ndarray]:
        """refs: {poc: [y, cb, cr]}.  tplan: optional pre-built TensorPlan
        (subclasses that tensorize at parse time pass it through the task)."""
        return grecon.reconstruct(plan, refs)

    def _filters(self, plan: FramePlan, planes: list[np.ndarray]):
        return apply_loop_filters(plan, planes)

    # -- stream loop ---------------------------------------------------------
    def decode_stream(self, data: bytes) -> list[DecodedFrame]:
        for unit in nal.split_nal_units(data):
            self.decode_nal(unit)
        return self.flush()

    def decode_nal(self, unit: nal.NalUnit) -> None:
        t = unit.nal_type
        if t == nal.NAL_SPS:
            s = parse_sps(unit.rbsp)
            self.sps_map[s.sps_id] = s
        elif t == nal.NAL_PPS:
            p = parse_pps(unit.rbsp)
            self.pps_map[p.pps_id] = p
        elif t == nal.NAL_EOS:
            # end of sequence: the next IRAP starts a new decode (its RASL
            # pictures, if CRA, are not decodable -- spec 7.4.2.2)
            self._first_pic_in_seq = True
        elif nal.is_slice_nal(t):
            if self._skip_until_irap and not nal.is_irap(t):
                return
            if nal.is_irap(t):
                self._skip_until_irap = False
            if (t in (nal.NAL_RASL_N, nal.NAL_RASL_R)
                    and self._discard_rasl):
                return  # RASL of a CRA-start/BLA: refs precede the splice
            if self.error_resilient:
                try:
                    self._decode_slice(unit)
                except Exception as e:  # corrupt stream: resync at next IRAP
                    self.errors.append(f"slice decode failed: {e!r}")
                    self._skip_until_irap = True
            else:
                self._decode_slice(unit)

    # -- checkpoint / resume (SURVEY.md 5): decoder state between access
    # units is exactly {parameter sets, DPB contents, POC state} ------------
    def save_state(self) -> dict:
        import copy
        return {
            "sps_map": copy.deepcopy(self.sps_map),
            "pps_map": copy.deepcopy(self.pps_map),
            "dpb": copy.deepcopy(self.dpb),
            "skip": self._skip_until_irap,
            "first_pic": self._first_pic_in_seq,
            "discard_rasl": self._discard_rasl,
        }

    def load_state(self, state: dict) -> None:
        import copy
        self.sps_map = copy.deepcopy(state["sps_map"])
        self.pps_map = copy.deepcopy(state["pps_map"])
        self.dpb = copy.deepcopy(state["dpb"])
        self._skip_until_irap = state["skip"]
        self._first_pic_in_seq = state.get("first_pic", False)
        self._discard_rasl = state.get("discard_rasl", False)

    def flush(self) -> list[DecodedFrame]:
        """Output-order frames decoded so far."""
        if getattr(self, "_pic", None) is not None:
            self._finish_picture()
        self._drain_recon()
        if self.dpb is None:
            return []
        self.dpb.flush()
        return [p.user for p in self.dpb.outputs]

    def _decode_slice(self, unit: nal.NalUnit) -> None:
        import time as _time
        t0 = _time.perf_counter()
        sh, sps, pps, off = parse_slice_header(
            unit.rbsp, unit.nal_type, self.sps_map, self.pps_map)
        if sh.dependent_slice_segment:
            # inherit every slice-level value from the preceding independent
            # slice segment (spec 7.4.7.1)
            prev = self._pic["last_indep_sh"]
            addr = sh.slice_segment_address
            import copy
            sh = copy.copy(prev)
            sh.dependent_slice_segment = True
            sh.first_slice_in_pic = False
            sh.slice_segment_address = addr
        if self.dpb is None:
            self.dpb = DPB(sps)
        if sh.first_slice_in_pic:
            try:
                self._finish_picture()
            except Exception as e:
                # a stale incomplete picture must not take the new one down
                if not self.error_resilient:
                    raise
                self.errors.append(f"incomplete picture dropped: {e!r}")
            t = unit.nal_type
            is_bla = t in (nal.NAL_BLA_W_LP, nal.NAL_BLA_W_RADL,
                           nal.NAL_BLA_N_LP)
            no_rasl = nal.is_irap(t) and (
                nal.is_idr(t) or is_bla or self._first_pic_in_seq)
            if nal.is_irap(t):
                # RASL pictures are associated with the most recent CRA/BLA
                self._discard_rasl = no_rasl and not nal.is_idr(t)
            self._first_pic_in_seq = False
            poc = self.dpb.compute_poc(sh, unit.temporal_id,
                                       no_rasl_output=no_rasl)
            self.dpb.apply_rps(sh, poc, no_rasl_output=no_rasl)
            l0, l1 = self.dpb.build_ref_lists(sh, poc)
            mctx = None
            if sh.slice_type != SLICE_I:
                col_mv = col_rp = None
                col_poc = None
                col_lt = None
                if sh.temporal_mvp_enabled:
                    col_list = l0 if sh.collocated_from_l0 else l1
                    col = col_list[sh.collocated_ref_idx]
                    col_mv, col_rp = col.col_mv, col.col_ref_poc
                    col_lt = col.col_is_long_term
                    col_poc = col.poc
                h4 = (sps.pic_height + 3) >> 2
                w4 = (sps.pic_width + 3) >> 2
                mctx = MotionCtx(sps, sh, poc, [p.poc for p in l0],
                                 [p.poc for p in l1], (h4, w4),
                                 col_mv=col_mv, col_ref_poc=col_rp,
                                 col_poc=col_poc,
                                 l0_lt=[p.is_long_term for p in l0],
                                 l1_lt=[p.is_long_term for p in l1],
                                 col_lt=col_lt)
            plan = FramePlan(sps, pps, sh)
            plan.alloc_maps()
            plan.use_native_parse = (self.use_native_parse
                                     and self.use_native_cabac)
            plan.poc = poc
            plan.l0_pocs = [p.poc for p in l0]
            plan.l1_pocs = [p.poc for p in l1]
            self._pic = {"plan": plan, "mctx": mctx, "sps": sps, "pps": pps,
                         "poc": poc, "nal_type": unit.nal_type, "ctbs": 0,
                         "n_slices": 0, "bytes": 0, "last_indep_sh": None,
                         "dep_ctx": None, "dep_avail": None, "dep_wpp": None}
        assert self._pic is not None, "slice without first_slice_in_pic start"
        pic_st = self._pic
        plan, mctx, sps = pic_st["plan"], pic_st["mctx"], pic_st["sps"]

        dependent = sh.dependent_slice_segment
        ctx = ContextModels(sh.init_type(), sh.slice_qp)
        if dependent and pic_st["dep_ctx"] is not None:
            ctx.restore(pic_st["dep_ctx"])
        carry = pic_st["dep_avail"] if dependent else None
        # a dependent segment continues the same slice (same slice index)
        slice_idx = pic_st["n_slices"] - (1 if dependent else 0)
        if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
            from decode_bench.reference.syntax.ctu import DecodeSubstreams
            provider = DecodeSubstreams(unit.rbsp[off:],
                                        sh.entry_point_offsets, ctx)
            _, coded, coder = parse_slice_data(
                None, sps, pps, sh, mctx, substreams=provider, plan=plan,
                slice_idx=slice_idx, carry_avail=carry,
                wpp_carry=pic_st["dep_wpp"] if dependent else None)
        else:
            dec = CabacDecoder(BitReader(unit.rbsp[off:]), ctx)
            _, coded, coder = parse_slice_data(dec, sps, pps, sh, mctx,
                                               plan=plan,
                                               slice_idx=slice_idx,
                                               carry_avail=carry)
        if pps.dependent_slice_segments_enabled:
            pic_st["dep_ctx"] = ctx.snapshot()
            pic_st["dep_avail"] = coder.avail
            pic_st["dep_wpp"] = coder.wpp_snapshots
        if not dependent:
            pic_st["last_indep_sh"] = sh
        pic_st["ctbs"] += coded
        pic_st["n_slices"] += 0 if dependent else 1
        pic_st["bytes"] += len(unit.rbsp)
        self.stats["parse_s"] += _time.perf_counter() - t0
        if pic_st["ctbs"] > sps.num_ctbs:
            raise ValueError("slice decoded past picture end")
        if pic_st["ctbs"] == sps.num_ctbs:
            self._finish_picture()

    def _finish_picture(self) -> None:
        """Parse-side picture completion.  Everything a LATER picture's parse
        needs (POC/DPB marking, TMVP collocated-MV grids) is final here; the
        pixel work is packaged as a recon task and handed to _schedule_recon,
        which subclasses may defer (shape calibration, worker threads).  The
        DPB holds shell Pictures whose planes are filled strictly in decode
        order by _run_recon, so MC always sees finished references."""
        pic_st = getattr(self, "_pic", None)
        self._pic = None
        if pic_st is None:
            return
        if pic_st["ctbs"] != pic_st["sps"].num_ctbs:
            raise ValueError("picture incomplete: "
                             f"{pic_st['ctbs']}/{pic_st['sps'].num_ctbs} CTUs")
        plan, mctx, sps = pic_st["plan"], pic_st["mctx"], pic_st["sps"]
        poc = pic_st["poc"]
        ns = getattr(plan, "nstate", None)
        if ns is not None:
            # convert native SAO records + replay motion syntax into
            # plan.pus / the MotionCtx grids (TMVP of later pictures reads
            # mctx.mv below, so this must happen before the col snapshot)
            ns.finalize(plan, mctx)
        frame = DecodedFrame(poc, None, None, plan)
        pic = Picture(poc, None,
                      is_reference=nal.is_reference_nal(pic_st["nal_type"]))
        pic.user = frame
        if mctx is not None:
            pic.col_mv = mctx.mv[::4, ::4].copy()
            pic.col_ref_poc = mctx.ref_poc[::4, ::4].copy()
            pic.col_is_long_term = mctx.lt[::4, ::4].copy()
        else:
            h16 = (sps.pic_height + 15) >> 4
            w16 = (sps.pic_width + 15) >> 4
            pic.col_mv = np.zeros((h16, w16, 2, 2), np.int32)
            pic.col_ref_poc = np.full((h16, w16, 2), NO_REF, np.int32)
            pic.col_is_long_term = np.zeros((h16, w16, 2), bool)
        # reference shells captured BEFORE inserting the current picture
        refs = {p.poc: p for p in self.dpb.pics if p.is_reference}
        self.stats["frames"] += 1
        self.stats["slice_bytes"] += pic_st["bytes"]
        self.stats["tus"] += ns.total_tus() if ns is not None else len(plan.tus)
        self.stats["ctbs"] += sps.num_ctbs
        self._decoded.append(frame)
        self.dpb.insert(pic)
        self._schedule_recon({"plan": plan, "refs": refs, "frame": frame,
                              "pic": pic})

    def _schedule_recon(self, task: dict) -> None:
        """Default: reconstruct immediately (golden behavior)."""
        self._run_recon(task)

    def _drain_recon(self) -> None:
        """Finish any deferred recon tasks (no-op unless a subclass defers)."""

    def _run_recon(self, task: dict) -> None:
        import time as _time
        plan, frame, pic = task["plan"], task["frame"], task["pic"]
        refs = {p: r.planes for p, r in task["refs"].items()}
        t1 = _time.perf_counter()
        prefilter = self._reconstruct(plan, refs, tplan=task.get("tplan"))
        t2 = _time.perf_counter()
        planes = [np.asarray(p).copy() for p in prefilter]
        if self.apply_filters:
            planes = self._filters(plan, planes)
        self.stats["recon_s"] += t2 - t1
        self.stats["filter_s"] += _time.perf_counter() - t2
        frame.prefilter = prefilter
        frame.planes = planes
        pic.planes = planes


class GoldenDecoder(DecoderBase):
    pass


def bypass_pixel_masks(plan: FramePlan):
    """Per-plane boolean masks of samples the loop filters must not modify
    (cu_transquant_bypass / PCM with pcm_loop_filter_disabled, spec 8.7)."""
    bm = plan.bypass_map
    if bm is None or not bm.any():
        return None
    h, w = plan.sps.pic_height, plan.sps.pic_width
    y = np.repeat(np.repeat(bm.astype(bool), 4, 0), 4, 1)[:h, :w]
    c = y[::2, ::2]
    return [y, c, c.copy()]


def apply_loop_filters(plan: FramePlan, planes: list[np.ndarray]
                       ) -> list[np.ndarray]:
    from decode_bench.reference.golden.deblock import deblock_picture
    from decode_bench.reference.golden.sao import sao_picture
    masks = bypass_pixel_masks(plan)
    orig = [np.asarray(p).copy() for p in planes] if masks else None
    if not plan.sh.deblocking_filter_disabled:
        planes = deblock_picture(plan, planes)
    if plan.sps.sao_enabled and (plan.sh.sao_luma or plan.sh.sao_chroma):
        planes = sao_picture(plan, planes)
    if masks:
        planes = [np.where(m, o, np.asarray(p))
                  for m, o, p in zip(masks, orig, planes)]
    return planes
