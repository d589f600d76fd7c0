"""Decoded picture buffer: POC, RPS application, reference lists, bumping
(spec 8.3.1-8.3.4, C.5).

Device-resident picture slabs in the TPU pipeline; plain NumPy here (the DPB
logic is identical, only the plane storage differs).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from p265_tpu_torch.hls.params import SPS, ShortTermRPS
from p265_tpu_torch.hls.slice_header import SLICE_B, SLICE_I, SliceHeader


@dataclass
class Picture:
    poc: int
    planes: list           # post-filter [y, cb, cr] (np or device arrays)
    is_reference: bool = True
    is_long_term: bool = False
    needed_for_output: bool = True
    # TMVP metadata at 16x16 granularity (spec motion compression)
    col_mv: np.ndarray | None = None       # [h16, w16, 2, 2]
    col_ref_poc: np.ndarray | None = None  # [h16, w16, 2], -2**30 = unused
    col_is_long_term: np.ndarray | None = None


NO_REF = -(1 << 30)


class DPB:
    def __init__(self, sps: SPS):
        self.sps = sps
        self.pics: list[Picture] = []
        self.prev_poc_tid0 = 0
        self.outputs: list[Picture] = []

    # -- POC (8.3.1) ---------------------------------------------------------
    def compute_poc(self, sh: SliceHeader, temporal_id: int = 0,
                    no_rasl_output: bool = False) -> int:
        """no_rasl_output: NoRaslOutputFlag of the current picture (spec
        8.3.1: an IRAP with NoRaslOutputFlag==1 gets PicOrderCntMsb = 0 --
        BLA pictures always, CRA when it starts the decode)."""
        if sh.is_idr():
            poc = 0
        elif no_rasl_output and sh.is_irap():
            poc = sh.pic_order_cnt_lsb
        else:
            max_lsb = self.sps.max_poc_lsb
            prev = self.prev_poc_tid0
            prev_lsb = prev & (max_lsb - 1)
            prev_msb = prev - prev_lsb
            lsb = sh.pic_order_cnt_lsb
            if lsb < prev_lsb and (prev_lsb - lsb) >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and (lsb - prev_lsb) > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + lsb
        # prevTid0Pic (8.3.1): previous tid-0 picture that is not RASL, RADL,
        # or a sub-layer non-reference picture
        t = sh.nal_type
        is_leading = 6 <= t <= 9          # RADL_N/R, RASL_N/R
        is_slnr = t < 16 and (t & 1) == 0  # *_N sub-layer non-reference
        if temporal_id == 0 and not is_leading and not is_slnr:
            self.prev_poc_tid0 = poc
        return poc

    # -- RPS (8.3.2) ---------------------------------------------------------
    def apply_rps(self, sh: SliceHeader, poc: int,
                  no_rasl_output: bool = False) -> None:
        """no_rasl_output: spec 8.3.2 -- when the current picture is an IRAP
        with NoRaslOutputFlag==1 (IDR, BLA, or CRA starting the decode), all
        reference pictures currently in the DPB are marked unused; prior
        pictures are bumped out (or dropped if no_output_of_prior_pics)."""
        if sh.is_idr() or (no_rasl_output and sh.is_irap()):
            for p in self.pics:
                p.is_reference = False
            self._flush_unneeded(bump_all=not sh.no_output_of_prior_pics)
            if sh.no_output_of_prior_pics:
                self.pics.clear()
            if sh.is_idr():
                return
            # BLA / CRA-start still carries an RPS, but it can no longer
            # match anything: fall through with an empty DPB reference set.
        rps = self._slice_rps(sh)
        keep = set()
        for d, used in zip(rps.delta_poc_s0 + rps.delta_poc_s1,
                           rps.used_s0 + rps.used_s1):
            keep.add(poc + d)
        lt_pics = {id(p) for p in self._lt_match(sh, poc, used_only=False)}
        for p in self.pics:
            if id(p) in lt_pics:
                p.is_reference = True
                p.is_long_term = True
            elif p.poc in keep:
                p.is_reference = True
                p.is_long_term = False
            else:
                p.is_reference = False
        self._flush_unneeded()

    def _lt_match(self, sh: SliceHeader, poc: int, used_only: bool
                  ) -> list[Picture]:
        """Pictures referenced by the slice's long-term entries (spec 8.3.2
        PocLtCurr/PocLtFoll), in signaled order."""
        out = []
        max_lsb = self.sps.max_poc_lsb
        for e in getattr(sh, "lt_entries", []):
            if used_only and not e["used"]:
                continue
            if e["msb_present"]:
                target = (poc - (poc & (max_lsb - 1))
                          - e["msb_cycle"] * max_lsb + e["poc_lsb"])
                match = [p for p in self.pics if p.poc == target]
            else:
                match = [p for p in self.pics
                         if (p.poc & (max_lsb - 1)) == e["poc_lsb"]
                         and p.is_reference]
            if not match:
                raise ValueError(
                    f"long-term reference poc_lsb={e['poc_lsb']} not in DPB")
            out.append(match[-1])
        return out

    def _slice_rps(self, sh: SliceHeader) -> ShortTermRPS:
        if sh.st_rps_explicit is not None:
            return sh.st_rps_explicit
        if not self.sps.st_rps:
            return ShortTermRPS()
        return self.sps.st_rps[sh.st_rps_idx]

    # -- reference lists (8.3.4) --------------------------------------------
    def build_ref_lists(self, sh: SliceHeader, poc: int
                        ) -> tuple[list[Picture], list[Picture]]:
        if sh.slice_type == SLICE_I:
            return [], []
        rps = self._slice_rps(sh)
        before = sorted((poc + d for d, u in zip(rps.delta_poc_s0, rps.used_s0)
                         if u), reverse=True)           # closest first
        after = sorted(poc + d for d, u in zip(rps.delta_poc_s1, rps.used_s1)
                       if u)
        by_poc = {p.poc: p for p in self.pics if p.is_reference}
        st_before = [by_poc[p] for p in before if p in by_poc]
        st_after = [by_poc[p] for p in after if p in by_poc]
        if len(st_before) != len(before) or len(st_after) != len(after):
            missing = [p for p in before + after if p not in by_poc]
            raise ValueError(f"reference pictures missing from DPB: {missing}")
        lt_curr = self._lt_match(sh, poc, used_only=True)
        tmp0 = st_before + st_after + lt_curr
        if sh.ref_pic_list_modification_l0 is not None:
            l0 = [tmp0[e] for e in sh.ref_pic_list_modification_l0]
        else:
            l0 = [tmp0[i % len(tmp0)]
                  for i in range(sh.num_ref_idx_l0_active)] if tmp0 else []
        l1 = []
        if sh.slice_type == SLICE_B:
            tmp1 = st_after + st_before + lt_curr
            if sh.ref_pic_list_modification_l1 is not None:
                l1 = [tmp1[e] for e in sh.ref_pic_list_modification_l1]
            else:
                l1 = [tmp1[i % len(tmp1)]
                      for i in range(sh.num_ref_idx_l1_active)] if tmp1 else []
        return l0, l1

    # -- insertion / output (C.5) -------------------------------------------
    def insert(self, pic: Picture) -> None:
        self.pics.append(pic)
        self._bump()

    def _bump(self) -> None:
        while True:
            pending = [p for p in self.pics if p.needed_for_output]
            over_reorder = len(pending) > self.sps.num_reorder_pics
            over_size = len(self.pics) >= self.sps.max_dec_pic_buffering
            if pending and (over_reorder or over_size):
                first = min(pending, key=lambda p: p.poc)
                self.outputs.append(first)
                first.needed_for_output = False
                self._flush_unneeded()
            else:
                break

    def _flush_unneeded(self, bump_all: bool = False) -> None:
        if bump_all:
            for p in sorted(self.pics, key=lambda p: p.poc):
                if p.needed_for_output:
                    self.outputs.append(p)
                    p.needed_for_output = False
        self.pics = [p for p in self.pics
                     if p.is_reference or p.needed_for_output]

    def flush(self) -> None:
        for p in sorted(self.pics, key=lambda p: p.poc):
            if p.needed_for_output:
                self.outputs.append(p)
                p.needed_for_output = False
        self.pics.clear()

    def get_ref(self, poc: int) -> Picture:
        for p in self.pics:
            if p.poc == poc and p.is_reference:
                return p
        raise KeyError(poc)
