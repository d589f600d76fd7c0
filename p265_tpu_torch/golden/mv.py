"""Motion vector derivation: merge and AMVP candidate lists (spec 8.5.3.2).

Shared verbatim by decoder and testgen encoder so the candidate derivation can
never desynchronize.  Operates on per-4x4 motion grids built up in decode
order.  Long-term references carry per-lane lt flags: AMVP/TMVP scaling is
suppressed between two long-term refs and a candidate is invalid when the
lt-ness of its reference differs from the target's (spec 8.5.3.2.7/.8).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NO_REF = -(1 << 30)


def _trunc_div(a: int, b: int) -> int:
    """C-style truncating integer division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def scale_mv(mv: tuple[int, int], tb: int, td: int) -> tuple[int, int]:
    """Temporal MV scaling (spec 8.5.3.2.8 eq 8-175..8-177)."""
    tb = max(-128, min(127, tb))
    td = max(-128, min(127, td))
    if td == tb:
        return mv
    tx = _trunc_div(16384 + (abs(td) >> 1), td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        p = dsf * c
        s = -1 if p < 0 else 1
        out.append(max(-32768, min(32767, s * ((abs(p) + 127) >> 8))))
    return tuple(out)


@dataclass
class Motion:
    """Motion of one PU: per-list (mv, ref_idx, ref_poc); ref_idx<0 = unused."""
    mv: list = field(default_factory=lambda: [(0, 0), (0, 0)])
    ref_idx: list = field(default_factory=lambda: [-1, -1])
    ref_poc: list = field(default_factory=lambda: [NO_REF, NO_REF])
    lt: list = field(default_factory=lambda: [False, False])   # long-term ref

    def uses(self, lx: int) -> bool:
        return self.ref_idx[lx] >= 0

    def same_motion(self, o: "Motion") -> bool:
        for lx in range(2):
            if self.uses(lx) != o.uses(lx):
                return False
            if self.uses(lx) and (self.mv[lx] != o.mv[lx]
                                  or self.ref_idx[lx] != o.ref_idx[lx]):
                return False
        return True

    def copy(self) -> "Motion":
        return Motion(list(self.mv), list(self.ref_idx), list(self.ref_poc),
                      list(self.lt))


class MotionCtx:
    """Frame-level motion state consulted during candidate derivation."""

    def __init__(self, sps, sh, poc: int, l0_pocs: list[int], l1_pocs: list[int],
                 grid_shape: tuple[int, int], avail_fn=None, intra_map=None,
                 col_mv=None, col_ref_poc=None, col_poc: int | None = None,
                 l0_lt=None, l1_lt=None, col_lt=None):
        self.sps = sps
        self.sh = sh
        self.poc = poc
        self.list_pocs = [l0_pocs, l1_pocs]
        self.list_lt = [l0_lt or [False] * len(l0_pocs),
                        l1_lt or [False] * len(l1_pocs)]
        # avail_fn / intra_map are wired by CtuCoder (late binding: the plan's
        # maps and the coder's availability grid exist after this object)
        self.avail = avail_fn              # (x, y) -> z-order availability
        self.intra_map = intra_map
        h4, w4 = grid_shape
        self.mv = np.zeros((h4, w4, 2, 2), np.int32)
        self.ref_idx = np.full((h4, w4, 2), -1, np.int32)
        self.ref_poc = np.full((h4, w4, 2), NO_REF, np.int32)
        self.lt = np.zeros((h4, w4, 2), bool)
        # PU motion becomes visible to later PUs of the same CU before the
        # CU's samples are reconstructed (AMVP may read PU0 from PU1).
        # Scoped by a per-CU serial so visibility never leaks across CU /
        # tile / slice boundaries (those go through the avail() gate).
        self.motion_coded = np.zeros((h4, w4), np.int64)
        self.cur_cu = 0
        self.col_mv = col_mv               # [h16, w16, 2, 2] of collocated pic
        self.col_ref_poc = col_ref_poc
        self.col_poc = col_poc
        self.col_lt = col_lt               # [h16, w16, 2] bool, or None
        # NoBackwardPredFlag: every ref in both lists has POC <= current
        self.no_backward = all(p <= poc for p in l0_pocs + l1_pocs)

    def begin_cu(self) -> None:
        self.cur_cu += 1

    # -- grid bookkeeping ----------------------------------------------------
    def store_pu(self, x: int, y: int, w: int, h: int, m: Motion) -> None:
        x4a, y4a = x >> 2, y >> 2
        x4b, y4b = (x + w) >> 2, (y + h) >> 2
        for lx in range(2):
            self.mv[y4a:y4b, x4a:x4b, lx, 0] = m.mv[lx][0]
            self.mv[y4a:y4b, x4a:x4b, lx, 1] = m.mv[lx][1]
            self.ref_idx[y4a:y4b, x4a:x4b, lx] = m.ref_idx[lx]
            self.ref_poc[y4a:y4b, x4a:x4b, lx] = m.ref_poc[lx]
            self.lt[y4a:y4b, x4a:x4b, lx] = m.lt[lx]
        self.motion_coded[y4a:y4b, x4a:x4b] = self.cur_cu

    def motion_at(self, x: int, y: int) -> Motion | None:
        """Motion of the coded block covering luma sample (x, y), or None if
        unavailable / intra."""
        if x < 0 or y < 0 or x >= self.sps.pic_width or y >= self.sps.pic_height:
            return None
        x4, y4 = x >> 2, y >> 2
        if not (self.avail(x, y)
                or (self.cur_cu and self.motion_coded[y4, x4] == self.cur_cu)):
            return None
        if self.intra_map[y4, x4]:
            return None
        if self.ref_idx[y4, x4, 0] < 0 and self.ref_idx[y4, x4, 1] < 0:
            return None
        m = Motion()
        for lx in range(2):
            m.mv[lx] = (int(self.mv[y4, x4, lx, 0]), int(self.mv[y4, x4, lx, 1]))
            m.ref_idx[lx] = int(self.ref_idx[y4, x4, lx])
            m.ref_poc[lx] = int(self.ref_poc[y4, x4, lx])
            m.lt[lx] = bool(self.lt[y4, x4, lx])
        return m

    # -- temporal candidate --------------------------------------------------
    def _col_motion_at(self, x: int, y: int):
        if self.col_mv is None:
            return None
        x16, y16 = x >> 4, y >> 4
        if (y16 >= self.col_ref_poc.shape[0]
                or x16 >= self.col_ref_poc.shape[1]):
            return None
        rp = self.col_ref_poc[y16, x16]
        if rp[0] == NO_REF and rp[1] == NO_REF:
            return None
        lt = (self.col_lt[y16, x16] if self.col_lt is not None
              else np.zeros(2, bool))
        return (self.col_mv[y16, x16], rp, lt)

    def temporal_candidate(self, x_pb: int, y_pb: int, n_w: int, n_h: int,
                           lx: int, ref_idx: int) -> tuple[int, int] | None:
        """TMVP (spec 8.5.3.2.8): scaled col MV for list lx / ref_idx."""
        if self.col_mv is None:
            return None
        sps = self.sps
        # bottom-right col position, must stay in the same CTU row
        x_br, y_br = x_pb + n_w, y_pb + n_h
        cand = None
        if (x_br < sps.pic_width and y_br < sps.pic_height
                and (y_br >> sps.log2_ctb_size) == (y_pb >> sps.log2_ctb_size)):
            cand = self._col_motion_at((x_br >> 4) << 4, (y_br >> 4) << 4)
        if cand is None:
            xc = x_pb + (n_w >> 1)
            yc = y_pb + (n_h >> 1)
            cand = self._col_motion_at((xc >> 4) << 4, (yc >> 4) << 4)
        if cand is None:
            return None
        col_mvs, col_rp, col_lt = cand
        # pick which col list to read (spec 8.5.3.2.9)
        if col_rp[0] == NO_REF:
            l_col = 1
        elif col_rp[1] == NO_REF:
            l_col = 0
        elif self.no_backward:
            l_col = lx
        else:
            l_col = 0 if self.sh.collocated_from_l0 else 1
        mv_col = (int(col_mvs[l_col][0]), int(col_mvs[l_col][1]))
        ref_poc_col = int(col_rp[l_col])
        # lt-ness mismatch -> unavailable; both long-term -> unscaled
        # (spec 8.5.3.2.8: LongTermRefPic equality gate)
        target_lt = bool(self.list_lt[lx][ref_idx])
        if bool(col_lt[l_col]) != target_lt:
            return None
        if target_lt:
            return mv_col
        tb = self.poc - self.list_pocs[lx][ref_idx]
        td = self.col_poc - ref_poc_col
        if td == 0:
            td = 1
        return scale_mv(mv_col, tb, td)


# ---------------------------------------------------------------------------
# merge candidate list (spec 8.5.3.2.3-8.5.3.2.5)
# ---------------------------------------------------------------------------

_COMB_IDX = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
             (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2)]


def derive_merge_list(ctx: MotionCtx, x_cu: int, y_cu: int, cu_size: int,
                      x_pb: int, y_pb: int, n_w: int, n_h: int,
                      part_mode: str, part_idx: int, max_cands: int
                      ) -> list[Motion]:
    is_b = len(ctx.list_pocs[1]) > 0
    # merge estimation region (log2_parallel_merge_level): with the default
    # level 2 (4x4) no candidates are suppressed; larger levels suppress
    # in-region neighbors
    plevel = ctx.sh  # placeholder; pps value threaded via sps-side default 2

    def nb(xn, yn):
        return ctx.motion_at(xn, yn)

    a1 = b1 = b0 = a0 = b2 = None
    if not (part_idx == 1 and part_mode in ("Nx2N", "nLx2N", "nRx2N")):
        a1 = nb(x_pb - 1, y_pb + n_h - 1)
    if not (part_idx == 1 and part_mode in ("2NxN", "2NxnU", "2NxnD")):
        b1 = nb(x_pb + n_w - 1, y_pb - 1)
    b0 = nb(x_pb + n_w, y_pb - 1)
    a0 = nb(x_pb - 1, y_pb + n_h)
    cands: list[Motion] = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and not (a1 is not None and b1.same_motion(a1)):
        cands.append(b1)
    if b0 is not None and not (b1 is not None and b0.same_motion(b1)):
        cands.append(b0)
    if a0 is not None and not (a1 is not None and a0.same_motion(a1)):
        cands.append(a0)
    n_four = sum(x is not None for x in (a0, a1, b0, b1))
    if n_four < 4:
        b2 = nb(x_pb - 1, y_pb - 1)
        if b2 is not None and not (
                (a1 is not None and b2.same_motion(a1))
                or (b1 is not None and b2.same_motion(b1))):
            cands.append(b2)
    # temporal
    if (ctx.sps.temporal_mvp_enabled and ctx.sh.temporal_mvp_enabled
            and len(cands) < max_cands):
        m = Motion()
        got = False
        mv0 = ctx.temporal_candidate(x_pb, y_pb, n_w, n_h, 0, 0)
        if mv0 is not None:
            m.mv[0] = mv0
            m.ref_idx[0] = 0
            m.ref_poc[0] = ctx.list_pocs[0][0]
            m.lt[0] = bool(ctx.list_lt[0][0])
            got = True
        if is_b and got:
            mv1 = ctx.temporal_candidate(x_pb, y_pb, n_w, n_h, 1, 0)
            if mv1 is not None:
                m.mv[1] = mv1
                m.ref_idx[1] = 0
                m.ref_poc[1] = ctx.list_pocs[1][0]
                m.lt[1] = bool(ctx.list_lt[1][0])
        if got:
            cands.append(m)
    cands = cands[:max_cands]
    # combined bi-predictive (B only)
    if is_b and 1 < len(cands) < max_cands:
        n_orig = len(cands)
        for (i, j) in _COMB_IDX[:n_orig * (n_orig - 1)]:
            if i >= n_orig or j >= n_orig:
                continue
            ci, cj = cands[i], cands[j]
            if not (ci.uses(0) and cj.uses(1)):
                continue
            if (ci.ref_poc[0] == cj.ref_poc[1] and ci.mv[0] == cj.mv[1]):
                continue
            m = Motion()
            m.mv[0], m.ref_idx[0], m.ref_poc[0] = ci.mv[0], ci.ref_idx[0], ci.ref_poc[0]
            m.mv[1], m.ref_idx[1], m.ref_poc[1] = cj.mv[1], cj.ref_idx[1], cj.ref_poc[1]
            m.lt[0], m.lt[1] = ci.lt[0], cj.lt[1]
            cands.append(m)
            if len(cands) == max_cands:
                break
    # zero candidates
    n0, n1 = len(ctx.list_pocs[0]), len(ctx.list_pocs[1])
    num_refs = min(n0, n1) if is_b else n0
    zidx = 0
    while len(cands) < max_cands:
        r = zidx if zidx < num_refs else 0
        m = Motion()
        m.mv[0] = (0, 0)
        m.ref_idx[0] = r
        m.ref_poc[0] = ctx.list_pocs[0][r] if n0 else NO_REF
        m.lt[0] = bool(ctx.list_lt[0][r]) if n0 else False
        if is_b:
            m.mv[1] = (0, 0)
            m.ref_idx[1] = r
            m.ref_poc[1] = ctx.list_pocs[1][r]
            m.lt[1] = bool(ctx.list_lt[1][r])
        cands.append(m)
        zidx += 1
    # 8x4/4x8 PUs: bi candidates become uni L0 (spec 8.5.3.2.3 final step)
    if n_w + n_h == 12:
        for m in cands:
            if m.uses(0) and m.uses(1):
                m.ref_idx[1] = -1
                m.ref_poc[1] = NO_REF
                m.mv[1] = (0, 0)
                m.lt[1] = False
    return cands


# ---------------------------------------------------------------------------
# AMVP (spec 8.5.3.2.6-8.5.3.2.7)
# ---------------------------------------------------------------------------


def derive_amvp(ctx: MotionCtx, x_pb: int, y_pb: int, n_w: int, n_h: int,
                lx: int, ref_idx: int) -> list[tuple[int, int]]:
    target_poc = ctx.list_pocs[lx][ref_idx]
    target_lt = bool(ctx.list_lt[lx][ref_idx])

    def candidate_from(positions, allow_scaled):
        # pass 1: same reference picture (either list), no scaling
        for (xn, yn) in positions:
            m = ctx.motion_at(xn, yn)
            if m is None:
                continue
            for ly in (lx, 1 - lx):
                if m.uses(ly) and m.ref_poc[ly] == target_poc:
                    return m.mv[ly], True
        if not allow_scaled:
            return None, False
        # pass 2: any reference of matching lt-ness; scaled only when both
        # short-term, unscaled when both long-term (spec 8.5.3.2.7)
        for (xn, yn) in positions:
            m = ctx.motion_at(xn, yn)
            if m is None:
                continue
            for ly in (lx, 1 - lx):
                if m.uses(ly) and m.lt[ly] == target_lt:
                    if target_lt:
                        return m.mv[ly], True
                    tb = ctx.poc - target_poc
                    td = ctx.poc - m.ref_poc[ly]
                    if td == 0:
                        td = 1
                    return scale_mv(m.mv[ly], tb, td), True
        return None, False

    pos_a = [(x_pb - 1, y_pb + n_h), (x_pb - 1, y_pb + n_h - 1)]
    pos_b = [(x_pb + n_w, y_pb - 1), (x_pb + n_w - 1, y_pb - 1),
             (x_pb - 1, y_pb - 1)]
    mv_a, got_a = candidate_from(pos_a, allow_scaled=True)
    # B-side scaling only allowed when no A neighbor exists at all (spec:
    # isScaledFlagLX = availableA0 || availableA1)
    a_exists = any(ctx.motion_at(x, y) is not None for (x, y) in pos_a)
    mv_b, got_b = candidate_from(pos_b, allow_scaled=not a_exists)
    cands = []
    if got_a:
        cands.append(mv_a)
    if got_b and not (got_a and mv_b == mv_a):
        cands.append(mv_b)
    if (len(cands) < 2 and ctx.sps.temporal_mvp_enabled
            and ctx.sh.temporal_mvp_enabled):
        mv_t = ctx.temporal_candidate(x_pb, y_pb, n_w, n_h, lx, ref_idx)
        if mv_t is not None:
            cands.append(mv_t)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]
