"""Golden deblocking filter (spec 8.7.2): vertical edges then horizontal.

Operates on whole-picture planes using FramePlan metadata maps.  bS currently
covers intra (=2) and TU-edge-with-cbf (=1); the MV-difference term is wired
in by the inter milestone via plan.mv_map/ref_map.
"""
from __future__ import annotations

import numpy as np

from decode_bench.reference.syntax.ctu import FramePlan
from decode_bench.reference.tables import BETA_TABLE, TC_TABLE, chroma_qp_from_luma, clip3


def _bs(plan: FramePlan, x4p: int, y4p: int, x4q: int, y4q: int) -> int:
    """Boundary strength between 4x4 blocks P and Q (8.7.2.4)."""
    im = plan.intra_map
    if im[y4p, x4p] or im[y4q, x4q]:
        return 2
    if plan.cbf_map[y4p, x4p] or plan.cbf_map[y4q, x4q]:
        return 1
    if plan.mv_map is not None:
        mv = plan.mv_map
        rf = plan.ref_map
        rp, rq = rf[y4p, x4p], rf[y4q, x4q]
        # refs as (l0_poc, l1_poc); -**31 marks unused
        sp = {int(v) for v in rp if v != -(1 << 30)}
        sq = {int(v) for v in rq if v != -(1 << 30)}
        if sp != sq:
            return 1
        mvs_p = [mv[y4p, x4p, i] for i in range(2) if rp[i] != -(1 << 30)]
        mvs_q = [mv[y4q, x4q, i] for i in range(2) if rq[i] != -(1 << 30)]
        if len(mvs_p) != len(mvs_q):
            return 1
        if len(sp) == 1 or (len(mvs_p) == 1):
            if any(abs(int(a[0]) - int(b[0])) >= 4 or abs(int(a[1]) - int(b[1])) >= 4
                   for a, b in zip(mvs_p, mvs_q)):
                return 1
        else:
            # two hypotheses: compare both pairings, take the min-difference one
            def diff(pair):
                (a0, b0), (a1, b1) = pair
                return (abs(int(a0[0]) - int(b0[0])) >= 4
                        or abs(int(a0[1]) - int(b0[1])) >= 4
                        or abs(int(a1[0]) - int(b1[0])) >= 4
                        or abs(int(a1[1]) - int(b1[1])) >= 4)
            d1 = diff(((mvs_p[0], mvs_q[0]), (mvs_p[1], mvs_q[1])))
            d2 = diff(((mvs_p[0], mvs_q[1]), (mvs_p[1], mvs_q[0])))
            if rp[0] == rp[1]:  # same ref both lists: either pairing may match
                if d1 and d2:
                    return 1
            elif d1:
                return 1
    return 0


def _filter_luma_segment(plane, px, py, dx, dy, beta, tc):
    """Filter one 4-line segment.  (px,py) = first P-side sample (p0) of line 0;
    (dx,dy) step across the edge (towards p3), lines advance perpendicular."""
    # gather p0..p3, q0..q3 for 4 lines
    lx, ly = dy, dx  # line direction
    p = np.empty((4, 4), np.int64)  # [i][line]
    q = np.empty((4, 4), np.int64)
    for i in range(4):
        for ln in range(4):
            p[i][ln] = plane[py - i * dy + ln * ly, px - i * dx + ln * lx]
            q[i][ln] = plane[py + (i + 1) * dy + ln * ly, px + (i + 1) * dx + ln * lx]
    dp0 = abs(p[2][0] - 2 * p[1][0] + p[0][0])
    dp3 = abs(p[2][3] - 2 * p[1][3] + p[0][3])
    dq0 = abs(q[2][0] - 2 * q[1][0] + q[0][0])
    dq3 = abs(q[2][3] - 2 * q[1][3] + q[0][3])
    d = dp0 + dp3 + dq0 + dq3
    if d >= beta:
        return
    def strong_line(ln):
        return (2 * ((dp0 if ln == 0 else dp3) + (dq0 if ln == 0 else dq3))
                < (beta >> 2)
                and abs(p[3][ln] - p[0][ln]) + abs(q[0][ln] - q[3][ln])
                < (beta >> 3)
                and abs(p[0][ln] - q[0][ln]) < ((5 * tc + 1) >> 1))
    strong = strong_line(0) and strong_line(3)
    newp = p.copy()
    newq = q.copy()
    if strong:
        for ln in range(4):
            p0, p1, p2, p3 = p[0][ln], p[1][ln], p[2][ln], p[3][ln]
            q0, q1, q2, q3 = q[0][ln], q[1][ln], q[2][ln], q[3][ln]
            newp[0][ln] = clip3(p0 - 2 * tc, p0 + 2 * tc,
                                (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
            newp[1][ln] = clip3(p1 - 2 * tc, p1 + 2 * tc,
                                (p2 + p1 + p0 + q0 + 2) >> 2)
            newp[2][ln] = clip3(p2 - 2 * tc, p2 + 2 * tc,
                                (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
            newq[0][ln] = clip3(q0 - 2 * tc, q0 + 2 * tc,
                                (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
            newq[1][ln] = clip3(q1 - 2 * tc, q1 + 2 * tc,
                                (q2 + q1 + q0 + p0 + 2) >> 2)
            newq[2][ln] = clip3(q2 - 2 * tc, q2 + 2 * tc,
                                (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)
    else:
        dep1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
        deq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)
        for ln in range(4):
            p0, p1, p2 = p[0][ln], p[1][ln], p[2][ln]
            q0, q1, q2 = q[0][ln], q[1][ln], q[2][ln]
            delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = clip3(-tc, tc, delta)
            newp[0][ln] = clip3(0, 255, p0 + delta)
            newq[0][ln] = clip3(0, 255, q0 - delta)
            if dep1:
                dp = clip3(-(tc >> 1), tc >> 1,
                           (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
                newp[1][ln] = clip3(0, 255, p1 + dp)
            if deq1:
                dq = clip3(-(tc >> 1), tc >> 1,
                           (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
                newq[1][ln] = clip3(0, 255, q1 + dq)
    for i in range(3):
        for ln in range(4):
            plane[py - i * dy + ln * ly, px - i * dx + ln * lx] = newp[i][ln]
            plane[py + (i + 1) * dy + ln * ly, px + (i + 1) * dx + ln * lx] = newq[i][ln]


def _filter_chroma_segment(plane, px, py, dx, dy, tc):
    lx, ly = dy, dx
    for ln in range(4):
        p0 = int(plane[py + ln * ly, px + ln * lx])
        p1 = int(plane[py - dy + ln * ly, px - dx + ln * lx])
        q0 = int(plane[py + dy + ln * ly, px + dx + ln * lx])
        q1 = int(plane[py + 2 * dy + ln * ly, px + 2 * dx + ln * lx])
        delta = clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
        plane[py + ln * ly, px + ln * lx] = clip3(0, 255, p0 + delta)
        plane[py + dy + ln * ly, px + dx + ln * lx] = clip3(0, 255, q0 - delta)


def deblock_picture(plan: FramePlan, planes: list[np.ndarray]
                    ) -> list[np.ndarray]:
    sps, sh = plan.sps, plan.sh
    w, h = sps.pic_width, sps.pic_height
    y = planes[0].copy()
    cb = planes[1].copy()
    cr = planes[2].copy()
    ef = plan.edge_flags
    qp = plan.qp_map
    boff = sh.beta_offset_div2 << 1
    toff = sh.tc_offset_div2 << 1

    for vertical in (True, False):
        # luma
        if vertical:
            for x in range(8, w, 8):
                for yy in range(0, h - 3, 4):
                    if not (ef[yy >> 2, x >> 2] & 1):
                        continue
                    bs = _bs(plan, (x - 1) >> 2, yy >> 2, x >> 2, yy >> 2)
                    if bs == 0:
                        continue
                    qpl = (int(qp[yy >> 2, (x - 1) >> 2])
                           + int(qp[yy >> 2, x >> 2]) + 1) >> 1
                    beta = int(BETA_TABLE[clip3(0, 51, qpl + boff)])
                    tc = int(TC_TABLE[clip3(0, 53, qpl + 2 * (bs - 1) + toff)])
                    if beta == 0 and tc == 0:
                        continue
                    _filter_luma_segment(y, x - 1, yy, 1, 0, beta, tc)
        else:
            for yy in range(8, h, 8):
                for x in range(0, w - 3, 4):
                    if not (ef[yy >> 2, x >> 2] & 2):
                        continue
                    bs = _bs(plan, x >> 2, (yy - 1) >> 2, x >> 2, yy >> 2)
                    if bs == 0:
                        continue
                    qpl = (int(qp[(yy - 1) >> 2, x >> 2])
                           + int(qp[yy >> 2, x >> 2]) + 1) >> 1
                    beta = int(BETA_TABLE[clip3(0, 51, qpl + boff)])
                    tc = int(TC_TABLE[clip3(0, 53, qpl + 2 * (bs - 1) + toff)])
                    if beta == 0 and tc == 0:
                        continue
                    _filter_luma_segment(y, x, yy - 1, 0, 1, beta, tc)
        # chroma: edges every 16 luma samples, bS==2 only
        cw, chh = w >> 1, h >> 1
        if vertical:
            for x in range(16, w, 16):
                for yy in range(0, h - 7, 8):
                    if not (ef[yy >> 2, x >> 2] & 1):
                        continue
                    bs = _bs(plan, (x - 1) >> 2, yy >> 2, x >> 2, yy >> 2)
                    if bs < 2:
                        continue
                    qpl = (int(qp[yy >> 2, (x - 1) >> 2])
                           + int(qp[yy >> 2, x >> 2]) + 1) >> 1
                    for plane, c_off in ((cb, plan.pps.cb_qp_offset),
                                         (cr, plan.pps.cr_qp_offset)):
                        qpc = chroma_qp_from_luma(clip3(0, 57, qpl + c_off))
                        tc = int(TC_TABLE[clip3(0, 53, qpc + 2 + toff)])
                        if tc:
                            _filter_chroma_segment(plane, (x >> 1) - 1, yy >> 1,
                                                   1, 0, tc)
        else:
            for yy in range(16, h, 16):
                for x in range(0, w - 7, 8):
                    if not (ef[yy >> 2, x >> 2] & 2):
                        continue
                    bs = _bs(plan, x >> 2, (yy - 1) >> 2, x >> 2, yy >> 2)
                    if bs < 2:
                        continue
                    qpl = (int(qp[(yy - 1) >> 2, x >> 2])
                           + int(qp[yy >> 2, x >> 2]) + 1) >> 1
                    for plane, c_off in ((cb, plan.pps.cb_qp_offset),
                                         (cr, plan.pps.cr_qp_offset)):
                        qpc = chroma_qp_from_luma(clip3(0, 57, qpl + c_off))
                        tc = int(TC_TABLE[clip3(0, 53, qpc + 2 + toff)])
                        if tc:
                            _filter_chroma_segment(plane, x >> 1, (yy >> 1) - 1,
                                                   0, 1, tc)
    return [y, cb, cr]
