"""Loop filters (spec 8.7): deblocking and SAO, bit-exact.

Counterpart of p265_tpu/kernels/loopfilter.py.  The host builds per-edge
parameter grids (bS, beta, tc) and per-CTB SAO grids in NumPy (copies of
the JAX module's host half: the port imports nothing of the JAX package);
the device filters whole batches of planes.  The horizontal deblocking
pass is the vertical filter on the transposed planes.  The JAX package ran
the three device functions as XLA; here `deblock_planes` (both directions
of a batch's luma and chroma), `deblock_luma_vertical` and
`deblock_chroma_vertical` (one direction, on any strides: the row-sharded
deblocking) and `sao_apply` launch the hand-written kernels of
csrc/loopfilter.cu on CUDA tensors (one launch a call over all the planes
of the batch) and take their plain versions (`*_ref`, branch-free int32
torch) on CPU tensors.

One assembly of the chain serves every caller: `pack_filter_params` (host)
and `filter_planes` (device: deblocking, SAO, then the restore of the
bypass samples and the uint8 output) are what the fused batch path runs;
the per-picture entry points `deblock`, `sao`, `loop_filters` and
`loop_filters_frames` (counterparts of deblock_tpu, sao_tpu,
loop_filters_tpu and loop_filters_tpu_frames) stack their pictures and
run the same two.

The kernels read the parameters at the reference's wire dtypes, as
pack_filter_params stages them (the deblocking grids int16, the SAO maps
int8), and their wrappers refuse any other dtype; the plain versions take
the same arrays (or wider ones) and widen them (kernels/staging.py
`widen`).  SAO's launch ends the chain: it writes uint8 samples, the
prefilter sample wherever a bypass mask is set.
"""
from __future__ import annotations

import numpy as np
import torch

from p265_tpu_torch import native
from p265_tpu_torch.golden.decoder import bypass_pixel_masks
from p265_tpu_torch.kernels import _build
from p265_tpu_torch.kernels.staging import stage, widen
from p265_tpu_torch.native import deblock as native_deblock
from p265_tpu_torch.spans import span
from p265_tpu_torch.syntax.ctu import SAO_BAND, SAO_EDGE
from p265_tpu_torch.tables import BETA_TABLE, TC_TABLE, chroma_qp_from_luma

NO_REF = -(1 << 30)

# ---------------------------------------------------------------------------
# host: edge parameter grids
# ---------------------------------------------------------------------------


def bs_vec(plan, y4p, x4p, y4q, x4q):
    """Vectorized boundary strength (8.7.2.4) over 4x4-unit index grids."""
    im, cbf = plan.intra_map, plan.cbf_map
    intra = im[y4p, x4p].astype(bool) | im[y4q, x4q].astype(bool)
    has_cbf = cbf[y4p, x4p].astype(bool) | cbf[y4q, x4q].astype(bool)
    mv_ne = np.zeros(np.shape(y4p), bool)
    if plan.mv_map is not None:
        mv, rf = plan.mv_map, plan.ref_map
        rp = rf[y4p, x4p].astype(np.int64)   # [..., 2]
        rq = rf[y4q, x4q].astype(np.int64)
        up0, up1 = rp[..., 0] != NO_REF, rp[..., 1] != NO_REF
        uq0, uq1 = rq[..., 0] != NO_REF, rq[..., 1] != NO_REF
        cnt_p = up0.astype(np.int32) + up1.astype(np.int32)
        cnt_q = uq0.astype(np.int32) + uq1.astype(np.int32)
        big = np.int64(1) << 60

        def ref_set(r, u0, u1):      # set as sorted (lo, hi) with dedupe
            a = np.where(u0, r[..., 0], big)
            b = np.where(u1, r[..., 1], big)
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            return lo, np.where(lo == hi, big, hi)

        lp, hp = ref_set(rp, up0, up1)
        lq, hq = ref_set(rq, uq0, uq1)
        set_ne = (lp != lq) | (hp != hq)

        mvp = mv[y4p, x4p]           # [..., 2, 2]
        mvq = mv[y4q, x4q]
        first_p = np.where(up0[..., None], mvp[..., 0, :], mvp[..., 1, :])
        first_q = np.where(uq0[..., None], mvq[..., 0, :], mvq[..., 1, :])

        def ge4(a, b):
            return ((np.abs(a[..., 0] - b[..., 0]) >= 4)
                    | (np.abs(a[..., 1] - b[..., 1]) >= 4))

        both2 = (cnt_p == 2) & (cnt_q == 2)
        mv_ne = (set_ne | (cnt_p != cnt_q) | ge4(first_p, first_q)
                 | (both2 & ge4(mvp[..., 1, :], mvq[..., 1, :])))
    return np.where(intra, 2,
                    np.where(has_cbf | mv_ne, 1, 0)).astype(np.int32)


def luma_edge_params(plan, vertical: bool):
    """-> (bs, beta, tc) int32 [n_seg, n_edges], in the orientation the
    vertical filter consumes (transposed layout for horizontal edges)."""
    sps, sh = plan.sps, plan.sh
    w, h = sps.pic_width, sps.pic_height
    ef, qp = plan.edge_flags, plan.qp_map
    boff, toff = sh.beta_offset_div2 << 1, sh.tc_offset_div2 << 1
    n_s = h // 4 if vertical else w // 4
    edges = np.arange(8, w if vertical else h, 8)
    if len(edges) == 0:
        z = np.zeros((n_s, 0), np.int32)
        return z, z.copy(), z.copy()
    s4 = np.arange(n_s)[:, None]            # segment index (4-sample rows)
    e4 = (edges >> 2)[None, :]
    if vertical:
        on = (ef[s4, e4] & 1).astype(bool)
        bs = bs_vec(plan, s4, e4 - 1, s4, e4)
        qpl = (qp[s4, e4 - 1].astype(np.int32)
               + qp[s4, e4].astype(np.int32) + 1) >> 1
    else:
        on = (ef[e4, s4] & 2).astype(bool)
        bs = bs_vec(plan, e4 - 1, s4, e4, s4)
        qpl = (qp[e4 - 1, s4].astype(np.int32)
               + qp[e4, s4].astype(np.int32) + 1) >> 1
    bs = np.where(on, bs, 0)
    beta = np.where(bs > 0,
                    BETA_TABLE[np.clip(qpl + boff, 0, 51)], 0).astype(np.int32)
    tc = np.where(bs > 0,
                  TC_TABLE[np.clip(qpl + 2 * (bs - 1) + toff, 0, 53)],
                  0).astype(np.int32)
    return bs, beta, tc


def chroma_edge_params(plan, vertical: bool):
    """-> [tc_cb, tc_cr] [n_seg, n_edges] in chroma coords; 0 = no filter."""
    sps, sh = plan.sps, plan.sh
    w, h = sps.pic_width, sps.pic_height
    ef, qp = plan.edge_flags, plan.qp_map
    toff = sh.tc_offset_div2 << 1
    edges = np.arange(16, w if vertical else h, 16)
    n_s = (h if vertical else w) // 8
    if len(edges) == 0:
        z = np.zeros((n_s, 0), np.int32)
        return [z, z.copy()]
    s4 = (np.arange(n_s) * 2)[:, None]      # 8-sample rows in 4x4 units
    e4 = (edges >> 2)[None, :]
    if vertical:
        on = (ef[s4, e4] & 1).astype(bool)
        bs = bs_vec(plan, s4, e4 - 1, s4, e4)
        qpl = (qp[s4, e4 - 1].astype(np.int32)
               + qp[s4, e4].astype(np.int32) + 1) >> 1
    else:
        on = (ef[e4, s4] & 2).astype(bool)
        bs = bs_vec(plan, e4 - 1, s4, e4, s4)
        qpl = (qp[e4 - 1, s4].astype(np.int32)
               + qp[e4, s4].astype(np.int32) + 1) >> 1
    strong = on & (bs >= 2)
    qpc_lut = np.array([chroma_qp_from_luma(q) for q in range(58)], np.int32)
    tcs = []
    for c_off in (plan.pps.cb_qp_offset, plan.pps.cr_qp_offset):
        qpc = qpc_lut[np.clip(qpl + c_off, 0, 57)]
        tcs.append(np.where(strong,
                            TC_TABLE[np.clip(qpc + 2 + toff, 0, 53)],
                            0).astype(np.int32))
    return tcs


def sao_maps(plan, c: int):
    """Per-CTB SAO grids (type [ny,nx], class [ny,nx], offsets [4,ny,nx]);
    expansion to pixels happens on the device."""
    sps = plan.sps
    nx, ny = sps.pic_width_ctbs, sps.pic_height_ctbs
    ty = np.zeros((ny, nx), np.int32)
    cls = np.zeros((ny, nx), np.int32)
    offs = np.zeros((4, ny, nx), np.int32)
    for a, rec in enumerate(plan.sao):
        iy, ix = divmod(a, nx)
        ty[iy, ix] = rec.type[c]
        cls[iy, ix] = rec.cls[c]
        for i in range(4):
            offs[i, iy, ix] = rec.offsets[c][i]
    return ty, cls, offs


# ---------------------------------------------------------------------------
# device: deblocking over a batch of planes [B, H, W]
# ---------------------------------------------------------------------------


def _edge_cols(n_e: int, device) -> torch.Tensor:
    return 8 * (torch.arange(n_e, device=device) + 1)


def deblock_luma_vertical_ref(planes, bs, beta, tc):
    """Plain version of deblock_luma_vertical: branch-free int32 torch
    (the int16 edge parameters widened here)."""
    bs, beta, tc = (widen(t, torch.int32) for t in (bs, beta, tc))
    B, H, W = planes.shape
    n_e = bs.shape[2]
    cols = _edge_cols(n_e, planes.device)
    p = [planes[:, :, cols - 1 - i] for i in range(4)]   # [B, H, n_e] each
    q = [planes[:, :, cols + i] for i in range(4)]

    def seg(v):  # [B, H, n_e] -> [B, H//4, 4, n_e]
        return v.reshape(B, H // 4, 4, n_e)

    sp = [seg(v) for v in p]
    sq = [seg(v) for v in q]
    dp0 = (sp[2][:, :, 0] - 2 * sp[1][:, :, 0] + sp[0][:, :, 0]).abs()
    dp3 = (sp[2][:, :, 3] - 2 * sp[1][:, :, 3] + sp[0][:, :, 3]).abs()
    dq0 = (sq[2][:, :, 0] - 2 * sq[1][:, :, 0] + sq[0][:, :, 0]).abs()
    dq3 = (sq[2][:, :, 3] - 2 * sq[1][:, :, 3] + sq[0][:, :, 3]).abs()
    d = dp0 + dp3 + dq0 + dq3
    filt = (bs > 0) & (d < beta)

    def strong_line(ln):
        dpl = dp0 if ln == 0 else dp3
        dql = dq0 if ln == 0 else dq3
        return ((2 * (dpl + dql) < (beta >> 2))
                & ((sp[3][:, :, ln] - sp[0][:, :, ln]).abs()
                   + (sq[0][:, :, ln] - sq[3][:, :, ln]).abs() < (beta >> 3))
                & ((sp[0][:, :, ln] - sq[0][:, :, ln]).abs()
                   < ((5 * tc + 1) >> 1)))

    strong = strong_line(0) & strong_line(3)         # [B, H//4, n_e]
    dep1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    deq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    def up(m):  # segment grid -> per-line [B, H, n_e]
        return m.repeat_interleave(4, dim=1)

    tcl = up(tc)
    p0, p1, p2, p3 = p
    q0, q1, q2, q3 = q

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    sp0 = clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
               p0 - 2 * tcl, p0 + 2 * tcl)
    sp1 = clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tcl, p1 + 2 * tcl)
    sp2 = clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
               p2 - 2 * tcl, p2 + 2 * tcl)
    sq0 = clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
               q0 - 2 * tcl, q0 + 2 * tcl)
    sq1 = clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tcl, q1 + 2 * tcl)
    sq2 = clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
               q2 - 2 * tcl, q2 + 2 * tcl)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wok = delta.abs() < tcl * 10
    dlt = clip(delta, -tcl, tcl)
    wp0 = (p0 + dlt).clamp(0, 255)
    wq0 = (q0 - dlt).clamp(0, 255)
    dp_ = clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -(tcl >> 1), tcl >> 1)
    wp1 = (p1 + dp_).clamp(0, 255)
    dq_ = clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -(tcl >> 1), tcl >> 1)
    wq1 = (q1 + dq_).clamp(0, 255)

    filt_l = up(filt)
    strong_l = up(filt & strong)
    weak_l = filt_l & ~strong_l & wok
    weakp1 = weak_l & up(dep1)
    weakq1 = weak_l & up(deq1)

    out = planes.clone()
    out[:, :, cols - 1] = torch.where(strong_l, sp0,
                                      torch.where(weak_l, wp0, p0))
    out[:, :, cols - 2] = torch.where(strong_l, sp1,
                                      torch.where(weakp1, wp1, p1))
    out[:, :, cols - 3] = torch.where(strong_l, sp2, p2)
    out[:, :, cols + 0] = torch.where(strong_l, sq0,
                                      torch.where(weak_l, wq0, q0))
    out[:, :, cols + 1] = torch.where(strong_l, sq1,
                                      torch.where(weakq1, wq1, q1))
    out[:, :, cols + 2] = torch.where(strong_l, sq2, q2)
    return out


def deblock_chroma_vertical_ref(planes, tc):
    """Plain version of deblock_chroma_vertical (tc widened here)."""
    tc = widen(tc, torch.int32)
    n_e = tc.shape[2]
    cols = _edge_cols(n_e, planes.device)
    p1 = planes[:, :, cols - 2]
    p0 = planes[:, :, cols - 1]
    q0 = planes[:, :, cols + 0]
    q1 = planes[:, :, cols + 1]
    tcl = tc.repeat_interleave(4, dim=1)
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tcl), tcl)
    on = tcl > 0
    out = planes.clone()
    out[:, :, cols - 1] = torch.where(on, (p0 + delta).clamp(0, 255), p0)
    out[:, :, cols + 0] = torch.where(on, (q0 - delta).clamp(0, 255), q0)
    return out


# ---------------------------------------------------------------------------
# device: SAO over a batch of planes
# ---------------------------------------------------------------------------

_EO = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))


def sao_apply_ref(src, ty_g, cls_g, offs_g, ctb: int, keep=None,
                  dtype=torch.int32):
    """Plain version of sao_apply (the int8 maps widened here)."""
    ty_g, cls_g, offs_g = (widen(t, torch.int32)
                           for t in (ty_g, cls_g, offs_g))
    B, H, W = src.shape
    dev = src.device

    def expand(m):  # [B, ny, nx] -> [B, H, W]
        e = m.repeat_interleave(ctb, dim=1).repeat_interleave(ctb, dim=2)
        return e[:, :H, :W]

    ty = expand(ty_g)
    cls = expand(cls_g)
    o = [expand(offs_g[:, i]) for i in range(4)]
    zero = torch.zeros((), dtype=src.dtype, device=dev)

    def pick(k, keys):  # sum_i (k == keys[i]) * o[i]
        return sum(torch.where(k == kv, o[i], zero)
                   for i, kv in enumerate(keys))

    v = src
    rel = ((v >> 3) - cls) & 31
    d_band = pick(rel, (0, 1, 2, 3))
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    d_edges = []
    for (dy0, dx0, dy1, dx1) in _EO:
        n0 = torch.roll(v, shifts=(-dy0, -dx0), dims=(1, 2))
        n1 = torch.roll(v, shifts=(-dy1, -dx1), dims=(1, 2))
        valid = ((yy + dy0 >= 0) & (yy + dy0 < H) & (xx + dx0 >= 0)
                 & (xx + dx0 < W) & (yy + dy1 >= 0) & (yy + dy1 < H)
                 & (xx + dx1 >= 0) & (xx + dx1 < W))
        e = torch.sign(v - n0) + torch.sign(v - n1)
        d_edges.append(torch.where(valid, pick(e, (-2, -1, 1, 2)), zero))
    d_edge = torch.where(cls == 0, d_edges[0],
                         torch.where(cls == 1, d_edges[1],
                                     torch.where(cls == 2, d_edges[2],
                                                 d_edges[3])))
    delta = torch.where(ty == SAO_BAND, d_band,
                        torch.where(ty == SAO_EDGE, d_edge, zero))
    out = (v + delta).clamp(0, 255)
    if keep is not None:
        out = torch.where(keep[1], keep[0], out)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# the kernels (csrc/loopfilter.cu): a CPU tensor takes the plain version,
# a CUDA tensor launches the kernel, any other device raises
# ---------------------------------------------------------------------------


def on_cuda(t, name: str) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {t.device}")
    return t.device.type == "cuda"


def _wire(t, what: str, dtype, shape, device) -> torch.Tensor:
    """t as a kernel reads it: its wire dtype (never cast here), shape and
    device; a mismatch raises."""
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device):
        raise ValueError(f"{what} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def _deblock_launch(name: str, groups: list, both: bool) -> list:
    """ONE launch of csrc/loopfilter.cu's deblocking over a table of plane
    groups [(planes [B,H,W], vertical parameters, horizontal parameters or
    None, chroma)]: luma parameters are (bS, beta, tc), chroma ones (tc,),
    all int16, the vertical ones [B, H//4, n_ev] and the horizontal ones
    (the transposed layout) [B, W//4, n_eh].  both: the vertical edges,
    then the horizontal ones; else the vertical edges only.  Planes may be any
    strided view (a transposed view is read and written in its storage
    order, with no copy); the outputs are new planes with the input's
    strides where the input is dense.  -> the outputs, in order."""
    rows, outs = [], []
    dev = groups[0][0].device
    for planes, pv, ph, chroma in groups:
        if (planes.dim() != 3 or planes.dtype != torch.int32
                or planes.device != dev):
            raise ValueError(f"{name}: planes must be int32 [B,H,W] on "
                             f"{dev}, got {planes.dtype} "
                             f"{tuple(planes.shape)} on {planes.device}")
        B, H, W = planes.shape
        reach = 2 if chroma else 4
        n_ev = pv[-1].shape[-1]
        n_eh = ph[-1].shape[-1] if both else 0
        if (H % 4 or (both and W % 4) or 8 * n_ev + reach > W
                or 8 * n_eh + reach > H):
            raise ValueError(f"{name}: {n_ev} vertical and {n_eh} "
                             f"horizontal edges do not fit planes of "
                             f"{H}x{W}")
        pv = [_wire(t, f"{name}: vertical edge parameters", torch.int16,
                    (B, H // 4, n_ev), dev) for t in pv]
        ph = ([_wire(t, f"{name}: horizontal edge parameters", torch.int16,
                     (B, W // 4, n_eh), dev) for t in ph] if both else [])
        out = torch.empty_like(planes)
        outs.append(out)
        if not out.numel():
            continue

        def ptrs(ts):
            # chroma has no bS and no beta
            return [0, 0] * chroma + [t.data_ptr() for t in ts]

        rows.append([planes.data_ptr(), out.data_ptr(), *ptrs(pv),
                     *(ptrs(ph) if both else [0, 0, 0]), int(chroma), B, H,
                     W, n_ev, n_eh, *planes.stride(), *out.stride()])
    if rows:
        table = np.array(rows, np.int64)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.p265_deblock(table.ctypes.data, len(rows), int(both),
                                   torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "deblock")
        _build.LAUNCHES["deblock"] += 1
    return outs


def deblock_luma_vertical(planes, bs, beta, tc):
    """planes [B,H,W] int32 (any strides); bs/beta/tc [B, H//4, n_e] int16
    (the plain version also takes int32); edges at x = 8(k+1).  Returns
    new planes; the inputs are not modified.  A CPU tensor takes
    deblock_luma_vertical_ref; a CUDA tensor launches csrc/loopfilter.cu
    once for all B planes (one direction)."""
    if not on_cuda(planes, "deblock_luma_vertical"):
        return deblock_luma_vertical_ref(planes, bs, beta, tc)
    return _deblock_launch("deblock_luma_vertical",
                           [(planes, [bs, beta, tc], None, False)],
                           both=False)[0]


def deblock_chroma_vertical(planes, tc):
    """planes [B,Hc,Wc] int32 (any strides); tc [B, Hc//4, n_e] int16 (the
    plain version also takes int32); edges at x = 8(k+1).  CPU:
    deblock_chroma_vertical_ref; CUDA: one launch of csrc/loopfilter.cu
    (one direction)."""
    if not on_cuda(planes, "deblock_chroma_vertical"):
        return deblock_chroma_vertical_ref(planes, tc)
    return _deblock_launch("deblock_chroma_vertical",
                           [(planes, [tc], None, True)], both=False)[0]


def _edge_params(fp: dict, key: str) -> tuple:
    """(luma (bS, beta, tc), chroma (tc,)) of one direction of fp."""
    return ([fp[f"{n}_{key}"] for n in ("bs", "beta", "tc")],
            [fp[f"tcc_{key}"]])


def deblock_planes_ref(luma, chroma, fp: dict) -> tuple:
    """Plain version of deblock_planes: the vertical edges, then the
    horizontal ones as the vertical filter on the transposes."""
    for key in ("v", "h"):
        if key == "h":
            luma, chroma = luma.transpose(1, 2), chroma.transpose(1, 2)
        lp, cp = _edge_params(fp, key)
        if lp[0].shape[2]:
            luma = deblock_luma_vertical_ref(luma, *lp)
        if cp[0].shape[2]:
            chroma = deblock_chroma_vertical_ref(chroma, *cp)
        if key == "h":
            luma, chroma = luma.transpose(1, 2), chroma.transpose(1, 2)
    return luma, chroma


def deblock_planes(luma, chroma, fp: dict) -> tuple:
    """The deblocking of a batch: luma [F,H,W] and chroma [2F,Hc,Wc] int32
    (any strides: rows of the tall plane on the batch path), fp the
    vertical (bs_v, beta_v, tc_v, tcc_v) and horizontal (bs_h, beta_h,
    tc_h, tcc_h: the transposed layout) edge parameters of
    pack_filter_params (int16) -> new planes, deblocked vertically, then
    horizontally; the inputs are not modified.  A CPU tensor takes
    deblock_planes_ref; a CUDA tensor launches csrc/loopfilter.cu ONCE for
    both directions and both plane groups."""
    if not on_cuda(luma, "deblock_planes"):
        return deblock_planes_ref(luma, chroma, fp)
    (lv, cv), (lh, ch) = _edge_params(fp, "v"), _edge_params(fp, "h")
    luma, chroma = _deblock_launch(
        "deblock_planes", [(luma, lv, lh, False), (chroma, cv, ch, True)],
        both=True)
    return luma, chroma


def sao_kernel(src, ty_g, cls_g, offs_g, ctb: int, row0: int = 0,
               total_h: int | None = None, halo: int = 0, keep=None,
               dtype=torch.int32):
    """One launch of csrc/loopfilter.cu's SAO on CUDA tensors: src
    [B, H + 2 halo, W] int32 (any strides; `halo` rows above and below the
    rows to filter), ty_g/cls_g [B,ny,nx] and offs_g [B,4,ny,nx] int8 ->
    the filtered rows [B,H,W] at `dtype` (int32 or uint8).  row0 is the
    picture row of the first filtered row and total_h the picture's height
    (default H): neighbours outside the picture's rows are no neighbours,
    and rows past the CTB map take its last CTB row.  keep: (prefilter
    [B,H,W] int32 any strides, mask [B,H,W] bool) -> where the mask is
    set, the output is the prefilter sample.  CTBs are a power of two from
    8 samples; with no halo rows the rows are the picture's from its
    first."""
    if (src.device.type != "cuda" or src.dim() != 3
            or src.dtype != torch.int32):
        raise ValueError(f"sao: the kernel takes an int32 [B,H,W] CUDA "
                         f"tensor, got {src.dtype} {tuple(src.shape)} on "
                         f"{src.device}")
    if dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"sao: writes int32 or uint8, not {dtype}")
    dev = src.device
    B, Hs, W = src.shape
    H = Hs - 2 * halo
    total_h = H if total_h is None else total_h
    ny, nx = ty_g.shape[1:]
    if (H < 0 or halo < 0 or row0 < 0 or ny * ctb < total_h or nx * ctb < W
            or ctb < 8 or ctb & (ctb - 1)
            or (not halo and (row0 or H < total_h))):
        raise ValueError(f"sao: a {ny}x{nx} map of {ctb}-sample CTBs does "
                         f"not cover {total_h}x{W} (rows {row0}.., halo "
                         f"{halo}), or the CTB is no power of two from 8")
    maps = [_wire(t, f"sao: {n}", torch.int8, shape, dev)
            for t, n, shape in ((ty_g, "types", (B, ny, nx)),
                                (cls_g, "classes", (B, ny, nx)),
                                (offs_g, "offsets", (B, 4, ny, nx)))]
    pre, mask, pstride = None, None, (0, 0, 0)
    if keep is not None:
        pre, mask = keep
        if (pre.dtype != torch.int32 or tuple(pre.shape) != (B, H, W)
                or pre.device != dev):
            raise ValueError(f"sao: the prefilter planes must be int32 "
                             f"{(B, H, W)} on {dev}, got {pre.dtype} "
                             f"{tuple(pre.shape)} on {pre.device}")
        mask = _wire(mask, "sao: bypass mask", torch.bool, (B, H, W), dev)
        pstride = pre.stride()
    out = torch.empty((B, H, W), dtype=dtype, device=dev)
    if out.numel():
        q = np.array([src.data_ptr(), out.data_ptr(),
                      *(t.data_ptr() for t in maps), B, H, W, *src.stride(),
                      halo, row0, total_h, ny, nx, ctb, SAO_BAND, SAO_EDGE,
                      int(dtype == torch.uint8),
                      0 if pre is None else pre.data_ptr(),
                      0 if mask is None else mask.data_ptr(), *pstride],
                     np.int64)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.p265_sao(q.ctypes.data,
                               torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "sao")
        _build.LAUNCHES["sao"] += 1
    return out


def sao_apply(src, ty_g, cls_g, offs_g, ctb: int, keep=None,
              dtype=torch.int32):
    """src [B,H,W] int32 (any strides); ty_g/cls_g [B,ny,nx] and offs_g
    [B,4,ny,nx] int8 (the plain version also takes int32) -> [B,H,W] at
    `dtype` (int32 or uint8); keep (prefilter, bypass mask) as in
    sao_kernel.  CPU: sao_apply_ref; CUDA: one launch of
    csrc/loopfilter.cu (sao_kernel)."""
    if not on_cuda(src, "sao_apply"):
        return sao_apply_ref(src, ty_g, cls_g, offs_g, ctb, keep, dtype)
    return sao_kernel(src, ty_g, cls_g, offs_g, ctb, keep=keep, dtype=dtype)


# ---------------------------------------------------------------------------
# the chain: deblocking, SAO, restore of the bypass samples
# ---------------------------------------------------------------------------


def filter_flags(plan) -> tuple:
    """(deblocking on, SAO luma on, SAO chroma on) of one picture."""
    return (not plan.sh.deblocking_filter_disabled,
            bool(plan.sps.sao_enabled and plan.sh.sao_luma),
            bool(plan.sps.sao_enabled and plan.sh.sao_chroma))


def _edge_grids_numpy(plans: list) -> dict:
    """The deblocking grids of F pictures by luma_edge_params and
    chroma_edge_params, stacked."""
    fp = {}
    for vertical in (True, False):
        lp = [luma_edge_params(p, vertical) for p in plans]
        cp = [chroma_edge_params(p, vertical) for p in plans]
        key = "v" if vertical else "h"
        fp[f"bs_{key}"] = np.stack([x[0] for x in lp]).astype(np.int16)
        fp[f"beta_{key}"] = np.stack([x[1] for x in lp]).astype(np.int16)
        fp[f"tc_{key}"] = np.stack([x[2] for x in lp]).astype(np.int16)
        fp[f"tcc_{key}"] = np.stack([x[0] for x in cp]
                                    + [x[1] for x in cp]).astype(np.int16)
    return fp


def _edge_grids_c(plans: list) -> dict:
    """The same grids by native/deblock.py: allocated once for the batch,
    each picture's slices written by one C call (a picture of another
    size than the first raises)."""
    F, sps = len(plans), plans[0].sps
    fp = {}
    for key, (luma, chroma) in native_deblock.grid_shapes(
            sps.pic_width, sps.pic_height).items():
        for n in ("bs", "beta", "tc"):
            fp[f"{n}_{key}"] = np.empty((F, *luma), np.int16)
        fp[f"tcc_{key}"] = np.empty((2 * F, *chroma), np.int16)
    for f, p in enumerate(plans):
        native_deblock.edge_params(p, [
            [fp[f"{n}_{key}"][f] for n in ("bs", "beta", "tc")]
            + [fp[f"tcc_{key}"][f], fp[f"tcc_{key}"][F + f]]
            for key in ("v", "h")])
    return fp


def pack_filter_params(plans: list, flags=None, masks: bool = True,
                       stats: dict | None = None) -> dict:
    """Host: the filter arrays of F pictures of one resolution, stacked on
    a leading axis in the batch layout (luma: F; chroma: F cb, then F cr).

    flags: the (deblock, sao_luma, sao_chroma) stages to pack, default the
    pictures' own flags, which must then be the same for all of them.  A
    stage's keys are present only when it is on (bs/beta/tc/tcc_{v,h},
    sao_{ty,cls,off}_{0,1}); mask_y/mask_c only when `masks` and a picture
    has bypass samples.  filter_planes runs exactly the stages it finds.
    The arrays travel at the reference's wire dtypes (its _build_batch):
    the edge parameters int16, the SAO maps int8, the masks bool.

    The deblocking grids come from one C call a picture (native/deblock.py)
    wherever the native library loads, else from luma_edge_params and
    chroma_edge_params; the two give the same arrays.  stats: optional
    dict accumulating the span edge_params (edge_params_s and its _cpu_s,
    the grids' derivation) and edge_params_c_pictures (the pictures whose
    grids the C call wrote)."""
    if flags is None:
        sigs = {filter_flags(p) for p in plans}
        if len(sigs) != 1:
            raise ValueError("pictures with different loop-filter flags in "
                             f"one batch: {sigs}")
        flags = sigs.pop()
    deblock_on, sao_luma, sao_chroma = flags
    fp = {}
    if deblock_on:
        with span(stats, "edge_params"):
            in_c = native.available()
            fp.update(_edge_grids_c(plans) if in_c
                      else _edge_grids_numpy(plans))
        if in_c and stats is not None:
            stats["edge_params_c_pictures"] = (
                stats.get("edge_params_c_pictures", 0) + len(plans))
    for c, on in ((0, sao_luma), (1, sao_chroma)):
        if not on:
            continue
        maps = [sao_maps(p, cc) for cc in ((0,) if c == 0 else (1, 2))
                for p in plans]
        for i, name in enumerate(("ty", "cls", "off")):
            fp[f"sao_{name}_{c}"] = np.stack([m[i] for m in maps]).astype(
                np.int8)
    if masks:
        ms = [bypass_pixel_masks(p) for p in plans]
        if any(m is not None for m in ms):
            sps = plans[0].sps
            H, W = sps.pic_height, sps.pic_width
            fp["mask_y"] = np.stack([(m[0] if m is not None
                                      else np.zeros((H, W), bool))
                                     for m in ms])
            fp["mask_c"] = np.stack([(m[c] if m is not None
                                      else np.zeros((H >> 1, W >> 1), bool))
                                     for c in (1, 2) for m in ms])
    return fp


def filter_planes(luma, chroma, fp: dict, ctb: int) -> tuple:
    """Device: luma [F,H,W] and chroma [2F,Hc,Wc] int32 prefilter planes ->
    the filtered pair as uint8; fp is pack_filter_params' dict as tensors
    on the planes' device at its wire dtypes (the kernels read them as
    they are), ctb the luma CTB size.  On the card: one deblocking launch
    (deblock_planes) and one SAO launch a component (luma; cb and cr),
    whose store restores the bypass samples (mask ? prefilter : filtered)
    and writes uint8.  A component without SAO (a picture whose slice
    header turns SAO off for it) takes torch.where and a uint8 cast
    instead."""
    pre = (luma, chroma)
    if "bs_v" in fp:
        luma, chroma = deblock_planes(luma, chroma, fp)
    out = []
    for c, (planes, size, mask) in enumerate(
            ((luma, ctb, fp.get("mask_y")),
             (chroma, ctb >> 1, fp.get("mask_c")))):
        keep = None if mask is None else (pre[c], mask)
        if f"sao_ty_{c}" in fp:
            planes = sao_apply(planes, fp[f"sao_ty_{c}"], fp[f"sao_cls_{c}"],
                               fp[f"sao_off_{c}"], size, keep, torch.uint8)
        else:
            if keep is not None:
                planes = torch.where(mask, pre[c], planes)
            planes = planes.to(torch.uint8,
                               memory_format=torch.contiguous_format)
        out.append(planes)
    return tuple(out)


# ---------------------------------------------------------------------------
# per-picture entry points: [y, cb, cr] planes in, [y, cb, cr] planes out
# ---------------------------------------------------------------------------


def _filter_frames(plans: list, planes_list: list, device, flags=None,
                   masks: bool = True) -> list:
    """The chain (filter_planes) over F pictures' [y, cb, cr] planes ->
    per picture [y, cb, cr] uint8 tensors on `device`."""
    device = torch.device(device)

    def stack(c):
        return torch.stack([torch.as_tensor(pl[c]).to(
            device=device, dtype=torch.int32) for pl in planes_list])

    F = len(plans)
    fp = stage(pack_filter_params(plans, flags, masks), device)
    luma, chroma = filter_planes(stack(0), torch.cat([stack(1), stack(2)]),
                                 fp, plans[0].sps.ctb_size)
    return [[luma[f], chroma[f], chroma[F + f]] for f in range(F)]


def deblock(plan, planes: list, device) -> list:
    """Deblocking of one picture's [y, cb, cr] planes (numpy or tensors) ->
    uint8 tensors on `device`.  Counterpart of deblock_tpu."""
    return _filter_frames([plan], [planes], device, (True, False, False),
                          masks=False)[0]


def sao(plan, planes: list, device) -> list:
    """SAO of one picture's planes, per the slice header's luma and chroma
    flags.  Counterpart of sao_tpu."""
    return _filter_frames([plan], [planes], device,
                          (False, bool(plan.sh.sao_luma),
                           bool(plan.sh.sao_chroma)), masks=False)[0]


def loop_filters(plan, planes: list, device) -> list:
    """The in-loop filter chain of one picture: deblocking, SAO, and the
    bypass / PCM-loop-filter restore.  Counterpart of loop_filters_tpu;
    bit-exact vs golden apply_loop_filters."""
    return _filter_frames([plan], [planes], device)[0]


def loop_filters_frames(plans: list, planes_list: list, device) -> list:
    """The chain for F same-resolution pictures in one batched pass;
    pictures whose filter flags differ go one by one.  Counterpart of
    loop_filters_tpu_frames."""
    if len({filter_flags(p) for p in plans}) > 1:
        return [loop_filters(p, pl, device)
                for p, pl in zip(plans, planes_list)]
    return _filter_frames(plans, planes_list, device)
